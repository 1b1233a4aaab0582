"""The program's counter ``workq.queue_rows`` (the work-queue rows entering
each K5 step, summed: the frontier that sets K5's device time and that the
dedup thins) per 1,000 reads of the traced window."""

from benchmark import program_trace


def read(rec):
    rows = (program_trace.report() or {}).get("counters", {}).get("workq.queue_rows", 0)
    return program_trace.per_kread(rows or None, rec)
