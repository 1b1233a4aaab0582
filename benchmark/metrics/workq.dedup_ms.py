"""Self time of the program's span ``workq.dedup`` (each dedup of the work
queue, every 4th step: ``workq_dedup``'s launches, no read-back) per 1,000
reads of the traced window."""

from benchmark import program_trace


def read(rec):
    return program_trace.per_kread(program_trace.span_ms(program_trace.report(), "workq.dedup", "self_ms"), rec)
