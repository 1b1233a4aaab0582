"""Self time of the program's span ``driver.merge`` (every
``_merge_results`` of a call: concatenation, lexsort and dedup of the
located rows on the host) per 1,000 reads of the traced window."""

from benchmark import program_trace


def read(rec):
    return program_trace.per_kread(program_trace.span_ms(program_trace.report(), "driver.merge", "self_ms"), rec)
