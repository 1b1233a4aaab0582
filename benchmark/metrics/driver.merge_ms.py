"""Self time of the program's span ``driver.merge`` (every
``_merge_results`` of a call: the located rows packed into one int64 key
a row, one sort of the keys and the dedup, on the host; a lexsort of the
four columns only where a key would need more than 63 bits) per 1,000
reads of the traced window."""

from benchmark import program_trace


def read(rec):
    return program_trace.per_kread(program_trace.span_ms(program_trace.report(), "driver.merge", "self_ms"), rec)
