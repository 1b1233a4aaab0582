"""Self time of the program's span ``approx.ladder``
(``run_scheme_search_chunked`` less its searches and syncs: the retry
ladder's host bookkeeping) per 1,000 reads of the traced window."""

from benchmark import program_trace


def read(rec):
    return program_trace.per_kread(program_trace.span_ms(program_trace.report(), "approx.ladder", "self_ms"), rec)
