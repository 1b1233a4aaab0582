"""Self time of the program's span ``sv.bad_mask`` (``seed_bad_mask``: the
host scan for seed characters the j-mer table cannot encode, once a call)
per 1,000 reads of the traced window."""

from benchmark import program_trace


def read(rec):
    return program_trace.per_kread(program_trace.span_ms(program_trace.report(), "sv.bad_mask", "self_ms"), rec)
