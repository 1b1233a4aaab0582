"""Total time of the program's ``sync`` spans (each host read of device
data and each blocking copy to the card on the search path: the host
waiting on the card) per 1,000 reads of the traced window."""

from benchmark import program_trace


def read(rec):
    return program_trace.per_kread(program_trace.span_ms(program_trace.report(), "sync", "total_ms"), rec)
