"""Count of the program's ``sync`` spans (operations on the search path
that block the host on the card) per 1,000 reads of the traced window."""

from benchmark import program_trace


def read(rec):
    stat = (program_trace.report() or {}).get("spans", {}).get("sync")
    return program_trace.per_kread(stat["count"] if stat and stat["count"] else None, rec)
