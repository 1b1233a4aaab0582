"""Share of the frontier ladder's searched queries that were retries (an
attempt after their chunk's first), from the program's counters
``approx.queries_retried`` and ``approx.queries_searched``, in percent."""

from benchmark import program_trace


def read(rec):
    counters = (program_trace.report() or {}).get("counters", {})
    searched = counters.get("approx.queries_searched", 0)
    if searched == 0:
        return None
    return 100.0 * counters.get("approx.queries_retried", 0) / searched
