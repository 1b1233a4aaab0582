"""Host time of the frontier engine's searches a K8 launch: the self time
of the program's spans ``approx.search`` (each ``scheme_search``: its
buffers, its context and its K8 launches) over the window's
``frontier_step`` launches, in microseconds."""

from benchmark import program_trace


def read(rec):
    ms = program_trace.span_ms(program_trace.report(), "approx.search", "self_ms")
    launches = rec["launches"].get("frontier_step", 0)
    if ms is None or launches == 0:
        return None
    return ms * 1e3 / launches
