"""Host time of the work-queue engine's step loop a K5 launch: the self
time of the program's spans ``workq.search`` (each ``workq_search``: its
queue set-up, its step loop and K5's wrapper, without the dedups and the
count read-backs, which are child spans) over the window's ``workq_step``
launches, in microseconds."""

from benchmark import program_trace


def read(rec):
    ms = program_trace.span_ms(program_trace.report(), "workq.search", "self_ms")
    launches = rec["launches"].get("workq_step", 0)
    if ms is None or launches == 0:
        return None
    return ms * 1e3 / launches
