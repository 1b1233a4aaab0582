"""The program's own tracer, read after the window: the spans and counters
that ``search_queries`` recorded under the stage timer the traced window
passed it.  Besides ``system.py`` the only module of the benchmark that
imports the program."""

from __future__ import annotations


def report() -> dict | None:
    """``trace.last().report()`` of the program (see its
    ``sahara_tpu_torch/trace.py``); None where the program has no tracer or
    no search was given one."""
    try:
        from sahara_tpu_torch import trace
    except ImportError:  # a program from before its tracer
        return None
    tracer = trace.last()
    return None if tracer is None else tracer.report()


def span_ms(rep: dict | None, name: str, key: str) -> float | None:
    """``key`` (``total_ms`` or ``self_ms``) of span ``name``; None where
    the span never closed."""
    stat = (rep or {}).get("spans", {}).get(name)
    return None if not stat or stat["count"] == 0 else stat[key]


def per_kread(value: float | None, rec: dict) -> float | None:
    """``value`` over the window's reads in thousands."""
    if value is None or rec["reads_done"] == 0:
        return None
    return value / (rec["reads_done"] / 1e3)
