"""The program's tracer: spans and counters at the search path's layer
boundaries, and the seed-and-verify stage times.

``search_queries(timer=t)`` makes ``t``, a ``StageTimer``, the current
tracer for the call (a context variable, so spans anywhere below the call
reach it without a parameter), and ``last()`` returns the tracer most
recently passed to a search.  Inside, ``span(name)`` records a span: its
name, start and end (``time.perf_counter_ns``), its parent span and the
call it belongs to, the id its root span took.  ``count(name, n)`` adds to
a counter.  ``sync(site)`` is the span ``sync`` around one operation that
blocks the host on the card: a read of device data, or a copy of host
memory to the device.

The tracer keeps, for each span name, the count, the total time and the
self time (the duration less the part its child spans cover), each
counter's total, and the count and time of each ``sync`` site: its memory
is bounded by the names, not by the calls.  ``report()`` returns all of it.

Whenever ``torch.profiler`` is recording, with a tracer or without one,
each span also opens ``torch.profiler.record_function(<name>)``, so the
spans lie on the profiler's clock as ``user_annotation`` events.  With
neither, a span costs a context-variable read and one check of the
profiler's flag.

A tracer serves one search at a time.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import time

import torch

STAGES = ("seed", "expand", "locate", "verify", "emit")  # a seed-and-verify chunk's stages

_TRACER: contextvars.ContextVar[StageTimer | None] = contextvars.ContextVar("sahara_tracer", default=None)
_SPAN: contextvars.ContextVar[_Span | None] = contextvars.ContextVar("sahara_span", default=None)
_NULL = contextlib.nullcontext()
_clock = time.perf_counter_ns
_profiling = torch.autograd._profiler_enabled
_last: StageTimer | None = None


class _Span:
    """One open span of ``tracer``; closed, it adds itself to the
    tracer's totals and its duration to its parent's children."""

    __slots__ = ("tracer", "name", "site", "parent", "call", "start", "end", "child_ns", "_token", "_annotation")

    def __init__(self, tracer: StageTimer, name: str, site: str | None = None):
        self.tracer, self.name, self.site = tracer, name, site
        self.child_ns = 0
        self._annotation = None

    def __enter__(self) -> _Span:
        parent = _SPAN.get()
        self.parent = parent if parent is not None and parent.tracer is self.tracer else None
        self.call = self.tracer._open_call() if self.parent is None else self.parent.call
        self._token = _SPAN.set(self)
        if _profiling():
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        self.start = _clock()
        return self

    def __exit__(self, *exc) -> None:
        self.end = _clock()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        _SPAN.reset(self._token)
        self.tracer._close(self)


class StageTimer:
    """The program's tracer (see the module docstring).  It also times the
    five stages of each seed-and-verify chunk (``STAGES``, the spans
    ``sv.<stage>``): on a CUDA device by events on the current stream (no
    synchronisation until ``totals``), so a stage's time is device-stream
    time between its boundaries, idle gaps included; on the CPU by the host
    clock."""

    def __init__(self, device: torch.device | str):
        self._cuda = torch.device(device).type == "cuda"
        self._events: list[tuple[str, torch.cuda.Event, torch.cuda.Event]] = []
        self._ms = dict.fromkeys(STAGES, 0.0)
        self._spans: dict[str, list[int]] = {}  # name -> [count, total ns, self ns]
        self._sites: dict[str, list[int]] = {}  # sync site -> [count, total ns]
        self._counters: dict[str, int] = {}
        self._calls = 0
        self._call_self: dict[str, int] = {}  # the open call's self ns by span name
        self._last_call: dict | None = None

    def _open_call(self) -> int:
        self._calls += 1
        self._call_self = {}
        return self._calls

    def _close(self, span: _Span) -> None:
        dur = span.end - span.start
        own = dur - span.child_ns
        stat = self._spans.setdefault(span.name, [0, 0, 0])
        stat[0] += 1
        stat[1] += dur
        stat[2] += own
        self._call_self[span.name] = self._call_self.get(span.name, 0) + own
        if span.site is not None:
            site = self._sites.setdefault(span.site, [0, 0])
            site[0] += 1
            site[1] += dur
        if span.parent is not None:
            span.parent.child_ns += dur
        else:
            self._last_call = dict(id=span.call, name=span.name, ms=dur / 1e6,
                                   self_ms={k: v / 1e6 for k, v in self._call_self.items()})

    @contextlib.contextmanager
    def stage(self, name: str):
        """The span ``sv.<name>`` of one of ``STAGES``, its stage timed as
        the class docstring says."""
        with _Span(self, "sv." + name) as span:
            if self._cuda:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                yield
                end.record()
                self._events.append((name, start, end))
            else:
                yield
        if not self._cuda:
            self._ms[name] += (span.end - span.start) / 1e6

    def totals(self) -> dict[str, float]:
        """Milliseconds of each of ``STAGES``, summed over chunks."""
        if self._events:
            torch.cuda.synchronize()
            for name, start, end in self._events:
                self._ms[name] += start.elapsed_time(end)
            self._events.clear()
        return dict(self._ms)

    def report(self) -> dict:
        """``calls`` (root spans closed); ``spans``: name -> ``count``,
        ``total_ms``, ``self_ms``; ``sites``: sync site -> ``count``,
        ``total_ms``; ``counters``: name -> total; ``last_call``: the last
        root span's ``id``, ``name``, ``ms`` and each name's ``self_ms`` in
        it; ``stages_ms``: ``totals()``."""
        return dict(
            calls=self._calls,
            spans={name: dict(count=c, total_ms=t / 1e6, self_ms=s / 1e6) for name, (c, t, s) in self._spans.items()},
            sites={site: dict(count=c, total_ms=t / 1e6) for site, (c, t) in self._sites.items()},
            counters=dict(self._counters),
            last_call=self._last_call,
            stages_ms=self.totals(),
        )


@contextlib.contextmanager
def tracing(tracer: StageTimer | None):
    """Make ``tracer`` the current tracer inside the block, and the one
    ``last()`` returns; None leaves the current one as it is."""
    global _last
    if tracer is None:
        yield
        return
    _last = tracer
    token = _TRACER.set(tracer)
    try:
        yield
    finally:
        _TRACER.reset(token)


def last() -> StageTimer | None:
    """The tracer most recently passed to a search, or None."""
    return _last


def span(name: str, site: str | None = None):
    """A span ``name`` (with a ``site`` where it is a sync) of the current
    tracer, a profiler annotation, both or neither."""
    tracer = _TRACER.get()
    if tracer is None:
        return torch.profiler.record_function(name) if _profiling() else _NULL
    return _Span(tracer, name, site)


def spanned(name: str):
    """Decorator: each call of the function is a span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def stage(name: str):
    """The current tracer's seed-and-verify stage ``name``
    (``StageTimer.stage``)."""
    tracer = _TRACER.get()
    if tracer is None:
        return torch.profiler.record_function("sv." + name) if _profiling() else _NULL
    return tracer.stage(name)


def sync(site: str):
    """The span ``sync`` around one operation at ``site`` that blocks the
    host on the card."""
    return span("sync", site)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the current tracer's counter ``name``."""
    tracer = _TRACER.get()
    if tracer is not None:
        tracer._counters[name] = tracer._counters.get(name, 0) + n


def to_host(t: torch.Tensor, site: str) -> torch.Tensor:
    """``t`` on the host, copied inside a sync span."""
    with sync(site):
        return t.cpu()


def to_device(t: torch.Tensor, device: torch.device, site: str) -> torch.Tensor:
    """Host tensor ``t`` on ``device``, copied inside a sync span."""
    with sync(site):
        return t.to(device)
