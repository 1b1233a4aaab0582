"""Timing on the card: the call time of a function (CUDA events) and the
device time of one kernel per launch (torch.profiler, or CUDA events where
the profiler records nothing).  Used by the rank bench and
``chip_smoke.py``; needs a CUDA card."""

from __future__ import annotations

import torch

# Profiler sessions opened by ``kernel_device_ms``/``kernel_device_total``,
# and the kernels that ``kernel_device_ms`` timed by CUDA events because the
# profiler recorded no device activity at all, in the order timed.
PROFILER_SESSIONS = 0
EVENT_TIMED: list[str] = []

# GPU cycles of ``torch.cuda._sleep`` ahead of each event-timed launch (about
# 2 ms at the H100's 1.98 GHz): the host queues the launch before the start
# event fires, so the span holds no host time.
SLEEP_CYCLES = 4_000_000


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` back-to-back calls (CUDA
    events), after one warm call: the wrapper's call time where it exceeds
    the kernel's."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def dev_ms(e) -> float:
    """Device milliseconds of one profiler event (key average)."""
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e3


def device_events(run) -> list:
    """The device-side key averages of one ``run()`` (torch.profiler),
    without the profiler's own buffer requests."""
    global PROFILER_SESSIONS
    from torch.profiler import ProfilerActivity, profile

    PROFILER_SESSIONS += 1
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and "Activity Buffer" not in e.key]


def kernel_device_total(run, name: str) -> tuple[float, int]:
    """Device milliseconds and launches of kernel ``name`` in one ``run()``
    (torch.profiler)."""
    events = [e for e in device_events(run) if name in e.key]
    return sum(dev_ms(e) for e in events), sum(e.count for e in events)


def event_device_ms(fn, reps: int, before=None) -> float:
    """Mean milliseconds per call of ``fn`` from CUDA events recorded just
    before and after each of ``reps`` calls, after one warm call; each call
    waits behind ``SLEEP_CYCLES`` of ``torch.cuda._sleep`` (and ``before``,
    an L2 flush for a cold time, runs ahead of that).  The span holds every
    launch ``fn`` makes on the stream, not only its kernel's."""
    fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(reps):
        if before is not None:
            before()
        torch.cuda._sleep(SLEEP_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in spans) / reps


def kernel_device_ms(fn, name: str, reps: int, before=None) -> float:
    """Mean device time of kernel ``name`` per launch over ``reps`` calls
    of ``fn``, after one warm call; ``before`` runs ahead of each call (an
    L2 flush for a cold time).  The mean is over the launches the trace
    records: the profiler drops a record now and then (19 of 20, or 49 of
    50, on the H100), so the sum is divided by the count seen.  A trace
    that records none of them is taken again, up to three times.  Where the
    last of those traces holds no device activity at all (the profiler on
    the H100 has stopped recording late in a long process), the time comes from
    ``event_device_ms`` and ``name`` is appended to ``EVENT_TIMED``; a
    trace with other kernels but none of ``name``, or with more than
    ``reps``, raises."""

    def run():
        for _ in range(reps):
            if before is not None:
                before()
            fn()

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        events = device_events(run)
        mine = [e for e in events if name in e.key]
        seen = sum(e.count for e in mine)
        if seen:
            break
    if not events:
        EVENT_TIMED.append(name)
        return event_device_ms(fn, reps, before)
    if not 0 < seen <= reps:
        keys = sorted({e.key[:60] for e in events})[:8]
        raise AssertionError(f"the profiler saw {seen} launches of {name}, not up to {reps}; device events: {keys}")
    return sum(dev_ms(e) for e in mine) / seen
