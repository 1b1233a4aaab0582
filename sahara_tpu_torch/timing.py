"""Timing on the card: the call time of a function (CUDA events) and the
device time of one kernel per launch (torch.profiler).  Used by the rank
bench and ``chip_smoke.py``; needs a CUDA card."""

from __future__ import annotations

import torch


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


def kernel_device_total(run, name: str) -> tuple[float, int]:
    """Device milliseconds and launches of kernel ``name`` in one ``run()``
    (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key]
    return sum(dev_ms(e) for e in events), sum(e.count for e in events)


def kernel_device_ms(fn, name: str, reps: int, before=None) -> float:
    """Mean device time of kernel ``name`` per launch over ``reps`` calls
    of ``fn``, after one warm call; ``before`` runs ahead of each call (an
    L2 flush for a cold time).  The mean is over the launches the trace
    records: the profiler drops a record now and then (19 of 20, or 49 of
    50, on the H100), so the sum is divided by the count seen.  A session
    that records none of them (seen once on the H100, after some thirty
    sessions) is run again, up to three times; then a trace with none, or
    with more than ``reps``, raises."""

    def run():
        for _ in range(reps):
            if before is not None:
                before()
            fn()

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        total, seen = kernel_device_total(run, name)
        if seen:
            break
    if not 0 < seen <= reps:
        raise AssertionError(f"the profiler saw {seen} launches of {name}, not up to {reps}")
    return total / seen
