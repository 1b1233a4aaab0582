"""kernel_device_ms's choice between the profiler's trace and CUDA events,
with the trace and the event timer stubbed (the timing itself needs the
card)."""

from types import SimpleNamespace

import pytest
import torch

from sahara_tpu_torch import timing

from tests import torch_support  # noqa: F401  (PyTorch on one thread)


def _event(key: str, count: int, ms: float):
    return SimpleNamespace(key=key, count=count, self_device_time_total=ms * 1e3)


@pytest.fixture
def stubbed(monkeypatch):
    """Traces served from a list (the last one repeats); every trace and
    event timing recorded."""
    state = SimpleNamespace(traces=[], taken=0, event_calls=[])

    def device_events(run):
        state.taken += 1
        return state.traces[min(state.taken, len(state.traces)) - 1]

    def event_device_ms(fn, reps, before=None):
        state.event_calls.append((reps, before))
        return 0.5

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(timing, "device_events", device_events)
    monkeypatch.setattr(timing, "event_device_ms", event_device_ms)
    monkeypatch.setattr(timing, "EVENT_TIMED", [])
    return state


@pytest.mark.parametrize("case", ["traced", "dropped_once", "no_activity", "other_kernels", "too_many"])
def test_kernel_device_ms_source(stubbed, case):
    """A trace with the kernel gives sum / launches seen; an empty trace is
    taken again up to three times; three traces with no device activity
    fall back to CUDA events and record the kernel in EVENT_TIMED; a trace
    with other kernels only, or with more launches than calls, raises."""
    mine = _event("void rank_all_kernel<6>(int4 const*, int const*, long, int*)", 19, 1.9)
    stubbed.traces = {
        "traced": [[mine, _event("fill_kernel", 20, 7.0)]],
        "dropped_once": [[], [mine]],
        "no_activity": [[]],
        "other_kernels": [[_event("fill_kernel", 20, 7.0)]],
        "too_many": [[_event("rank_all_kernel<6>", 21, 2.1)]],
    }[case]
    calls = []
    flush = object()
    run = lambda: timing.kernel_device_ms(lambda: calls.append(1), "rank_all_kernel", 20, before=flush)  # noqa: E731
    if case in ("other_kernels", "too_many"):
        with pytest.raises(AssertionError, match="launches of rank_all_kernel"):
            run()
        assert timing.EVENT_TIMED == [] and stubbed.event_calls == []
        return
    ms = run()
    assert calls == [1]  # the warm call; the stubbed traces run nothing
    if case == "no_activity":
        assert (ms, stubbed.taken, timing.EVENT_TIMED, stubbed.event_calls) == (0.5, 3, ["rank_all_kernel"],
                                                                                [(20, flush)])
    else:
        assert ms == pytest.approx(0.1)
        assert stubbed.taken == (2 if case == "dropped_once" else 1)
        assert timing.EVENT_TIMED == [] and stubbed.event_calls == []
