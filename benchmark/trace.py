"""Device traces: a run of batches under ``torch.profiler``, read back from
its Chrome trace.

``summarize`` gives the traced window's length, the time the device was
busy in it (the union of kernel, copy and set intervals, so overlapping
operations count once), every kernel with its duration, and the device
operations that took most time.  ``idle_by_host`` names what the host was
running during the device's idle gaps, from the Python function events of
a trace taken with ``with_stack=True``.
"""

from __future__ import annotations

import json
import os
import re
import tempfile

import numpy as np

from benchmark import stats

WINDOW = "benchmark.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def profile(run, with_stack: bool = False) -> list[dict]:
    """The complete events of one ``run()`` on the card, its span marked by
    a ``WINDOW`` annotation."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with torch_profile(activities=activities, with_stack=with_stack) as prof:
        with record_function(WINDOW):
            run()
            sync()
    with tempfile.TemporaryDirectory() as tmp:  # under TMPDIR
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            doc = json.load(fh)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def window_of(events: list[dict]) -> tuple[float, float]:
    """The ``WINDOW`` annotation's span on the host, in trace microseconds."""
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == WINDOW and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError("the trace holds no window annotation")
    return spans[0]


def device_ops(events: list[dict], lo: float, hi: float) -> list[dict]:
    return [e for e in events if e.get("cat") in DEVICE_CATS and e["ts"] < hi and e["ts"] + e["dur"] > lo]


def summarize(events: list[dict]) -> dict | None:
    """None where the trace holds no device operation; else ``window_s``,
    ``busy_s``, ``kernels`` ([name, seconds] of every kernel launch) and
    ``top`` ([name, seconds] of the device operations that took most time,
    summed by name)."""
    lo, hi = window_of(events)
    dev = device_ops(events, lo, hi)
    if not dev:
        return None
    intervals = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
    by_name: dict[str, float] = {}
    for e in dev:
        key = device_name(e["name"])
        by_name[key] = by_name.get(key, 0.0) + e["dur"] * 1e-6
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:TOP]
    return dict(
        window_s=(hi - lo) * 1e-6,
        busy_s=stats.busy(intervals, lo, hi) * 1e-6,
        kernels=[[e["name"], e["dur"] * 1e-6] for e in dev if e["cat"] == "kernel"],
        top=[[name, s] for name, s in top],
    )


def host_name(name: str) -> str:
    """A host event's name, short: a Python function's file without its
    directories, a built-in without its object's address."""
    name = re.sub(r" of .* at 0x[0-9a-f]+>$", ">", name)
    head, sep, tail = name.partition("(")
    return os.path.basename(head) + sep + tail if sep and "/" in head else name


def device_name(name: str) -> str:
    """A device operation's name, short: a kernel without its template
    arguments and its parameters; copies and sets as they are."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    while True:  # template arguments, innermost first
        shorter = re.sub(r"<[^<>]*>", "", name)
        if shorter == name:
            return name.split("(")[0][:120]
        name = shorter


def idle_by_host(events: list[dict], max_gaps: int = 1000) -> list[list]:
    """[name, seconds]: the device's idle time in the window, by the host
    function that ran through it, the longest first.  A gap goes to the
    innermost Python function (else PyTorch operation) that covers half of
    it or more, else to the one that covers most of it; only the
    ``max_gaps`` longest gaps are read."""
    lo, hi = window_of(events)
    dev = device_ops(events, lo, hi)
    idle = stats.gaps([(e["ts"], e["ts"] + e["dur"]) for e in dev], lo, hi)
    idle = sorted(idle, key=lambda g: g[1] - g[0], reverse=True)[:max_gaps]
    host = [e for e in events if e.get("cat") == "python_function"]
    if not host:
        host = [e for e in events if e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver")]
    if not host or not idle:
        return []
    start = np.array([e["ts"] for e in host], dtype=np.float64)
    end = start + np.array([e["dur"] for e in host], dtype=np.float64)
    dur = end - start
    totals: dict[str, float] = {}
    for gs, ge in idle:
        over = np.minimum(end, ge) - np.maximum(start, gs)
        if not (over > 0).any():
            name = "(no host event)"
        else:
            half = np.flatnonzero(over >= 0.5 * (ge - gs))
            pick = half[np.argmin(dur[half])] if len(half) else int(np.argmax(over))
            name = host_name(host[pick]["name"])
        totals[name] = totals.get(name, 0.0) + (ge - gs) * 1e-6
    return [[name, s] for name, s in sorted(totals.items(), key=lambda kv: kv[1], reverse=True)[:TOP]]
