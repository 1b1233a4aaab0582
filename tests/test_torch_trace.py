"""The program's tracer (``sahara_tpu_torch/trace.py``) on the CPU: spans,
self times and call ids on a hand-built tree; the search's rows with a
tracer and without one; nothing recorded with neither a tracer nor a
profiler; the spans under ``torch.profiler`` as nested annotations; the
seed-and-verify stage totals; the frontier ladder's counters; the work
queue's spans."""

import functools
import json

import numpy as np
import pytest
import torch

from sahara_tpu_torch import trace
from sahara_tpu_torch.engine import seedverify
from sahara_tpu_torch.engine.device import DeviceIndex
from sahara_tpu_torch.engine.driver import search_queries
from sahara_tpu_torch.index.build import build_bifmindex

from tests import torch_support  # noqa: F401  (PyTorch on one thread)

ENGINES = {"sv": dict(engine="auto"), "approx": dict(engine="approx", generator_name="optimum"),
           "workq": dict(engine="workq", generator_name="h2-k2")}


@pytest.fixture(scope="module")
def setup():
    """A bidirectional index on the CPU and 120 reads of 50 chars with up
    to 2 substitutions."""
    rng = np.random.default_rng(91)
    seqs = [rng.integers(1, 5, int(rng.integers(300, 1200))).astype(np.uint8) for _ in range(8)]
    seqs[5][:200] = seqs[2][-200:]  # a repeat
    reads = []
    for _ in range(120):
        s = seqs[int(rng.integers(0, len(seqs)))]
        p = int(rng.integers(0, len(s) - 50))
        q = s[p : p + 50].copy()
        q[rng.integers(0, 50, int(rng.integers(0, 3)))] = rng.integers(1, 5)
        reads.append(q)
    return DeviceIndex.from_host(build_bifmindex(seqs, 6, "d_dna5"), device="cpu"), np.stack(reads)


def search(setup, engine, **kw):
    index, reads = setup
    return search_queries(index, reads, k=2, device="cpu", chunk=32, **ENGINES[engine], **kw)


def refuse(*args, **kwargs):
    raise AssertionError("a span entered record_function")


@pytest.fixture(scope="module")
def untraced(setup):
    """An engine's search with neither a tracer nor a profiler, made once a
    module with ``record_function`` refused and no last tracer: its rows,
    and the last tracer, the current tracer and the current span it left."""

    @functools.cache
    def run(engine):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.profiler, "record_function", refuse)
            mp.setattr(torch.autograd.profiler, "record_function", refuse)
            mp.setattr(trace, "_last", None)
            assert not torch.autograd._profiler_enabled()
            rows = search(setup, engine).rows()
            return rows, trace.last(), trace._TRACER.get(), trace._SPAN.get()

    return run


def test_spans_nest_with_call_ids_and_self_times(monkeypatch):
    """A tree on a clock that moves only where the test says: search
    [0, 100] holds a [10, 40] (which holds sync [20, 30]) and b [50, 70];
    a second root is the next call."""
    now = [0]
    monkeypatch.setattr(trace, "_clock", lambda: now[0])
    timer = trace.StageTimer("cpu")

    def at(t):
        now[0] = t

    with trace.tracing(timer):
        with trace.span("search") as root:
            at(10)
            with trace.span("a") as a:
                at(20)
                with trace.sync("here") as s:
                    at(30)
                at(40)
            at(50)
            with trace.span("b") as b:
                at(70)
            at(100)
        with trace.span("search") as second:
            at(103)
            trace.count("n", 2)
            trace.count("n")
    assert (a.parent, s.parent, b.parent, root.parent, second.parent) == (root, a, root, None, None)
    assert (root.call, a.call, s.call, b.call, second.call) == (1, 1, 1, 1, 2)
    rep = timer.report()
    spans = rep["spans"]
    assert spans["search"] == dict(count=2, total_ms=103e-6, self_ms=53e-6)
    assert spans["a"] == dict(count=1, total_ms=30e-6, self_ms=20e-6)
    assert spans["sync"] == dict(count=1, total_ms=10e-6, self_ms=10e-6)
    assert spans["b"] == dict(count=1, total_ms=20e-6, self_ms=20e-6)
    assert rep["sites"] == {"here": dict(count=1, total_ms=10e-6)}
    assert rep["counters"] == {"n": 3} and rep["calls"] == 2
    assert rep["last_call"] == dict(id=2, name="search", ms=3e-6, self_ms={"search": 3e-6})
    assert sum(v["self_ms"] for v in spans.values()) == pytest.approx(spans["search"]["total_ms"])
    assert trace.last() is timer and trace._TRACER.get() is None and trace._SPAN.get() is None


def test_tracing_none_keeps_the_current_tracer():
    outer = trace.StageTimer("cpu")
    with trace.tracing(outer), trace.tracing(None):
        assert trace._TRACER.get() is outer
    assert trace._TRACER.get() is None


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_rows_alike_with_and_without_a_tracer(setup, untraced, engine):
    """The same rows either way; the report holds the call's spans, every
    self time summing to the root's duration."""
    plain = untraced(engine)[0]
    timer = trace.StageTimer("cpu")
    traced = search(setup, engine, timer=timer)
    assert traced.rows() == plain and len(plain) >= 120
    assert trace.last() is timer
    rep = timer.report()
    spans = rep["spans"]
    assert rep["calls"] == 1 and spans["search"]["count"] == 1 and spans["driver.merge"]["count"] >= 1
    assert spans["sync"]["count"] == sum(site["count"] for site in rep["sites"].values()) > 0
    total = sum(v["self_ms"] for v in spans.values())
    assert total == pytest.approx(spans["search"]["total_ms"], rel=1e-9)
    assert rep["last_call"]["ms"] == pytest.approx(spans["search"]["total_ms"])
    if engine == "sv":
        assert {"sv.bad_mask", "sv.seed", "sv.expand", "sv.locate", "sv.verify", "sv.emit"} <= set(spans)
        # the sites and counts of the driver that scanned the reads on the host: the mask reads nothing back
        assert {site: v["count"] for site, v in rep["sites"].items()} == {
            "driver.queries": 1, "driver.seq_starts": 1, "sv.counts": 4, "sv.part_offsets": 4,
            "sv.emit_nonzero": 4, "sv.emit_rows": 4}
        assert rep["counters"]["sv.bad_queries"] == 0
    elif engine == "approx":
        counters = rep["counters"]
        assert spans["approx.ladder"]["count"] == 1 and spans["approx.search"]["count"] >= 4  # chunks of 32
        assert counters["approx.queries_searched"] == 120 + counters["approx.queries_retried"]
        assert {"approx.flags", "driver.hit_lanes", "driver.hit_mask", "driver.located"} <= set(rep["sites"])
    else:
        counters = rep["counters"]
        assert spans["driver.workq"]["count"] == 1 and spans["workq.search"]["count"] == 4  # chunks of 32
        assert spans["driver.locate_flat"]["count"] == 4 and spans["workq.dedup"]["count"] > 0
        assert counters["workq.queue_rows"] > 0 and counters["workq.hit_intervals"] > 0
        assert "workq.overflow_splits" not in counters
        assert {"workq.lanes", "workq.hits", "driver.flat_hits", "driver.located"} <= set(rep["sites"])


@pytest.mark.parametrize("step", [0, 5, 1])
def test_sv_counts_the_queries_the_mask_flags(setup, step):
    """Counter ``sv.bad_queries``: exactly the reads with an N planted at
    the end of the first seed part, where the j-mer table reads it (every
    ``step``-th read; 0: none).  The span ``sv.bad_mask`` holds no other
    span, so no ``sync``: the mask is never read back."""
    index, reads = setup
    reads = reads.copy()
    if step:
        reads[::step, 16] = 5  # parts (0, 17), (17, 17), (34, 16) at m = 50, k = 2
    timer = trace.StageTimer("cpu")
    search_queries(index, reads, k=2, device="cpu", chunk=32, timer=timer)
    rep = timer.report()
    bad_mask = rep["spans"]["sv.bad_mask"]
    assert rep["counters"]["sv.bad_queries"] == (len(reads[::step]) if step else 0)
    assert bad_mask["count"] == 1 and bad_mask["self_ms"] == bad_mask["total_ms"]


def test_the_ladder_counts_its_retries(setup, untraced):
    """Caps of 2 slots and 1 hit overflow: the retried queries are counted
    apart, inside every query the ladder searched."""
    timer = trace.StageTimer("cpu")
    want = untraced("approx")[0]
    assert search(setup, "approx", timer=timer, s_cap=2, h_cap=1).rows() == want
    counters = timer.report()["counters"]
    assert 0 < counters["approx.queries_retried"] and counters["approx.queries_searched"] == (
        120 + counters["approx.queries_retried"])


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_no_tracer_and_no_profiler_record_nothing(untraced, engine, monkeypatch):
    """With neither, no span enters ``record_function`` and nothing is
    kept: a span is the shared null context.  The search is the module's
    untraced one (``untraced``), which refuses ``record_function``."""
    rows, last, tracer, span = untraced(engine)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert rows
    assert trace.span("search") is trace._NULL and trace.stage("seed") is trace._NULL
    assert last is None and tracer is None and span is None
    assert trace._TRACER.get() is None and trace._SPAN.get() is None


def annotations(tmp_path, run):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def inside(inner, outer):
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("with_tracer", [False, True])
def test_spans_are_nested_annotations_under_the_profiler(setup, tmp_path, with_tracer):
    """Under a CPU ``torch.profiler`` trace, with a tracer or without one,
    each span is a ``user_annotation`` event inside its parent's."""
    timer = trace.StageTimer("cpu") if with_tracer else None
    ev = annotations(tmp_path, lambda: search(setup, "sv", timer=timer))
    by = {}
    for e in ev:
        by.setdefault(e["name"], []).append(e)
    root = by["search"][0]
    assert len(by["search"]) == 1
    for name in ("driver.merge", "sv.bad_mask", "sv.seed", "sv.emit", "sync"):
        assert by[name] and all(inside(e, root) for e in by[name]), name
    emits = by["sv.emit"]
    assert any(inside(s, e) for s in by["sync"] for e in emits)  # the emit's reads nest in the stage
    if with_tracer:
        assert timer.report()["spans"]["sync"]["count"] == len(by["sync"])


def test_totals_keep_the_five_sv_stages(setup):
    """``totals()`` returns exactly the five stages; a frontier search
    leaves them at 0; the stage timer is importable from its old home."""
    assert seedverify.StageTimer is trace.StageTimer
    timer = trace.StageTimer("cpu")
    search(setup, "approx", timer=timer)
    assert timer.totals() == dict.fromkeys(trace.STAGES, 0.0)
    search(setup, "sv", timer=timer)
    totals = timer.totals()
    assert tuple(totals) == trace.STAGES == ("seed", "expand", "locate", "verify", "emit")
    assert all(v > 0 for v in totals.values())
    spans = timer.report()["spans"]
    assert sum(totals.values()) == pytest.approx(sum(spans["sv." + s]["total_ms"] for s in trace.STAGES))
