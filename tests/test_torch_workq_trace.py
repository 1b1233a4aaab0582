"""The work-queue engine (``engine="workq"``, sahara's default scheme
h2-k2 at k=2) on the CPU against the benchmark's plain reference
(``benchmark/reference.py``), over several chunks and through the
``QueueOverflow`` halving; and its spans and counters under the program's
tracer: ``workq.search`` a (chunk, tape group) search, ``workq.dedup`` a
dedup, ``driver.workq`` a call, the counters equal to the rows, hit
intervals and dedup kills the engine handled, with the dedup on and off."""

import gc
import weakref

import numpy as np
import pytest
import torch

from benchmark import genome, reads, reference
from sahara_tpu_torch import trace
from sahara_tpu_torch.engine import workq
from sahara_tpu_torch.engine.device import DeviceIndex
from sahara_tpu_torch.engine import driver
from sahara_tpu_torch.engine.driver import load_scheme, search_queries
from sahara_tpu_torch.engine.tape import compile_tape
from sahara_tpu_torch.index.build import build_bifmindex
from sahara_tpu_torch.kernels import LAUNCHES

from tests import torch_support  # noqa: F401  (PyTorch on one thread)

K, M, CHUNK = 2, 100, 16
# A step's widest queue is 130-odd rows at a chunk of 16 here and under 64
# for one query: 96 makes the driver halve some chunks, each half fitting.
SMALL_CAP = 96
# every sync site on the work-queue path (K5's ``workq.step_counts`` only on the card)
SITES = {"driver.queries", "workq.tape", "driver.active", "workq.lanes", "workq.step_counts", "workq.hits",
         "driver.flat_hits", "driver.located"}


@pytest.fixture(scope="module")
def setup():
    """A 30,000-char text of the benchmark's repeat model, its index on the
    CPU, 40 reads of 100 chars with 2 planted edits on both strands (80
    queries, 5 chunks), and the reference's rows."""
    text = genome.make_reference(np.random.default_rng(1234), 30_000)
    mix = dict(read_length=M, errors=K, mapped_fraction=1.0, batch_reads=40, pool_batches=1)
    batch = reads.make_pool(text, mix, 2**31 + 17)[0]
    index = DeviceIndex.from_host(build_bifmindex([text], 6, "d_dna5", rate=16), device="cpu")
    want = reference.hits(reference.Text([text], reference.g_for(M, K), "cpu"), batch, K)
    return index, batch, want


def search(setup, timer=None):
    index, batch, _ = setup
    return search_queries(index, batch, k=K, edit=True, mode="all", engine="workq", generator_name="h2-k2",
                          chunk=CHUNK, device="cpu", timer=timer)


class Watch:
    """Wraps ``workq.workq_search``, ``workq.expand_step`` and
    ``workq.workq_dedup`` to record what each search did: its phase-0
    length, its steps, the rows entering each step, the live rows its dedups
    zeroed, its hit intervals, and whether it overflowed."""

    def __init__(self, mp):
        self.searches = []
        search_fn, step_fn, dedup_fn = workq.workq_search, workq.expand_step, workq.workq_dedup

        def watched_search(*args, ph0, **kw):
            rec = dict(ph0=ph0, dedup_every=kw["dedup_every"], rows=[], kills=0, hits=0, overflowed=False)
            self.searches.append(rec)
            try:
                out = search_fn(*args, ph0=ph0, **kw)
            except workq.QueueOverflow:
                rec["overflowed"] = True
                raise
            rec["hits"] = out.n_hits
            return out

        def watched_step(ctx, state, **kw):
            self.searches[-1]["rows"].append(state[2].shape[0])
            return step_fn(ctx, state, **kw)

        def watched_dedup(ctx, lb, lbr, sz, meta):
            out = dedup_fn(ctx, lb, lbr, sz, meta)
            self.searches[-1]["kills"] += int(((sz > 0) & (out == 0)).sum())
            return out

        mp.setattr(workq, "workq_search", watched_search)
        mp.setattr(workq, "expand_step", watched_step)
        mp.setattr(workq, "workq_dedup", watched_dedup)

    def dedups(self):
        """Dedups the searches made: one before each step g >= ph0 with
        (g - ph0) a multiple of the cadence, none with the dedup off."""
        return sum(1 for s in self.searches if s["dedup_every"] for g in range(len(s["rows"]))
                   if g >= s["ph0"] and (g - s["ph0"]) % s["dedup_every"] == 0)


@pytest.fixture(scope="module", params=["chunks", "overflow", "no_dedup"])
def traced(request, setup):
    """(case, plain rows, traced rows, the tracer's report, the watch) of
    one search without a tracer and one with it; ``overflow`` with
    ``workq.HARD_CAP`` cut to ``SMALL_CAP``, ``no_dedup`` with
    ``workq.DEDUP_EVERY`` at 0."""
    with pytest.MonkeyPatch.context() as mp:
        if request.param == "overflow":
            mp.setattr(workq, "HARD_CAP", SMALL_CAP)
        if request.param == "no_dedup":
            mp.setattr(workq, "DEDUP_EVERY", 0)
        plain = search(setup)
        watch = Watch(mp)
        timer = trace.StageTimer("cpu")
        launches = LAUNCHES["workq_step"]
        got = search(setup, timer)
        assert LAUNCHES["workq_step"] == launches  # the plain step launches nothing
    return request.param, plain, got, timer.report(), watch


def test_rows_match_the_reference(setup, traced):
    """Row for row, errors too, with and without a tracer, over 5 chunks,
    through the halving, and with the dedup off."""
    _, _, want = setup
    _, plain, got, _, _ = traced
    for res in (plain, got):
        np.testing.assert_array_equal(res.query_id, want["query"])
        np.testing.assert_array_equal(res.seq_id, want["seq"])
        np.testing.assert_array_equal(res.pos, want["pos"])
        np.testing.assert_array_equal(res.errors, want["errors"])
    assert got.rows() == plain.rows() and len(want["query"]) >= 40


def test_spans_close_as_the_engine_ran(traced):
    case, _, _, rep, watch = traced
    spans = rep["spans"]
    ok = [s for s in watch.searches if not s["overflowed"]]
    assert spans["search"]["count"] == 1 and spans["driver.workq"]["count"] == 1
    assert spans["workq.search"]["count"] == len(watch.searches)
    assert spans["driver.locate_flat"]["count"] == len(ok)
    if case == "chunks":  # h2-k2 has 3 searches, one tape group: a search a chunk
        assert len(watch.searches) == len(ok) == 80 // CHUNK
    assert spans.get("workq.dedup", {}).get("count", 0) == watch.dedups()
    assert (watch.dedups() > 0) == (case != "no_dedup")
    total = sum(v["self_ms"] for v in spans.values())
    assert total == pytest.approx(spans["search"]["total_ms"], rel=1e-9)
    assert set(rep["sites"]) <= SITES and "workq.step_counts" not in rep["sites"]


def test_counters_count_what_the_engine_did(traced):
    case, _, _, rep, watch = traced
    counters = rep["counters"]
    assert sum(len(s["rows"]) for s in watch.searches) > 0
    assert counters["workq.queue_rows"] == sum(sum(s["rows"]) for s in watch.searches)
    assert counters["workq.hit_intervals"] == sum(s["hits"] for s in watch.searches) > 0
    splits = sum(s["overflowed"] for s in watch.searches)
    assert counters.get("workq.overflow_splits", 0) == splits
    assert (splits > 0) == (case == "overflow")
    # kills are counted at the end of a search, so an overflowing search's are not
    kills = sum(s["kills"] for s in watch.searches if not s["overflowed"])
    assert counters["workq.dedup_kills"] == kills
    assert (kills > 0) == (case != "no_dedup")
    if case == "overflow":
        assert max(r for s in watch.searches for r in s["rows"]) <= SMALL_CAP


@pytest.mark.parametrize("cap", [None, SMALL_CAP], ids=["chunks", "overflow"])
def test_the_queries_go_when_the_search_returns(setup, monkeypatch, cap):
    """``_workq_hits`` keeps no reference to its queries once it returns,
    through the halving too: no reference cycle holds them (on the card, a
    call's upload) until Python's next cycle collection."""
    index, batch, _ = setup
    if cap is not None:
        monkeypatch.setattr(workq, "HARD_CAP", cap)
    tape = compile_tape(load_scheme("h2-k2", 0, K, M, edit=True, sigma=6, n_text=index.n))
    queries = torch.from_numpy(np.ascontiguousarray(batch, dtype=np.uint8))
    gone = weakref.ref(queries)
    gc.disable()
    try:
        found = driver._workq_hits(index, queries, tape, edit=True, active=np.ones(len(batch), dtype=bool),
                                   chunk=CHUNK)
        del queries
        assert gone() is None and sum(hits.n_hits for *_, hits in found) > 0
    finally:
        gc.enable()
