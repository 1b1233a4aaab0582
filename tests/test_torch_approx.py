"""The frontier engine (``engine="approx"``) in the port against
sahara_tpu's, row for row: schemes, error counts, both metrics, best hits,
max_hits, a mirrored index, the retry ladder (the port retries only the
overflowing queries, pooled across chunks), overflow past the retries, and
the plain step (K8's plain version) against one JAX ``scheme_search`` call,
lane for lane, its live slots a prefix of the length it says."""

import functools

import numpy as np
import pytest
import torch

from sahara_tpu.alphabet import D_DNA5
from sahara_tpu.engine import approx as jax_approx
from sahara_tpu.engine import driver as jax_driver
from sahara_tpu.engine.device import DeviceIndex as JaxDeviceIndex
from sahara_tpu.engine.tape import compile_tape as jax_compile_tape
from sahara_tpu.index.build import build_bifmindex as jax_build_bifmindex
from sahara_tpu.schemes import expand as jax_expand
from sahara_tpu.schemes import get_generator as jax_get_generator
from sahara_tpu_torch.engine import approx, driver
from sahara_tpu_torch.engine.device import DeviceIndex
from sahara_tpu_torch.engine.driver import load_scheme, search_queries
from sahara_tpu_torch.engine.tape import compile_tape
from sahara_tpu_torch.index.build import build_bifmindex
from sahara_tpu_torch.kernels.frontier import SZ, FrontierContext, frontier_step_plain, pack_tape

from tests import torch_support  # noqa: F401  (PyTorch on one thread)

M = 24


@pytest.fixture(scope="module")
def corpus():
    """Two sequences sharing a 50-char segment, the JAX and port indexes,
    and 8 reads of M chars with up to 2 substitutions or indels, each with
    its reverse complement."""
    rng = np.random.default_rng(23)
    seqs = [rng.integers(1, 5, n).astype(np.uint8) for n in (1200, 500)]
    seqs[1][100:150] = seqs[0][300:350]
    queries = []
    for i in range(8):
        s = seqs[i % 2]
        p = int(rng.integers(0, len(s) - M - 2))
        q = s[p : p + M + 2].copy()
        if i % 3 == 1:
            q[rng.integers(0, M)] = rng.integers(1, 5)
        elif i % 3 == 2:
            q = np.delete(q, int(rng.integers(0, M)))
        q = q[:M]
        queries += [q, D_DNA5.reverse_complement_rank(q).astype(np.uint8)]
    queries[0] = seqs[0][310 : 310 + M].copy()  # in the shared segment: hits in both sequences
    jdev = JaxDeviceIndex.from_host(jax_build_bifmindex(seqs, 6, "d_dna5"))
    pdev = DeviceIndex.from_host(build_bifmindex(seqs, 6, "d_dna5"), device="cpu")
    return seqs, queries, jdev, pdev


@pytest.fixture(scope="module")
def port_rows(corpus):
    """The port's rows on the corpus's queries by search options, each
    search made once a module."""
    _, queries, _, pdev = corpus

    @functools.cache
    def rows(**kw):
        return search_queries(pdev, queries, engine="approx", device="cpu", **kw).rows()

    return rows


def _both(corpus, port_rows, **kw):
    _, queries, jdev, _ = corpus
    want = jax_driver.search_queries(jdev, queries, engine="approx", **kw).rows()
    return port_rows(**kw), want


@pytest.mark.parametrize("gen,k,edit", [
    ("optimum", 1, True), ("optimum", 2, True), ("optimum", 3, True), ("h2-k2", 2, True), ("01*0", 2, True),
    ("optimum", 1, False), ("pigeon_opt", 2, False), ("kianfar", 3, False),
])
def test_approx_matches_jax(corpus, port_rows, gen, k, edit):
    got, want = _both(corpus, port_rows, k=k, edit=edit, generator_name=gen)
    assert got == want and len(want) >= 6


@pytest.mark.parametrize("kw", [{"mode": "besthits"}, {"max_hits": 2}], ids=["besthits", "max_hits"])
def test_approx_modes_match_jax(corpus, port_rows, kw):
    got, want = _both(corpus, port_rows, k=2, generator_name="optimum", **kw)
    assert got == want and len(want) >= 8
    if "max_hits" in kw:
        assert np.bincount([r[0] for r in want]).max() == 2


def test_approx_on_a_mirrored_index(corpus):
    """A mirrored index ranks right extensions on the forward table."""
    seqs, queries, _, _ = corpus
    both = seqs + [s[::-1].copy() for s in seqs]
    jdev = JaxDeviceIndex.from_host(jax_build_bifmindex(both, 6, "d_dna5", mirrored=True))
    pdev = DeviceIndex.from_host(build_bifmindex(both, 6, "d_dna5", mirrored=True), device="cpu")
    assert pdev.mirrored and pdev.rev_word_off == 0
    kw = dict(k=1, generator_name="optimum", engine="approx")
    want = jax_driver.search_queries(jdev, queries, **kw).rows()
    assert search_queries(pdev, queries, device="cpu", **kw).rows() == want and len(want) >= 8


def test_retries_give_the_uncapped_rows(corpus, port_rows):
    """Caps of 2 frontier slots and 1 hit overflow at first: the chunks
    retry with doubled caps (each on its own, so their hit buffers end at
    different widths) and give the rows of the default caps (those of the
    optimum-2-True case of ``test_approx_matches_jax``)."""
    _, queries, jdev, pdev = corpus
    kw = dict(k=2, generator_name="optimum", engine="approx")
    uncapped = port_rows(k=2, edit=True, generator_name="optimum")
    want = jax_driver.search_queries(jdev, queries, s_cap=2, h_cap=1, chunk=8, **kw).rows()
    got = search_queries(pdev, queries, device="cpu", s_cap=2, h_cap=1, chunk=8, **kw).rows()
    assert got == want == uncapped


def _tapes(pdev, edit=True):
    """The port's and the JAX package's tape of ``optimum`` at k=2."""
    tape = compile_tape(load_scheme("optimum", 0, 2, M, edit=edit, sigma=6, n_text=pdev.n))
    return tape, jax_compile_tape(jax_expand(jax_get_generator("optimum").generator(0, 2, 0, 0), M))


def _assert_same_hits(got, want):
    """Two ``SearchHits`` alike: hits within the counts, counts, both flag
    arrays and the hit buffers' width."""
    assert got.lb.shape == want.lb.shape
    assert np.array_equal(got.count.numpy(), want.count)
    assert np.array_equal(got.frontier_overflow.numpy(), want.frontier_overflow)
    assert np.array_equal(got.hit_overflow.numpy(), want.hit_overflow)
    valid = np.arange(want.lb.shape[2]) < want.count[:, :, None]
    for name in ("lb", "sz", "err"):
        assert np.array_equal(np.where(valid, getattr(got, name).numpy(), 0), np.where(valid, getattr(want, name), 0))


def test_overflow_after_the_retries_raises(corpus, monkeypatch):
    """A lane still over its caps after the last attempt: the hits, counts
    and flags equal the reference's, and the driver raises as the
    reference does."""
    _, queries, jdev, pdev = corpus
    qarr = np.stack(queries)
    tape, jtape = _tapes(pdev)
    got = approx.run_scheme_search_chunked(pdev, qarr, tape, edit=True, s_cap=1, h_cap=1, max_retries=2)
    want = jax_approx.run_scheme_search_chunked(jdev, qarr.astype(np.int32), jtape, edit=True, s_cap=1, h_cap=1,
                                                max_retries=2)
    assert got.any_overflow and want.any_overflow
    _assert_same_hits(got, want)
    monkeypatch.setattr(driver, "run_scheme_search_chunked",
                        functools.partial(approx.run_scheme_search_chunked, max_retries=1))
    monkeypatch.setattr(jax_driver, "run_scheme_search_chunked",
                        functools.partial(jax_approx.run_scheme_search_chunked, max_retries=1))
    for search, index, extra in ((search_queries, pdev, {"device": "cpu"}), (jax_driver.search_queries, jdev, {})):
        with pytest.raises(RuntimeError, match="overflowed its frontier/hit buffers after retries"):
            search(index, queries, k=2, generator_name="optimum", engine="approx", s_cap=1, h_cap=1, **extra)


@pytest.mark.parametrize("caps,max_retries", [((2, 1), 8), ((1, 1), 2)], ids=["ladder", "exhausted"])
def test_pooled_retries_match_jax(corpus, monkeypatch, caps, max_retries):
    """Two chunks of 8 queries on the reference's cap ladder, each chunk's
    retries searching only its overflowing queries, in one search with the
    other chunk's (each query at its own chunk's caps): the whole
    ``SearchHits`` equals the JAX package's, whose chunks rerun whole.  On
    the ladder the chunks end at different caps, so some search holds
    queries at two caps; exhausted, lanes still overflow after two
    attempts."""
    _, queries, jdev, pdev = corpus
    qarr = np.stack(queries)
    tape, jtape = _tapes(pdev)
    searched = []
    search = approx.scheme_search

    def recorded(index, q, *args, **kw):
        chunks = {int(np.flatnonzero((qarr == row).all(axis=1))[0]) // 8 for row in q.numpy()}
        searched.append((q.shape[0], kw["s_cap"], kw["h_cap"], chunks, kw["caps"] is not None))
        return search(index, q, *args, **kw)

    monkeypatch.setattr(approx, "scheme_search", recorded)
    kw = dict(edit=True, s_cap=caps[0], h_cap=caps[1], max_retries=max_retries)
    got = approx.run_scheme_search_chunked(pdev, qarr, tape, chunk=8, **kw)
    want = jax_approx.run_scheme_search_chunked(jdev, qarr.astype(np.int32), jtape, chunk=8, **kw)
    _assert_same_hits(got, want)
    assert searched[:2] == [(8, *caps, {0}, False), (8, *caps, {1}, False)] and all(x[0] <= 8 for x in searched)
    retried = [x[0] for x in searched[2:]]
    assert retried and sum(retried) < 16 * (max_retries - 1)  # not every query of every attempt
    assert any(x[3] == {0, 1} for x in searched[2:])  # both chunks' retries in one search
    if max_retries == 2:
        assert want.any_overflow
    else:
        widths = {jax_approx.run_scheme_search(jdev, qarr[i : i + 8].astype(np.int32), jtape, **kw).lb.shape[2]
                  for i in (0, 8)}
        assert len(widths) == 2 and not want.any_overflow and any(x[4] for x in searched)


@pytest.mark.parametrize("edit", [True, False])
def test_plain_step_matches_jax_scheme_search(corpus, edit):
    """Every step of one search through the plain step against one JAX
    ``scheme_search`` call with the same caps: per lane the same hit
    count, flags and hits, in the same order."""
    _, queries, jdev, pdev = corpus
    qarr = np.stack(queries).astype(np.int32)
    tape = compile_tape(load_scheme("h2-k2", 0, 2, M, edit=edit, sigma=6, n_text=pdev.n))
    active = np.ones(len(qarr), dtype=bool)
    active[3] = False
    s_cap, h_cap = (4, 2) if edit else (1, 1)  # some lanes overflow: their cut frontiers agree too
    h_lb, h_sz, h_err, cnt, fovf, hovf = (np.asarray(x) for x in jax_approx.scheme_search(
        jdev, qarr, tape.side, tape.qpos, tape.lo, tape.hi, active, edit=edit, s_cap=s_cap, h_cap=h_cap, m=M,
        ns=tape.num_searches, k=tape.max_errors))
    hits, got_cnt, flags = approx.scheme_search(
        pdev, torch.from_numpy(qarr), torch.from_numpy(pack_tape(tape.side, tape.qpos, tape.lo, tape.hi)),
        torch.from_numpy(active), edit=edit, s_cap=s_cap, h_cap=h_cap, k=tape.max_errors)
    assert np.array_equal(got_cnt.numpy(), cnt)
    assert np.array_equal(flags.numpy().astype(bool), np.stack([fovf, hovf]))
    valid = np.arange(h_cap)[None, :] < cnt[:, None]
    for got, want in zip(hits.numpy(), (h_lb, h_sz, h_err)):
        assert np.array_equal(np.where(valid, got, 0), np.where(valid, want, 0))
    assert cnt.sum() >= 6 and (hovf.any() or fovf.any())
    assert not cnt.reshape(len(qarr), -1)[3].any()


def test_plain_step_live_slots_are_a_prefix(corpus, monkeypatch):
    """At every step of a search with some overflowing lanes, the plain
    step's next frontier holds its live slots (sz > 0) in the prefix
    0 .. live - 1 of each lane, live = min(children, s_cap), and nothing
    past it; and the step reads nothing past ``live``: junk in the dead
    slots of its input changes none of its outputs."""
    _, queries, _, pdev = corpus
    tape, _ = _tapes(pdev)
    step, seen = approx.frontier_step, []
    junk = torch.Generator().manual_seed(5)

    def check(ctx, state, live, out, out_live, hits, hit_cnt, flags, **kw):
        dead = torch.arange(ctx.s_cap) >= live[:, None]
        noisy = torch.where(dead, torch.randint(-9, 99, state.shape, generator=junk, dtype=torch.int32), state)
        again = [torch.empty_like(out), torch.empty_like(out_live), hits.clone(), hit_cnt.clone(), flags.clone()]
        frontier_step_plain(ctx, noisy, live, *again)
        step(ctx, state, live, out, out_live, hits, hit_cnt, flags, **kw)
        assert all(torch.equal(a, b) for a, b in zip((out, out_live, hits, hit_cnt, flags), again))
        slots = torch.arange(ctx.s_cap)
        assert torch.equal(out[SZ] > 0, slots < out_live[:, None])
        assert not out[:, slots >= out_live[:, None]].any()
        seen.append((int(out_live.max()), int(flags[0].sum())))

    monkeypatch.setattr(approx, "frontier_step", check)
    qarr = torch.from_numpy(np.stack(queries).astype(np.int32))
    words = torch.from_numpy(pack_tape(tape.side, tape.qpos, tape.lo, tape.hi))
    approx.scheme_search(pdev, qarr, words, torch.ones(len(qarr), dtype=torch.bool), edit=True, s_cap=4, h_cap=2,
                         k=2)
    assert len(seen) == M + 3 and max(n for n, _ in seen) == 4 and seen[-1][1] > 0


@pytest.mark.parametrize("s_lim,h_lim", [(5, 2), (4, 3), (0, 1)], ids=["s_cap", "h_cap", "zero"])
def test_context_refuses_caps_past_the_widths(corpus, s_lim, h_lim):
    """A lane's own caps must lie between 1 and the buffers' widths (4, 2):
    the kernel writes a lane's children and hits below them."""
    _, queries, _, pdev = corpus
    tape, _ = _tapes(pdev)
    qarr = torch.from_numpy(np.stack(queries).astype(np.int32))
    words = torch.from_numpy(pack_tape(tape.side, tape.qpos, tape.lo, tape.hi))
    caps = torch.tensor([[4], [2]], dtype=torch.int32).repeat(1, len(qarr) * tape.num_searches)
    FrontierContext(pdev.occ, pdev.c_arr, qarr, words, pdev.sigma, True, tape.num_searches, pdev.rev_word_off, 4, 2,
                    caps.clone())
    caps[:, -1] = torch.tensor([s_lim, h_lim])
    with pytest.raises(ValueError, match="caps"):
        FrontierContext(pdev.occ, pdev.c_arr, qarr, words, pdev.sigma, True, tape.num_searches, pdev.rev_word_off,
                        4, 2, caps)


def test_approx_needs_a_bidirectional_index(corpus):
    seqs, queries, _, _ = corpus
    fwd = DeviceIndex.from_host(build_bifmindex(seqs, 6, "d_dna5"), device="cpu", include_rev=False)
    with pytest.raises(ValueError, match="requires a bidirectional index"):
        search_queries(fwd, queries, k=1, engine="approx", device="cpu")
