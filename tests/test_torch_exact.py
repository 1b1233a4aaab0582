"""sahara_tpu_torch exact search and locate (K6 and K7 through their plain
versions on the CPU) against sahara_tpu's on the same indexes: sigma 6
(DNA ranks, occ16 rows) with the full suffix array on and off, and the wide
rows of sigma 16, 32, 64 and 128 over synthetic kmer vocabularies, as
tests/test_kmer_sketch.py builds them.  Exact: everything is integer."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sahara_tpu.engine import exact as jax_exact
from sahara_tpu.engine import locate as jax_locate
from sahara_tpu.engine import rank as jax_rank
from sahara_tpu.engine.device import DeviceIndex as JaxDeviceIndex
from sahara_tpu.engine.device import pad_queries as jax_pad_queries
from sahara_tpu.index import build as jax_build
from sahara_tpu_torch.engine import rank
from sahara_tpu_torch.engine.device import DeviceIndex, pad_queries
from sahara_tpu_torch.engine.driver import search_queries
from sahara_tpu_torch.engine.exact import exact_search
from sahara_tpu_torch.engine.locate import lf_walk, locate
from sahara_tpu_torch.index.build import build_fmindex
from sahara_tpu_torch.index.jmer import pick_lut_j
from sahara_tpu_torch.kernels.exact import table_start

from tests import torch_support  # noqa: F401  (PyTorch on one thread)

CASES = [(6, True), (6, False), (16, False), (32, False), (64, False), (128, False)]


def _seqs(sigma: int) -> list[np.ndarray]:
    """Three sequences over symbols 1..sigma-1, the second opening with a
    copy of 120 symbols of the first."""
    rng = np.random.default_rng(sigma)
    seqs = [rng.integers(1, sigma, size=n).astype(np.uint8) for n in (700, 333, 90)]
    seqs[1][:120] = seqs[0][200:320]
    return seqs


def _queries(seqs: list[np.ndarray], sigma: int) -> list[np.ndarray]:
    """Substrings of 1-30 symbols (hits, wide intervals at 1-2 symbols),
    random strings (mostly empty intervals), the repeat, a query of the
    largest symbol and a zero-length query."""
    rng = np.random.default_rng(100 + sigma)
    out = []
    for _ in range(40):
        s = seqs[int(rng.integers(0, len(seqs)))]
        ln = int(rng.integers(1, 31))
        p = int(rng.integers(0, len(s) - ln + 1))
        out.append(s[p : p + ln].copy())
    out += [rng.integers(1, sigma, size=int(rng.integers(1, 26))).astype(np.uint8) for _ in range(20)]
    return out + [seqs[0][200:320].copy(), np.full(3, sigma - 1, dtype=np.uint8), np.zeros(0, dtype=np.uint8)]


def _edge_queries(seqs: list[np.ndarray], j: int) -> list[np.ndarray]:
    """Queries at the edges of the j-mer table start, all ending in a stretch
    of DNA ranks (1..4) of the text: lengths 0, j - 1, j and j + 1; a
    3j-symbol substring with an N (5) or a $ (0) at its last symbol, at its
    j-th from the end (both inside the table's window) and at its (j+1)-th
    (just outside); and absent DNA strings, whose empty intervals must keep
    the reference's lb.  ``_edge_skips`` gives the steps each skips."""
    s = seqs[0]
    dna = ((s >= 1) & (s <= 4)).astype(np.int64)
    runs = np.flatnonzero(np.convolve(dna, np.ones(j + 1, dtype=np.int64), "valid") == j + 1)
    end = int(runs[runs >= 2 * j - 1][0]) + j + 1  # s[end - j - 1 : end] are DNA ranks
    out = [s[end - ln : end].copy() for ln in (0, j - 1, j, j + 1)]
    for sym in (5, 0):
        for at in (1, j, j + 1):
            q = s[end - 3 * j : end].copy()
            q[-at] = sym
            out.append(q)
    rng = np.random.default_rng(j)
    return out + [rng.integers(1, 5, size=3 * j + i).astype(np.uint8) for i in range(4)]


def _edge_skips(j: int) -> list[int]:
    return [0, 0, j, j] + [0, 0, j] * 2 + [j] * 4


@pytest.fixture(scope="module", params=CASES, ids=[f"sigma{s}-{'full_sa' if f else 'sampled'}" for s, f in CASES])
def case(request):
    """(sigma, seqs, the port's index on the CPU, the JAX package's)."""
    sigma, full_sa = request.param
    seqs = _seqs(sigma)
    name = "d_dna5" if sigma == 6 else f"kmer{sigma}"
    port = DeviceIndex.from_host(build_fmindex(seqs, sigma, name), device="cpu", full_sa=full_sa)
    jdev = JaxDeviceIndex.from_host(jax_build.build_fmindex(seqs, sigma, name))
    if not full_sa:
        jdev = dataclasses.replace(jdev, sa_full=None)
    assert (port.sa_full is not None) == full_sa == (jdev.sa_full is not None)
    assert port.row_ints == rank.row_ints(sigma)
    tensors = [getattr(port, f.name) for f in dataclasses.fields(port)]
    assert all(t.is_contiguous() for t in tensors if isinstance(t, torch.Tensor))  # the kernels take no strides
    return sigma, seqs, port, jdev


def _jax_intervals(jdev, queries):
    q, lens = jax_pad_queries([x.astype(np.int32) for x in queries])
    lb, ln = jax_exact.exact_search(jdev, jnp.asarray(q), jnp.asarray(lens))
    return np.asarray(lb), np.asarray(ln)


def test_exact_search_matches_jax(case):
    """At sigma 6 the index holds the j-mer table (its text is DNA ranks),
    so the plain scan starts the queries it covers from the table: the edge
    queries of ``_edge_queries`` first, each taking the table or not as
    ``_edge_skips`` says, then the rest."""
    sigma, seqs, port, jdev = case
    j = port.lut_j
    assert (port.lut is not None) == (sigma == 6) and j == (pick_lut_j(port.n) if sigma == 6 else 0)
    edges = _edge_queries(seqs, j) if sigma == 6 else []
    queries = edges + _queries(seqs, sigma)
    q, lens = pad_queries(queries)
    lb, ln = exact_search(port, q, lens)
    want_lb, want_ln = _jax_intervals(jdev, queries)
    np.testing.assert_array_equal(lb.numpy(), want_lb)
    np.testing.assert_array_equal(ln.numpy(), want_ln)
    assert (lb[-1].item(), ln[-1].item()) == (0, port.n)  # the zero-length query
    assert (ln == 0).any() and ln[-3].item() >= 2  # empty intervals, the repeat
    if edges:
        qt, lt = torch.from_numpy(q).long(), torch.from_numpy(lens).long()
        skip = table_start(qt, lt, port.lut, j, sigma, port.n)[2]
        assert skip[: len(edges)].tolist() == _edge_skips(j)
        assert skip[len(edges) :].any()  # substrings of the text take it too
        assert (ln[1:4] > 0).all() and (ln[len(edges) - 4 : len(edges)] == 0).all()  # present, absent


def test_locate_matches_jax(case):
    """locate's rows (interval, seq, pos) in the JAX package's order: by
    interval, each interval's rows in SA order; every planted substring
    among its own hits."""
    sigma, seqs, port, jdev = case
    queries = _queries(seqs, sigma)[:-1]  # the zero-length query spans the whole text
    lb, ln = exact_search(port, *pad_queries(queries))
    src, seq_id, pos = locate(port, lb, ln)
    want_lb, want_ln = _jax_intervals(jdev, queries)
    cap = 1 << int(want_ln.sum()).bit_length()
    w_src, w_seq, w_pos, valid, total = map(np.asarray, jax_locate.locate(jdev, want_lb, want_ln, cap))
    assert int(total) == src.shape[0] == ln.sum().item()
    np.testing.assert_array_equal(src.numpy(), w_src[valid])
    np.testing.assert_array_equal(seq_id.numpy(), w_seq[valid])
    np.testing.assert_array_equal(pos.numpy(), w_pos[valid])
    hits = set(zip(src.tolist(), seq_id.tolist(), pos.tolist()))
    for i, q in enumerate(queries):
        for sid, p in ((sid, p) for sid, s in enumerate(seqs) for p in range(len(s) - len(q) + 1)
                       if np.array_equal(s[p : p + len(q)], q)):
            assert (i, sid, p) in hits


def test_lf_walk_masks_invalid_rows(case):
    _, _, port, _ = case
    rows = torch.tensor([0, 5, port.n - 1, 7], dtype=torch.int32)
    valid = torch.tensor([True, False, True, False])
    seq_id, pos = lf_walk(port, rows, valid)
    want_seq, want_pos = lf_walk(port, rows[valid], torch.ones(2, dtype=torch.bool))
    assert seq_id.tolist()[1::2] == pos.tolist()[1::2] == [-1, -1]
    assert seq_id[valid].tolist() == want_seq.tolist() and pos[valid].tolist() == want_pos.tolist()


@pytest.mark.parametrize("sigma", [6, 16, 32, 64, 128])
def test_rank_helpers_on_every_row_width(sigma):
    """rank_all_from_row, rank_sym, symbol_from_row and lf on packed rows of
    any width against the JAX package's on the planar table, at i = 0 and
    i = n too."""
    host = jax_build.build_fmindex(_seqs(sigma), sigma, f"kmer{sigma}")
    occ = torch.from_numpy(rank.pack_occ(host.occ))
    assert occ.shape == (host.occ.shape[0], rank.row_ints(sigma)) and not occ[:, 2 * sigma :].any()
    rng = np.random.default_rng(sigma)
    idx = np.r_[0, host.n, rng.integers(0, host.n, size=300)].astype(np.int32)
    sym = rng.integers(0, sigma, size=idx.shape[0]).astype(np.int32)
    i, t = jnp.asarray(idx), torch.from_numpy(idx)
    jocc = jnp.asarray(host.occ)
    rows = rank.occ_row(occ, t)
    np.testing.assert_array_equal(rank.rank_all_from_row(rows, sigma, t).numpy(),
                                  np.asarray(jax_rank.rank_all(jocc, sigma, i)))
    np.testing.assert_array_equal(rank.rank_sym(occ, sigma, torch.from_numpy(sym), t).numpy(),
                                  np.asarray(jax_rank.rank_sym_word(jocc, i >> 5, jnp.asarray(sym), i, 1, sigma)))
    np.testing.assert_array_equal(rank.symbol_from_row(rows, sigma, t).numpy(),
                                  np.asarray(jax_rank.symbol_from_row(jax_rank.occ_row(jocc, i), sigma, i)))
    bwt_rows = np.minimum(idx, host.n - 1)
    np.testing.assert_array_equal(
        rank.lf(occ, torch.from_numpy(host.c_arr), sigma, torch.from_numpy(bwt_rows)).numpy(),
        np.asarray(jax_rank.lf(jocc, jnp.asarray(host.c_arr), sigma, jnp.asarray(bwt_rows))))


@pytest.mark.parametrize("sigma,ints", [(2, 16), (6, 16), (8, 16), (9, 32), (16, 32), (17, 48), (32, 64),
                                        (64, 128), (128, 256)])
def test_row_ints(sigma, ints):
    assert rank.row_ints(sigma) == ints
    assert rank.pack_occ(np.ones((3, 2 * sigma), dtype=np.int32)).shape == (3, ints)


def test_device_index_refuses_sigma_above_128():
    with pytest.raises(ValueError, match="sigma <= 128"):
        rank.pack_occ(np.zeros((2, 2 * 129), dtype=np.int32))


def test_approximate_search_refuses_wide_rows():
    """Seed-and-verify and the work-queue engine take occ16 rows only: a
    wide index is refused, never searched some other way."""
    index = DeviceIndex.from_host(build_fmindex(_seqs(32), 32, "kmer32"), device="cpu")
    queries = np.stack([s[:40] for s in _seqs(32)])
    for engine in ("auto", "sv", "workq"):
        with pytest.raises(ValueError, match="occ16 rows"):
            search_queries(index, queries, k=1, engine=engine, device="cpu")


def test_pad_queries():
    q, lens = pad_queries([np.array([3, 1], dtype=np.int64), np.zeros(0, dtype=np.int64), np.array([127] * 4)])
    assert q.dtype == np.uint8 and lens.dtype == np.int32
    np.testing.assert_array_equal(q, [[3, 1, 0, 0], [0, 0, 0, 0], [127] * 4])
    np.testing.assert_array_equal(lens, [2, 0, 4])
