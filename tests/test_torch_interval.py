"""The interval-sharded index in the port against sahara_tpu's: the shard
plan, each shard's arrays, the container (each package loads the other's),
and search_queries_sharded row for row in both regimes (resident: every
shard's seed-and-verify view uploaded once; swap: one whole shard at a
time), with window-split sequences.  The JAX side takes its swap regime
where SAHARA_HBM_BUDGET is 0, the port where ``resident_budget=0``."""

import filecmp

import numpy as np
import pytest

from sahara_tpu.alphabet import D_DNA5
from sahara_tpu.engine.device import DeviceIndex as JaxDeviceIndex
from sahara_tpu.engine.driver import search_queries as jax_search_queries
from sahara_tpu.engine.driver import search_queries_sharded as jax_search_sharded
from sahara_tpu.index.build import build_bifmindex as jax_build_bifmindex
from sahara_tpu.index.shard import build_sharded_bifmindex as jax_build_sharded
from sahara_tpu.index.shard import load_any_index as jax_load_any_index
from sahara_tpu.index.shard import plan_shards as jax_plan_shards
from sahara_tpu.index.shard import save_sharded as jax_save_sharded
from sahara_tpu_torch.engine import seedverify
from sahara_tpu_torch.engine.device import DeviceIndex, device_bytes
from sahara_tpu_torch.engine.driver import search_queries_sharded
from sahara_tpu_torch.index.build import build_bifmindex
from sahara_tpu_torch.index.shard import (
    ShardedIndex, build_sharded_bifmindex, load_any_index, peek_index_kind, plan_shards, save_sharded,
)

from tests import torch_support  # noqa: F401  (PyTorch on one thread)

M = 36  # three exact parts of 12 at k=2: the resident regime applies
MAX_CHARS, OVERLAP = 400, 64
ARRAYS = ("occ", "occ_rev", "c_arr", "sampled", "sample_seq", "sample_pos", "seq_lens", "text4", "sa_abs")


@pytest.fixture(scope="module")
def corpus():
    """One sequence split into windows (0), two short ones, and a 60-char
    segment copied into three sequences of two shards (multi-hit reads);
    reads of M chars with up to two substitutions, each with its reverse
    complement, and one read from a window boundary."""
    rng = np.random.default_rng(17)
    seqs = [rng.integers(1, 5, n).astype(np.uint8) for n in (900, 200, 150, 180)]
    seg = rng.integers(1, 5, 60).astype(np.uint8)
    seqs[1][20:80], seqs[2][50:110], seqs[3][10:70] = seg, seg, seg
    queries = []
    for i in range(10):
        s = seqs[i % 4]
        p = int(rng.integers(0, len(s) - M))
        q = s[p : p + M].copy()
        q[rng.integers(0, M, i % 3)] = rng.integers(1, 5)
        queries += [q, D_DNA5.reverse_complement_rank(q).astype(np.uint8)]
    queries.append(seqs[0][380 : 380 + M].copy())  # straddles the first window's end
    queries.append(seg[5 : 5 + M].copy())
    return seqs, queries


def _sharded(seqs, lib=build_sharded_bifmindex):
    return lib(seqs, 6, "d_dna5", max_chars=MAX_CHARS, overlap=OVERLAP)


@pytest.fixture(scope="module")
def single_rows(corpus):
    """The JAX package's rows on one unsharded index, by (k, edit, mode)."""
    seqs, queries = corpus
    dev = JaxDeviceIndex.from_host(jax_build_bifmindex(seqs, 6, "d_dna5"))
    cache = {}

    def rows(k, edit, mode="all"):
        if (k, edit, mode) not in cache:
            res = jax_search_queries(dev, queries, k=k, edit=edit, mode=mode, generator_name="optimum")
            cache[k, edit, mode] = res.rows()
        return cache[k, edit, mode]

    return rows


@pytest.mark.parametrize("lens,max_chars,overlap", [
    ([1000, 300], 400, 50), ([100, 200, 150, 90], 300, 10), ([5000], 1024, 100), ([10, 20, 30], 1000, 5),
])
def test_plan_shards_matches_jax(lens, max_chars, overlap):
    assert plan_shards(lens, max_chars, overlap) == jax_plan_shards(lens, max_chars, overlap)


def test_shard_arrays_and_container_match_jax(corpus, tmp_path):
    seqs, _ = corpus
    ours, theirs = _sharded(seqs), _sharded(seqs, jax_build_sharded)
    assert isinstance(ours, ShardedIndex) and ours.num_shards == theirs.num_shards >= 3
    assert ours.windowed_gids.tolist() == theirs.windowed_gids.tolist() == [0]
    for a, b in zip(ours.shards, theirs.shards):
        for name in ARRAYS:
            assert np.array_equal(getattr(a, name), getattr(b, name)), name
    for mine, jax_map in ((ours.seq_gid, theirs.seq_gid), (ours.seq_off, theirs.seq_off)):
        assert all(np.array_equal(x, y) for x, y in zip(mine, jax_map))
    save_sharded(tmp_path / "port.idx", ours)
    jax_save_sharded(str(tmp_path / "jax.idx"), theirs)
    assert filecmp.cmp(tmp_path / "port.idx", tmp_path / "jax.idx", shallow=False)


def test_containers_load_across_packages(corpus, tmp_path):
    seqs, _ = corpus
    jax_save_sharded(str(tmp_path / "jax.idx"), _sharded(seqs, jax_build_sharded))
    save_sharded(tmp_path / "port.idx", _sharded(seqs))
    assert peek_index_kind(tmp_path / "jax.idx") == "sharded"
    ours, theirs = load_any_index(tmp_path / "jax.idx"), jax_load_any_index(str(tmp_path / "port.idx"))
    assert ours.num_seqs == theirs.num_seqs == len(seqs)
    for a, b in zip(ours.shards, theirs.shards):
        for name in ARRAYS:
            assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert all(np.array_equal(x, y) for x, y in zip(ours.seq_off, theirs.seq_off))


def _both(seqs, queries, monkeypatch, regime, **kw):
    """(port rows, JAX rows) of one sharded search in ``regime``; asserts
    each took it."""
    if regime == "swap":
        monkeypatch.setenv("SAHARA_HBM_BUDGET", "0")
    else:
        monkeypatch.delenv("SAHARA_HBM_BUDGET", raising=False)
    theirs = _sharded(seqs, jax_build_sharded)
    want = jax_search_sharded(theirs, queries, generator_name="optimum", **kw).rows()
    ours = _sharded(seqs)
    got = search_queries_sharded(ours, queries, generator_name="optimum", device="cpu",
                                 resident_budget=0 if regime == "swap" else None, **kw).rows()
    return got, want, ours, theirs


@pytest.mark.parametrize("regime", ["resident", "swap"])
@pytest.mark.parametrize("edit,k", [(True, 1), (True, 2), (False, 1), (False, 2)])
def test_sharded_search_matches_jax(corpus, single_rows, monkeypatch, regime, edit, k):
    seqs, queries = corpus
    for mode in ("all", "besthits"):
        got, want, ours, theirs = _both(seqs, queries, monkeypatch, regime, k=k, edit=edit, mode=mode)
        assert got == want == single_rows(k, edit, mode), mode
        assert (ours.resident is not None) == (regime == "resident")
        assert (getattr(theirs, "_resident_devs", None) is not None) == (regime == "resident")
    assert len(got) >= len(queries) // 2


@pytest.mark.parametrize("regime", ["resident", "swap"])
def test_max_hits_differs_between_regimes(corpus, monkeypatch, regime):
    """The resident regime caps the merged rows at max_hits a query; the
    swap regime caps each shard's, so a query with hits in two shards can
    get more: both as the reference does."""
    seqs, queries = corpus
    got, want, _, _ = _both(seqs, queries, monkeypatch, regime, k=1, edit=True, max_hits=2)
    assert got == want
    per_query = np.bincount([r[0] for r in got])
    if regime == "resident":
        assert per_query.max() == 2
    else:
        assert per_query.max() > 2


def test_resident_fallback_is_deferred(corpus, single_rows, monkeypatch):
    """With no seed under the occurrence budget every query falls back: the
    views are dropped and each shard is searched whole by the work-queue
    engine, giving the reference's rows."""
    seqs, queries = corpus
    monkeypatch.delenv("SAHARA_HBM_BUDGET", raising=False)
    theirs = _sharded(seqs, jax_build_sharded)
    want = jax_search_sharded(theirs, queries, k=1, generator_name="optimum", sv_part_cap=0).rows()
    monkeypatch.setattr(seedverify, "PART_CAP", 0)
    ours = _sharded(seqs)
    lines = []
    got = search_queries_sharded(ours, queries, k=1, generator_name="optimum", device="cpu", verbose_cb=lines.append)
    assert got.rows() == want == single_rows(1, True)
    assert ours.resident is None and getattr(theirs, "_resident_devs", None) is None
    assert any("(resident)" in line for line in lines) and any("full index swap-in" in line for line in lines)


@pytest.mark.parametrize("start", [380, 340])
def test_window_boundary_hits_once(corpus, start):
    """A read across the first window's end lies wholly in the second
    window; a read inside the overlap lies in both, and its hit is kept
    once, at its global position."""
    seqs, _ = corpus
    q = seqs[0][start : start + M].copy()
    got = search_queries_sharded(_sharded(seqs), [q], k=0, device="cpu").rows()
    assert [(s, p) for _, s, p, _ in got] == [(0, start)]


def test_short_sequences_pack_without_windows(single_rows, corpus):
    """Sequences shorter than the budget pack whole into shards: no window,
    and the rows equal the single index's."""
    seqs, queries = corpus
    short = [s[:350] for s in seqs]
    sh = build_sharded_bifmindex(short, 6, "d_dna5", max_chars=MAX_CHARS, overlap=OVERLAP)
    assert [g.tolist() for g in sh.seq_gid] == [[0], [1, 2], [3]] and len(sh.windowed_gids) == 0
    assert all(not off.any() for off in sh.seq_off)
    want = jax_search_queries(JaxDeviceIndex.from_host(jax_build_bifmindex(short, 6, "d_dna5")), queries, k=1,
                              generator_name="optimum")
    assert search_queries_sharded(sh, queries, k=1, generator_name="optimum", device="cpu").rows() == want.rows()


@pytest.mark.parametrize("kw", [{}, {"include_rev": False}, {"full_sa": False}])
def test_device_bytes_counts_every_upload(corpus, kw):
    """The resident budget counts what the upload puts on the device, the
    full suffix array included."""
    seqs, _ = corpus
    host = build_bifmindex(seqs, 6, "d_dna5")
    index = DeviceIndex.from_host(host, device="cpu", **kw)
    tensors = [index.occ, index.c_arr, index.sampled, index.sample_seq, index.sample_pos, index.text4,
               index.seq_starts, index.lut, index.sa_full]
    assert device_bytes(host, **kw) == sum(t.numel() * t.element_size() for t in tensors if t is not None)
    assert (index.sa_full is not None) == ("full_sa" not in kw)


def test_resident_budget_picks_the_regime(corpus):
    """Views over the budget take the swap regime, views within it stay on
    the device; one 2-D array of queries searches as the list does."""
    seqs, queries = corpus
    sh = _sharded(seqs)
    need = sum(device_bytes(h, include_rev=False) for h in sh.shards)
    lines = []
    search_queries_sharded(sh, queries, k=1, device="cpu", resident_budget=need - 1, verbose_cb=lines.append)
    assert sh.resident is None and any("uploaded in" in line for line in lines)
    matrix = search_queries_sharded(sh, np.stack(queries), k=1, device="cpu", resident_budget=need)
    assert sh.resident is not None and len(sh.resident) == sh.num_shards
    assert matrix.rows() == search_queries_sharded(sh, queries, k=1, device="cpu").rows()
