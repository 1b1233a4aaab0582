"""sahara_tpu_torch.search_queries against sahara_tpu's seed-and-verify
driver, row for row: the seed-and-verify route, its fallback to the
work-queue engine, and the routes both packages refuse."""

import numpy as np
import pytest
import torch

from sahara_tpu.alphabet import D_DNA5
from sahara_tpu.engine.device import DeviceIndex as JaxDeviceIndex
from sahara_tpu.engine.driver import search_queries as jax_search_queries
from sahara_tpu.index.build import build_bifmindex
from sahara_tpu_torch.engine import seedverify
from sahara_tpu_torch.engine.device import DeviceIndex
from sahara_tpu_torch.engine.driver import search_queries
from sahara_tpu_torch.index.fmindex import from_arrays
from sahara_tpu_torch.parallel import data_mesh, replicate_index

from tests import torch_support  # noqa: F401  (PyTorch on one thread)
from tests.util import random_seqs

M = 48


@pytest.fixture(scope="module")
def indexes():
    rng = np.random.default_rng(31)
    seqs = random_seqs(rng, 6, min_len=1500, max_len=4000, sigma=5)
    seqs[1][200:900] = seqs[0][1000:1700]  # a repeat: multi-hit reads
    host = build_bifmindex(seqs, 6, "d_dna5", rate=16)
    names = ("occ", "c_arr", "sampled", "sample_seq", "sample_pos", "seq_lens", "text4", "sa_abs", "occ_rev")
    meta = {"kind": "bi", "sigma": 6, "alphabet": "d_dna5", "rate": 16, "n": host.n}
    port_host = from_arrays({k: getattr(host, k) for k in names}, meta)
    return seqs, JaxDeviceIndex.from_host(host), port_host, DeviceIndex.from_host(port_host, device="cpu")


def _reads(seqs, rng, n_reads, k, edit=True):
    """Reads with up to k planted edits (substitutions only for Hamming),
    each followed by its reverse complement, as the CLI and bench.py search
    them."""
    out = []
    for _ in range(n_reads):
        s = seqs[int(rng.integers(0, len(seqs)))]
        p = int(rng.integers(0, len(s) - M - k))
        q = np.array(s[p : p + M + k], dtype=np.uint8)
        for _ in range(int(rng.integers(0, k + 1))):
            kind, at = int(rng.integers(0, 3)) if edit else 0, int(rng.integers(0, M))
            if kind == 0:
                q[at] = 1 + (q[at] - 1 + int(rng.integers(1, 4))) % 4
            elif kind == 1:
                q = np.delete(q, at)
            else:
                q = np.insert(q, at, rng.integers(1, 5))
        q = q[:M]
        out += [q, D_DNA5.reverse_complement_rank(q).astype(np.uint8)]
    return out


@pytest.mark.parametrize("edit,k", [(True, 1), (True, 2), (True, 3), (False, 0), (False, 2)])
def test_search_matches_jax(indexes, edit, k):
    seqs, jdev, _, pdev = indexes
    queries = _reads(seqs, np.random.default_rng(40 + k + 10 * edit), 200, k, edit)
    qids = np.arange(len(queries)) * 3 + 7
    for mode, max_hits in (("all", 0), ("besthits", 0), ("besthits", 2)):
        kw = dict(k=k, edit=edit, mode=mode, max_hits=max_hits, chunk=128, query_ids=qids)
        want = jax_search_queries(jdev, queries, engine="sv", **kw)
        got = search_queries(pdev, queries, device="cpu", **kw)
        assert got.rows() == want.rows(), mode
        assert len(want.rows()) >= len(queries) // 2


def test_matrix_queries_and_sampled_walk_match_full_sa(indexes):
    seqs, _, port_host, pdev = indexes
    queries = np.stack(_reads(seqs, np.random.default_rng(50), 150, 2))
    full = search_queries(pdev, queries, k=2, device="cpu", chunk=100)
    sampled = search_queries(DeviceIndex.from_host(port_host, device="cpu", full_sa=False),
                             list(queries), k=2, device="cpu", chunk=100)
    assert sampled.rows() == full.rows() and len(full.rows()) >= 150


@pytest.mark.parametrize("rank,where", [(5, -3), (0, -1)])
def test_untableable_rank_raises(indexes, rank, where):
    """A rank the j-mer table cannot encode no longer raises: the query is
    re-searched through the work-queue engine, as the reference does, and
    the rows equal its ``auto`` rows."""
    seqs, jdev, _, pdev = indexes
    queries = _reads(seqs, np.random.default_rng(60), 20, 2)
    queries[6] = queries[6].copy()  # a forward strand: it has hits
    queries[6][where] = rank
    want = jax_search_queries(jdev, queries, k=2)
    got = search_queries(pdev, queries, k=2, device="cpu")
    assert got.rows() == want.rows() and 6 in set(got.query_id.tolist())


def test_part_cap_overflow_raises(indexes, monkeypatch):
    """Seeds over the per-part budget no longer raise: those queries go
    through the work-queue engine, and the rows equal the reference's."""
    seqs, jdev, _, pdev = indexes
    queries = _reads(seqs, np.random.default_rng(61), 20, 2)
    want = jax_search_queries(jdev, queries, k=2, sv_part_cap=0)
    monkeypatch.setattr(seedverify, "PART_CAP", 0)
    got = search_queries(pdev, queries, k=2, device="cpu")
    assert got.rows() == want.rows() and len(want.rows()) >= 20


@pytest.mark.parametrize("route", ["frontier", "mesh", "sv_short"])
def test_unported_routes_raise(indexes, route):
    """The frontier engine is ``approx``, and any other engine name is
    refused; ``approx`` has no mesh driver; seed-and-verify refuses reads
    too short even for one-error parts (16 chars at k=2: two parts of 8).
    The reference refuses each alike."""
    seqs, jdev, port_host, pdev = indexes
    kw = dict(k=2, device="cpu")
    if route == "frontier":
        kw["engine"] = "frontier"
    elif route == "mesh":
        mesh = data_mesh(devices=["cpu"] * 2)
        kw.update(engine="approx", mesh=mesh)
        pdev = replicate_index(port_host, mesh)
    else:
        kw["engine"] = "sv"
    queries = [np.asarray(seqs[0][: 16 if route == "sv_short" else M], dtype=np.uint8)]
    with pytest.raises(ValueError, match={"frontier": "unknown search engine 'frontier'",
                                          "mesh": "engine 'approx' has no distributed driver",
                                          "sv_short": "seed-verify engine not applicable"}[route]):
        search_queries(pdev, queries, **kw)
    if route == "sv_short":
        with pytest.raises(ValueError, match="seed-verify engine not applicable"):
            jax_search_queries(jdev, queries, k=2, engine="sv")


def test_search_needs_a_card_by_default(indexes):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    seqs, _, _, pdev = indexes
    with pytest.raises(RuntimeError, match="no CUDA device"):
        search_queries(pdev, [np.asarray(seqs[0][:M], dtype=np.uint8)], k=2)
