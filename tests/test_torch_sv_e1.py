"""One-error seed-and-verify (SV-e1) against sahara_tpu, row for row, on
the CPU: the part plan, ``engine="sv"`` and ``auto`` on reads too short for
exact parts (m // (k+1) < 10), under edit and Hamming distance, the
``PART_CAP`` fallback, best hits and the per-query cap.  Every stage is
integer, so every comparison is exact."""

import numpy as np
import pytest

from sahara_tpu.alphabet import D_DNA5
from sahara_tpu.engine.device import DeviceIndex as JaxDeviceIndex
from sahara_tpu.engine.driver import search_queries as jax_search_queries
from sahara_tpu.engine.seedverify import plan_parts_e1 as jax_plan_parts_e1
from sahara_tpu.index.build import build_bifmindex
from sahara_tpu_torch.engine import driver, seedverify
from sahara_tpu_torch.engine.device import DeviceIndex
from sahara_tpu_torch.engine.driver import search_queries
from sahara_tpu_torch.engine.seedverify import plan_parts, plan_parts_e1
from sahara_tpu_torch.index.fmindex import from_arrays

from tests import torch_support  # noqa: F401  (PyTorch on one thread)
from tests.util import random_seqs


@pytest.fixture(scope="module")
def indexes():
    """Four random sequences (~6,000 chars) with two repeats, so that seeds
    have several occurrences and reads several hits."""
    rng = np.random.default_rng(71)
    seqs = random_seqs(rng, 4, min_len=1200, max_len=2000, sigma=5)
    seqs[1][100:500] = seqs[0][700:1100]
    seqs[3][:300] = seqs[2][-300:]
    host = build_bifmindex(seqs, 6, "d_dna5", rate=16)
    names = ("occ", "c_arr", "sampled", "sample_seq", "sample_pos", "seq_lens", "text4", "sa_abs", "occ_rev")
    meta = {"kind": "bi", "sigma": 6, "alphabet": "d_dna5", "rate": 16, "n": host.n}
    port_host = from_arrays({k: getattr(host, k) for k in names}, meta)
    return seqs, JaxDeviceIndex.from_host(host), DeviceIndex.from_host(port_host, device="cpu")


def _reads(seqs, rng, n_reads, m, k, edit):
    """Reads of m chars with up to k planted edits (substitutions only for
    Hamming), each followed by its reverse complement."""
    out = []
    for _ in range(n_reads):
        s = seqs[int(rng.integers(0, len(seqs)))]
        p = int(rng.integers(0, len(s) - m - k))
        q = np.array(s[p : p + m + k], dtype=np.uint8)
        for _ in range(int(rng.integers(0, k + 1))):
            kind, at = int(rng.integers(0, 3)) if edit else 0, int(rng.integers(0, m))
            if kind == 0:
                q[at] = 1 + (q[at] - 1 + int(rng.integers(1, 4))) % 4
            elif kind == 1:
                q = np.delete(q, at)
            else:
                q = np.insert(q, at, rng.integers(1, 5))
        q = q[:m]
        out += [q, D_DNA5.reverse_complement_rank(q).astype(np.uint8)]
    return out


@pytest.mark.parametrize("k", range(8))
def test_plan_parts_e1_matches_jax(k):
    for m in range(8, 81):
        assert plan_parts_e1(m, k) == jax_plan_parts_e1(m, k), m


@pytest.mark.parametrize("m,k,edit", [
    (36, 3, True), (36, 3, False), (30, 3, True), (30, 3, False),
    (20, 2, True), (20, 2, False), (20, 3, True), (20, 3, False), (36, 2, True),
])
def test_sv_e1_rows_equal_jax(indexes, m, k, edit):
    """Both engines that reach seed-and-verify give the reference's rows;
    all but the last case (exact parts, 36 // 3 >= 10) take one-error
    seeds, whose anchor shift the 2k+1 verify starts must absorb."""
    seqs, jdev, pdev = indexes
    assert (plan_parts(m, k) is None) == ((m, k) != (36, 2))
    queries = _reads(seqs, np.random.default_rng(100 * m + 10 * k + edit), 60, m, k, edit)
    qids = np.arange(len(queries)) * 5 + 3
    kw = dict(k=k, edit=edit, chunk=48, query_ids=qids)
    want = jax_search_queries(jdev, queries, engine="sv", **kw)
    assert len(want.rows()) >= len(queries) // 2
    for engine in ("sv", "auto"):
        assert search_queries(pdev, queries, engine=engine, device="cpu", **kw).rows() == want.rows(), engine


def test_sv_e1_part_cap_fallback_rows_equal_jax(indexes, monkeypatch):
    """Seeds over a small per-part budget send their queries to the
    work-queue engine in both packages; the merged rows are equal."""
    seqs, jdev, pdev = indexes
    queries = _reads(seqs, np.random.default_rng(7), 40, 36, 3, True)
    want = jax_search_queries(jdev, queries, k=3, chunk=32, sv_part_cap=1)
    searched = []
    run_workq = driver._run_workq_grouped

    def spy(index, qarr, *args, **kw):
        searched.append(len(qarr))
        return run_workq(index, qarr, *args, **kw)

    monkeypatch.setattr(seedverify, "PART_CAP", 1)
    monkeypatch.setattr(driver, "_run_workq_grouped", spy)
    got = search_queries(pdev, queries, k=3, chunk=32, device="cpu")
    assert got.rows() == want.rows() and len(want.rows()) >= 40
    assert searched and 0 < searched[0] < len(queries)


def test_sv_e1_fallback_mask_differs_from_jax(indexes, monkeypatch):
    """Where the port flags queries the reference does not (the masks may
    differ, since seed intervals count with dedup's multiplicity), the
    unflagged queries keep the reference's rows, and a flagged one's rows,
    from the work-queue engine, are reference positions at no fewer
    errors: that engine is not exact at k=3 on short reads (ROADMAP.md,
    queue 3), so such rows may fall short of the reference's."""
    seqs, jdev, pdev = indexes
    queries = _reads(seqs, np.random.default_rng(13), 40, 36, 3, True)
    want = jax_search_queries(jdev, queries, k=3, chunk=32).rows()
    flagged = []
    run_workq = driver._run_workq_grouped

    def spy(index, qarr, tape, qids, *args, **kw):
        flagged.extend(qids.tolist())
        return run_workq(index, qarr, tape, qids, *args, **kw)

    monkeypatch.setattr(seedverify, "PART_CAP", 1)
    monkeypatch.setattr(driver, "_run_workq_grouped", spy)
    got = search_queries(pdev, queries, k=3, chunk=32, device="cpu").rows()
    assert 0 < len(set(flagged)) < len(queries)
    assert [r for r in got if r[0] not in flagged] == [r for r in want if r[0] not in flagged]
    least = {(q, s, p): e for q, s, p, e in want}
    fb_rows = [r for r in got if r[0] in flagged]
    assert fb_rows and all(least.get(r[:3], r[3] + 1) <= r[3] for r in fb_rows)


@pytest.mark.parametrize("mode,max_hits", [("besthits", 0), ("besthits", 2), ("all", 1)])
def test_sv_e1_besthits_and_max_hits_equal_jax(indexes, mode, max_hits):
    seqs, jdev, pdev = indexes
    queries = _reads(seqs, np.random.default_rng(11), 40, 30, 3, True)
    kw = dict(k=3, edit=True, mode=mode, max_hits=max_hits, chunk=32)
    want = jax_search_queries(jdev, queries, engine="sv", **kw)
    assert search_queries(pdev, queries, engine="sv", device="cpu", **kw).rows() == want.rows()
    assert len(want.rows()) >= len(queries) // 2
