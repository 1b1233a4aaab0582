"""sahara_tpu_torch seed-and-verify stages against sahara_tpu's: seed scan,
interval expansion, locate and verify."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sahara_tpu.engine.device import DeviceIndex as JaxDeviceIndex
from sahara_tpu.engine.locate import expand_intervals as jax_expand_intervals
from sahara_tpu.engine.locate import lf_walk as jax_lf_walk
from sahara_tpu.engine.seedverify import plan_parts as jax_plan_parts
from sahara_tpu.engine.seedverify import seed_parts as jax_seed_parts
from sahara_tpu.engine.seedverify import sv_verify as jax_sv_verify
from sahara_tpu.index.build import build_bifmindex
from sahara_tpu_torch.engine.device import DeviceIndex
from sahara_tpu_torch.engine.locate import expand_intervals, lf_walk
from sahara_tpu_torch.engine.seedverify import plan_parts, seed_parts
from sahara_tpu_torch.index.fmindex import from_arrays
from sahara_tpu_torch.kernels.verify import verify

from tests.util import random_seqs


def _both(seqs):
    """(host, JAX device index, port CPU device index) over one build."""
    host = build_bifmindex(seqs, 6, "d_dna5", rate=16)
    names = ("occ", "c_arr", "sampled", "sample_seq", "sample_pos", "seq_lens", "text4", "sa_abs")
    meta = {"kind": "uni", "sigma": 6, "alphabet": "d_dna5", "rate": host.rate, "n": host.n}
    port = DeviceIndex.from_host(from_arrays({k: getattr(host, k) for k in names}, meta), device="cpu")
    return host, JaxDeviceIndex.from_host(host), port


@pytest.fixture(scope="module")
def long_index():
    return _both(random_seqs(np.random.default_rng(21), 4, min_len=2000, max_len=4000, sigma=5))


@pytest.fixture(scope="module")
def short_index():
    """Many short sequences: verify windows cross sentinels and the text start."""
    return _both(random_seqs(np.random.default_rng(22), 12, min_len=20, max_len=70, sigma=5))


def _text(host):
    from sahara_tpu.index.textstore import unpack_text4

    return unpack_text4(host.text4, host.n)


def _seed_queries(host, rng, nq, m):
    text = _text(host)
    real = np.flatnonzero(text[: host.n - m])
    at = rng.choice(real, nq)
    q = text[at[:, None] + np.arange(m)].astype(np.uint8)
    q[q == 0] = 1
    q[np.arange(nq), rng.integers(0, m, nq)] = rng.integers(1, 5, nq)
    q[: nq // 8] = rng.integers(1, 5, (nq // 8, m))  # mostly empty intervals
    q[nq // 8 : nq // 4, rng.integers(0, m)] = 5  # N: clamped table codes
    q[nq // 4 : nq // 4 + 4, -1] = 0  # sentinel rank in a part
    return q


def test_plan_parts_matches_jax():
    for m in (12, 20, 36, 40, 100, 150):
        for k in range(8):
            assert plan_parts(m, k) == jax_plan_parts(m, k)


@pytest.mark.parametrize("use_lut", [True, False])
@pytest.mark.parametrize("m,k", [(40, 2), (45, 3)])
def test_seed_scan_matches_jax(long_index, use_lut, m, k):
    """lo and sz compared everywhere, empty intervals included: neither scan
    stops early, so lo of an empty interval is defined and equal."""
    host, jdev, pdev = long_index
    if not use_lut:
        jdev = dataclasses.replace(jdev, lut=None, lut_j=0)
        pdev = dataclasses.replace(pdev, lut=None, lut_j=0)
    q = _seed_queries(host, np.random.default_rng(m + k), 300, m)
    parts = plan_parts(m, k)
    packed = np.asarray(jax_seed_parts(jdev, jnp.asarray(q, dtype=jnp.int32), parts))
    lo, sz = seed_parts(pdev, torch.from_numpy(q), parts)
    np.testing.assert_array_equal(lo.reshape(-1).numpy(), packed[: q.shape[0] * len(parts)])
    np.testing.assert_array_equal(sz.reshape(-1).numpy(), packed[q.shape[0] * len(parts) :])
    assert (sz > 0).any() and (sz == 0).any()


@pytest.mark.parametrize("cap_rows", [64, 512])
def test_expand_intervals_matches_jax(cap_rows):
    rng = np.random.default_rng(cap_rows)
    lb = rng.integers(0, 10_000, 40).astype(np.int32)
    ln = np.where(rng.random(40) < 0.4, 0, rng.integers(0, 20, 40)).astype(np.int32)
    want = [np.asarray(x) for x in jax_expand_intervals(jnp.asarray(lb), jnp.asarray(ln), cap_rows)]
    got = [x.numpy() for x in expand_intervals(torch.from_numpy(lb), torch.from_numpy(ln), cap_rows)]
    for g, w, name in zip(got, want, ("rows", "src", "valid", "total")):
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64), err_msg=name)


@pytest.mark.parametrize("full_sa", [True, False])
def test_lf_walk_matches_jax(short_index, full_sa):
    host, jdev, pdev = short_index
    if not full_sa:
        jdev = dataclasses.replace(jdev, sa_full=None)
        pdev = dataclasses.replace(pdev, sa_full=None)
    # rows whose suffix starts at a real char (sentinel rows are unspecified)
    rows = np.flatnonzero(_text(host)[host.sa_abs] != 0).astype(np.int32)
    valid = np.random.default_rng(1).random(len(rows)) < 0.9
    want = jax_lf_walk(jdev, jnp.asarray(rows), jnp.asarray(valid))
    got = lf_walk(pdev, torch.from_numpy(rows), torch.from_numpy(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64), np.asarray(w).astype(np.int64))


def _candidates(host, rng, n_cands, m, k, offsets, edit=True):
    """Anchored candidates and mutated queries near them (shifted by up to
    k under edit distance), many of them at sequence edges so that windows
    cross sentinels and the text start."""
    text = _text(host)
    isa = np.empty(host.n, dtype=np.int64)
    isa[host.sa_abs] = np.arange(host.n)
    real = np.flatnonzero(text)
    at = rng.choice(real, n_cands)
    off = rng.choice(offsets, n_cands)
    queries = np.empty((n_cands, m), dtype=np.uint8)
    for r in range(n_cands):
        start = at[r] - off[r] + (int(rng.integers(-k, k + 1)) if edit else 0)
        pos = start + np.arange(m)
        q = np.where((pos >= 0) & (pos < host.n), text[np.clip(pos, 0, host.n - 1)], 0)
        for _ in range(int(rng.integers(0, k + 1))):
            q[int(rng.integers(0, m))] = int(rng.integers(1, 5))
        q[q == 0] = rng.integers(1, 5, int((q == 0).sum()))
        queries[r] = q
    return queries, isa[at].astype(np.int32), off.astype(np.int32)


@pytest.mark.parametrize("edit", [True, False])
@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_verify_matches_jax(short_index, edit, k):
    host, jdev, pdev = short_index
    m, cap = 24, 512
    queries, rows, off = _candidates(host, np.random.default_rng(10 * k + edit), 400, m, k, [0, 8, 16], edit)
    r_cnt = len(rows)
    pad = cap - r_cnt
    valid = np.r_[np.ones(r_cnt, bool), np.zeros(pad, bool)]
    q_of = np.arange(cap, dtype=np.int32) % r_cnt
    hq_cap = 8192
    packed = np.asarray(jax_sv_verify(
        jdev, jnp.asarray(queries, dtype=jnp.int32), jnp.asarray(np.r_[rows, np.zeros(pad, np.int32)]),
        jnp.asarray(q_of), jnp.asarray(np.r_[off, np.zeros(pad, np.int32)]), jnp.asarray(valid),
        m=m, k=k, edit=edit, hq_cap=hq_cap,
    ))
    cnt = int(packed[3 * hq_cap])
    assert not packed[3 * hq_cap + 1]
    want = set(zip((packed[:cnt] % cap).tolist(), packed[hq_cap : hq_cap + cnt].tolist(),
                   packed[2 * hq_cap : 2 * hq_cap + cnt].tolist()))

    seq_id, pos = lf_walk(pdev, torch.from_numpy(rows), torch.ones(r_cnt, dtype=torch.bool))
    a0 = pdev.seq_starts[seq_id.long()].long() + pos.long() - torch.from_numpy(off).long()
    base = a0 - (k if edit else 0)
    dist = verify(pdev.text4, pdev.n, torch.from_numpy(queries), torch.arange(r_cnt, dtype=torch.int32),
                  base.to(torch.int32), k, edit)
    cand, delta = torch.nonzero(dist <= k, as_tuple=True)
    got = set(zip(cand.tolist(), (base[cand] + delta).tolist(), dist[cand, delta].tolist()))
    assert got == want
    assert len(want) >= r_cnt // 4
    assert (base < 0).any() or k == 0  # windows reach before the text start

