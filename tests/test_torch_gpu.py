"""The CUDA kernels against their plain versions, and the search on the card
against the search on the CPU.  Needs a CUDA card: every test skips
without one.  This file imports only the port, so on a machine without JAX
it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from sahara_tpu_torch.engine.device import DeviceIndex
from sahara_tpu_torch.engine.driver import search_queries
from sahara_tpu_torch.engine.seedverify import plan_parts
from sahara_tpu_torch.index.build import build_fmindex
from sahara_tpu_torch.kernels import LAUNCHES
from sahara_tpu_torch.kernels.rank import rank_all, rank_all_plain
from sahara_tpu_torch.kernels.seed import seed_scan, seed_scan_plain
from sahara_tpu_torch.kernels.verify import verify, verify_plain

pytestmark = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def host():
    rng = np.random.default_rng(77)
    seqs = [rng.integers(1, 5, int(rng.integers(20, 3000))).astype(np.uint8) for _ in range(30)]
    seqs[3][:400] = seqs[2][-400:]  # a repeat
    return build_fmindex(seqs, 6, "d_dna5"), seqs


def _reads(seqs, rng, n, m, k):
    out = []
    long_seqs = [s for s in seqs if len(s) > m + k]
    for _ in range(n):
        s = long_seqs[int(rng.integers(0, len(long_seqs)))]
        p = int(rng.integers(0, len(s) - m))
        q = np.array(s[p : p + m], dtype=np.uint8)
        q[rng.integers(0, m, int(rng.integers(0, k + 1)))] = rng.integers(1, 5)
        out.append(q)
    return np.stack(out)


def test_rank_all_kernel_matches_plain(host):
    dev = _card()
    idx_host, _ = host
    index = DeviceIndex.from_host(idx_host, device=dev)
    idx = torch.from_numpy(np.r_[0, idx_host.n, np.random.default_rng(1).integers(0, idx_host.n, 5000)].astype(np.int32)).to(dev)
    before = LAUNCHES["rank_all"]
    got = rank_all(index.occ16, index.sigma, idx)
    torch.cuda.synchronize()
    assert LAUNCHES["rank_all"] == before + 1
    assert torch.equal(got, rank_all_plain(index.occ16, index.sigma, idx))
    with pytest.raises(TypeError):
        rank_all(index.occ16, index.sigma, idx.long())


@pytest.mark.parametrize("use_lut", [True, False])
def test_seed_scan_kernel_matches_plain(host, use_lut):
    dev = _card()
    idx_host, seqs = host
    index = DeviceIndex.from_host(idx_host, device=dev)
    q = _reads(seqs, np.random.default_rng(2), 2000, 60, 3)
    q[:50] = np.random.default_rng(3).integers(0, 6, (50, 60))  # N and sentinel ranks too
    parts = plan_parts(60, 3)
    lut, lut_j = (index.lut, index.lut_j) if use_lut else (None, 0)
    args = (index.occ16, index.c_arr, lut, lut_j, torch.from_numpy(q).to(dev), parts, index.sigma, index.n)
    lo, sz = seed_scan(*args)
    torch.cuda.synchronize()
    lo_p, sz_p = seed_scan_plain(*args)
    assert torch.equal(lo, lo_p) and torch.equal(sz, sz_p)
    assert (sz > 0).any()


@pytest.mark.parametrize("edit,k", [(True, 0), (True, 1), (True, 3), (True, 7), (False, 2)])
def test_verify_kernel_matches_plain(host, edit, k):
    dev = _card()
    idx_host, seqs = host
    index = DeviceIndex.from_host(idx_host, device=dev)
    rng = np.random.default_rng(4 + k)
    m = 40
    q = torch.from_numpy(_reads(seqs, rng, 300, m, k)).to(dev)
    # starts all over the text, its edges and beyond them
    base = np.r_[-m - 5, -3, idx_host.n - 10, idx_host.n + 3, rng.integers(-20, idx_host.n, 3000)]
    q_of = rng.integers(0, 300, len(base))
    args = (index.text4, index.n, q, torch.from_numpy(q_of.astype(np.int32)).to(dev),
            torch.from_numpy(base.astype(np.int32)).to(dev), k, edit)
    got = verify(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, verify_plain(*args))


@pytest.mark.parametrize("full_sa", [True, False])
def test_search_on_card_matches_cpu(host, full_sa):
    dev = _card()
    idx_host, seqs = host
    queries = _reads(seqs, np.random.default_rng(5), 700, 50, 2)
    want = search_queries(DeviceIndex.from_host(idx_host, device="cpu", full_sa=full_sa), queries,
                          k=2, device="cpu", chunk=256)
    got = search_queries(DeviceIndex.from_host(idx_host, device=dev, full_sa=full_sa), queries,
                         k=2, chunk=256)
    assert got.rows() == want.rows() and len(want.rows()) >= 700
