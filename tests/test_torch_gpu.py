"""The CUDA kernels against their plain versions, and the search on the card
against the search on the CPU.  Needs a CUDA card: every test skips
without one.  This file imports only the port, so on a machine without JAX
it runs on its own (the CLI case builds its corpus with the port's own
read simulator):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import contextlib
import io
import os
import traceback
import warnings
from collections import Counter

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sahara_tpu_torch import trace
from sahara_tpu_torch.cli.main import main as cli_main
from sahara_tpu_torch.engine import approx, seedverify, workq
from sahara_tpu_torch.engine.device import DeviceIndex
from sahara_tpu_torch.engine.driver import load_scheme, search_queries, search_queries_sharded
from sahara_tpu_torch.engine.exact import exact_search as engine_exact_search
from sahara_tpu_torch.engine.locate import locate
from sahara_tpu_torch.engine.rank import lf, sampled_bit
from sahara_tpu_torch.engine.seedverify import plan_parts
from sahara_tpu_torch.engine.tape import compile_tape
from sahara_tpu_torch.index.build import build_bifmindex, build_fmindex
from sahara_tpu_torch.index.shard import build_sharded_bifmindex
from sahara_tpu_torch.index.jmer import pick_lut_j
from sahara_tpu_torch.index.textstore import unpack_text4
from sahara_tpu_torch.io.fasta import FastaRecord, write_fasta
from sahara_tpu_torch.kernels import LAUNCHES
from sahara_tpu_torch.kernels.dedup import workq_dedup, workq_dedup_plain
from sahara_tpu_torch.kernels.exact import exact_search, exact_search_plain, table_start
from sahara_tpu_torch.kernels.frontier import FrontierContext, frontier_step, frontier_step_plain, pack_tape
from sahara_tpu_torch.kernels.lf_walk import lf_walk, lf_walk_plain
from sahara_tpu_torch.kernels.rank import rank_all, rank_all_plain
from sahara_tpu_torch.kernels.rank_smem import (
    SMEM_LIMIT, launch_shape, occ16_smem_bytes, rank_all_smem, rank_all_smem_plain,
)
from sahara_tpu_torch.kernels.seed import seed_bad_mask_kernel, seed_bad_mask_plain, seed_scan, seed_scan_plain
from sahara_tpu_torch.kernels.verify import hamming_lanes, verify, verify_plain
from sahara_tpu_torch.kernels.workq import EPOCHS, TILE, step_context, workq_step, workq_step_plain
from sahara_tpu_torch.timing import event_device_ms, kernel_device_ms

# by its own name, from the directory pytest puts on sys.path: the card's
# Python has a package of its own named ``tests``
import torch_support  # noqa: F401  (PyTorch on one thread)

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
    got = rank_all(index.occ, index.sigma, idx)
    torch.cuda.synchronize()
    assert LAUNCHES["rank_all"] == before + 1
    assert torch.equal(got, rank_all_plain(index.occ, index.sigma, idx))
    with pytest.raises(TypeError):
        rank_all(index.occ, index.sigma, idx.long())


def test_event_device_ms_near_profiler_time(host):
    """The CUDA-event time that stands in for the profiler's (the span of
    one rank_all call behind a sleep) is near the kernel's profiler time:
    no host time in it, at most a few microseconds of events."""
    dev = _card()
    idx_host, _ = host
    index = DeviceIndex.from_host(idx_host, device=dev)
    idx = torch.from_numpy(np.random.default_rng(2).integers(0, idx_host.n, 1 << 20).astype(np.int32)).to(dev)
    call = lambda: rank_all(index.occ, index.sigma, idx)  # noqa: E731
    traced = kernel_device_ms(call, "rank_all_kernel", 20)
    events = event_device_ms(call, 20)
    assert 0.5 * traced < events < 1.5 * traced + 0.01, (traced, events)


@pytest.mark.parametrize("use_lut", [True, False])
def test_seed_scan_kernel_matches_plain(host, use_lut):
    dev = _card()
    idx_host, seqs = host
    index = DeviceIndex.from_host(idx_host, device=dev)
    q = _reads(seqs, np.random.default_rng(2), 2000, 60, 3)
    q[:50] = np.random.default_rng(3).integers(0, 6, (50, 60))  # N and sentinel ranks too
    parts = plan_parts(60, 3)
    lut, lut_j = (index.lut, index.lut_j) if use_lut else (None, 0)
    args = (index.occ, index.c_arr, lut, lut_j, torch.from_numpy(q).to(dev), parts, index.sigma, index.n)
    lo, sz = seed_scan(*args)
    torch.cuda.synchronize()
    lo_p, sz_p = seed_scan_plain(*args)
    assert torch.equal(lo, lo_p) and torch.equal(sz, sz_p)
    assert (sz > 0).any()


@pytest.mark.parametrize("m", [36, 60, 100])
@pytest.mark.parametrize("nq", [1, 255, 256, 257, 65_537, 865_920])
def test_seed_bad_mask_kernel_matches_plain(nq, m):
    """N-laden matrices: ACGT rows, every 16th row ranks 0..5 throughout,
    and a rank 0..5 at a random column of every 5th row; also from a row
    that starts off the 16-byte grid (the matrix less its first row)."""
    dev = _card()
    rng = np.random.default_rng(nq + m)
    q = rng.integers(1, 5, (nq, m), dtype=np.uint8)
    q[::16] = rng.integers(0, 6, q[::16].shape, dtype=np.uint8)
    q[::5, rng.integers(0, m)] = rng.integers(0, 6, len(q[::5]), dtype=np.uint8)
    qd = torch.from_numpy(q).to(dev)
    parts = plan_parts(m, 2)
    for lut_j in (10, 3):
        for sub in (qd, qd[1:]):
            before = LAUNCHES["seed_bad_mask"]
            got = seed_bad_mask_kernel(sub, parts, lut_j)
            torch.cuda.synchronize()
            assert LAUNCHES["seed_bad_mask"] == before + (len(sub) > 0)
            assert got.dtype == torch.bool and torch.equal(got, seed_bad_mask_plain(sub, parts, lut_j))
    assert got.any() or nq < 16


def _windows(text, rng, case, m, k):
    """Candidate starts whose windows text[p, p + m + k) (p = base + d) split
    K3's two loops: ``mixed`` all over the text and beyond its ends,
    ``sentinel`` with an inter-sequence sentinel in the window's middle,
    ``edges`` starting before 0 or ending past n, ``clean`` inside [0, n)
    with no sentinel (the fast loop for every start)."""
    n = len(text)
    if case == "mixed":
        return np.r_[-m - 5, -3, n - 10, n + 3, rng.integers(-20, n, 3000)]
    if case == "sentinel":
        zeros = np.flatnonzero(text == 0)
        return rng.choice(zeros, 2000) - m // 2 + rng.integers(-m // 3, m // 3 + 1, 2000)
    if case == "edges":
        return np.r_[rng.integers(-m - 3 * k - 5, 1, 1000), rng.integers(n - m - 3 * k - 5, n + 5, 1000)]
    zero_before = np.r_[0, np.cumsum(text == 0)]
    span = m + 3 * k  # every start p = base + d, d <= 2k, reads text[p, p + m + k)
    ok = np.flatnonzero(zero_before[span:] == zero_before[:-span])
    return rng.choice(ok, 2000)


@pytest.mark.parametrize("case", ["mixed", "sentinel", "edges", "clean"])
@pytest.mark.parametrize("edit,k", [(True, 0), (True, 1), (True, 2), (True, 3), (True, 4), (True, 5), (True, 6),
                                    (True, 7), (False, 2)])
def test_verify_kernel_matches_plain(host, edit, k, case):
    dev = _card()
    idx_host, seqs = host
    index = DeviceIndex.from_host(idx_host, device=dev)
    rng = np.random.default_rng(4 + k)
    text = unpack_text4(idx_host.text4, idx_host.n)
    for m in (40, 37):  # 37: rows and query chars not a multiple of 4 or 8
        base = _windows(text, rng, case, m, k)
        # half the queries cut from the text at their candidate, with edits
        q = _reads(seqs, rng, len(base), m, k)
        shift = k if edit else 0  # the start d = k is the candidate's own
        own = np.flatnonzero((base >= 0) & (base + shift + m <= idx_host.n))[::2]
        q[own] = text[base[own, None] + shift + np.arange(m)]
        q[own, rng.integers(0, m, len(own))] = rng.integers(1, 5, len(own))
        q = q.clip(1, 5)
        # an odd offset: query rows start off 4-byte alignment
        flat = torch.zeros(q.size + 3, dtype=torch.uint8, device=dev)
        qd = flat[3:].view(q.shape)
        qd.copy_(torch.from_numpy(q))
        args = (index.text4, index.n, qd, torch.arange(len(base), dtype=torch.int32, device=dev),
                torch.from_numpy(base.astype(np.int32)).to(dev), k, edit)
        got = verify(*args)
        torch.cuda.synchronize()
        want = verify_plain(*args)
        assert torch.equal(got, want)
        assert (want <= k).any() or case in ("sentinel", "edges")


def _hamming_case(text, rng, case, m, cnt):
    """(starts int64[cnt], queries uint8[cnt, m]) for K3h: ``clean``
    windows inside the text, ``edges`` past either end, ``tail`` with a
    sentinel in the window's last partial word of 8, ``n`` queries with N
    and ``wide`` queries with bytes of 16 and more (the fast loop hands
    those to the general one).  Half the queries are cut from the text at
    their window, with a substitution."""
    n = len(text)
    if case == "edges":
        base = np.r_[rng.integers(-m - 5, 1, cnt // 2), rng.integers(n - m - 5, n + 5, cnt - cnt // 2)]
    elif case == "tail":
        last = 8 * ((m - 1) // 8)  # the first char of the window's last word
        base = rng.choice(np.flatnonzero(text == 0), cnt) - rng.integers(last, m, cnt)
    else:
        base = rng.integers(0, n - m + 1, cnt)
    q = rng.integers(1, 5, (cnt, m)).astype(np.uint8)
    own = np.flatnonzero((base >= 0) & (base + m <= n))[::2]
    q[own] = text[base[own, None] + np.arange(m)]
    q[own, rng.integers(0, m, len(own))] = rng.integers(1, 5, len(own))
    if case == "n":
        q[rng.integers(0, cnt, cnt), rng.integers(0, m, cnt)] = 5
    elif case == "wide":
        q[rng.integers(0, cnt, cnt // 8), rng.integers(0, m, cnt // 8)] = rng.integers(16, 256, cnt // 8)
    return base, q


def _hamming_check(index, base, q):
    """K3h against its plain version, the queries' rows off 4-byte alignment."""
    dev = index.device
    flat = torch.zeros(q.size + 3, dtype=torch.uint8, device=dev)
    qd = flat[3:].view(q.shape)
    qd.copy_(torch.from_numpy(q))
    args = (index.text4, index.n, qd, torch.arange(len(base), dtype=torch.int32, device=dev),
            torch.from_numpy(base.astype(np.int32)).to(dev), 0, False)
    before = LAUNCHES["verify"]
    got = verify(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["verify"] == before + 1
    want = verify_plain(*args)
    assert torch.equal(got, want)
    return want


@pytest.mark.parametrize("case", ["clean", "edges", "tail", "n", "wide"])
def test_hamming_kernel_matches_plain_every_m(host, case):
    """K3h for every m from 1 to 150 on 600 candidates: the launch takes 1
    lane a candidate up to m = 8 and 8 from m = 33, so every lane count
    runs."""
    dev = _card()
    idx_host, _ = host
    index = DeviceIndex.from_host(idx_host, device=dev)
    text = unpack_text4(idx_host.text4, idx_host.n)
    rng = np.random.default_rng(21 + len(case))
    lanes, hits = set(), 0
    for m in range(1, 151):
        base, q = _hamming_case(text, rng, case, m, 600)
        want = _hamming_check(index, base, q)
        lanes.add(hamming_lanes(len(base), m))
        hits += int((want[:, 0] <= 2).sum())
    assert lanes == {1, 2, 4, 8}
    assert hits > 0 or case in ("edges", "tail")


def test_hamming_kernel_every_lane_count_at_m150(host):
    """K3h at m = 150 on batches from 64 to 262,144 candidates, one for
    each lane count the launch picks, windows all over the text and past
    its ends."""
    dev = _card()
    idx_host, _ = host
    index = DeviceIndex.from_host(idx_host, device=dev)
    text = unpack_text4(idx_host.text4, idx_host.n)
    rng = np.random.default_rng(22)
    m, by_lanes = 150, {}
    for cnt in (1 << e for e in range(6, 19)):
        by_lanes.setdefault(hamming_lanes(cnt, m), cnt)
    assert set(by_lanes) == {1, 2, 4, 8}
    for cnt in by_lanes.values():
        base, q = _hamming_case(text, rng, "clean", m, cnt)
        base[::7] = rng.integers(-m, len(text) + 1, len(base[::7]))
        _hamming_check(index, base, q)


def test_seed_scan_kernel_shares_rows(host):
    """Lanes whose interval ends share an occ row, lanes that straddle a row
    boundary and empty lanes (lo == hi), at every step of the scan."""
    dev = _card()
    idx_host, seqs = host
    index = DeviceIndex.from_host(idx_host, device=dev)
    rng = np.random.default_rng(13)
    m = 39  # 13-char parts: the first steps after the table keep wide intervals
    q = _reads(seqs, rng, 3000, m, 2)
    q[:300] = rng.integers(1, 5, (300, m))  # mostly empty
    q[300:600, : m // 2] = q[300:600, m // 2 : 2 * (m // 2)]  # repeated halves
    q[600:650, 5] = 5  # N: a clamped table code
    q[650:660, -1] = 0  # a sentinel rank
    parts = plan_parts(m, 2)
    qd = torch.from_numpy(q).to(dev)
    for lut, lut_j in ((index.lut, index.lut_j), (None, 0)):
        args = (index.occ, index.c_arr, lut, lut_j, qd, parts, index.sigma, index.n)
        lo, sz = seed_scan(*args)
        torch.cuda.synchronize()
        lo_p, sz_p = seed_scan_plain(*args)
        assert torch.equal(lo, lo_p) and torch.equal(sz, sz_p)
        # the interval before each step: the plain scan of the part suffixes
        same = straddle = empty = 0
        for t in range(lut_j, min(ln for _, ln in parts)):
            lo_t, sz_t = seed_scan_plain(index.occ, index.c_arr, lut, lut_j, qd,
                                         [(off + ln - t, t) for off, ln in parts], index.sigma, index.n)
            one_row = (lo_t >> 5) == ((lo_t + sz_t) >> 5)
            same += int((one_row & (sz_t > 0)).sum())
            straddle += int((~one_row).sum())
            empty += int((sz_t == 0).sum())
        assert same > 0 and straddle > 0 and empty > 0


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


@pytest.fixture(scope="module")
def bihost():
    rng = np.random.default_rng(78)
    seqs = [rng.integers(1, 5, int(rng.integers(200, 1500))).astype(np.uint8) for _ in range(12)]
    seqs[4][:300] = seqs[1][-300:]  # a repeat
    seqs[7][50] = 5  # an N in the text: sigma_live = 6
    return build_bifmindex(seqs, 6, "d_dna5"), seqs


@pytest.mark.parametrize("kw", [dict(), dict(engine="approx", generator_name="optimum"),
                                dict(engine="approx", generator_name="optimum", s_cap=2, h_cap=1)],
                         ids=["sv", "frontier", "frontier_ladder"])
def test_sync_spans_count_every_synchronizing_operation(bihost, kw):
    """PyTorch's sync debug mode warns at each operation that synchronises
    the host with the card.  In one seed-and-verify call and one frontier
    call (and one whose chunks climb the retry ladder at different caps)
    each warning comes inside a ``sync`` span, and there are as many spans
    as warnings."""
    dev = _card()
    idx_host, seqs = bihost
    index = DeviceIndex.from_host(idx_host, device=dev)
    queries = _reads(seqs, np.random.default_rng(9), 600, 50, 2)
    args = dict(k=2, chunk=128, **kw)
    want = search_queries(index, queries, **args)  # builds the kernels and warms PyTorch's
    torch.cuda.synchronize()
    timer, seen = trace.StageTimer(dev), []

    def note(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            current = trace._SPAN.get()
            ours = [f for f in traceback.extract_stack() if "sahara_tpu_torch" in f.filename]
            where = f"{os.path.basename(ours[-1].filename)}:{ours[-1].lineno}" if ours else f"{filename}:{lineno}"
            seen.append((where, None if current is None else current.name))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = search_queries(index, queries, timer=timer, **args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    rep = timer.report()
    spans = rep["spans"]["sync"]["count"]
    outside = Counter(where for where, name in seen if name != "sync")
    assert not outside and spans == len(seen), (outside, spans, Counter(where for where, _ in seen), rep["sites"])
    assert got.rows() == want.rows() and len(want.rows()) >= 600
    if kw.get("s_cap") == 2:
        assert rep["counters"]["approx.queries_retried"] > 0 and "frontier.caps_check" in rep["sites"]


def test_rank_all_smem_kernel_matches_plain(bihost):
    dev = _card()
    idx_host, _ = bihost
    index = DeviceIndex.from_host(idx_host, device=dev, include_rev=False)
    idx = torch.from_numpy(np.r_[0, idx_host.n, np.random.default_rng(6).integers(0, idx_host.n, 300_000)]
                           .astype(np.int32)).to(dev)
    before = LAUNCHES["rank_all_smem"]
    got = rank_all_smem(index.occ, index.sigma, idx)
    torch.cuda.synchronize()
    assert LAUNCHES["rank_all_smem"] == before + 1
    assert torch.equal(got, rank_all_smem_plain(index.occ, index.sigma, idx))


def test_rank_all_smem_refuses_a_large_table():
    dev = _card()
    occ16 = torch.zeros((4000, 16), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        rank_all_smem(occ16, 6, torch.zeros(8, dtype=torch.int32, device=dev))


# batch sizes around a warp, a K1 thread's and a K4 CTA's share, and past
# one sweep of K4's whole grid ("grid+7": 1,024 x the grid's CTAs + 7)
RANK_BATCHES = [1, 31, 33, 1023, 1025, "grid+7", 300_000]


def _random_rank_inputs(rows, n, sigma, seed, dev):
    """A random int32 occ16 table (the rank function is defined for any
    table, so no index build is needed) and n positions in [0, 32 rows),
    0 and 32 rows - 1 among them."""
    rng = np.random.default_rng(seed)
    occ16 = np.zeros((rows, 16), dtype=np.int32)
    occ16[:, : 2 * sigma] = rng.integers(-(2**31), 2**31, size=(rows, 2 * sigma), dtype=np.int64)
    if n == "grid+7":
        n = 1024 * launch_shape(1 << 30, sigma)["ctas"] + 7
    idx = rng.integers(0, 32 * rows, size=n).astype(np.int32)
    idx[0], idx[-1] = 0, 32 * rows - 1
    return torch.from_numpy(occ16).to(dev), torch.from_numpy(idx).to(dev)


@pytest.mark.parametrize("sigma", range(2, 9))
@pytest.mark.parametrize("n", RANK_BATCHES)
def test_rank_all_kernel_on_random_tables(n, sigma):
    dev = _card()
    occ16, idx = _random_rank_inputs(40_000, n, sigma, 100 + sigma, dev)
    got = rank_all(occ16, sigma, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, rank_all_plain(occ16, sigma, idx))


@pytest.mark.parametrize("sigma", range(2, 9))
@pytest.mark.parametrize("n", RANK_BATCHES)
def test_rank_all_smem_kernel_on_random_tables(n, sigma):
    dev = _card()
    occ16, idx = _random_rank_inputs(SMEM_LIMIT // occ16_smem_bytes(1), n, sigma, 200 + sigma, dev)
    got = rank_all_smem(occ16, sigma, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, rank_all_smem_plain(occ16, sigma, idx))


# 1 row; 5 and 3,127 rows (odd: the cluster's slices of the table end
# inside a row); the largest table K4 takes; one row more must be refused
@pytest.mark.parametrize("rows", [1, 5, 3127, SMEM_LIMIT // 64, SMEM_LIMIT // 64 + 1])
def test_rank_all_smem_kernel_table_sizes(rows):
    dev = _card()
    occ16, idx = _random_rank_inputs(rows, 5000, 6, rows, dev)
    if occ16_smem_bytes(rows) > SMEM_LIMIT:
        with pytest.raises(ValueError, match="shared memory"):
            rank_all_smem(occ16, 6, idx)
        return
    got = rank_all_smem(occ16, 6, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, rank_all_smem_plain(occ16, 6, idx))


def test_rank_all_smem_launch_shape():
    """The card's table budget is the wrapper's, and the grid is whole
    clusters, at most one CTA per SM."""
    _card()
    shape = launch_shape(1 << 30, 6)
    assert shape["table_budget"] == SMEM_LIMIT
    assert shape["cluster_ctas"] in (2, 4)
    assert shape["ctas"] % shape["cluster_ctas"] == 0
    assert 0 < shape["ctas"] <= torch.cuda.get_device_properties(0).multi_processor_count
    assert launch_shape(1, 6)["ctas"] == shape["cluster_ctas"]


def _record_steps(index, queries, tape, *, edit, k, cap, monkeypatch, check=None):
    """Run one work-queue search (dedup on) and return every step's
    (context, input queue, drain, pre-step hit counts); ``check`` sees each
    step before it runs."""
    dev = index.device
    steps = []
    expand_step = workq.expand_step

    def recorded(ctx, state, *, drain=False):
        if check is not None:
            check(ctx, state, drain)
        steps.append((ctx, state, drain, None if ctx.hq_counts is None else ctx.hq_counts.clone()))
        return expand_step(ctx, state, drain=drain)

    monkeypatch.setattr(workq, "expand_step", recorded)
    workq.workq_search(index, torch.from_numpy(queries).to(dev), workq.upload_tape(tape, dev),
                       torch.ones(len(queries), dtype=torch.bool, device=dev), edit=edit, k=k,
                       ph0=workq.phase0_length(tape, edit), dedup_every=workq.DEDUP_EVERY, cap_per_query=cap)
    monkeypatch.undo()
    return steps


@pytest.mark.parametrize("cap", [0, 1])
@pytest.mark.parametrize("edit", [True, False])
def test_workq_step_kernels_match_plain(bihost, monkeypatch, edit, cap):
    """K5's one-launch step against its plain version at every step of a
    real search, drain steps and the in-search cap included."""
    dev = _card()
    idx_host, seqs = bihost
    index = DeviceIndex.from_host(idx_host, device=dev)
    queries = _reads(seqs, np.random.default_rng(8), 400, 40, 2)
    queries[::9, 7] = 5  # N in some reads
    tape = compile_tape(load_scheme("h2-k2", 0, 2, 40, edit=edit, sigma=6, n_text=idx_host.n))
    seen = dict(drains=0, children=0, hits=0)

    def check(ctx, state, drain):
        before = LAUNCHES["workq_step"]
        got = workq_step(ctx, *state, drain=drain)
        torch.cuda.synchronize()
        assert LAUNCHES["workq_step"] == before + 1
        want = workq_step_plain(ctx, *state, drain=drain)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        seen.update(drains=seen["drains"] + drain, children=seen["children"] + len(got[0]),
                    hits=seen["hits"] + got[4].shape[1])

    _record_steps(index, queries, tape, edit=edit, k=2, cap=cap, monkeypatch=monkeypatch, check=check)
    assert seen["drains"] > 0 and seen["children"] > 0 and seen["hits"] > 0


def test_workq_step_look_back_over_many_tiles(bihost, monkeypatch):
    """Queues of over 1,000 tiles (a real queue repeated): the look-back
    chains every tile's offsets, for children and for hits.  The first
    launch also wraps the epoch tag and the ticket counter."""
    dev = _card()
    idx_host, seqs = bihost
    index = DeviceIndex.from_host(idx_host, device=dev)
    queries = _reads(seqs, np.random.default_rng(12), 400, 40, 2)
    tape = compile_tape(load_scheme("h2-k2", 0, 2, 40, edit=True, sigma=6, n_text=idx_host.n))
    steps = _record_steps(index, queries, tape, edit=True, k=2, cap=3, monkeypatch=monkeypatch)
    widest = max((s for s in steps if not s[2]), key=lambda s: s[1][2].shape[0])
    drains = [s for s in steps if s[2]]
    ctx = widest[0]
    ctx.epoch, ctx.tickets = EPOCHS - 1, (1 << 32) - 3
    ctx.counters[2] = -3
    for ctx, state, drain, counts in (widest, max(drains, key=lambda s: s[1][2].shape[0])):
        reps = -(-1000 * TILE // state[2].shape[0]) + 1
        big = tuple(x.repeat(reps) for x in state)
        ctx.hq_counts.copy_(counts)
        got = workq_step(ctx, *big, drain=drain)
        want = workq_step_plain(ctx, *big, drain=drain)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert big[2].shape[0] > 1000 * TILE and len(got[0]) > 0 and (got[4].shape[1] > 0) == drain


def dedup_queue(rng, n: int, layout, *, ns: int, m: int, dead: float = 0.1):
    """A work-queue of n rows for the dedup and a lane tape it can read:
    (lb, lbr, sz, meta, tape), int32 numpy arrays.  Rows draw their cursor
    (lb, lbr, sz, d, s, q) from a pool of about n / 4, so many share one, at
    equal and lower err and with other op and edge flags; q spans the
    layout's whole field, its top bit (the meta word's sign) included; a
    share ``dead`` of rows has sz 0.  The tape holds a word for every lane
    q * ns + s the layout can hold, each with a random largest-lower-bound
    field (bits 17-20), for ``m`` tape positions."""
    pool = max(n // 4, 1)
    lb, lbr = rng.integers(0, 1 << 30, pool), rng.integers(0, 1 << 30, pool)
    size = rng.integers(1, 1000, pool)
    d, s = rng.integers(0, 1 << layout.d_bits, pool), rng.integers(0, 1 << layout.s_bits, pool)
    q = rng.integers(0, layout.max_nq, pool)
    pick = rng.integers(0, pool, n)
    opf = np.zeros(n, dtype=np.int64)
    if layout.opf_bits:
        opf = rng.integers(0, 3, n) | (rng.integers(0, 4, n) << 2)  # op | edge flags
    meta = (opf | (rng.integers(0, 1 << layout.err_bits, n) << layout.err_shift) | (d[pick] << layout.d_shift)
            | (s[pick] << layout.s_shift) | (q[pick] << layout.q_shift))
    sz = np.where(rng.random(n) < dead, 0, size[pick])
    tape = rng.integers(0, 1 << 21, (layout.max_nq * ns + (1 << layout.s_bits)) * m)
    return (*(x.astype(np.int32) for x in (lb[pick], lbr[pick], sz)), meta.astype(np.uint32).view(np.int32),
            tape.astype(np.int32))


def _check_dedup(ctx, queue):
    """The dedup kernel's sz against its plain version's, bit for bit, on
    one queue, and the kills it adds to ``ctx.counters[3]`` against the
    plain version's count; returns that count."""
    before, kills, plain_kills = LAUNCHES["workq_dedup"], int(ctx.counters[3]), ctx.dedup_kills
    got = workq_dedup(ctx, *queue)
    torch.cuda.synchronize()
    assert LAUNCHES["workq_dedup"] == before + 1
    assert torch.equal(got, workq_dedup_plain(ctx, *queue))
    assert int(ctx.counters[3]) - kills == ctx.dedup_kills - plain_kills
    return ctx.dedup_kills - plain_kills


# opf | err | d | s | q: edit (q takes 13 bits) and Hamming (17 bits, no op or edge flags)
DEDUP_LAYOUTS = [workq.MetaLayout(4, 3, 9, 3), workq.MetaLayout(0, 3, 9, 3)]


@pytest.mark.parametrize("dead", [0.1, 1.0], ids=["live", "dead"])
@pytest.mark.parametrize("n", [1, 2, 256, 257, 65536, 65537])
@pytest.mark.parametrize("layout", DEDUP_LAYOUTS, ids=["edit", "hamming"])
def test_workq_dedup_kernel_matches_plain(layout, n, dead):
    """Queues whose rows share cursors at equal and lower err and with
    other op and edge flags, query ids filling the meta word's top bit; at
    the hash table's and the tiles' edges; and every row dead.  A second
    call finds the first call's entries in the table."""
    dev = _card()
    lb, lbr, sz, meta, tape = dedup_queue(np.random.default_rng(n), n, layout, ns=2, m=3, dead=dead)
    ctx = step_context(torch.zeros((1, 16), dtype=torch.int32, device=dev),
                       torch.zeros(8, dtype=torch.int32, device=dev), torch.from_numpy(tape).to(dev), sigma=6, sl=5,
                       edit=layout.opf_bits > 0, m=3, ns=2, rev_off=0, layout=layout, max_rows=n)
    queue = tuple(torch.from_numpy(x).to(dev) for x in (lb, lbr, sz, meta))
    kills = _check_dedup(ctx, queue)
    assert _check_dedup(ctx, queue) == kills
    if dead == 1.0:
        assert kills == 0
    elif n >= 256:
        assert kills > 0 and (meta[sz > 0] < 0).any()


@pytest.mark.parametrize("edit", [True, False])
def test_workq_dedup_kernel_on_search_queues(bihost, monkeypatch, edit):
    """The dedup kernel against its plain version on every queue of a real
    search (h2-k2, N in some reads), in the search's own layout, and on
    each queue followed by a copy of itself, whose rows die against the
    first copy's (a Hamming search makes no duplicate cursors of its own).
    One context serves every call, its table growing, and its tags wrap."""
    dev = _card()
    idx_host, seqs = bihost
    index = DeviceIndex.from_host(idx_host, device=dev)
    queries = _reads(seqs, np.random.default_rng(13), 400, 40, 2)
    queries[::9, 7] = 5
    tape = compile_tape(load_scheme("h2-k2", 0, 2, 40, edit=edit, sigma=6, n_text=idx_host.n))
    steps = _record_steps(index, queries, tape, edit=edit, k=2, cap=0, monkeypatch=monkeypatch)
    ctx = steps[0][0]
    assert all(c is ctx for c, _, _, _ in steps)
    kills = sum(_check_dedup(ctx, state) for _, state, _, _ in steps)
    assert len(steps) > 40 and (kills > 0) == edit
    ctx.dedup_table = torch.zeros(1 << 24, dtype=torch.int64, device=dev)  # every queue below fits: no new table
    ctx.dedup_epoch = (1 << 32) - 3
    for _, state, _, _ in steps:
        twice = tuple(torch.cat([x, x]) for x in state)
        assert _check_dedup(ctx, twice) > 0 or not (state[2] > 0).any()
    assert ctx.dedup_epoch == len(steps) - 2  # the tags wrapped at the third call


@pytest.mark.parametrize("edit", [True, False])
def test_workq_search_on_card_matches_cpu(bihost, edit):
    dev = _card()
    idx_host, seqs = bihost
    queries = _reads(seqs, np.random.default_rng(9), 300, 30, 2)
    queries[::7, 3] = 5
    tape = compile_tape(load_scheme("optimum", 0, 2, 30, edit=edit, sigma=6, n_text=idx_host.n))
    runs, kills = [], []
    before = LAUNCHES["workq_dedup"]
    for d in ("cpu", dev):
        index = DeviceIndex.from_host(idx_host, device=d)
        timer = trace.StageTimer(d)
        with trace.tracing(timer):
            hits = workq.run_workq_search(index, queries, tape, edit=edit, dedup=True)
        runs.append(sorted(zip(hits.lane.tolist(), hits.lb.tolist(), hits.sz.tolist(), hits.err.tolist())))
        kills.append(timer.report()["counters"]["workq.dedup_kills"])
    assert runs[0] == runs[1] and len(runs[0]) >= 250
    assert LAUNCHES["workq_dedup"] > before
    assert kills[0] == kills[1] and (kills[0] > 0) == edit


def test_fallback_on_card_matches_cpu(bihost):
    """N reads leave seed-and-verify for the work-queue engine on the card."""
    dev = _card()
    idx_host, seqs = bihost
    queries = _reads(seqs, np.random.default_rng(10), 400, 50, 2)
    queries[::8, 16] = 5  # the last char of the first part: the j-mer table cannot seed it
    want = search_queries(DeviceIndex.from_host(idx_host, device="cpu"), queries, k=2, device="cpu", chunk=128)
    before, masks = LAUNCHES["workq_step"], LAUNCHES["seed_bad_mask"]
    got = search_queries(DeviceIndex.from_host(idx_host, device=dev), queries, k=2, chunk=128)
    assert LAUNCHES["workq_step"] > before and LAUNCHES["seed_bad_mask"] == masks + 1  # one mask a call
    assert got.rows() == want.rows() and len(want.rows()) >= 400


@pytest.fixture(scope="module")
def cli_corpus(tmp_path_factory):
    """A three-sequence reference, its three indexes (bidirectional, single
    and kmer: --kmer 3 --window 4, sigma 32) and 40 simulated reads of 80
    chars with 2 planted edits (40 with 2 substitutions, for Hamming
    distance; 40 error-free, for exact search), all through the port's
    CLI."""
    tmp = tmp_path_factory.mktemp("cli_gpu")
    rng = np.random.default_rng(11)
    ref = str(tmp / "ref.fasta")
    write_fasta(ref, [FastaRecord(id=f"chr{i}", seq=bytes(b"ACGT"[j] for j in rng.integers(0, 4, size=n)))
                      for i, n in enumerate((3000, 1500, 800))])
    with contextlib.redirect_stdout(io.StringIO()):
        for name, errors in (("reads", ["-e", "2"]), ("subs", ["--substitution_errors", "2"]), ("exact", ["-e", "0"])):
            assert cli_main(["read_simulator", "-i", ref, "-o", str(tmp / f"{name}.fasta"), "-n", "40", "-l", "80",
                             "--seed", "5"] + errors) == 0
        assert cli_main(["index", ref]) == 0
        assert cli_main(["uni-index", ref]) == 0
        assert cli_main(["kmer-index", ref, "--kmer", "3", "--window", "4"]) == 0
    return tmp, ref


@pytest.mark.parametrize("reads,flags,kernel", [
    ("reads", ["-e", "2", "-d", "lev", "-g", "h2-k2"], "verify"),
    ("subs", ["-e", "2", "-d", "ham", "-g", "optimum"], "verify"),
    ("reads", ["-e", "2", "-d", "lev", "-g", "optimum", "--engine", "workq"], "workq_step"),
], ids=["edit", "hamming", "workq"])
def test_cli_search_on_card_matches_cpu(cli_corpus, reads, flags, kernel):
    _card()
    tmp, ref = cli_corpus
    reads = str(tmp / f"{reads}.fasta")
    outs = {}
    for device in ("cpu", "cuda"):
        outs[device] = str(tmp / f"{kernel}_{len(flags)}_{device}.txt")
        before = LAUNCHES[kernel]
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli_main(["search", "-q", reads, "-i", ref + ".idx", "-o", outs[device], "--device", device]
                            + flags) == 0
        assert (LAUNCHES[kernel] > before) == (device == "cuda")
    with open(outs["cpu"]) as a, open(outs["cuda"]) as b:
        want = a.read()
        assert b.read() == want and len(want.splitlines()) >= 40


@pytest.mark.parametrize("argv,kernels", [
    (["uni-search", "-q", "{tmp}/exact.fasta", "-i", "{ref}.single.idx"], ("exact_search",)),
    (["kmer-search", "--query", "{tmp}/exact.fasta", "--index", "{ref}.kmer.idx"], ("exact_search", "lf_walk")),
], ids=["uni-search", "kmer-search"])
def test_exact_cli_on_card_matches_cpu(cli_corpus, argv, kernels):
    _card()
    tmp, ref = cli_corpus
    outs = {}
    for device in ("cpu", "cuda"):
        outs[device] = str(tmp / f"{argv[0]}_{device}.txt")
        before = {k: LAUNCHES[k] for k in kernels}
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli_main([a.format(tmp=tmp, ref=ref) for a in argv] + ["-o" if argv[0] == "uni-search" else
                                                                          "--output", outs[device],
                                                                          "--device", device]) == 0
        assert all((LAUNCHES[k] > before[k]) == (device == "cuda") for k in kernels)
    with open(outs["cpu"]) as a, open(outs["cuda"]) as b:
        want = a.read()
        assert b.read() == want and len(want.splitlines()) >= 40


@pytest.fixture(scope="module", params=[6, 17, 32, 128])
def exact_host(request):
    """A host index over symbols 1..sigma-1 (DNA ranks at sigma 6, occ16
    rows; wide rows at 17, 48 int32 with the bit words off a 16 B boundary,
    and at 32 and 128), a repeat and a stretch of DNA ranks 1..4 (for the
    j-mer table start) in it, and its sequences."""
    sigma = request.param
    rng = np.random.default_rng(90 + sigma)
    seqs = [rng.integers(1, sigma, int(rng.integers(500, 3000))).astype(np.uint8) for _ in range(20)]
    seqs[3][:400] = seqs[2][-400:]
    seqs[5][:300] = rng.integers(1, 5, 300)
    return build_fmindex(seqs, sigma, "d_dna5" if sigma == 6 else f"kmer{sigma}"), seqs


def _scan_lut(index, j):
    """The j-mer table by the plain full scan of every code's j symbols
    (digit d, plus 1, is the d-th symbol consumed), on any row width."""
    d = torch.arange(j, device=index.occ.device)
    codes = torch.arange(4**j, device=index.occ.device)
    q = (((codes[:, None] >> (2 * d)) & 3) + 1).flip(1).to(torch.uint8).contiguous()
    lb, ln = exact_search_plain(index.occ, index.c_arr, q, torch.full_like(codes, j, dtype=torch.int32),
                                index.sigma, index.n)
    return torch.cat([lb, lb + ln])


def _exact_queries(seqs, sigma, rng):
    """Substrings of 1-60 symbols, substrings of the DNA stretch, random
    strings, queries at the edges of the j-mer table start (lengths 0 to
    12 ending in the DNA stretch; N (5), $ (0) or sigma placed at each of
    the last 12 symbols of a DNA substring, inside and just outside the
    table's window at any j up to 11; absent DNA strings), a zero-length
    query (its interval stays [0, n): rb = n at every step of the others'
    first), a query of symbols at and above sigma (clamped to sigma - 1),
    and a length past the matrix width (clamped to it)."""
    out = []
    for _ in range(3000):
        s = seqs[int(rng.integers(0, len(seqs)))]
        ln = int(rng.integers(1, 61))
        p = int(rng.integers(0, max(len(s) - ln, 1)))
        out.append(s[p : p + ln])
    dna = seqs[5][:300]
    for _ in range(500):
        ln = int(rng.integers(1, 61))
        p = int(rng.integers(0, 300 - ln))
        out.append(dna[p : p + ln])
    out += [rng.integers(1, sigma, int(rng.integers(1, 40))).astype(np.uint8) for _ in range(500)]
    out += [dna[200 - ln : 200] for ln in range(13)]
    for sym in sorted({5, 0, min(sigma, 255)}):
        for at in range(1, 13):
            q = dna[150:190].copy()
            q[-at] = sym
            out.append(q)
    out += [rng.integers(1, 5, int(rng.integers(10, 40))).astype(np.uint8) for _ in range(100)]
    out += [np.zeros(0, dtype=np.uint8), np.array([sigma - 1, sigma, 255, 1], dtype=np.uint8)]
    width = max(len(q) for q in out)
    q = np.zeros((len(out), width), dtype=np.uint8)
    lens = np.array([len(x) for x in out], dtype=np.int32)
    for i, x in enumerate(out):
        q[i, : len(x)] = x
    lens[-1] = width + 5
    return q, lens


@pytest.mark.parametrize("use_lut", [True, False])
def test_exact_search_kernel_matches_plain(exact_host, use_lut):
    """K6 against the plain full scan, with the j-mer table start (the
    index's own table at sigma 6, built by K1, which must equal the scan's;
    a table by the scan at the wide rows) and without it."""
    dev = _card()
    host, seqs = exact_host
    index = DeviceIndex.from_host(host, device=dev)
    q, lens = _exact_queries(seqs, host.sigma, np.random.default_rng(1))
    args = (index.occ, index.c_arr, torch.from_numpy(q).to(dev), torch.from_numpy(lens).to(dev), index.sigma, index.n)
    j = pick_lut_j(index.n)
    table = (None, 0)
    if use_lut:
        table = (_scan_lut(index, j), j)
        assert (index.lut is not None) == (host.sigma == 6)
        if index.lut is not None:
            assert index.lut_j == j and torch.equal(index.lut, table[0])
        skip = table_start(args[2].long(), args[3].long().clamp(0, q.shape[1]), *table, index.sigma, index.n)[2]
        assert skip.any() and not skip.all()
    before = LAUNCHES["exact_search"]
    lb, ln = exact_search(*args, *table)
    torch.cuda.synchronize()
    assert LAUNCHES["exact_search"] == before + 1
    lb_p, ln_p = exact_search_plain(*args)
    assert torch.equal(lb, lb_p) and torch.equal(ln, ln_p)
    assert (lb[-2].item(), ln[-2].item()) == (0, index.n)
    assert (ln > 1).any() and (ln == 0).any()
    with pytest.raises(TypeError):
        exact_search(args[0], args[1], args[2], args[3].long(), index.sigma, index.n)
    if use_lut:
        with pytest.raises(ValueError, match="j-mer table"):
            exact_search(*args, table[0][1:], j)


def test_exact_search_kernel_wide_queries():
    """Queries of up to 8,000 chars (2,000 query words a thread, read
    backwards) against the plain scan, with the table."""
    dev = _card()
    rng = np.random.default_rng(5)
    seqs = [rng.integers(1, 5, 40000).astype(np.uint8)]
    index = DeviceIndex.from_host(build_fmindex(seqs, 6, "d_dna5"), device=dev)
    q = np.stack([seqs[0][p : p + 8000] for p in rng.integers(0, 32000, 300)])
    lens = rng.integers(0, 8001, 300).astype(np.int32)
    q[np.arange(0, 300, 3), np.maximum(lens[::3] - 3, 0)] = 5  # an N in every third query's table window
    args = (index.occ, index.c_arr, torch.from_numpy(q).to(dev), torch.from_numpy(lens).to(dev), index.sigma, index.n)
    got = exact_search(*args, index.lut, index.lut_j)
    assert all(torch.equal(a, b) for a, b in zip(got, exact_search_plain(*args)))


def test_lf_walk_kernel_matches_plain(exact_host):
    """Every SA row of the text (hit rows, rows already sampled, rows of
    sentinels), through K7 and through the plain fixed-trip walk."""
    dev = _card()
    host, _ = exact_host
    index = DeviceIndex.from_host(host, device=dev, full_sa=False)
    rows = torch.arange(index.n, dtype=torch.int32, device=dev)
    args = (index.occ, index.c_arr, index.sampled, index.sample_seq, index.sample_pos, index.sigma, index.rate, rows)
    before = LAUNCHES["lf_walk"]
    seq_id, pos = lf_walk(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["lf_walk"] == before + 1
    want_seq, want_pos = lf_walk_plain(*args)
    assert torch.equal(seq_id, want_seq) and torch.equal(pos, want_pos)
    steps = torch.zeros_like(rows)  # each row's walk, by the plain LF step
    live = torch.ones_like(rows, dtype=torch.bool)
    for _ in range(index.rate):
        live &= sampled_bit(index.sampled, rows) == 0
        steps += live
        rows = torch.where(live, lf(index.occ, index.c_arr, index.sigma, rows), rows)
    assert (steps == 0).any() and (steps == index.rate - 1).any()  # rows already sampled, the longest walks
    with pytest.raises(TypeError):
        lf_walk(*args[:-1], rows.long())


def test_exact_locate_on_card_matches_cpu(exact_host):
    """exact search + locate (sampled walk) on the card against the CPU."""
    dev = _card()
    host, seqs = exact_host
    q, lens = _exact_queries(seqs, host.sigma, np.random.default_rng(2))
    got, want = (locate(ix, *engine_exact_search(ix, q[:-2], lens[:-2]))
                 for ix in (DeviceIndex.from_host(host, device=dev, full_sa=False),
                            DeviceIndex.from_host(host, device="cpu", full_sa=False)))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want)) and want[0].shape[0] >= 3000


@pytest.fixture(scope="module", params=[(6, False), (5, False), (6, True)], ids=["sigma6", "sigma5", "mirrored"])
def frontier_host(request):
    """A bidirectional index at sigma 6 (DNA with N) or 5 (DNA), or a
    mirrored one (each sequence and its reverse), and reads of 40 chars."""
    sigma, mirrored = request.param
    rng = np.random.default_rng(79)
    seqs = [rng.integers(1, 5, int(rng.integers(200, 1500))).astype(np.uint8) for _ in range(10)]
    seqs[4][:300] = seqs[1][-300:]  # a repeat
    queries = _reads(seqs, rng, 300, 40, 2)
    if mirrored:
        seqs = seqs + [x[::-1].copy() for x in seqs]
    alphabet = "d_dna5" if sigma == 6 else "d_dna4"
    return build_bifmindex(seqs, sigma, alphabet, mirrored=mirrored), seqs, queries


@pytest.mark.parametrize("edit,caps", [(True, (64, 32)), (False, (64, 32)), (True, (2, 1))],
                         ids=["edit", "hamming", "overflow"])
def test_frontier_step_kernel_matches_plain(frontier_host, monkeypatch, edit, caps):
    """K8 against its plain version at every step of a real search in
    chunks of 64 queries (every search of the retry ladder, where chunks
    at different caps share a search): the next frontier's live counts and
    its live prefix, the hit buffers, the hit counts and the overflow
    flags."""
    dev = _card()
    idx_host, _, queries = frontier_host
    index = DeviceIndex.from_host(idx_host, device=dev)
    tape = compile_tape(load_scheme("optimum", 0, 2, 40, edit=edit, sigma=index.sigma, n_text=idx_host.n))
    kernel = approx.frontier_step
    seen, found = dict(steps=0, overflow=0, widest=0, mixed=0), []  # found: [context, its hits] a search

    def check(ctx, state, live, out, out_live, hits, hit_cnt, flags, **kw):
        want = [out.clone(), out_live.clone(), hits.clone(), hit_cnt.clone(), flags.clone()]
        before = LAUNCHES["frontier_step"]
        kernel(ctx, state, live, out, out_live, hits, hit_cnt, flags, **kw)
        torch.cuda.synchronize()
        assert LAUNCHES["frontier_step"] == before + 1
        frontier_step_plain(ctx, state, live, *want)
        assert torch.equal(out_live, want[1])
        prefix = torch.arange(ctx.s_cap, device=dev) < out_live[:, None]
        assert torch.equal(torch.where(prefix, out, 0), want[0])
        assert all(torch.equal(a, b) for a, b in zip((hits, hit_cnt, flags), want[2:]))
        warp_lists = F.pad(live, (0, -len(live) % 8)).reshape(-1, 8).sum(dim=1)  # 8 lanes a warp
        seen.update(steps=seen["steps"] + 1, overflow=seen["overflow"] + int(flags.sum()),
                    widest=max(seen["widest"], int(warp_lists.max())), mixed=seen["mixed"] + (ctx.caps is not None))
        if not found or found[-1][0] is not ctx:
            found.append([ctx, 0])
        found[-1][1] = int(hit_cnt.sum())

    monkeypatch.setattr(approx, "frontier_step", check)
    approx.run_scheme_search_chunked(index, queries, tape, edit=edit, s_cap=caps[0], h_cap=caps[1], chunk=64)
    assert seen["steps"] >= 41 and sum(n for _, n in found) >= 250
    assert (seen["overflow"] > 0 and seen["mixed"] > 0) or caps != (2, 1)
    assert seen["widest"] > 32 or caps == (2, 1) or not edit  # a warp's list of two rounds


def test_frontier_step_checks_its_buffers(frontier_host):
    """On the card, ``frontier_step`` called on its own checks every buffer
    and launches nothing on a wrong one: a frontier of the wrong width, a
    live count on the CPU, int64 hit counts; its context refuses lane caps
    wider than the buffers."""
    dev = _card()
    idx_host, _, queries = frontier_host
    index = DeviceIndex.from_host(idx_host, device=dev)
    tape = compile_tape(load_scheme("optimum", 0, 2, 40, edit=True, sigma=index.sigma, n_text=idx_host.n))
    words = torch.from_numpy(pack_tape(tape.side, tape.qpos, tape.lo, tape.hi)).to(dev)
    q = torch.from_numpy(queries[:8].astype(np.int32)).to(dev)
    ctx = FrontierContext(index.occ, index.c_arr, q, words, index.sigma, True, tape.num_searches,
                          index.rev_word_off, 4, 2)
    b = ctx.lanes
    i32 = dict(dtype=torch.int32, device=dev)
    good = [torch.zeros((6, b, 4), **i32), torch.ones(b, **i32), torch.zeros((6, b, 4), **i32),
            torch.zeros(b, **i32), torch.zeros((3, b, 2), **i32), torch.zeros(b, **i32), torch.zeros((2, b), **i32)]
    bad = {2: torch.zeros((6, b, 8), **i32), 1: torch.ones(b, dtype=torch.int32), 5: torch.zeros(b, dtype=torch.int64,
                                                                                                  device=dev)}
    before = LAUNCHES["frontier_step"]
    for at, wrong in bad.items():
        with pytest.raises((ValueError, TypeError)):
            frontier_step(ctx, *good[:at], wrong, *good[at + 1:])
    for s_lim, h_lim in ((5, 2), (4, 3), (0, 1)):
        caps = torch.tensor([[4] * b, [2] * b], **i32)
        caps[:, b - 1] = torch.tensor([s_lim, h_lim])
        with pytest.raises(ValueError, match="caps"):
            FrontierContext(index.occ, index.c_arr, q, words, index.sigma, True, tape.num_searches,
                            index.rev_word_off, 4, 2, caps)
    assert LAUNCHES["frontier_step"] == before
    frontier_step(ctx, *good)
    assert LAUNCHES["frontier_step"] == before + 1


def test_pooled_retries_on_card_match_whole_chunks(frontier_host):
    """Chunks of 16 queries from caps of 2 slots and 1 hit: the engine's
    retries (only the overflowing queries, pooled across chunks) against
    each chunk searched whole at every rung of its own ladder, as the
    reference does: the same hits within the counts, counts and flags."""
    dev = _card()
    idx_host, _, queries = frontier_host
    index = DeviceIndex.from_host(idx_host, device=dev)
    tape = compile_tape(load_scheme("optimum", 0, 2, 40, edit=True, sigma=index.sigma, n_text=idx_host.n))
    before = LAUNCHES["frontier_step"]
    got = approx.run_scheme_search_chunked(index, queries, tape, edit=True, s_cap=2, h_cap=1, chunk=16)
    pooled = LAUNCHES["frontier_step"] - before
    words = torch.from_numpy(pack_tape(tape.side, tape.qpos, tape.lo, tape.hi)).to(dev)
    widths, whole = [], 0
    for lo in range(0, len(queries), 16):
        q = torch.from_numpy(queries[lo : lo + 16].astype(np.int32)).to(dev)
        every = torch.ones(len(q), dtype=torch.bool, device=dev)
        s_cap, h_cap = 2, 1
        for attempt in range(8):
            hits, cnt, flags = approx.scheme_search(index, q, words, every, edit=True, s_cap=s_cap, h_cap=h_cap, k=2)
            whole += 1
            over = flags.cpu().bool()
            if not over.any() or attempt == 7:
                break
            s_cap, h_cap = s_cap * (2 if over[0].any() else 1), h_cap * (2 if over[1].any() else 1)
        rows = slice(lo, lo + len(q))
        assert torch.equal(got.count[rows].reshape(-1), cnt)
        assert torch.equal(torch.stack([got.frontier_overflow[rows], got.hit_overflow[rows]]).reshape(2, -1), over)
        valid = torch.arange(h_cap, device=dev) < cnt[:, None]
        for mine, want in zip((got.lb, got.sz, got.err), hits):
            assert torch.equal(torch.where(valid, mine[rows, :, :h_cap].reshape(-1, h_cap), 0),
                               torch.where(valid, want, 0))
        widths.append(h_cap)
    assert got.lb.shape[2] == max(widths) and len(set(widths)) > 1  # chunks end at different caps
    assert pooled < whole * (40 + 1 + 2)  # fewer searches than the chunks' rungs
    assert int(got.count.sum()) >= 250


@pytest.mark.parametrize("kw", [dict(edit=True), dict(edit=False), dict(edit=True, max_hits=2, mode="besthits")],
                         ids=["edit", "hamming", "besthits_max_hits"])
def test_approx_search_on_card_matches_cpu(frontier_host, kw):
    """search_queries(engine="approx") on the card against the CPU, with
    several chunks; max_hits keeps the same rows because K8 finds a lane's
    hits in the plain version's order."""
    dev = _card()
    idx_host, _, queries = frontier_host
    args = dict(k=2, engine="approx", generator_name="optimum", chunk=128, **kw)
    want = search_queries(DeviceIndex.from_host(idx_host, device="cpu"), queries, device="cpu", **args)
    before = LAUNCHES["frontier_step"]
    got = search_queries(DeviceIndex.from_host(idx_host, device=dev), queries, **args)
    assert LAUNCHES["frontier_step"] > before
    assert got.rows() == want.rows() and len(want.rows()) >= 250


@pytest.mark.parametrize("regime", ["resident", "swap", "fallback"])
def test_sharded_search_on_card_matches_cpu(bihost, monkeypatch, regime):
    """search_queries_sharded on the card against the CPU: shards of at most
    4,000 chars, one sequence split into windows; the fallback case sends
    every query from the resident views to the work-queue engine (K5)."""
    dev = _card()
    _, seqs = bihost
    seqs = seqs + [np.concatenate(seqs[:4])]  # a sequence longer than a shard
    queries = _reads(seqs, np.random.default_rng(13), 300, 50, 2)
    if regime == "fallback":
        monkeypatch.setattr(seedverify, "PART_CAP", 0)
    budget = 0 if regime == "swap" else None
    runs = []
    for d in ("cpu", dev):
        sh = build_sharded_bifmindex(seqs, 6, "d_dna5", max_chars=4000, overlap=256)
        assert len(sh.windowed_gids) == 1
        before = dict(LAUNCHES)
        runs.append(search_queries_sharded(sh, queries, k=2, device=d, resident_budget=budget).rows())
        assert (sh.resident is not None) == (regime == "resident")
    kernel = {"resident": "verify", "swap": "verify", "fallback": "workq_step"}[regime]
    assert LAUNCHES[kernel] > before[kernel]
    assert runs[0] == runs[1] and len(runs[0]) >= 300


def _card_mesh(n=2):
    _card()
    from sahara_tpu_torch.parallel import data_mesh

    return data_mesh(devices=[torch.device("cuda", 0)] * n)


@pytest.mark.parametrize("engine,m", [("auto", 50), ("workq", 50), ("auto", 20)], ids=["sv", "workq", "short"])
def test_mesh_on_card_matches_one_device(bihost, engine, m):
    """A mesh of the card twice against the card alone: seed-and-verify
    (with the N reads' fallback), the work-queue engine, and short reads,
    which a mesh sends to the work-queue engine (rows checked against the
    CPU mesh there: one device takes SV-e1)."""
    from sahara_tpu_torch.parallel import data_mesh, replicate_index

    mesh = _card_mesh()
    idx_host, seqs = bihost
    queries = _reads(seqs, np.random.default_rng(14), 300, m, 2)
    queries[::8, m // 3 - 1] = 5
    kw = dict(k=2, engine=engine, chunk=64, generator_name="optimum")
    reps = replicate_index(idx_host, mesh)
    assert reps[0] is reps[1]
    before = dict(LAUNCHES)
    got = search_queries(reps, queries, mesh=mesh, **kw)
    kernels = ("workq_step",) if engine == "workq" or m == 20 else ("seed_scan", "verify", "workq_step")
    assert all(LAUNCHES[name] > before[name] for name in kernels)
    if m == 20:
        cpu = data_mesh(devices=["cpu"] * 2)
        want = search_queries(replicate_index(idx_host, cpu), queries, mesh=cpu, device="cpu", **kw)
    else:
        want = search_queries(DeviceIndex.from_host(idx_host, device="cuda"), queries, **kw)
    assert got.rows() == want.rows() and len(want.rows()) >= 300


def test_interval_mesh_on_card_matches_cpu(bihost):
    """The interval search, four shards on the card four times (one
    sequence split into windows), against the same search on the CPU and
    the unsharded rows; K5 and K7 launch."""
    from sahara_tpu_torch.parallel import data_mesh
    from sahara_tpu_torch.parallel.interval import distributed_interval_search

    mesh = _card_mesh(4)
    _, seqs = bihost
    seqs = seqs + [np.concatenate(seqs[:8])]
    sh = build_sharded_bifmindex(seqs, 6, "d_dna5", max_chars=8000, overlap=256)
    assert sh.num_shards == 4 and len(sh.windowed_gids) == 1
    queries = _reads(seqs, np.random.default_rng(15), 200, 40, 2)
    tape = compile_tape(load_scheme("optimum", 0, 2, 40, edit=True, sigma=6, n_text=sum(h.n for h in sh.shards)))
    before = dict(LAUNCHES)
    got = distributed_interval_search(mesh, sh, queries, tape, edit=True, chunk=64)
    assert LAUNCHES["workq_step"] > before["workq_step"] and LAUNCHES["lf_walk"] > before["lf_walk"]
    want = distributed_interval_search(data_mesh(devices=["cpu"] * 4), sh, queries, tape, edit=True, chunk=64)
    one = search_queries(DeviceIndex.from_host(build_bifmindex(seqs, 6, "d_dna5"), device="cpu"), queries, k=2,
                         generator_name="optimum", device="cpu")
    assert got.rows() == want.rows() == one.rows() and len(one.rows()) >= 200


def test_data_mesh_needs_the_cards():
    _card()
    from sahara_tpu_torch.parallel import data_mesh

    n = torch.cuda.device_count()
    assert data_mesh().devices == tuple(torch.device("cuda", i) for i in range(n))
    with pytest.raises(ValueError, match=f"requested {n + 1} devices, have {n}"):
        data_mesh(n + 1)


def test_multihost_on_card_matches_one_process(cli_corpus, tmp_path):
    """Two ``--mh_*`` processes sharing the card: rank 0's merged file
    equals one process's output."""
    import os
    import socket
    import subprocess
    import sys

    _card()
    tmp, ref = cli_corpus
    argv = ["search", "-q", str(tmp / "reads.fasta"), "-i", ref + ".idx", "-e", "2", "-d", "lev"]
    one, multi = tmp_path / "one.txt", tmp_path / "multi.txt"
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli_main(argv + ["-o", str(one)]) == 0
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-m", "sahara_tpu_torch", *argv, "-o", str(multi), "--mh_coordinator",
                               f"127.0.0.1:{port}", "--mh_num_processes", "2", "--mh_process_id", str(r)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out.decode(errors="replace")[-2000:]
    assert multi.read_text() == one.read_text() and len(one.read_text().splitlines()) >= 40
    assert not list(tmp_path.glob("multi.txt.h*"))
