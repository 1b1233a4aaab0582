"""Drive sahara_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py

Needs one CUDA card (Hopper, sm_90a) and nvcc.  In order it:

1. prints the card's name and power limit, builds the three CUDA kernels
   from ``sahara_tpu_torch/kernels/csrc`` (all nvcc runs at once) and prints
   each kernel's registers;
2. regenerates the ``bench.py`` workload from its seeds (40 MB reference,
   65,536 reads of 100 bp with 2 planted errors, both strands) and builds
   the forward index with its full-SA sidecar;
3. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (exact equality: all integer), and times both;
4. runs the main path — index upload (the j-mer table build runs K1) and
   ``search_queries`` at e=2 edit distance — with the launch counts reset
   just before, checks every kernel was launched and the hit set against
   the JAX package's, then times three passes (the median is the result),
   one pass split by stage, and profiles one pass (device busy time, the
   heaviest device ops and host functions);
5. uploads the index without the full suffix array and checks that the
   sampled LF-walk locate (K1) gives the same hits on the first 8,192 reads;
6. prints the kernels' JSON line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.  The full report goes to
   ``chiprun_out/chip_smoke.json``.

Any failure raises, and the script exits non-zero.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# The JAX package's hit set for this workload, recorded on the CPU with
# sahara_tpu: bench.load_workload() at its defaults (40 MB, 65,536 reads,
# 100 bp, e=2), reads interleaved with their reverse complements as in
# bench.py, then sahara_tpu.engine.driver._run_sv_grouped(k=2, edit=True,
# chunk=16384) on DeviceIndex.from_host(build_bifmindex([ref], 6, "d_dna5",
# rate=16)).  Rows (query, seq, pos, err) as int64, sorted
# lexicographically; sha256 of their bytes.  No query fell back to the
# work-queue engine, so the seed-and-verify hit set is the whole hit set.
JAX_HITS = 80248
JAX_SHA256 = "05a0ffc11e48aaecc4f5c0910bf8d6947aef16804e696903f291d3297e2d4f59"
BENCH_R05_HITS = 80248  # hits printed by bench.py in BENCH_r05.json

K = 2
CHUNK = 16384
SAMPLED_READS = 8192
K1_POSITIONS = 1 << 20

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, and the
# float32 rate outside the tensor cores, an upper bound on the card's
# 32-bit integer operation rate
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
DP_OPS_PER_CELL = 9


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def registers(report: str) -> list[str]:
    """'<entry>: N registers, S B spill stores' from a ptxas -v report."""
    rows, entry, spill = [], None, "?"
    for line in report.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry, spill = m.group(1), "?"
        elif m := re.search(r"(\d+) bytes spill stores", line):
            spill = m.group(1)
        elif (m := re.search(r"Used (\d+) registers", line)) and entry:
            rows.append(f"{entry}: {m.group(1)} registers, {spill} B spill stores")
            entry = None
    return rows


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def assert_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> int:
    if got.shape != want.shape or not torch.equal(got, want):
        bad = (got != want).sum().item() if got.shape == want.shape else "shape"
        raise AssertionError(f"{name}: kernel differs from its plain version ({bad} entries)")
    return 0


def sorted_rows(res) -> np.ndarray:
    rows = np.stack([res.query_id, res.seq_id, res.pos, res.errors], axis=1).astype(np.int64)
    return np.ascontiguousarray(rows[np.lexsort(rows.T[::-1])])


def seed_reads(index, queries: torch.Tensor, parts) -> tuple[int, int]:
    """(distinct occ rows, distinct table j-mers) the seed scan reads; the
    j-mers bound the table codes from above, since the scan clamps codes.

    Before the step that adds a part's t-th char from the end, the lane's
    interval is that of the part's last t chars, and hi = lo + sz (backward
    search never narrows below empty), so the plain scan of those suffixes
    gives the rows every step ranks at."""
    from sahara_tpu_torch.kernels.seed import seed_scan_plain

    j, seen = index.lut_j, []
    for t in range(j, max(ln for _, ln in parts)):
        suffixes = [(off + ln - t, t) for off, ln in parts if ln > t]
        lo, sz = seed_scan_plain(index.occ16, index.c_arr, index.lut, j, queries, suffixes, index.sigma, index.n)
        seen += [lo.reshape(-1) >> 5, (lo + sz).reshape(-1) >> 5]
    jmers = torch.cat([queries[:, off + ln - j : off + ln] for off, ln in parts]).long()
    return torch.unique(torch.cat(seen)).numel(), torch.unique(jmers, dim=0).shape[0]


def profile_pass(run) -> dict:
    """Device busy time and the heaviest ops of one pass (torch.profiler),
    and the heaviest host functions (cProfile, a second pass)."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    def dev_ms(e) -> float:
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e3

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # device-side events only (kernels and copies); the profiler's own
    # buffer requests are not the program's work
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and "Activity Buffer" not in e.key]
    out = {
        "device_busy_ms": sum(dev_ms(e) for e in dev),
        "top_device_ms": [(e.key[:120], dev_ms(e), e.count) for e in sorted(dev, key=dev_ms, reverse=True)[:8]],
    }
    prof_host = cProfile.Profile()
    prof_host.enable()
    run()
    torch.cuda.synchronize()
    prof_host.disable()
    stats = pstats.Stats(prof_host).stats
    top = sorted(stats.items(), key=lambda kv: kv[1][2], reverse=True)[:10]
    out["top_host_tottime_ms"] = [(f"{f[0].split('/')[-1]}:{f[1]}:{f[2]}", v[2] * 1e3, v[1]) for f, v in top]
    return out


def kernel_phases(index, queries: np.ndarray, rng: np.random.Generator, ref: np.ndarray) -> list[dict]:
    """Each kernel against its plain version at the main path's shapes."""
    from sahara_tpu_torch.engine.locate import expand_intervals, lf_walk
    from sahara_tpu_torch.engine.seedverify import plan_parts, seed_parts
    from sahara_tpu_torch.kernels.rank import rank_all, rank_all_plain
    from sahara_tpu_torch.kernels.seed import seed_scan, seed_scan_plain
    from sahara_tpu_torch.kernels.verify import verify, verify_plain

    dev, sigma, n = index.device, index.sigma, index.n
    rows = []

    # K1 at 1M random positions over the whole occ table (larger than L2)
    idx = torch.from_numpy(rng.integers(0, n + 1, K1_POSITIONS).astype(np.int32)).to(dev)
    err = assert_equal("rank_all", rank_all(index.occ16, sigma, idx), rank_all_plain(index.occ16, sigma, idx))
    rows_read = torch.unique(idx >> 5).numel()
    b, by = bound(rows_read * 64 + K1_POSITIONS * (4 + 4 * sigma), K1_POSITIONS * sigma * 3)
    rows.append(dict(
        name="rank_all", route="cuda", source="sahara_tpu_torch/kernels/csrc/rank.cu",
        replaces="sahara_tpu/kernels/rank.py:218", max_abs_err=err,
        ms=time_ms(lambda: rank_all(index.occ16, sigma, idx), 50),
        plain_ms=time_ms(lambda: rank_all_plain(index.occ16, sigma, idx), 5),
        bound_ms=b, bound_by=by, library_ms=None, shape=f"{K1_POSITIONS} positions, sigma={sigma}",
    ))

    # K2 on one chunk of reads cut from the reference at random, 2 random
    # substitutions each (the chunk's own shape: 16,384 reads x 3 parts)
    m = queries.shape[1]
    parts = plan_parts(m, K)
    at = rng.integers(0, len(ref) - m, CHUNK)
    qs = ref[at[:, None] + np.arange(m)]
    for _ in range(K):
        col = rng.integers(0, m, CHUNK)
        qs[np.arange(CHUNK), col] = rng.integers(1, 5, CHUNK)
    qd = torch.from_numpy(np.ascontiguousarray(qs, dtype=np.uint8)).to(dev)
    args = (index.occ16, index.c_arr, index.lut, index.lut_j, qd, parts, sigma, n)
    lo, sz = seed_scan(*args)
    lo_p, sz_p = seed_scan_plain(*args)
    err = assert_equal("seed_scan lo", lo, lo_p) + assert_equal("seed_scan sz", sz, sz_p)
    steps = sum(ln - index.lut_j for _, ln in parts)
    rows_read, codes_read = seed_reads(index, qd, parts)
    b, by = bound(rows_read * 64 + codes_read * 8 + CHUNK * (m + len(parts) * 8), CHUNK * 2 * steps * 4)
    rows.append(dict(
        name="seed_scan", route="cuda", source="sahara_tpu_torch/kernels/csrc/seed.cu",
        replaces="sahara_tpu/engine/seedverify.py:158", max_abs_err=err,
        ms=time_ms(lambda: seed_scan(*args), 20), plain_ms=time_ms(lambda: seed_scan_plain(*args), 3),
        bound_ms=b, bound_by=by, library_ms=None, shape=f"{CHUNK} reads x {len(parts)} parts",
    ))

    # K3 on the real candidates of the workload's first chunk
    qc = torch.from_numpy(np.ascontiguousarray(queries[:CHUNK], dtype=np.uint8)).to(dev)
    lo, sz = seed_parts(index, qc, parts)
    n_cands = int(sz.sum().item())
    cand_rows, src, valid, _ = expand_intervals(lo.reshape(-1), sz.reshape(-1), n_cands)
    seq_id, pos = lf_walk(index, cand_rows, valid)
    offs = torch.tensor([off for off, _ in parts], device=dev)
    a0 = index.seq_starts[seq_id.long()].long() + pos.long() - offs[src % len(parts)]
    q_of = (src // len(parts)).to(torch.int32)
    for edit in (True, False):
        base = (a0 - (K if edit else 0)).to(torch.int32)
        vargs = (index.text4, n, qc, q_of, base, K, edit)
        err = assert_equal(f"verify edit={edit}", verify(*vargs), verify_plain(*vargs))
        s_cnt = 2 * K + 1 if edit else 1
        # chars read: base .. base + S - 1 + m + k - 1 (m under Hamming)
        span = torch.arange(s_cnt + m + (K if edit else 0) - 1, device=dev)
        words = torch.unique((base.long()[:, None] + span).clamp(0, n - 1) >> 3).numel()
        cells = n_cands * s_cnt * m * (2 * K + 1) if edit else n_cands * m
        b, by = bound(
            words * 4 + torch.unique(q_of).numel() * m + n_cands * (8 + 4 * s_cnt),
            cells * (DP_OPS_PER_CELL if edit else 3),
        )
        rows.append(dict(
            name="verify" if edit else "verify_hamming", route="cuda",
            source="sahara_tpu_torch/kernels/csrc/verify.cu",
            replaces="sahara_tpu/engine/seedverify.py:330", max_abs_err=err,
            ms=time_ms(lambda: verify(*vargs), 20), plain_ms=time_ms(lambda: verify_plain(*vargs), 2),
            bound_ms=b, bound_by=by, library_ms=None,
            shape=f"{n_cands} candidates x {s_cnt} starts, m={m}, k={K}",
        ))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from sahara_tpu_torch.engine.device import DeviceIndex
    from sahara_tpu_torch.engine.driver import search_queries
    from sahara_tpu_torch.engine.seedverify import StageTimer
    from sahara_tpu_torch.index.build import build_fmindex
    from sahara_tpu_torch.kernels import LAUNCHES, reset_launches
    from sahara_tpu_torch.kernels._build import build_all
    from sahara_tpu_torch.sim.workload import bench_workload

    report: dict = {}
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    ptxas = build_all()
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {report['build_s']:.1f} s", flush=True)
    for name, log in sorted(ptxas.items()):
        for row in registers(log):
            print(f"  {name}.cu {row}", flush=True)

    t0 = time.perf_counter()
    ref, queries = bench_workload()
    report["workload_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = build_fmindex([ref], 6, "d_dna5", rate=16)
    report["index_build_s"] = time.perf_counter() - t0
    print(f"workload {report['workload_s']:.1f} s, index build {report['index_build_s']:.1f} s "
          f"(n={host.n}, {len(queries)} strand queries)", flush=True)

    # kernel vs plain, on an uploaded copy of the index
    kernels = kernel_phases(DeviceIndex.from_host(host), queries, np.random.default_rng(7), ref)
    for row in kernels:
        print(f"{row['name']}: {row['ms']:.4f} ms (plain {row['plain_ms']:.3f} ms, "
              f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}) at {row['shape']}", flush=True)

    # main path: upload + one search pass, with launch counts from zero
    kw = dict(k=K, edit=True, chunk=CHUNK)
    reset_launches()
    t0 = time.perf_counter()
    index = DeviceIndex.from_host(host)
    torch.cuda.synchronize()
    report["upload_s"] = time.perf_counter() - t0
    res = search_queries(index, queries, **kw)
    launches = dict(LAUNCHES)
    report["launches"] = launches
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"main path never launched {name}")
    rows = sorted_rows(res)
    sha = hashlib.sha256(rows.tobytes()).hexdigest()
    print(f"hits {len(rows)} (JAX package {JAX_HITS}, BENCH_r05 bench.py {BENCH_R05_HITS}) sha256 {sha}", flush=True)
    if len(rows) != JAX_HITS or sha != JAX_SHA256:
        raise AssertionError("hit set differs from the JAX package's")

    torch.cuda.reset_peak_memory_stats()
    passes = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = search_queries(index, queries, **kw)
        torch.cuda.synchronize()
        passes.append(time.perf_counter() - t0)
        if not np.array_equal(sorted_rows(res), rows):
            raise AssertionError("timed pass gave another hit set")
    dt = sorted(passes)[1]
    timer = StageTimer(index.device)
    search_queries(index, queries, timer=timer, **kw)
    stages = timer.totals()
    report["profile"] = profile_pass(lambda: search_queries(index, queries, **kw))
    report.update(
        passes_s=passes, pass_s=dt, reads_per_s=len(queries) / 2 / dt, stage_ms=stages,
        max_memory_allocated=torch.cuda.max_memory_allocated(), hits=len(rows), sha256=sha,
    )
    print(f"main path: {report['reads_per_s']:.1f} reads/s (median of 3: {dt * 1e3:.1f} ms for {len(queries) // 2} reads, "
          f"both strands), stages ms {json.dumps({k: round(v, 3) for k, v in stages.items()})}, "
          f"max_memory_allocated {report['max_memory_allocated']} B", flush=True)
    print(f"passes s {passes}; device busy {report['profile']['device_busy_ms']:.2f} ms of a pass", flush=True)

    # sampled LF-walk locate: no full suffix array on the card
    reset_launches()
    sampled = DeviceIndex.from_host(host, full_sa=False)
    k1_upload = LAUNCHES["rank_all"]
    sub = queries[: 2 * SAMPLED_READS]
    t0 = time.perf_counter()
    res_s = search_queries(sampled, sub, **kw)
    torch.cuda.synchronize()
    report["sampled_pass_s"] = time.perf_counter() - t0
    report["sampled_locate_rank_all_launches"] = LAUNCHES["rank_all"] - k1_upload
    if report["sampled_locate_rank_all_launches"] <= 0:
        raise AssertionError("sampled locate never launched rank_all")
    want = rows[rows[:, 0] < 2 * SAMPLED_READS]
    if not np.array_equal(sorted_rows(res_s), want):
        raise AssertionError("sampled-walk hits differ from the full-SA hits")
    print(f"sampled walk: {len(want)} hits equal on the first {SAMPLED_READS} reads, "
          f"{report['sampled_locate_rank_all_launches']} rank_all launches in locate, "
          f"{report['sampled_pass_s'] * 1e3:.1f} ms", flush=True)

    for row in kernels:
        row["launches"] = launches.get(row["name"], 0)
    report.update(card=card, kernels=kernels)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(card)
    # the Hamming variant of verify is checked and timed above but is not on
    # the main path (edit distance), so the line lists the three kernels
    main_kernels = [row for row in kernels if row["name"] in launches]
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in main_kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
