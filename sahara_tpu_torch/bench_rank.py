"""Rank microbenchmark on the card: K1 (table in device memory) against K4
(table in shared memory), the counterpart of ``bench_rank.py``.

    python -m sahara_tpu_torch.bench_rank [--n 262144] [--sizes 0.1,4.6]

For each size it builds the occ table of a seeded random DNA text of that
many million characters with the port's own index build, draws ``--n``
random positions, times K1 and K4 on the same table and positions, asserts
that both equal the plain version, and prints ranks/s.  Each variant is
timed two ways over ``--reps`` warm launches: the kernel's device time per
launch (torch.profiler), on which ``ranks_per_s`` rests, and the wrapper's
call time (CUDA events over back-to-back calls), on which
``call_ranks_per_s`` rests.  K4 runs only where the table fits its shared
memory, and the line says so where it does not.  The last line is one JSON
object with every row.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from sahara_tpu_torch.engine.rank import pack_occ
from sahara_tpu_torch.index.build import build_fmindex
from sahara_tpu_torch.kernels.rank import rank_all, rank_all_plain
from sahara_tpu_torch.kernels.rank_smem import occ16_smem_bytes, rank_all_smem, smem_eligible
from sahara_tpu_torch.timing import kernel_device_ms, time_ms


def setup(ref_mb: float, n: int, device) -> tuple[torch.Tensor, int, torch.Tensor]:
    """(occ16 on the device, sigma, int32[n] random positions in [0, n_text))
    for a random DNA text of ``ref_mb`` million characters (seed 0)."""
    rng = np.random.default_rng(0)
    text = rng.integers(1, 5, size=int(ref_mb * 1_000_000)).astype(np.uint8)
    host = build_fmindex([text], 6, "d_dna5")
    occ16 = torch.from_numpy(pack_occ(host.occ)).to(device)
    idx = torch.from_numpy(rng.integers(0, host.n, size=n).astype(np.int32)).to(device)
    return occ16, host.sigma, idx


def run_size(ref_mb: float, n: int, reps: int = 50) -> list[dict]:
    """Time K1, and K4 where the table fits, at one text size."""
    occ16, sigma, idx = setup(ref_mb, n, torch.device("cuda"))
    want = rank_all_plain(occ16, sigma, idx)
    w_rows = occ16.shape[0]
    print(f"# ref={ref_mb}MB occ rows={w_rows} table={occ16_smem_bytes(w_rows)} B n={n}", flush=True)
    # (variant, wrapper, kernel symbol the profiler reports)
    variants = [("k1_rank_all", rank_all, "rank_all_kernel")]
    if smem_eligible(w_rows):
        variants.append(("k4_rank_all_smem", rank_all_smem, "rank_smem_kernel"))
    else:
        print("# k4_rank_all_smem skipped: occ table exceeds K4's shared memory", flush=True)
    rows = []
    for name, fn, kernel in variants:
        if not torch.equal(fn(occ16, sigma, idx), want):
            raise AssertionError(f"{name} deviates from the plain rank")
        ms = kernel_device_ms(lambda: fn(occ16, sigma, idx), kernel, reps)
        call_ms = time_ms(lambda: fn(occ16, sigma, idx), reps)
        rows.append({"variant": name, "ref_mb": ref_mb, "occ_rows": w_rows, "positions": n, "ms": ms,
                     "ranks_per_s": n / ms * 1e3, "call_ms": call_ms, "call_ranks_per_s": n / call_ms * 1e3})
        print(f"{name:18s}: {n / ms / 1e3:.1f}M ranks/s ({ms:.4f} ms/batch device, call {call_ms:.4f} ms: "
              f"{n / call_ms / 1e3:.1f}M ranks/s), equal to plain", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=262144, help="positions per batch")
    ap.add_argument("--sizes", default="0.1,4.6", help="text sizes in million characters, comma-separated")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_rank: no CUDA device available", file=sys.stderr)
        return 1
    rows = [row for mb in args.sizes.split(",") for row in run_size(float(mb), args.n, args.reps)]
    print(json.dumps({"metric": "rank_queries_per_sec", "device": torch.cuda.get_device_name(0), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
