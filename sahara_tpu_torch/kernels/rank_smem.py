"""K4 rank_all_smem: rank-all with the whole occ16 table in shared memory
(csrc/rank_smem.cu).

The Hopper counterpart of ``sahara_tpu/kernels/rank.py::rank_all_vmem``: the
same function as K1, for tables small enough to sit in one CTA's shared
memory (``occ16_smem_bytes`` at most ``SMEM_LIMIT``), staged once per
thread-block cluster.  Larger tables are refused, never handed to K1 behind
the caller's back: the caller chooses, as ``sahara_tpu_torch/bench_rank.py``
does.
"""

from __future__ import annotations

import ctypes

import torch

from sahara_tpu_torch.engine.rank import ROW_INTS
from sahara_tpu_torch.kernels import LAUNCHES, check, on_cuda, raise_on_error, stream_of
from sahara_tpu_torch.kernels._build import load
from sahara_tpu_torch.kernels.rank import rank_all_plain

# table bytes one CTA holds on the H100 (and H200): the opt-in 232,448 B of
# shared memory less the kernel's mbarrier and the table's alignment,
# rounded down to a 64 B row (3,631 rows); the kernel computes the same
# budget on the card and refuses a larger table itself
SMEM_LIMIT = 232_384

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = load("rank_smem").sahara_rank_all_smem
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        _fn = fn
    return _fn


def launch_shape(n: int, sigma: int) -> dict:
    """The kernel's launch for ``n`` positions on the current card: grid
    CTAs, CTAs a cluster and the table bytes a CTA holds."""
    fn = load("rank_smem").sahara_rank_all_smem_shape
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    out = (ctypes.c_int32 * 3)()
    raise_on_error(fn(n, sigma, ctypes.addressof(out)), "rank_all_smem launch shape")
    return dict(ctas=out[0], cluster_ctas=out[1], table_budget=out[2])


def occ16_smem_bytes(w_rows: int) -> int:
    """Shared memory the kernel stages for a W-row occ16 table."""
    return w_rows * ROW_INTS * 4


def smem_eligible(w_rows: int) -> bool:
    return occ16_smem_bytes(w_rows) <= SMEM_LIMIT


rank_all_smem_plain = rank_all_plain


def rank_all_smem(occ16: torch.Tensor, sigma: int, idx: torch.Tensor) -> torch.Tensor:
    """rank-all at positions ``idx`` (int32[n]) against an occ16 table that
    fits shared memory; int32[n, sigma].  Raises for a larger table."""
    if not smem_eligible(occ16.shape[0]):
        raise ValueError(
            f"occ16 table of {occ16.shape[0]} rows needs {occ16_smem_bytes(occ16.shape[0])} B of shared "
            f"memory, over the {SMEM_LIMIT} B a CTA can hold beside its barrier; use kernels.rank.rank_all"
        )
    if not on_cuda(occ16, idx):
        return rank_all_smem_plain(occ16, sigma, idx)
    check("occ16", occ16, torch.int32, 2)
    check("idx", idx, torch.int32, 1)
    if occ16.shape[1] != ROW_INTS or not 2 <= sigma <= ROW_INTS // 2:
        raise ValueError(f"occ16 must be [W, {ROW_INTS}] with 2 <= sigma <= 8")
    out = torch.empty((idx.shape[0], sigma), dtype=torch.int32, device=idx.device)
    if idx.shape[0] == 0:
        return out
    rc = _kernel()(occ16.data_ptr(), occ16.shape[0], idx.data_ptr(), idx.shape[0], sigma, out.data_ptr(),
                   stream_of(idx))
    raise_on_error(rc, "rank_all_smem")
    LAUNCHES["rank_all_smem"] += 1
    return out
