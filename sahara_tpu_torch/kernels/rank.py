"""K1 rank_all: all-sigma ranks at a batch of positions (csrc/rank.cu).

The Hopper counterpart of ``sahara_tpu/kernels/rank.py::rank_all_hbm``.  On
the main path it builds the j-mer seed table at index upload
(``index/jmer.py``); it takes occ16 rows only (sigma <= 8).
"""

from __future__ import annotations

import ctypes

import torch

from sahara_tpu_torch.engine.rank import ROW_INTS, occ_row, rank_all_from_row
from sahara_tpu_torch.kernels import LAUNCHES, check, on_cuda, raise_on_error, stream_of
from sahara_tpu_torch.kernels._build import load

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = load("rank").sahara_rank_all
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        _fn = fn
    return _fn


def rank_all_plain(occ16: torch.Tensor, sigma: int, idx: torch.Tensor) -> torch.Tensor:
    """int32[n, sigma]: count of each symbol in bwt[0:idx[t]]."""
    return rank_all_from_row(occ_row(occ16, idx), sigma, idx)


def rank_all(occ16: torch.Tensor, sigma: int, idx: torch.Tensor) -> torch.Tensor:
    """rank-all at positions ``idx`` (int32[n], each in [0, n_text]) against
    an occ16 table (int32[W, 16]); int32[n, sigma]."""
    if not on_cuda(occ16, idx):
        return rank_all_plain(occ16, sigma, idx)
    check("occ16", occ16, torch.int32, 2)
    check("idx", idx, torch.int32, 1)
    if occ16.shape[1] != ROW_INTS or not 2 <= sigma <= ROW_INTS // 2:
        raise ValueError(f"occ16 must be [W, {ROW_INTS}] with 2 <= sigma <= 8")
    out = torch.empty((idx.shape[0], sigma), dtype=torch.int32, device=idx.device)
    if idx.shape[0] == 0:
        return out
    rc = _kernel()(occ16.data_ptr(), idx.data_ptr(), idx.shape[0], sigma, out.data_ptr(), stream_of(idx))
    raise_on_error(rc, "rank_all")
    LAUNCHES["rank_all"] += 1
    return out
