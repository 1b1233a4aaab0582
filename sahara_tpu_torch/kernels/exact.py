"""K6 exact_search: exact backward search of every query (csrc/exact.cu).

The counterpart of ``sahara_tpu/engine/exact.py::exact_search`` on any occ
row width (occ16 rows for sigma <= 8, wide rows up to sigma = 128).  Each
query is consumed right to left over its own length from [0, n); neither
version stops early, so ``lb`` equals the reference's even for an empty
interval, and a zero-length query gives (0, n).  Symbols at or above sigma
are clamped to sigma - 1 in both versions.
"""

from __future__ import annotations

import ctypes

import torch

from sahara_tpu_torch.engine.rank import rank_sym
from sahara_tpu_torch.kernels import LAUNCHES, check, on_cuda, raise_on_error, stream_of
from sahara_tpu_torch.kernels._build import load

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = load("exact").sahara_exact_search
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # occ, c_arr, queries, qlens
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int32,  # nq, width, row_ints, sigma, n
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # lb, len, stream
        ]
        _fn = fn
    return _fn


def exact_search_plain(occ, c_arr, queries, qlens, sigma: int, n: int):
    """(lb, len) int32[B] of every query's interval."""
    nq, width = queries.shape
    q = queries.long()
    lens = qlens.long().clamp(0, width)
    lb = torch.zeros(nq, dtype=torch.int32, device=q.device)
    rb = torch.full((nq,), n, dtype=torch.int32, device=q.device)
    for j in range(width):
        at = lens - 1 - j
        active = at >= 0
        c = q.gather(1, at.clamp(min=0)[:, None])[:, 0].clamp(max=sigma - 1)
        base = c_arr[c]
        lb = torch.where(active, base + rank_sym(occ, sigma, c, lb), lb)
        rb = torch.where(active, base + rank_sym(occ, sigma, c, rb), rb)
    return lb, rb - lb


def exact_search(occ, c_arr, queries, qlens, sigma: int, n: int):
    """Intervals (lb, len) int32[B] of left-aligned queries (uint8[B, L],
    lengths int32[B]) against an occ table of any row width."""
    if not on_cuda(occ, c_arr, queries, qlens):
        return exact_search_plain(occ, c_arr, queries, qlens, sigma, n)
    check("occ", occ, torch.int32, 2)
    check("c_arr", c_arr, torch.int32, 1)
    check("queries", queries, torch.uint8, 2)
    check("qlens", qlens, torch.int32, 1)
    nq, width = queries.shape
    if qlens.shape[0] != nq or not 1 <= sigma <= occ.shape[1] // 2 or c_arr.shape[0] != sigma + 1:
        raise ValueError(f"exact_search: {nq} queries, {qlens.shape[0]} lengths, sigma {sigma}, "
                         f"occ rows of {occ.shape[1]}, {c_arr.shape[0]} C entries")
    lb = torch.empty(nq, dtype=torch.int32, device=queries.device)
    ln = torch.empty_like(lb)
    if nq == 0:
        return lb, ln
    rc = _kernel()(occ.data_ptr(), c_arr.data_ptr(), queries.data_ptr(), qlens.data_ptr(), nq, width,
                   occ.shape[1], sigma, n, lb.data_ptr(), ln.data_ptr(), stream_of(queries))
    raise_on_error(rc, "exact_search")
    LAUNCHES["exact_search"] += 1
    return lb, ln
