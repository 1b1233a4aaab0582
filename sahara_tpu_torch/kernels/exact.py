"""K6 exact_search: exact backward search of every query (csrc/exact.cu).

The counterpart of ``sahara_tpu/engine/exact.py::exact_search`` on any occ
row width (occ16 rows for sigma <= 8, wide rows up to sigma = 128).  Each
query is consumed right to left over its own length from [0, n); neither
version stops early, so ``lb`` equals the reference's even for an empty
interval, and a zero-length query gives (0, n).  Symbols at or above sigma
are clamped to sigma - 1 in both versions.  Given the index's j-mer table
(``lut``, ``lut_j``: ``index/jmer.py``), a query whose last ``lut_j``
symbols are all DNA ranks below sigma (1..4) starts at step ``lut_j`` from
the table, which the same recursion built, so the intervals are the same.
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
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # occ, c_arr, lut, lut_j
            ctypes.c_void_p, ctypes.c_void_p,  # queries, qlens
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int32,  # nq, width, row_ints, sigma, n
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # lb, len, stream
        ]
        _fn = fn
    return _fn


def table_start(queries, lens, lut, lut_j: int, sigma: int, n: int):
    """(lb, rb, steps skipped) of each query before its scan: the j-mer
    table's interval where the last ``lut_j`` symbols are all ranks 1..4
    below sigma (digit d of the code is the d-th symbol consumed, minus 1),
    else [0, n) and none skipped.  ``queries`` int64[B, L], ``lens``
    int64[B] within [0, L]."""
    nq, width = queries.shape
    lb = torch.zeros(nq, dtype=torch.int32, device=queries.device)
    rb = torch.full((nq,), n, dtype=torch.int32, device=queries.device)
    if lut is None or not 0 < lut_j <= width:
        return lb, rb, torch.zeros_like(lens)
    d = torch.arange(lut_j, device=queries.device)
    digits = queries.gather(1, (lens[:, None] - 1 - d).clamp(min=0)) - 1
    ok = (lens >= lut_j) & ((digits >= 0) & (digits < min(4, sigma - 1))).all(dim=1)
    code = (digits.clamp(0, 3) << (2 * d)).sum(dim=1)
    lb = torch.where(ok, lut[code], lb)
    rb = torch.where(ok, lut[code + 4**lut_j], rb)
    return lb, rb, torch.where(ok, lut_j, 0)


def exact_search_plain(occ, c_arr, queries, qlens, sigma: int, n: int, lut=None, lut_j: int = 0):
    """(lb, len) int32[B] of every query's interval."""
    nq, width = queries.shape
    q = queries.long()
    lens = qlens.long().clamp(0, width)
    lb, rb, skip = table_start(q, lens, lut, lut_j, sigma, n)
    for j in range(width):
        at = lens - 1 - j
        active = (at >= 0) & (j >= skip)
        c = q.gather(1, at.clamp(min=0)[:, None])[:, 0].clamp(max=sigma - 1)
        base = c_arr[c]
        lb = torch.where(active, base + rank_sym(occ, sigma, c, lb), lb)
        rb = torch.where(active, base + rank_sym(occ, sigma, c, rb), rb)
    return lb, rb - lb


def exact_search(occ, c_arr, queries, qlens, sigma: int, n: int, lut=None, lut_j: int = 0):
    """Intervals (lb, len) int32[B] of left-aligned queries (uint8[B, L],
    lengths int32[B]) against an occ table of any row width; ``lut``
    (int32[2 * 4^lut_j]) starts the queries it covers from the j-mer table."""
    if not on_cuda(occ, c_arr, queries, qlens, *([] if lut is None else [lut])):
        return exact_search_plain(occ, c_arr, queries, qlens, sigma, n, lut, lut_j)
    check("occ", occ, torch.int32, 2)
    check("c_arr", c_arr, torch.int32, 1)
    check("queries", queries, torch.uint8, 2)
    check("qlens", qlens, torch.int32, 1)
    nq, width = queries.shape
    if qlens.shape[0] != nq or not 1 <= sigma <= min(occ.shape[1] // 2, 128) or c_arr.shape[0] != sigma + 1:
        raise ValueError(f"exact_search: {nq} queries, {qlens.shape[0]} lengths, sigma {sigma}, "
                         f"occ rows of {occ.shape[1]}, {c_arr.shape[0]} C entries")
    if lut is not None:
        check("lut", lut, torch.int32, 1)
        if not 1 <= lut_j <= 15 or lut.shape[0] != 2 * 4**lut_j:
            raise ValueError(f"exact_search: a j-mer table of {lut.shape[0]} entries for j = {lut_j}")
    lb = torch.empty(nq, dtype=torch.int32, device=queries.device)
    ln = torch.empty_like(lb)
    if nq == 0:
        return lb, ln
    rc = _kernel()(occ.data_ptr(), c_arr.data_ptr(), None if lut is None else lut.data_ptr(), lut_j,
                   queries.data_ptr(), qlens.data_ptr(), nq, width, occ.shape[1], sigma, n, lb.data_ptr(),
                   ln.data_ptr(), stream_of(queries))
    raise_on_error(rc, "exact_search")
    LAUNCHES["exact_search"] += 1
    return lb, ln
