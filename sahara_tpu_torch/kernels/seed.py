"""K2 seed_scan: exact backward search of every (query, part) lane
(csrc/seed.cu).

The counterpart of ``sahara_tpu/engine/seedverify.py::_seed_scan``: a j-mer
table lookup for the last ``lut_j`` chars of each part, then one
single-symbol rank at both interval ends per remaining char.  Neither
version stops early, so ``lo`` is defined (and equal to the reference's)
even for empty intervals.

Beside it, ``seed_bad_mask_kernel`` (``bad_mask_kernel``, K2m): the queries
whose table-covered part suffixes hold a rank outside 1..4, which the table
cannot encode, flagged on the card from the uploaded query matrix.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sahara_tpu_torch.engine.rank import rank_sym
from sahara_tpu_torch.kernels import LAUNCHES, check, on_cuda, raise_on_error, stream_of
from sahara_tpu_torch.kernels._build import load

_fn = None
_bad_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = load("seed").sahara_seed_scan
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # occ16, c_arr, lut, lut_j
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,  # queries, nq, m
            ctypes.c_void_p, ctypes.c_int,  # parts (host int32[2P]), P
            ctypes.c_int, ctypes.c_int32,  # sigma, n
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # lo, sz, stream
        ]
        _fn = fn
    return _fn


def _bad_kernel():
    global _bad_fn
    if _bad_fn is None:
        fn = load("seed").sahara_seed_bad_mask
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,  # queries, nq, m
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # part ends (host int32[P]), P, lut_j
            ctypes.c_void_p, ctypes.c_void_p,  # out, stream
        ]
        _bad_fn = fn
    return _bad_fn


def seed_scan_plain(occ16, c_arr, lut, lut_j, queries, parts, sigma, n):
    """(lo, sz) int32[nq, P]; ``lut`` is None or used for every part."""
    q = queries.long()
    nq, p_cnt = q.shape[0], len(parts)
    if lut is not None:
        code = torch.zeros((nq, p_cnt), dtype=torch.int64, device=q.device)
        for i in range(lut_j):
            c = q[:, [off + ln - 1 - i for off, ln in parts]]
            code += (c - 1) * (1 << (2 * i))
        code = code.clamp(0, (1 << (2 * lut_j)) - 1)
        lo = lut[code]
        hi = lut[code + (1 << (2 * lut_j))]
        start = lut_j
    else:
        lo = torch.zeros((nq, p_cnt), dtype=torch.int32, device=q.device)
        hi = torch.full((nq, p_cnt), n, dtype=torch.int32, device=q.device)
        start = 0
    for t in range(start, max(ln for _, ln in parts)):
        act = torch.tensor([ln > t for _, ln in parts], device=q.device)
        c = q[:, [off + max(ln - 1 - t, 0) for off, ln in parts]].clamp(0, sigma - 1)
        base = c_arr[c]
        lo = torch.where(act, base + rank_sym(occ16, sigma, c, lo), lo)
        hi = torch.where(act, base + rank_sym(occ16, sigma, c, hi), hi)
    return lo, (hi - lo).clamp(min=0)


def seed_scan(occ16, c_arr, lut, lut_j, queries, parts, sigma, n):
    """Seed intervals of every (query, part) lane: (lo, sz) int32[nq, P].

    ``queries`` are uint8 ranks [nq, m]; ``parts`` ((off, len), ...); pass
    ``lut`` only when every part is at least ``lut_j`` chars long."""
    tensors = [occ16, c_arr, queries] + ([] if lut is None else [lut])
    if not on_cuda(*tensors):
        return seed_scan_plain(occ16, c_arr, lut, lut_j, queries, parts, sigma, n)
    check("occ16", occ16, torch.int32, 2)
    check("c_arr", c_arr, torch.int32, 1)
    check("queries", queries, torch.uint8, 2)
    if lut is not None:
        check("lut", lut, torch.int32, 1)
        if lut.shape[0] != 2 << (2 * lut_j) or min(ln for _, ln in parts) < lut_j:
            raise ValueError("lut must hold 2 * 4^lut_j entries and every part >= lut_j chars")
    nq, m = queries.shape
    if not parts or max(off + ln for off, ln in parts) > m or min(ln for _, ln in parts) < 1:
        raise ValueError(f"parts {parts} do not fit {m}-char queries")
    lo = torch.empty((nq, len(parts)), dtype=torch.int32, device=queries.device)
    sz = torch.empty_like(lo)
    if nq == 0:
        return lo, sz
    parts_host = np.asarray([off for off, _ in parts] + [ln for _, ln in parts], dtype=np.int32)
    rc = _kernel()(
        occ16.data_ptr(), c_arr.data_ptr(), None if lut is None else lut.data_ptr(), lut_j,
        queries.data_ptr(), nq, m, parts_host.ctypes.data, len(parts), sigma, n,
        lo.data_ptr(), sz.data_ptr(), stream_of(queries),
    )
    raise_on_error(rc, "seed_scan")
    LAUNCHES["seed_scan"] += 1
    return lo, sz


def seed_bad_mask_plain(queries, parts, lut_j):
    """bool[nq]: the queries with a rank outside 1..4 in the last ``lut_j``
    chars of any part."""
    sub = queries[:, [off + ln - 1 - i for off, ln in parts for i in range(lut_j)]]
    return ((sub < 1) | (sub > 4)).any(dim=1)


def seed_bad_mask_kernel(queries, parts, lut_j):
    """The queries whose table-covered part suffixes (the last ``lut_j``
    chars of each part) hold a rank the j-mer table cannot encode: bool[nq]
    on the queries' device, read back nowhere.

    ``queries`` are uint8 ranks [nq, m]; every part holds at least ``lut_j``
    >= 1 chars."""
    if not on_cuda(queries):
        return seed_bad_mask_plain(queries, parts, lut_j)
    check("queries", queries, torch.uint8, 2)
    nq, m = queries.shape
    if not parts or lut_j < 1 or min(ln for _, ln in parts) < lut_j or max(off + ln for off, ln in parts) > m:
        raise ValueError(f"parts {parts} do not fit {m}-char queries with {lut_j}-char table suffixes")
    out = torch.empty(nq, dtype=torch.bool, device=queries.device)
    if nq == 0:
        return out
    ends = np.asarray([off + ln for off, ln in parts], dtype=np.int32)
    rc = _bad_kernel()(queries.data_ptr(), nq, m, ends.ctypes.data, len(parts), lut_j, out.data_ptr(),
                       stream_of(queries))
    raise_on_error(rc, "seed_bad_mask")
    LAUNCHES["seed_bad_mask"] += 1
    return out
