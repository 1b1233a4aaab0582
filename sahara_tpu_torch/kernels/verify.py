"""K3 verify: banded minimal-span edit (or Hamming) distance of each
candidate's query at each start offset (csrc/verify.cu).

The counterpart of ``sahara_tpu/engine/seedverify.py::_gather_windows`` and
the DP and Hamming body of ``_verify_core``.  For candidate r and start
offset d the text span starts at ``base[r] + d``.  Under edit distance
there are S = 2k+1 starts and the DP keeps a band of B = 2k+1 cells; DP
cell (i, c) stands for column j = i - k + c, whose text char is
text[start + j - 1].  Rank-0 chars (sentinels, and positions outside the
text) can neither match, substitute nor be deleted.  Cells are saturated at
INF after each row: values below INF are exactly the reference's, values at
or above it never become hits.  Under Hamming distance (K3h) the span is
text[base[r], base[r] + m), and a rank-0 char in it gives INF.
"""

from __future__ import annotations

import ctypes

import torch

from sahara_tpu_torch.kernels import LAUNCHES, check, on_cuda, raise_on_error, stream_of
from sahara_tpu_torch.kernels._build import load

INF = 1 << 20
MAX_K = 7

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = load("verify").sahara_verify
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,  # text4, n, queries, m
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # q_of, base, n_cands
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,  # k, edit, dist, stream
        ]
        _fn = fn
    return _fn


def hamming_lanes(n_cands: int, m: int) -> int:
    """Lanes a candidate that the Hamming launch of ``n_cands`` candidates
    of ``m`` chars takes on the current card (1, 2, 4 or 8)."""
    fn = load("verify").sahara_verify_hamming_lanes
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int64, ctypes.c_int]
    return fn(n_cands, m)


def text_ranks(text4: torch.Tensor, n: int, pos: torch.Tensor) -> torch.Tensor:
    """Ranks at text positions ``pos`` (int64); 0 outside [0, n)."""
    inside = (pos >= 0) & (pos < n)
    p = pos.clamp(0, max(n - 1, 0))
    nib = (text4[p >> 3].long() >> (4 * (p & 7))) & 0xF
    return torch.where(inside, nib, 0)


def verify_plain(text4, n, queries, q_of, base, k, edit):
    """dist int32[R, 2k+1] (edit) or int32[R, 1] (Hamming)."""
    dev = base.device
    r_cnt, m = q_of.shape[0], queries.shape[1]
    q = queries.long()[q_of.long()]  # [R, m]
    base = base.long()
    if not edit:
        w = text_ranks(text4, n, base[:, None] + torch.arange(m, device=dev))
        mism = (w != q).sum(dim=1)
        return torch.where((w == 0).any(dim=1), INF, mism).to(torch.int32)[:, None]
    s_cnt = b_cnt = 2 * k + 1
    # text[start + j - 1] for start = base + d, j = i - k + c: window column
    # x = d + i + c over positions base - k - 1 + x
    width = s_cnt + m + b_cnt
    win = text_ranks(text4, n, base[:, None] - k - 1 + torch.arange(width, device=dev))
    c_idx = torch.arange(b_cnt, device=dev)
    d_idx = torch.arange(s_cnt, device=dev)[:, None]
    a = torch.where(c_idx == k, 0, INF).expand(r_cnt, s_cnt, b_cnt).clone()
    b = torch.full((r_cnt, s_cnt, b_cnt), INF, dtype=torch.int64, device=dev)
    pad = torch.full((r_cnt, s_cnt, 1), INF, dtype=torch.int64, device=dev)
    for i in range(1, m + 1):
        j = i - k + c_idx  # [B]
        wch = win[:, d_idx + i + c_idx]  # [R, S, B]
        sub = torch.where(wch == 0, INF, (wch != q[:, i - 1, None, None]).long())
        up_a = torch.cat([a[:, :, 1:], pad], dim=2)
        up_b = torch.cat([b[:, :, 1:], pad], dim=2)
        an = torch.minimum(a + sub, up_a + 1)
        an = torch.where(j == 0, i, an)
        an = torch.where(j < 0, INF, an)
        bn = torch.where(j <= 0, INF, torch.minimum(a + sub, up_b + 1))
        dele = torch.where((wch == 0) | (j == 1), INF, 1)
        cols = [an[:, :, 0]]
        for c in range(1, b_cnt):
            cols.append(torch.minimum(an[:, :, c], cols[-1] + dele[:, :, c]))
        a = torch.stack(cols, dim=2).clamp(max=INF)
        b = bn.clamp(max=INF)
    return b.min(dim=2).values.to(torch.int32)


def verify(text4, n, queries, q_of, base, k, edit):
    """Distance of query ``q_of[r]`` (a row of uint8 ``queries``) against the
    text span at each start ``base[r] + d``: int32[R, 2k+1] under edit
    distance, int32[R, 1] under Hamming."""
    if not 0 <= k <= MAX_K:
        raise ValueError(f"verify supports k <= {MAX_K}, got {k}")
    if not on_cuda(text4, queries, q_of, base):
        return verify_plain(text4, n, queries, q_of, base, k, edit)
    check("text4", text4, torch.int32, 1)
    check("queries", queries, torch.uint8, 2)
    check("q_of", q_of, torch.int32, 1)
    check("base", base, torch.int32, 1)
    if q_of.shape != base.shape:
        raise ValueError("q_of and base must have one entry per candidate")
    r_cnt = q_of.shape[0]
    dist = torch.empty((r_cnt, 2 * k + 1 if edit else 1), dtype=torch.int32, device=base.device)
    if r_cnt == 0:
        return dist
    rc = _kernel()(
        text4.data_ptr(), n, queries.data_ptr(), queries.shape[1], q_of.data_ptr(), base.data_ptr(),
        r_cnt, k, int(edit), dist.data_ptr(), stream_of(base),
    )
    raise_on_error(rc, "verify")
    LAUNCHES["verify"] += 1
    return dist
