"""Locate: expand SA intervals into rows, map each row to its text position.

The counterpart of ``sahara_tpu/engine/locate.py``: ``expand_intervals`` is
an integer cumsum plus searchsorted, and ``lf_walk`` either gathers the
full suffix array or walks each row back by LF steps to a sampled row (one
K7 launch).  ``locate`` is the two for a batch of intervals, allocated to
their exact total.
"""

from __future__ import annotations

import torch

from sahara_tpu_torch import trace
from sahara_tpu_torch.engine.device import DeviceIndex
from sahara_tpu_torch.kernels import lf_walk as k7


def expand_intervals(lb: torch.Tensor, ln: torch.Tensor, cap_rows: int):
    """Flatten intervals [lb_i, lb_i + ln_i) into a dense row vector.

    Returns (rows int32[cap_rows], src int64[cap_rows] — the interval each
    row came from, valid bool[cap_rows], total int64 scalar tensor).  Rows
    beyond ``cap_rows`` are dropped; the caller checks ``total``."""
    ln = ln.long()
    ends = torch.cumsum(ln, dim=0)
    total = ends[-1] if ln.numel() else torch.zeros((), dtype=torch.int64, device=ln.device)
    out_idx = torch.arange(cap_rows, dtype=torch.int64, device=ln.device)
    src = torch.searchsorted(ends, out_idx, right=True).clamp(0, max(lb.shape[0] - 1, 0))
    start_of_src = ends[src] - ln[src]
    rows = (lb.long()[src] + (out_idx - start_of_src)).to(torch.int32)
    return rows, src, out_idx < total, total


def lf_walk(index: DeviceIndex, rows: torch.Tensor, valid: torch.Tensor):
    """(seq_id, pos) int32 of each SA row; -1 where not ``valid``.

    With the full suffix array this is one gather plus a search of the
    sequence starts.  Otherwise each row walks back by LF steps until its
    row is sampled (< rate steps by the text layout): one K7 launch.

    Rows whose suffix starts at a sentinel are unspecified and may differ
    between the two paths; no search hit produces one."""
    seq_id, pos = _walk(index, torch.where(valid, rows, 0).to(torch.int32))
    return torch.where(valid, seq_id, -1), torch.where(valid, pos, -1)


def _walk(index: DeviceIndex, rows: torch.Tensor):
    if index.sa_full is not None:
        abs_pos = index.sa_full[rows.long()]
        seq_id = torch.searchsorted(index.seq_starts, abs_pos, right=True) - 1
        pos = abs_pos - index.seq_starts[seq_id.clamp(min=0)]
        return seq_id.to(torch.int32), pos
    return k7.lf_walk(index.occ, index.c_arr, index.sampled, index.sample_seq, index.sample_pos, index.sigma,
                      index.rate, rows)


def locate(index: DeviceIndex, lb: torch.Tensor, ln: torch.Tensor):
    """Every row of the intervals [lb_i, lb_i + ln_i) and its text position:
    (src int64 — the interval each row came from, seq_id int32, pos int32),
    intervals in order and each interval's rows in SA order.  Reads the
    total once to allocate exactly."""
    with trace.sync("locate.total"):
        total = int(ln.long().sum())
    rows, src, _, _ = expand_intervals(lb, ln, total)
    seq_id, pos = _walk(index, rows)
    return src, seq_id, pos
