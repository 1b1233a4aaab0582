"""Locate: expand SA intervals into rows, map each row to its text position.

The counterpart of ``sahara_tpu/engine/locate.py``: ``expand_intervals`` is
an integer cumsum plus searchsorted, and ``lf_walk`` either gathers the
full suffix array or walks each row back by LF steps to a sampled row.
"""

from __future__ import annotations

import torch

from sahara_tpu_torch.engine.device import DeviceIndex
from sahara_tpu_torch.engine.rank import sampled_bit, sampled_rank
from sahara_tpu_torch.kernels.rank import rank_all


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
    row is sampled (< rate steps by the text layout), a fixed loop of
    ``rate`` trips; each trip is one rank_all launch over the rows and their
    successors, whose difference also names the BWT symbol.

    Rows whose suffix starts at a sentinel are unspecified and may differ
    between the two paths; no search hit produces one."""
    rows = torch.where(valid, rows, 0).to(torch.int32)
    if index.sa_full is not None:
        abs_pos = index.sa_full[rows.long()]
        seq_id = torch.searchsorted(index.seq_starts, abs_pos, right=True) - 1
        pos = abs_pos - index.seq_starts[seq_id.clamp(min=0)]
        return torch.where(valid, seq_id, -1).to(torch.int32), torch.where(valid, pos, -1)
    nr = rows.shape[0]
    steps = torch.zeros_like(rows)
    for _ in range(index.rate):
        done = sampled_bit(index.sampled, rows) == 1
        ranks = rank_all(index.occ16, index.sigma, torch.cat([rows, rows + 1]))
        before, after = ranks[:nr], ranks[nr:]
        sym = (after - before).argmax(dim=1)
        nxt = index.c_arr[sym] + before.gather(1, sym[:, None])[:, 0]
        rows = torch.where(done, rows, nxt)
        steps = torch.where(done, steps, steps + 1)
    slot = sampled_rank(index.sampled, rows).clamp(0, index.sample_seq.shape[0] - 1).long()
    seq_id = index.sample_seq[slot]
    pos = index.sample_pos[slot] + steps
    return torch.where(valid, seq_id, -1), torch.where(valid, pos, -1)
