"""Seed-and-verify search: pigeonhole exact seeding + banded verify.

The counterpart of ``sahara_tpu/engine/seedverify.py`` for the exact-parts
plan.  Each query is split into k+1 parts; any occurrence with <= k errors
aligns at least one part exactly, so exact backward search of every part
finds a witness for every hit.  One chunk (``sv_fused``) runs five stages:

1. seed    — K2 seed_scan: part intervals (lo, sz);
2. expand  — ragged part intervals to candidate SA rows (cumsum/searchsorted);
3. locate  — SA row to text position (full-SA gather, or the sampled LF-walk
             through K1 rank_all);
4. verify  — K3 verify: banded minimal-span edit DP (or Hamming count) of
             the full query around each anchor;
5. emit    — (candidate, start) pairs with distance <= k, one D2H.

Hit contract: every (query, seqId, pos) whose minimal-span edit (or Hamming)
distance is <= k, with the minimal error count per position after the
driver's merge.  PyTorch allocates dynamically, so a chunk reads its
candidate count once and allocates exactly: no capacity memory, no retries.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from sahara_tpu_torch.engine.device import DeviceIndex
from sahara_tpu_torch.engine.locate import expand_intervals, lf_walk
from sahara_tpu_torch.kernels.seed import seed_scan
from sahara_tpu_torch.kernels.verify import MAX_K, verify

MIN_PART = 10  # shortest exact part worth seeding with (else candidate blowup)

# Per-part occurrence budget: a query with any part interval larger than this
# is not expanded; seed-and-verify cannot search it exactly on its own.
PART_CAP = 1 << 16

STAGES = ("seed", "expand", "locate", "verify", "emit")


def _balanced_split(m: int, p: int) -> tuple[tuple[int, int], ...]:
    base, rem = divmod(m, p)
    parts = []
    off = 0
    for i in range(p):
        ln = base + (1 if i < rem else 0)
        parts.append((off, ln))
        off += ln
    return tuple(parts)


def plan_parts(m: int, k: int) -> tuple[tuple[int, int], ...] | None:
    """Balanced split of an m-char query into k+1 parts: ((off, len), ...);
    None when the parts would be too short to filter effectively."""
    if m // (k + 1) < MIN_PART:
        return None
    return _balanced_split(m, k + 1)


def seed_bad_mask(index: DeviceIndex, queries: np.ndarray, parts) -> np.ndarray | None:
    """Queries whose table-covered part suffixes carry ranks the j-mer table
    cannot encode (anything outside 1..4); None when there are none or the
    table path is inactive."""
    j = index.lut_j
    if index.lut is None or j <= 0 or min(ln for _, ln in parts) < j:
        return None
    cols = [off + ln - 1 - i for off, ln in parts for i in range(j)]
    sub = queries[:, cols]
    bad = ((sub < 1) | (sub > 4)).any(axis=1)
    return bad if bad.any() else None


def sv_eligible(index: DeviceIndex, m: int, k: int) -> bool:
    return index.text4 is not None and index.seq_starts is not None and k <= MAX_K and (
        plan_parts(m, k) is not None
    )


def seed_parts(index: DeviceIndex, queries: torch.Tensor, parts) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, sz) int32[nq, P]: the exact SA interval of every (query, part)
    lane; ``queries`` are uint8 ranks on the index's device."""
    use_lut = index.lut is not None and index.lut_j > 0 and min(ln for _, ln in parts) >= index.lut_j
    return seed_scan(
        index.occ16, index.c_arr, index.lut if use_lut else None, index.lut_j if use_lut else 0,
        queries, parts, index.sigma, index.n,
    )


class StageTimer:
    """Milliseconds per stage, summed over chunks.  On a CUDA device each
    stage is bracketed by events on the current stream (no synchronisation
    until ``totals``), so a stage's time is device-stream time between its
    boundaries, idle gaps included; on the CPU it is host time."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._events: list[tuple[str, torch.cuda.Event, torch.cuda.Event]] = []
        self._ms = dict.fromkeys(STAGES, 0.0)

    @contextlib.contextmanager
    def stage(self, name: str):
        if self._cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._events.append((name, start, end))
        else:
            t0 = time.perf_counter()
            yield
            self._ms[name] += (time.perf_counter() - t0) * 1e3

    def totals(self) -> dict[str, float]:
        if self._events:
            torch.cuda.synchronize()
            for name, start, end in self._events:
                self._ms[name] += start.elapsed_time(end)
            self._events.clear()
        return dict(self._ms)


def sv_fused(
    index: DeviceIndex,
    queries: torch.Tensor,
    parts,
    *,
    k: int,
    edit: bool,
    timer: StageTimer | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One chunk: seed -> expand -> locate -> verify -> emit.

    ``queries`` uint8[nq, m] on the index's device.  Returns host arrays
    (q_idx int64[H] local query index, abs_pos int64[H] padded-text start,
    err int64[H], over bool[nq] — queries with a part interval larger than
    ``PART_CAP``, which contribute no hits here)."""
    stage = timer.stage if timer is not None else (lambda _name: contextlib.nullcontext())
    dev = queries.device
    p_cnt = len(parts)
    with stage("seed"):
        lo, sz = seed_parts(index, queries, parts)
        over = (sz > PART_CAP).any(dim=1)
        sz = torch.where(over[:, None], 0, sz)
        n_cands, n_over = torch.stack([sz.sum(dtype=torch.int64), over.sum()]).tolist()
    over_host = over.cpu().numpy() if n_over else np.zeros(queries.shape[0], dtype=bool)
    if n_cands == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, over_host
    with stage("expand"):
        rows, src, valid, _ = expand_intervals(lo.reshape(-1), sz.reshape(-1), n_cands)
        q_of = src // p_cnt
        offs = torch.tensor([off for off, _ in parts], dtype=torch.int64, device=dev)
        off_of = offs[src % p_cnt]
    with stage("locate"):
        seq_id, pos = lf_walk(index, rows, valid)
        abs_pos = index.seq_starts[seq_id.clamp(min=0).long()].long() + pos.long()
    with stage("verify"):
        base = abs_pos - off_of - (k if edit else 0)  # earliest candidate start
        dist = verify(
            index.text4, index.n, queries, q_of.to(torch.int32), base.to(torch.int32), k, edit
        )
    with stage("emit"):
        cand, delta = torch.nonzero(dist <= k, as_tuple=True)
        hits = torch.stack([q_of[cand], base[cand] + delta, dist[cand, delta].long()]).cpu().numpy()
    return hits[0], hits[1], hits[2], over_host
