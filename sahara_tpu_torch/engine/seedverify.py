"""Seed-and-verify search: pigeonhole seeding + banded verify.

The counterpart of ``sahara_tpu/engine/seedverify.py``, with its two seed
plans.  Exact parts (``plan_parts``): each query is split into k+1 parts;
any occurrence with <= k errors aligns at least one part exactly, so exact
backward search of every part finds a witness for every hit.  One-error
parts (``plan_parts_e1``), for reads too short for that: (k+2)//2 parts,
one of which aligns with at most one error, found by a k=1 work-queue
search of the part slices (the driver runs it, ``seed_tape``).  One chunk
(``sv_fused``, or ``sv_e1`` after the seed search) runs five stages:

1. seed    — K2 seed_scan: part intervals (lo, sz); or the one-error seed
             search (K5 workq_step);
2. expand  — ragged part intervals to candidate SA rows (cumsum/searchsorted;
             one-error seeds also drop duplicate (query, part, row) keys);
3. locate  — SA row to text position (full-SA gather, or the sampled LF-walk
             through K7 lf_walk);
4. verify  — K3 verify: banded minimal-span edit DP (or Hamming count) of
             the full query around each anchor;
5. emit    — (candidate, start) pairs with distance <= k, one D2H.

Both plans share stages 3-5 (``verify_candidates``); under edit distance
the 2k+1 starts around the anchor absorb a one-error seed's shift.

Hit contract: every (query, seqId, pos) whose minimal-span edit (or Hamming)
distance is <= k, with the minimal error count per position after the
driver's merge.  PyTorch allocates dynamically, so a chunk reads its
candidate count once and allocates exactly: no capacity memory, no retries.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sahara_tpu_torch import trace
from sahara_tpu_torch.engine.device import DeviceIndex
from sahara_tpu_torch.engine.locate import expand_intervals, lf_walk
from sahara_tpu_torch.engine.tape import SchemeTape, compile_tape
from sahara_tpu_torch.kernels.seed import seed_bad_mask_kernel, seed_scan
from sahara_tpu_torch.kernels.verify import MAX_K, verify
from sahara_tpu_torch.schemes import expand, get_generator, limit_to_hamming
from sahara_tpu_torch.trace import StageTimer  # noqa: F401  (importable from here too)

MIN_PART = 10  # shortest exact part worth seeding with (else candidate blowup)

# Per-part occurrence budget: a query with any part interval (one-error
# seeds: any part's seed intervals together) larger than this is not
# expanded; seed-and-verify cannot search it exactly on its own.
PART_CAP = 1 << 16


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


def plan_parts_e1(m: int, k: int) -> tuple[tuple[int, int], ...] | None:
    """Parts for one error per seed: with P = (k+2)//2 disjoint parts, any
    alignment with <= k errors leaves a part with <= 1 error (P parts of
    >= 2 each would make >= k+1).  None for k < 2 or parts shorter than
    ``MIN_PART``."""
    if k < 2:
        return None
    p = (k + 2) // 2
    if m // p < MIN_PART:
        return None
    return _balanced_split(m, p)


def _table_seeds(index: DeviceIndex, parts) -> bool:
    """Whether K2 starts every part from the j-mer table."""
    return index.lut is not None and index.lut_j > 0 and min(ln for _, ln in parts) >= index.lut_j


@trace.spanned("sv.bad_mask")
def seed_bad_mask(index: DeviceIndex, queries: torch.Tensor, parts) -> torch.Tensor | None:
    """bool[nq] on the index's device: the queries (uint8 ranks on that
    device) whose table-covered part suffixes carry ranks the j-mer table
    cannot encode (anything outside 1..4); None where the table path is
    inactive.  Nothing is read back: ``sv_fused`` counts the flags with its
    own counts."""
    if not _table_seeds(index, parts):
        return None
    return seed_bad_mask_kernel(queries, parts, index.lut_j)


def sv_eligible(index: DeviceIndex, m: int, k: int, seed_errors: int = 0) -> bool:
    """``seed_errors=1`` also admits the one-error plan where exact parts
    are too short."""
    if not (index.text4 is not None and index.seq_starts is not None and k <= MAX_K):
        return False
    if plan_parts(m, k) is not None:
        return True
    return seed_errors >= 1 and plan_parts_e1(m, k) is not None


@functools.lru_cache(maxsize=None)
def seed_tape(ln: int, edit: bool) -> SchemeTape:
    """The k=1 scheme tape (optimum generator) for ln-char seed parts."""
    ess = expand(get_generator("optimum").generator(0, 1, 0, 0), ln)
    return compile_tape(ess if edit else limit_to_hamming(ess))


def seed_parts(index: DeviceIndex, queries: torch.Tensor, parts) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, sz) int32[nq, P]: the exact SA interval of every (query, part)
    lane; ``queries`` are uint8 ranks on the index's device."""
    use_lut = _table_seeds(index, parts)
    return seed_scan(
        index.occ, index.c_arr, index.lut if use_lut else None, index.lut_j if use_lut else 0,
        queries, parts, index.sigma, index.n,
    )


def verify_candidates(
    index: DeviceIndex, queries: torch.Tensor, rows: torch.Tensor, q_of: torch.Tensor, off_of: torch.Tensor, *,
    k: int, edit: bool,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stages 3-5 of a chunk: locate each candidate SA row (int32), verify
    query ``q_of`` (int64) around its anchor, the row's text position less
    the part's offset ``off_of`` (int64), and emit host arrays (q_idx,
    abs_pos, err) int64 of the (candidate, start) pairs within k."""
    with trace.stage("locate"):
        seq_id, pos = lf_walk(index, rows, torch.ones_like(rows, dtype=torch.bool))
        abs_pos = index.seq_starts[seq_id.clamp(min=0).long()].long() + pos.long()
    with trace.stage("verify"):
        base = abs_pos - off_of - (k if edit else 0)  # earliest candidate start
        dist = verify(
            index.text4, index.n, queries, q_of.to(torch.int32), base.to(torch.int32), k, edit
        )
    with trace.stage("emit"):
        with trace.sync("sv.emit_nonzero"):
            cand, delta = torch.nonzero(dist <= k, as_tuple=True)
        hits = trace.to_host(torch.stack([q_of[cand], base[cand] + delta, dist[cand, delta].long()]),
                             "sv.emit_rows").numpy()
    return hits[0], hits[1], hits[2]


def _over_host(over: torch.Tensor, n_over: int) -> np.ndarray:
    return trace.to_host(over, "sv.over").numpy() if n_over else np.zeros(over.shape[0], dtype=bool)


def _part_offsets(parts, dev: torch.device) -> torch.Tensor:
    """int64[P]: each part's offset in the query, on ``dev``."""
    return trace.to_device(torch.tensor([off for off, _ in parts], dtype=torch.int64), dev, "sv.part_offsets")


_NO_HITS = (np.zeros(0, dtype=np.int64),) * 3


def sv_fused(
    index: DeviceIndex,
    queries: torch.Tensor,
    parts,
    *,
    k: int,
    edit: bool,
    part_cap: int | None = None,
    bad: torch.Tensor | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One chunk of the exact-parts plan: seed -> expand -> locate -> verify
    -> emit.

    ``queries`` uint8[nq, m] on the index's device; ``bad`` the chunk's
    slice of ``seed_bad_mask`` (None: no query flagged).  Returns host
    arrays (q_idx int64[H] local query index, abs_pos int64[H] padded-text
    start, err int64[H], over bool[nq] — queries with a part interval larger
    than ``part_cap`` (default ``PART_CAP``) or flagged in ``bad``, which
    contribute no hits here).  Counter ``sv.bad_queries``: the flagged."""
    p_cnt = len(parts)
    with trace.stage("seed"):
        lo, sz = seed_parts(index, queries, parts)
        over = (sz > (PART_CAP if part_cap is None else part_cap)).any(dim=1)
        if bad is not None:
            over |= bad  # a flagged query's table intervals are garbage
        sz = torch.where(over[:, None], 0, sz)
        counts = [sz.sum(dtype=torch.int64), over.sum()] + ([] if bad is None else [bad.sum()])
        with trace.sync("sv.counts"):
            n_cands, n_over, *n_bad = torch.stack(counts).tolist()
    trace.count("sv.bad_queries", sum(n_bad))
    over_host = _over_host(over, n_over)
    if n_cands == 0:
        return (*_NO_HITS, over_host)
    with trace.stage("expand"):
        rows, src, _, _ = expand_intervals(lo.reshape(-1), sz.reshape(-1), n_cands)
        off_of = _part_offsets(parts, queries.device)[src % p_cnt]
    return (*verify_candidates(index, queries, rows, src // p_cnt, off_of, k=k, edit=edit), over_host)


def sv_e1(
    index: DeviceIndex,
    queries: torch.Tensor,
    parts,
    seeds: tuple[np.ndarray, np.ndarray, np.ndarray],
    *,
    k: int,
    edit: bool,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One chunk of the one-error plan after its seed search: expand ->
    locate -> verify -> emit.

    ``seeds`` are the seed search's hit intervals as host int64 arrays (lb,
    sz, qp = query * P + part).  A query whose part's intervals sum past
    ``PART_CAP`` (a row counted once per interval that holds it) is flagged
    in ``over`` and expanded no further; the rest expand to distinct
    (query, part, row) candidates.  Returns what ``sv_fused`` returns."""
    nq, p_cnt = queries.shape[0], len(parts)
    if len(seeds[0]) == 0:
        return (*_NO_HITS, np.zeros(nq, dtype=bool))
    dev = queries.device
    with trace.stage("expand"):
        lb, sz, qp = (trace.to_device(torch.from_numpy(a), dev, "sv.seeds") for a in seeds)
        tot = torch.zeros(nq * p_cnt, dtype=torch.int64, device=dev).index_add_(0, qp, sz)
        over = (tot.view(nq, p_cnt) > PART_CAP).any(dim=1)
        sz = torch.where(over[qp // p_cnt], 0, sz)
        with trace.sync("sv.counts"):
            n_rows, n_over = torch.stack([sz.sum(), over.sum()]).tolist()
        over_host = _over_host(over, n_over)
        if n_rows == 0:
            return (*_NO_HITS, over_host)
        rows, src, _, _ = expand_intervals(lb, sz, n_rows)
        with trace.sync("sv.unique"):
            key = torch.unique((qp[src] << 32) | rows.long())  # rows < 2^31
        qp_u = key >> 32
        off_of = _part_offsets(parts, dev)[qp_u % p_cnt]
    rows = (key & 0xFFFFFFFF).to(torch.int32)
    return (*verify_candidates(index, queries, rows, qp_u // p_cnt, off_of, k=k, edit=edit), over_host)
