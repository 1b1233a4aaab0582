"""Search driver: bucket queries by length, run seed-and-verify chunk by
chunk, and return canonical (queryId, seqId, pos, errors) rows.

The counterpart of the seed-and-verify route of
``sahara_tpu/engine/driver.py::search_queries``.  What this package does not
port yet raises ``NotImplementedError`` naming the ROADMAP.md item that will
port it; nothing is dropped silently:

- a bucket that seed-and-verify cannot search with exact parts (short
  reads, k > 7, an index without a text store), and the scheme engines;
- queries that the reference re-searches through its work-queue engine:
  ranks the j-mer table cannot encode (N), and seeds over ``PART_CAP``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sahara_tpu_torch.engine.device import DeviceIndex, resolve_device
from sahara_tpu_torch.engine.seedverify import (
    StageTimer,
    plan_parts,
    seed_bad_mask,
    sv_eligible,
    sv_fused,
)

_WORKQ_ITEM = "ROADMAP.md queue 1 item 9 (work-queue engine)"


@dataclasses.dataclass
class SearchResult:
    """Located hits: parallel int64 arrays (row-per-hit)."""

    query_id: np.ndarray
    seq_id: np.ndarray
    pos: np.ndarray
    errors: np.ndarray

    def rows(self) -> list[tuple[int, int, int, int]]:
        return list(zip(self.query_id.tolist(), self.seq_id.tolist(), self.pos.tolist(), self.errors.tolist()))


def _empty() -> SearchResult:
    z = np.zeros(0, dtype=np.int64)
    return SearchResult(z, z, z, z)


def _select(result: SearchResult, keep: np.ndarray) -> SearchResult:
    return SearchResult(result.query_id[keep], result.seq_id[keep], result.pos[keep], result.errors[keep])


def _cap_hits_per_query(result: SearchResult, max_hits: int) -> SearchResult:
    """Keep at most ``max_hits`` rows per queryId, preserving row order."""
    if max_hits <= 0 or len(result.query_id) == 0:
        return result
    q = result.query_id
    order = np.argsort(q, kind="stable")
    qs = q[order]
    starts = np.flatnonzero(np.r_[True, qs[1:] != qs[:-1]])
    run_len = np.diff(np.r_[starts, len(qs)])
    rank = np.arange(len(qs)) - np.repeat(starts, run_len)
    keep = np.zeros(len(q), dtype=bool)
    keep[order] = rank < max_hits
    return _select(result, keep)


def _besthits_filter(result: SearchResult) -> SearchResult:
    """Keep each query's minimal-error hits only."""
    if len(result.query_id) == 0:
        return result
    order = np.argsort(result.query_id, kind="stable")
    q = result.query_id[order]
    e = result.errors[order]
    starts = np.flatnonzero(np.r_[True, q[1:] != q[:-1]])
    run_len = np.diff(np.r_[starts, len(q)])
    best = np.minimum.reduceat(e, starts)
    keep = np.zeros(len(q), dtype=bool)
    keep[order] = e == np.repeat(best, run_len)
    return _select(result, keep)


def _concat(results: list[SearchResult]) -> SearchResult:
    if not results:
        return _empty()
    fields = ("query_id", "seq_id", "pos", "errors")
    return SearchResult(*(np.concatenate([getattr(r, f) for r in results]) for f in fields))


def _merge_results(results: list[SearchResult]) -> SearchResult:
    """Unique (queryId, seqId, pos) rows sorted lexicographically, keeping
    the minimal error count per position."""
    merged = _concat(results)
    q, s, p, e = merged.query_id, merged.seq_id, merged.pos, merged.errors
    if len(q) == 0:
        return SearchResult(q, s, p, e)
    order = np.lexsort((e, p, s, q))
    q, s, p, e = q[order], s[order], p[order], e[order]
    keep = np.r_[True, (q[1:] != q[:-1]) | (s[1:] != s[:-1]) | (p[1:] != p[:-1])]
    return SearchResult(q[keep], s[keep], p[keep], e[keep])


def _sv_hits_to_result(seq_starts: np.ndarray, q_idx, abs_pos, err, qids: np.ndarray) -> SearchResult:
    """Map hits at absolute padded-text positions to (seqId, pos) rows."""
    if len(q_idx) == 0:
        return _empty()
    seq = np.searchsorted(seq_starts, abs_pos, side="right") - 1
    return SearchResult(
        query_id=qids[q_idx].astype(np.int64),
        seq_id=seq.astype(np.int64),
        pos=(abs_pos - seq_starts[seq]).astype(np.int64),
        errors=err.astype(np.int64),
    )


def _run_sv_fused(
    index: DeviceIndex,
    qarr: np.ndarray,
    qids: np.ndarray,
    *,
    k: int,
    edit: bool,
    chunk: int,
    parts,
    timer: StageTimer | None = None,
) -> SearchResult:
    """Upload the query matrix once as uint8, then run ``sv_fused`` on each
    chunk of it.  The chunks' rows are concatenated, not merged."""
    qfull = torch.from_numpy(np.ascontiguousarray(qarr, dtype=np.uint8)).to(index.device)
    seq_starts = index.seq_starts.cpu().numpy().astype(np.int64)
    results = []
    for start in range(0, qarr.shape[0], chunk):
        q_idx, abs_pos, err, over = sv_fused(
            index, qfull[start : start + chunk], parts, k=k, edit=edit, timer=timer
        )
        if over.any():
            raise NotImplementedError(
                f"{int(over.sum())} queries have a seed interval over the per-part budget "
                f"(PART_CAP); their exact re-search needs {_WORKQ_ITEM}"
            )
        results.append(_sv_hits_to_result(seq_starts, start + q_idx, abs_pos, err, qids))
    return _concat(results)


def search_queries(
    index: DeviceIndex,
    queries,
    *,
    k: int,
    edit: bool = True,
    mode: str = "all",
    max_hits: int = 0,
    chunk: int = 16384,
    engine: str = "auto",
    query_ids: np.ndarray | None = None,
    device=None,
    timer: StageTimer | None = None,
) -> SearchResult:
    """Approximate search of rank-array queries (a list of 1-D arrays, or
    one 2-D array of equal-length queries) against a device index.

    ``device`` (default: the CUDA card) must be the index's device.
    ``timer`` collects per-stage milliseconds.  Returns located hits over all
    queries in canonical order."""
    dev = resolve_device(device)
    if index.device.type != dev.type:
        raise ValueError(f"index lies on {index.device}, search asked for {dev}")
    if engine not in ("auto", "sv"):
        raise NotImplementedError(f"engine {engine!r} is not ported yet; see ROADMAP.md queue 1")
    if mode not in ("all", "besthits"):
        raise ValueError(f"unknown search mode {mode!r}")

    by_len: dict[int, list[int] | None] = {}
    if isinstance(queries, np.ndarray):
        if queries.ndim != 2:
            raise ValueError("matrix queries must be 2-D [nq, m]")
        if queries.shape[1]:
            by_len[queries.shape[1]] = None
    else:
        for i, q in enumerate(queries):
            by_len.setdefault(len(q), []).append(i)

    results: list[SearchResult] = []
    for length, idxs in sorted(by_len.items()):
        if length == 0:
            continue
        if idxs is None:
            qarr = np.ascontiguousarray(queries, dtype=np.uint8)
            qids = np.arange(len(queries), dtype=np.int64)
        else:
            qarr = np.stack([queries[i] for i in idxs]).astype(np.uint8, copy=False)
            qids = np.asarray(idxs, dtype=np.int64)
        if query_ids is not None:
            qids = np.asarray(query_ids, dtype=np.int64)[qids]
        if not sv_eligible(index, length, k):
            raise NotImplementedError(
                f"seed-and-verify with exact parts cannot search m={length}, k={k} on this index; "
                f"{_WORKQ_ITEM} and item 10 (one-error seeds) will"
            )
        parts = plan_parts(length, k)
        bad = seed_bad_mask(index, qarr, parts)
        if bad is not None:
            raise NotImplementedError(
                f"{int(bad.sum())} queries carry ranks outside 1..4 where the seed table reads "
                f"them; their exact search needs {_WORKQ_ITEM}"
            )
        res = _run_sv_fused(index, qarr, qids, k=k, edit=edit, chunk=chunk, parts=parts, timer=timer)
        # the filter keeps each row whose error is its query's least, which
        # commutes with the merge; the cap counts merged rows in order
        if mode == "besthits":
            res = _besthits_filter(res)
        if max_hits > 0:
            res = _cap_hits_per_query(_merge_results([res]), max_hits)
        results.append(res)
    return _merge_results(results)
