"""Search driver: bucket queries by length, pick an engine per bucket, and
return canonical (queryId, seqId, pos, errors) rows.

The counterpart of ``sahara_tpu/engine/driver.py::search_queries`` on one
device.  Engines:

- ``sv`` (seed-and-verify, ``engine/seedverify.py``) where its parts filter
  (``sv_eligible`` with one-error seeds): exact k+1 parts where they are at
  least ``MIN_PART`` long, else (k+2)//2 one-error parts found by a k=1
  work-queue search (short reads).  Queries it cannot search exactly on its
  own — seeds over ``PART_CAP``, and under exact parts ranks the j-mer table
  cannot encode (N) — are re-searched through the work-queue engine and
  merged, as the reference does.
- ``workq`` (the scheme engine, ``engine/workq.py``) for every other bucket
  under ``auto``, and for every bucket under ``engine="workq"``.

What is not ported raises ``NotImplementedError`` naming its ROADMAP.md
item: the frontier engine (item 14) and meshes (item 15).  Interval-sharded
indexes (item 13) have no entry point in the port yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sahara_tpu_torch.engine import workq
from sahara_tpu_torch.engine.device import DeviceIndex, resolve_device
from sahara_tpu_torch.engine.locate import expand_intervals, lf_walk
from sahara_tpu_torch.engine.rank import ROW_INTS
from sahara_tpu_torch.engine.seedverify import (
    StageTimer,
    plan_parts,
    plan_parts_e1,
    seed_bad_mask,
    seed_tape,
    stage_of,
    sv_e1,
    sv_eligible,
    sv_fused,
)
from sahara_tpu_torch.engine.tape import SchemeTape, compile_tape
from sahara_tpu_torch.schemes import expand, get_generator, limit_to_hamming
from sahara_tpu_torch.schemes.costs import node_count, optimize_by_wnc_topdown, weighted_node_count
from sahara_tpu_torch.schemes.types import Scheme


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


def _run_sv_chunks(
    index: DeviceIndex,
    qarr: np.ndarray,
    qids: np.ndarray,
    *,
    k: int,
    edit: bool,
    chunk: int,
    run,
    parts,
    timer: StageTimer | None = None,
) -> tuple[SearchResult, np.ndarray]:
    """Upload the query matrix once as uint8, then run each chunk of it
    through ``run`` with ``parts``: ``sv_fused`` (exact parts) or
    ``_sv_e1_chunk`` (one-error parts).  The chunks' rows are concatenated,
    not merged.  Returns the rows and bool[nq]: queries over ``PART_CAP``,
    which gave no rows here."""
    qfull = torch.from_numpy(np.ascontiguousarray(qarr, dtype=np.uint8)).to(index.device)
    seq_starts = index.seq_starts.cpu().numpy().astype(np.int64)
    results, over_all = [], []
    for start in range(0, qarr.shape[0], chunk):
        q_idx, abs_pos, err, over = run(index, qfull[start : start + chunk], parts, k=k, edit=edit, timer=timer)
        over_all.append(over)
        results.append(_sv_hits_to_result(seq_starts, start + q_idx, abs_pos, err, qids))
    return _concat(results), np.concatenate(over_all) if over_all else np.zeros(0, dtype=bool)


def _sv_e1_chunk(index: DeviceIndex, queries: torch.Tensor, parts, *, k: int, edit: bool,
                 timer: StageTimer | None = None):
    """One chunk of the one-error plan: the seed search, one work-queue
    search (k=1, dedup on) per part length over the parts' slices stacked
    query-major, then ``sv_e1``."""
    groups: dict[int, list[int]] = {}  # part length -> part indices
    for pi, (_, ln) in enumerate(parts):
        groups.setdefault(ln, []).append(pi)
    lb, sz, qp = [], [], []
    with stage_of(timer)("seed"):
        for ln, pidx in sorted(groups.items()):
            pq = torch.stack([queries[:, parts[pi][0] : parts[pi][0] + ln] for pi in pidx], dim=1).reshape(-1, ln)
            part_of = np.asarray(pidx, dtype=np.int64)
            for start, ns, hits in _workq_hits(index, pq, seed_tape(ln, edit), edit=edit,
                                               active=np.ones(pq.shape[0], dtype=bool), chunk=pq.shape[0]):
                row = start + hits.lane.astype(np.int64) // ns  # row of pq
                lb.append(hits.lb.astype(np.int64))
                sz.append(hits.sz.astype(np.int64))
                qp.append(row // len(pidx) * len(parts) + part_of[row % len(pidx)])
    seeds = tuple(np.concatenate(a) if a else np.zeros(0, dtype=np.int64) for a in (lb, sz, qp))
    return sv_e1(index, queries, parts, seeds, k=k, edit=edit, timer=timer)


def load_scheme(
    generator_name: str, min_k: int, max_k: int, length: int, *, edit: bool, sigma: int, n_text: int,
    dynamic: bool = False, verbose_cb=None,
) -> Scheme:
    """Generate and expand a scheme for one query length; ``dynamic`` picks
    the part sizes with the top-down weighted-node-count optimiser.
    ``verbose_cb`` gets the partition (if dynamic) and the expanded
    scheme's node counts as lines."""
    oss = get_generator(generator_name).generator(min_k, max_k, 0, 0)
    if dynamic:
        partition = optimize_by_wnc_topdown(oss, length, sigma, n_text, edit)
        if verbose_cb:
            verbose_cb(f"partition: {partition}")
        ess = expand(oss, partition)
    else:
        ess = expand(oss, length)
    if verbose_cb:
        verbose_cb(f"node count: {node_count(ess, sigma, edit)}")
        verbose_cb(f"weighted node count: {weighted_node_count(ess, sigma, n_text, edit)}")
    return ess if edit else limit_to_hamming(ess)


def _locate_flat_hits(index: DeviceIndex, hits: workq.FlatHits, ns: int, query_ids: np.ndarray) -> SearchResult:
    """Expand a work-queue result's hit intervals to rows and locate them."""
    if hits.n_hits == 0:
        return _empty()
    dev = index.device
    lb = torch.from_numpy(hits.lb).to(dev)
    sz = torch.from_numpy(hits.sz).to(dev)
    rows, src, valid, _ = expand_intervals(lb, sz, int(hits.sz.sum(dtype=np.int64)))
    seq_id, pos = lf_walk(index, rows, valid)
    src, seq_id, pos = (t.cpu().numpy().astype(np.int64) for t in (src, seq_id, pos))
    return SearchResult(
        query_id=query_ids[hits.lane[src] // ns].astype(np.int64),
        seq_id=seq_id,
        pos=pos,
        errors=hits.err[src].astype(np.int64),
    )


def _workq_hits(
    index: DeviceIndex,
    queries: torch.Tensor,
    tape: SchemeTape,
    *,
    edit: bool,
    active: np.ndarray,
    chunk: int,
    cap_per_query: int = 0,
) -> list[tuple[int, int, workq.FlatHits]]:
    """Work-queue search of uint8 ``queries`` on the index's device: split
    schemes with more than ``MAX_NS`` searches into tape groups, chunk the
    queries to the meta-packing limit and search each (chunk, group) with
    dedup on.  Returns (first query of the chunk, searches of the group,
    unlocated hits) per search.

    A step that passes ``workq.HARD_CAP`` halves the chunk's active queries
    and searches the halves, recursing until each fits; one query alone
    over the ceiling raises ``RuntimeError``."""
    groups = [
        SchemeTape(side=tape.side[g : g + workq.MAX_NS], qpos=tape.qpos[g : g + workq.MAX_NS],
                   lo=tape.lo[g : g + workq.MAX_NS], hi=tape.hi[g : g + workq.MAX_NS])
        for g in range(0, tape.num_searches, workq.MAX_NS)
    ]
    dev = index.device
    group_tapes = [workq.upload_tape(g, dev) for g in groups]
    chunk = min(chunk, *(workq.max_chunk_queries(g.length, g.num_searches, g.max_errors, edit) for g in groups))
    out: list[tuple[int, int, workq.FlatHits]] = []

    def search(start: int, act: np.ndarray, gt: SchemeTape, dt) -> None:
        try:
            hits = workq.workq_search(
                index, queries[start : start + chunk], dt, torch.from_numpy(act).to(dev), edit=edit,
                k=gt.max_errors, ph0=workq.phase0_length(gt, edit), dedup_every=workq.DEDUP_EVERY,
                cap_per_query=cap_per_query,
            )
        except workq.QueueOverflow:
            act_idx = np.flatnonzero(act)
            if len(act_idx) <= 1:
                raise RuntimeError(
                    "a single query's search frontier exceeds the work-queue ceiling (workq.HARD_CAP)"
                ) from None
            for half in np.array_split(act_idx, 2):
                sub = np.zeros_like(act)
                sub[half] = True
                search(start, sub, gt, dt)
            return
        out.append((start, gt.num_searches, hits))

    for start in range(0, queries.shape[0], chunk):
        act = active[start : start + chunk]
        if act.any():
            for gt, dt in zip(groups, group_tapes):
                search(start, act, gt, dt)
    return out


def _run_workq_grouped(
    index: DeviceIndex,
    qarr: np.ndarray,
    tape: SchemeTape,
    qids: np.ndarray,
    *,
    edit: bool,
    active: np.ndarray | None,
    max_hits: int,
    chunk: int,
) -> SearchResult:
    """Work-queue engine driver: search the queries (``_workq_hits``),
    locate, merge and cap."""
    act = np.ones(qarr.shape[0], dtype=bool) if active is None else np.asarray(active, dtype=bool)
    qfull = torch.from_numpy(np.ascontiguousarray(qarr, dtype=np.uint8)).to(index.device)
    found = _workq_hits(index, qfull, tape, edit=edit, active=act, chunk=chunk,
                        cap_per_query=4 * max_hits if max_hits > 0 else 0)
    results = [_locate_flat_hits(index, hits, ns, qids[start:]) for start, ns, hits in found]
    return _cap_hits_per_query(_merge_results(results), max_hits)


def _run_sv_with_fallback(
    index: DeviceIndex, qarr: np.ndarray, qids: np.ndarray, *, k: int, edit: bool, chunk: int, scheme_kw: dict,
    timer: StageTimer | None, verbose_cb=None,
) -> SearchResult:
    """Seed-and-verify over the bucket, with exact parts where they are
    long enough and one-error parts otherwise; queries it cannot search
    exactly alone (a seed over ``PART_CAP``; under exact parts also N in a
    table-covered seed, which the one-error plan's work-queue seeds search)
    go through the work-queue engine instead, and the row sets are
    concatenated."""
    m = qarr.shape[1]
    parts = plan_parts(m, k)
    if parts is None:
        res, fallback = _run_sv_chunks(index, qarr, qids, k=k, edit=edit, chunk=chunk, run=_sv_e1_chunk,
                                       parts=plan_parts_e1(m, k), timer=timer)
    else:
        bad = seed_bad_mask(index, qarr, parts)
        fallback = np.zeros(qarr.shape[0], dtype=bool) if bad is None else bad.copy()
        keep = np.flatnonzero(~fallback)
        sv_q, sv_ids = (qarr, qids) if bad is None else (qarr[keep], qids[keep])
        res, over = _run_sv_chunks(index, sv_q, sv_ids, k=k, edit=edit, chunk=chunk, run=sv_fused, parts=parts,
                                   timer=timer)
        fallback[keep[over]] = True
    if not fallback.any():
        return res
    if verbose_cb:
        verbose_cb(f"seed-verify: {int(fallback.sum())} repeat-saturated queries re-searched via the scheme engine")
    tape = compile_tape(load_scheme(min_k=0, max_k=k, length=qarr.shape[1], edit=edit, **scheme_kw))
    res_fb = _run_workq_grouped(index, qarr[fallback], tape, qids[fallback], edit=edit, active=None,
                                max_hits=0, chunk=chunk)
    return _concat([res, res_fb])


def search_queries(
    index: DeviceIndex,
    queries,
    *,
    k: int,
    generator_name: str = "h2-k2",
    edit: bool = True,
    mode: str = "all",
    max_hits: int = 0,
    dynamic: bool = False,
    chunk: int = 16384,
    engine: str = "auto",
    query_ids: np.ndarray | None = None,
    mesh=None,
    device=None,
    timer: StageTimer | None = None,
    verbose_cb=None,
) -> SearchResult:
    """Approximate search of rank-array queries (a list of 1-D arrays, or
    one 2-D array of equal-length queries) against a device index.

    ``engine``: ``auto`` (seed-and-verify where it applies, else the
    work-queue engine), ``sv`` or ``workq``.  ``generator_name`` and
    ``dynamic`` choose the work-queue engine's search scheme.  ``device``
    (default: the CUDA card) must be the index's device.  ``timer``
    collects the seed-and-verify stages' milliseconds.  ``verbose_cb``
    gets a line per bucket (its engine) and the schemes' node counts.
    Returns located hits over all queries in canonical order."""
    dev = resolve_device(device)
    if index.device.type != dev.type:
        raise ValueError(f"index lies on {index.device}, search asked for {dev}")
    if engine not in ("auto", "sv", "workq"):
        raise NotImplementedError(
            f"engine {engine!r} is not ported; the frontier engine is ROADMAP.md queue 1 item 14"
        )
    if mesh is not None:
        raise NotImplementedError("multi-device search is not ported; see ROADMAP.md queue 1 item 15")
    if mode not in ("all", "besthits"):
        raise ValueError(f"unknown search mode {mode!r}")
    if index.row_ints != ROW_INTS:
        raise ValueError(f"approximate search takes occ16 rows (sigma <= 8), got a sigma={index.sigma} index; "
                         "exact search (engine/exact.py) takes any sigma")

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
        scheme_kw = dict(generator_name=generator_name, sigma=index.sigma, n_text=index.n, dynamic=dynamic)
        use_sv = engine in ("auto", "sv") and sv_eligible(index, length, k, seed_errors=1)
        if engine == "sv" and not use_sv:
            raise ValueError(
                "seed-verify engine not applicable (index lacks a text store, "
                f"or parts too short for m={length}, k={k})"
            )
        if verbose_cb:
            verbose_cb(f"engine: {'seed-verify' if use_sv else 'workq'} (single-device, m={length}, "
                       f"{len(qarr)} queries)")
        if use_sv:
            res = _run_sv_with_fallback(index, qarr, qids, k=k, edit=edit, chunk=chunk, scheme_kw=scheme_kw,
                                        timer=timer, verbose_cb=verbose_cb)
            # the filter keeps each row whose error is its query's least,
            # which commutes with the merge; the cap counts merged rows in order
            if mode == "besthits":
                res = _besthits_filter(res)
            if max_hits > 0:
                res = _cap_hits_per_query(_merge_results([res]), max_hits)
            results.append(res)
        elif mode == "all":
            tape = compile_tape(load_scheme(min_k=0, max_k=k, length=length, edit=edit, verbose_cb=verbose_cb,
                                            **scheme_kw))
            results.append(_run_workq_grouped(index, qarr, tape, qids, edit=edit, active=None,
                                              max_hits=max_hits, chunk=chunk))
        else:
            # strata j = 0..k: a query stops at the first stratum with hits
            active = np.ones(len(qarr), dtype=bool)
            for j in range(k + 1):
                if not active.any():
                    break
                tape = compile_tape(load_scheme(min_k=j, max_k=j, length=length, edit=edit, verbose_cb=verbose_cb,
                                                **scheme_kw))
                res = _run_workq_grouped(index, qarr, tape, qids, edit=edit, active=active,
                                         max_hits=max_hits, chunk=chunk)
                results.append(res)
                active &= ~np.isin(qids, res.query_id)
    return _merge_results(results)
