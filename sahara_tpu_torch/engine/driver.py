"""Search driver: bucket queries by length, pick an engine per bucket, and
return canonical (queryId, seqId, pos, errors) rows.

The counterpart of ``sahara_tpu/engine/driver.py::search_queries``, on one
device or over a data mesh (``parallel/``).  Engines:

- ``sv`` (seed-and-verify, ``engine/seedverify.py``) where its parts filter
  (``sv_eligible`` with one-error seeds): exact k+1 parts where they are at
  least ``MIN_PART`` long, else (k+2)//2 one-error parts found by a k=1
  work-queue search (short reads).  Queries it cannot search exactly on its
  own — seeds over ``PART_CAP``, and under exact parts ranks the j-mer table
  cannot encode (N) — are re-searched through the work-queue engine and
  merged, as the reference does.
- ``workq`` (the scheme engine, ``engine/workq.py``) for every other bucket
  under ``auto``, and for every bucket under ``engine="workq"``.
- ``approx`` (the frontier engine, ``engine/approx.py``) for every bucket
  under ``engine="approx"``.

On a mesh of more than one entry (``search_queries(mesh=...)``, the index
replicated by ``parallel.replicate_index``) each device searches its
contiguous slices of every bucket, ``chunk`` queries a device at a time, as
the reference routes them: seed-and-verify with exact parts only
(``parallel/sv.py``), so short-read buckets go to the work-queue engine;
the fallback and the work-queue buckets are split the same way.  The
frontier engine has no mesh driver.

``search_queries_sharded`` searches an interval-sharded index
(``index/shard.py``) shard by shard and maps the rows back to global
coordinates.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from sahara_tpu_torch import trace
from sahara_tpu_torch.engine import seedverify, workq
from sahara_tpu_torch.engine.approx import SearchHits, run_scheme_search_chunked
from sahara_tpu_torch.engine.device import DeviceIndex, device_bytes, resolve_device
from sahara_tpu_torch.engine.locate import expand_intervals, lf_walk
from sahara_tpu_torch.engine.rank import ROW_INTS
from sahara_tpu_torch.engine.seedverify import (
    plan_parts,
    plan_parts_e1,
    seed_bad_mask,
    seed_tape,
    sv_e1,
    sv_eligible,
    sv_fused,
)
from sahara_tpu_torch.engine.tape import SchemeTape, compile_tape
from sahara_tpu_torch.index.shard import ShardedIndex
from sahara_tpu_torch.kernels.verify import MAX_K
from sahara_tpu_torch.schemes import expand, get_generator, limit_to_hamming
from sahara_tpu_torch.schemes.costs import node_count, optimize_by_wnc_topdown, weighted_node_count
from sahara_tpu_torch.schemes.types import Scheme
from sahara_tpu_torch.trace import StageTimer


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


_FIELDS = ("query_id", "seq_id", "pos", "errors")


def _concat(results: list[SearchResult]) -> SearchResult:
    if not results:
        return _empty()
    return SearchResult(*(np.concatenate([getattr(r, f) for r in results]) for f in _FIELDS))


# The widest sort key the merge packs a row into: an int64's bits below its sign.
KEY_BITS = 63


@trace.spanned("driver.merge")
def _merge_results(results: list[SearchResult]) -> SearchResult:
    """Unique (queryId, seqId, pos) rows sorted lexicographically, keeping
    the minimal error count per position.

    Each column, less its least value, takes the bits its range needs
    (none where it holds one value), and a row packs into one int64 key,
    ``((q << ws | s) << wp | p) << we | e``, part by part: one sort of the
    keys orders the rows as the lexsort of the four columns does, and the
    first row of each (q, s, p) run holds its least error.  Rows whose
    widths sum past ``KEY_BITS`` take that lexsort (counter
    ``driver.merge_lexsort``; ``driver.merge_rows`` counts the rows in)."""
    parts = [[getattr(r, f) for f in _FIELDS] for r in results if len(r.query_id)]
    n = sum(len(part[0]) for part in parts)
    trace.count("driver.merge_rows", n)
    if n == 0:
        return _concat(results)
    lows = [min(int(part[i].min()) for part in parts) for i in range(4)]
    widths = [(max(int(part[i].max()) for part in parts) - lows[i]).bit_length() for i in range(4)]
    if sum(widths) > KEY_BITS:
        trace.count("driver.merge_lexsort")
        merged = _concat(results)
        q, s, p, e = merged.query_id, merged.seq_id, merged.pos, merged.errors
        order = np.lexsort((e, p, s, q))
        q, s, p, e = q[order], s[order], p[order], e[order]
        keep = np.r_[True, (q[1:] != q[:-1]) | (s[1:] != s[:-1]) | (p[1:] != p[:-1])]
        return SearchResult(q[keep], s[keep], p[keep], e[keep])
    key = np.empty(n, dtype=np.int64)
    field = np.empty(max(len(part[0]) for part in parts), dtype=np.int64)
    at = 0
    for part in parts:
        m = len(part[0])
        k, f = key[at:at + m], field[:m]
        at += m
        k.fill(0)
        for c, lo, w in zip(part, lows, widths):
            if w:
                k <<= w
                np.subtract(c, lo, out=f, dtype=np.int64)
                k |= f
    key.sort()
    we = widths[3]
    run = key >> we if we else key
    keep = np.empty(n, dtype=bool)
    keep[0] = True
    np.not_equal(run[1:], run[:-1], out=keep[1:])
    key = key[keep]
    out = []
    total = shift = sum(widths)
    for lo, w in zip(lows, widths):
        shift -= w
        if w:
            # the field at shift 0 is the last one read from ``key``
            col = key >> shift if shift else key
            if shift + w < total:
                col &= (1 << w) - 1
            if lo:
                col += lo
        else:
            col = np.full(len(key), lo, dtype=np.int64)
        out.append(col)
    return SearchResult(*out)


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
) -> tuple[SearchResult, np.ndarray]:
    """Upload the query matrix once as uint8, then run each chunk of it
    through ``run`` with ``parts``: ``sv_fused`` (exact parts, with its
    slice of the uploaded matrix's ``seed_bad_mask``) or ``_sv_e1_chunk``
    (one-error parts, whose seed search takes N).  The chunks' rows are
    concatenated, not merged.  Returns the rows and bool[nq]: queries over
    ``PART_CAP`` or flagged by the mask, which gave no rows here."""
    qfull = trace.to_device(torch.from_numpy(np.ascontiguousarray(qarr, dtype=np.uint8)), index.device,
                            "driver.queries")
    seq_starts = trace.to_host(index.seq_starts, "driver.seq_starts").numpy().astype(np.int64)
    bad = seed_bad_mask(index, qfull, parts) if run is sv_fused else None
    results, over_all = [], []
    for start in range(0, qarr.shape[0], chunk):
        extra = {} if bad is None else {"bad": bad[start : start + chunk]}
        q_idx, abs_pos, err, over = run(index, qfull[start : start + chunk], parts, k=k, edit=edit, **extra)
        over_all.append(over)
        results.append(_sv_hits_to_result(seq_starts, start + q_idx, abs_pos, err, qids))
    return _concat(results), np.concatenate(over_all) if over_all else np.zeros(0, dtype=bool)


def _sv_e1_chunk(index: DeviceIndex, queries: torch.Tensor, parts, *, k: int, edit: bool):
    """One chunk of the one-error plan: the seed search, one work-queue
    search (k=1, dedup on) per part length over the parts' slices stacked
    query-major, then ``sv_e1``."""
    groups: dict[int, list[int]] = {}  # part length -> part indices
    for pi, (_, ln) in enumerate(parts):
        groups.setdefault(ln, []).append(pi)
    lb, sz, qp = [], [], []
    with trace.stage("seed"):
        for ln, pidx in sorted(groups.items()):
            pq = torch.stack([queries[:, parts[pi][0] : parts[pi][0] + ln] for pi in pidx], dim=1).reshape(-1, ln)
            part_of = np.asarray(pidx, dtype=np.int64)
            for start, _, ns, hits in _workq_hits(index, pq, seed_tape(ln, edit), edit=edit,
                                                  active=np.ones(pq.shape[0], dtype=bool), chunk=pq.shape[0]):
                row = start + hits.lane.astype(np.int64) // ns  # row of pq
                lb.append(hits.lb.astype(np.int64))
                sz.append(hits.sz.astype(np.int64))
                qp.append(row // len(pidx) * len(parts) + part_of[row % len(pidx)])
    seeds = tuple(np.concatenate(a) if a else np.zeros(0, dtype=np.int64) for a in (lb, sz, qp))
    return sv_e1(index, queries, parts, seeds, k=k, edit=edit)


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


@trace.spanned("driver.locate_flat")
def _locate_flat_hits(index: DeviceIndex, hits: workq.FlatHits, ns: int, query_ids: np.ndarray) -> SearchResult:
    """Expand a work-queue result's hit intervals to rows and locate them."""
    if hits.n_hits == 0:
        return _empty()
    dev = index.device
    lb = trace.to_device(torch.from_numpy(hits.lb), dev, "driver.flat_hits")
    sz = trace.to_device(torch.from_numpy(hits.sz), dev, "driver.flat_hits")
    rows, src, valid, _ = expand_intervals(lb, sz, int(hits.sz.sum(dtype=np.int64)))
    seq_id, pos = lf_walk(index, rows, valid)
    src, seq_id, pos = (trace.to_host(t, "driver.located").numpy().astype(np.int64) for t in (src, seq_id, pos))
    return SearchResult(
        query_id=query_ids[hits.lane[src] // ns].astype(np.int64),
        seq_id=seq_id,
        pos=pos,
        errors=hits.err[src].astype(np.int64),
    )


@trace.spanned("driver.workq")
def _workq_hits(
    index: DeviceIndex,
    queries: torch.Tensor,
    tape: SchemeTape,
    *,
    edit: bool,
    active: np.ndarray,
    chunk: int,
    cap_per_query: int = 0,
) -> list[tuple[int, int, int, workq.FlatHits]]:
    """Work-queue search of uint8 ``queries`` on the index's device: split
    schemes with more than ``MAX_NS`` searches into tape groups, chunk the
    queries to the meta-packing limit and search each (chunk, group) with
    dedup on.  Returns (first query of the chunk, first search of the
    group, searches of the group, unlocated hits) per search.

    A step that passes ``workq.HARD_CAP`` halves the chunk's active queries
    and searches the halves, halving again until each fits (counter
    ``workq.overflow_splits``); one query alone over the ceiling raises
    ``RuntimeError``.  The halving is a loop over a stack, not a recursive
    closure: such a closure refers to itself, and the reference cycle kept
    ``queries`` on the card until Python's cycle collector next ran."""
    groups = [
        SchemeTape(side=tape.side[g : g + workq.MAX_NS], qpos=tape.qpos[g : g + workq.MAX_NS],
                   lo=tape.lo[g : g + workq.MAX_NS], hi=tape.hi[g : g + workq.MAX_NS])
        for g in range(0, tape.num_searches, workq.MAX_NS)
    ]
    dev = index.device
    group_tapes = [workq.upload_tape(g, dev) for g in groups]
    chunk = min(chunk, *(workq.max_chunk_queries(g.length, g.num_searches, g.max_errors, edit) for g in groups))
    out: list[tuple[int, int, int, workq.FlatHits]] = []
    for start in range(0, queries.shape[0], chunk):
        if not active[start : start + chunk].any():
            continue
        for g, (gt, dt) in enumerate(zip(groups, group_tapes)):
            todo = [active[start : start + chunk]]  # active sets still to search, the next one last
            while todo:
                act = todo.pop()
                try:
                    hits = workq.workq_search(
                        index, queries[start : start + chunk], dt,
                        trace.to_device(torch.from_numpy(act), dev, "driver.active"), edit=edit,
                        k=gt.max_errors, ph0=workq.phase0_length(gt, edit), dedup_every=workq.DEDUP_EVERY,
                        cap_per_query=cap_per_query,
                    )
                except workq.QueueOverflow:
                    act_idx = np.flatnonzero(act)
                    if len(act_idx) <= 1:
                        raise RuntimeError(
                            "a single query's search frontier exceeds the work-queue ceiling (workq.HARD_CAP)"
                        ) from None
                    trace.count("workq.overflow_splits")
                    for half in reversed(np.array_split(act_idx, 2)):  # the first half next
                        sub = np.zeros_like(act)
                        sub[half] = True
                        todo.append(sub)
                    continue
                out.append((start, g * workq.MAX_NS, gt.num_searches, hits))
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
    replicas: tuple[DeviceIndex, ...] | None = None,
) -> SearchResult:
    """Work-queue engine driver: search the queries (``_workq_hits``),
    locate, merge and cap.  With ``replicas`` (a mesh's replicated index)
    each device searches and locates its slices of the queries, ``chunk`` a
    device at a time."""
    act = np.ones(qarr.shape[0], dtype=bool) if active is None else np.asarray(active, dtype=bool)
    if replicas is not None:
        from sahara_tpu_torch.parallel.mesh import mesh_slices

        # a query lies in one slice, so each slice's capped rows are its rows
        return _merge_results([
            _run_workq_grouped(replicas[d], qarr[rows], tape, qids[rows], edit=edit, active=act[rows],
                               max_hits=max_hits, chunk=chunk)
            for d, rows in mesh_slices(len(qarr), chunk, len(replicas))
        ])
    qfull = trace.to_device(torch.from_numpy(np.ascontiguousarray(qarr, dtype=np.uint8)), index.device,
                            "driver.queries")
    found = _workq_hits(index, qfull, tape, edit=edit, active=act, chunk=chunk,
                        cap_per_query=4 * max_hits if max_hits > 0 else 0)
    results = [_locate_flat_hits(index, hits, ns, qids[start:]) for start, _, ns, hits in found]
    return _cap_hits_per_query(_merge_results(results), max_hits)


def _run_sv(
    index: DeviceIndex, qarr: np.ndarray, qids: np.ndarray, *, k: int, edit: bool, chunk: int,
) -> tuple[SearchResult, np.ndarray]:
    """Seed-and-verify over the bucket, with exact parts where they are
    long enough and one-error parts otherwise.  Returns the rows and
    bool[nq]: the queries it cannot search exactly alone (a seed over
    ``PART_CAP``; under exact parts also N in a table-covered seed, which
    the one-error plan's work-queue seeds search), which gave no rows."""
    m = qarr.shape[1]
    parts = plan_parts(m, k)
    if parts is None:
        return _run_sv_chunks(index, qarr, qids, k=k, edit=edit, chunk=chunk, run=_sv_e1_chunk,
                              parts=plan_parts_e1(m, k))
    return _run_sv_chunks(index, qarr, qids, k=k, edit=edit, chunk=chunk, run=sv_fused, parts=parts)


def _run_sv_with_fallback(
    index: DeviceIndex, qarr: np.ndarray, qids: np.ndarray, *, k: int, edit: bool, chunk: int, scheme_kw: dict,
    verbose_cb=None, replicas: tuple[DeviceIndex, ...] | None = None,
) -> SearchResult:
    """``_run_sv`` (``_run_sv_mesh`` with a mesh's ``replicas``), with the
    queries it cannot search alone re-searched through the work-queue
    engine; the row sets are concatenated."""
    if replicas is None:
        res, fallback = _run_sv(index, qarr, qids, k=k, edit=edit, chunk=chunk)
    else:
        res, fallback = _run_sv_mesh(replicas, qarr, qids, k=k, edit=edit, chunk=chunk)
    if not fallback.any():
        return res
    if verbose_cb:
        verbose_cb(f"seed-verify: {int(fallback.sum())} repeat-saturated queries re-searched via the scheme engine")
    tape = compile_tape(load_scheme(min_k=0, max_k=k, length=qarr.shape[1], edit=edit, **scheme_kw))
    res_fb = _run_workq_grouped(index, qarr[fallback], tape, qids[fallback], edit=edit, active=None,
                                max_hits=0, chunk=chunk, replicas=replicas)
    return _concat([res, res_fb])


def _run_sv_mesh(
    replicas: tuple[DeviceIndex, ...], qarr: np.ndarray, qids: np.ndarray, *, k: int, edit: bool, chunk: int,
) -> tuple[SearchResult, np.ndarray]:
    """``_run_sv`` over a mesh: exact parts only, ``chunk`` queries a
    device at a time (``parallel/sv.py``)."""
    from sahara_tpu_torch.parallel.mesh import DataMesh
    from sahara_tpu_torch.parallel.sv import distributed_sv_search

    mesh = DataMesh(tuple(rep.device for rep in replicas))
    hits, _ = distributed_sv_search(mesh, replicas, qarr, k, edit=edit, chunk=chunk, part_cap=seedverify.PART_CAP)
    seq_starts = trace.to_host(replicas[0].seq_starts, "driver.seq_starts").numpy().astype(np.int64)
    return _sv_hits_to_result(seq_starts, hits.q_idx, hits.abs_pos, hits.err, qids), hits.fallback


def _locate_hits(index: DeviceIndex, hits: SearchHits, query_ids: np.ndarray, max_hits: int = 0) -> SearchResult:
    """Expand a frontier-engine result's hit intervals to located rows:
    query-major, then search, then hit discovery order, then SA row; at
    most ``max_hits`` rows a query (0: all) in that order."""
    h_cap = hits.lb.shape[2]
    valid = torch.arange(h_cap, device=hits.lb.device) < hits.count[:, :, None]
    with trace.sync("driver.hit_lanes"):
        q_idx = torch.nonzero(valid)[:, 0]
    if q_idx.numel() == 0:
        return _empty()
    lb, sz, err = (_masked(t, valid) for t in (hits.lb, hits.sz, hits.err))
    with trace.sync("driver.hit_rows"):
        total = int(sz.sum(dtype=torch.int64))
    rows, src, ok, _ = expand_intervals(lb, sz, total)
    seq_id, pos = lf_walk(index, rows, ok)
    src, seq_id, pos, q_of, err_of = (trace.to_host(t, "driver.located").numpy().astype(np.int64)
                                      for t in (src, seq_id, pos, q_idx[src], err[src]))
    result = SearchResult(query_id=query_ids[q_of].astype(np.int64), seq_id=seq_id, pos=pos, errors=err_of)
    return _cap_hits_per_query(result, max_hits)


def _masked(t: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``t[mask]``: a boolean mask's selection reads its count back."""
    with trace.sync("driver.hit_mask"):
        return t[mask]


def _run_scheme_engine(
    index: DeviceIndex, qarr: np.ndarray, tape: SchemeTape, qids: np.ndarray, *, engine: str, edit: bool,
    active: np.ndarray | None, max_hits: int, chunk: int, s_cap: int, h_cap: int,
    replicas: tuple[DeviceIndex, ...] | None,
) -> SearchResult:
    """One tape through the work-queue engine (over a mesh with its
    ``replicas``) or the frontier engine (``engine="approx"``); the frontier
    engine raises ``RuntimeError`` when a lane still overflows its buffers
    after the retries."""
    if engine == "workq":
        return _run_workq_grouped(index, qarr, tape, qids, edit=edit, active=active, max_hits=max_hits, chunk=chunk,
                                  replicas=replicas)
    hits = run_scheme_search_chunked(index, qarr, tape, edit=edit, active=active, s_cap=s_cap, h_cap=h_cap,
                                     chunk=chunk)
    if hits.any_overflow:
        raise RuntimeError("scheme search overflowed its frontier/hit buffers after retries; "
                           "hits would be silently dropped")
    return _locate_hits(index, hits, qids, max_hits=max_hits)


def search_queries(
    index: DeviceIndex | tuple[DeviceIndex, ...],
    queries,
    *,
    k: int,
    generator_name: str = "h2-k2",
    edit: bool = True,
    mode: str = "all",
    max_hits: int = 0,
    dynamic: bool = False,
    s_cap: int = 64,
    h_cap: int = 32,
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
    work-queue engine), ``sv``, ``workq`` or ``approx`` (the frontier
    engine, whose first frontier and hit buffers hold ``s_cap`` and
    ``h_cap`` states a lane).  ``generator_name`` and ``dynamic`` choose the
    scheme engines' search scheme.  ``mesh`` (a ``parallel.DataMesh``, with
    ``index`` from ``parallel.replicate_index``) searches data-parallel,
    ``chunk`` queries a device; ``engine="approx"`` has no mesh driver and
    raises ``ValueError``.  ``device`` (default: the CUDA card) must be the
    index's device type.  ``timer``, a ``StageTimer``, is the call's
    tracer (``trace.py``): it records the call's spans and counters and the
    single-device seed-and-verify stages' milliseconds.  ``verbose_cb``
    gets a line per bucket (its engine) and the schemes' node counts.
    Returns located hits over all queries in canonical order."""
    with trace.tracing(timer), trace.span("search"):
        replicas = None  # on a mesh of more than one entry, each entry's replica
        if mesh is not None:
            from sahara_tpu_torch.parallel.mesh import check_replicas

            replicas = check_replicas(index, mesh)
            index = replicas[0]
        use_mesh = mesh is not None and mesh.size > 1
        replicas = replicas if use_mesh else None
        dev = resolve_device(device)
        if index.device.type != dev.type:
            raise ValueError(f"index lies on {index.device}, search asked for {dev}")
        if engine not in ("auto", "sv", "workq", "approx"):
            raise ValueError(f"unknown search engine {engine!r}")
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
            # on a mesh seed-and-verify seeds with exact parts only, as the reference's does
            use_sv = engine in ("auto", "sv") and sv_eligible(index, length, k, seed_errors=0 if use_mesh else 1)
            if engine == "sv" and not use_sv:
                raise ValueError(
                    "seed-verify engine not applicable (index lacks a text store, "
                    f"or parts too short for m={length}, k={k})"
                )
            bucket_engine = "workq" if engine == "auto" else engine
            if use_mesh and not use_sv and bucket_engine != "workq":
                raise ValueError(f"engine {bucket_engine!r} has no distributed driver; use engine='auto' or 'workq' "
                                 "with a mesh")
            if verbose_cb:
                where = f"mesh[{mesh.size}]" if use_mesh else "single-device"
                verbose_cb(f"engine: {'seed-verify' if use_sv else bucket_engine} ({where}, m={length}, "
                           f"{len(qarr)} queries)")
            run = dict(engine=bucket_engine, edit=edit, max_hits=max_hits, chunk=chunk, s_cap=s_cap, h_cap=h_cap,
                       replicas=replicas)
            if use_sv:
                res = _run_sv_with_fallback(index, qarr, qids, k=k, edit=edit, chunk=chunk, scheme_kw=scheme_kw,
                                            verbose_cb=verbose_cb, replicas=replicas)
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
                results.append(_run_scheme_engine(index, qarr, tape, qids, active=None, **run))
            else:
                # strata j = 0..k: a query stops at the first stratum with hits
                active = np.ones(len(qarr), dtype=bool)
                for j in range(k + 1):
                    if not active.any():
                        break
                    tape = compile_tape(load_scheme(min_k=j, max_k=j, length=length, edit=edit, verbose_cb=verbose_cb,
                                                    **scheme_kw))
                    res = _run_scheme_engine(index, qarr, tape, qids, active=active, **run)
                    results.append(res)
                    active &= ~np.isin(qids, res.query_id)
        return _merge_results(results)


# Card memory the resident regime leaves free beside the shards' views, for
# the search's own workspace (PERF.md states what a pass takes).
RESIDENT_MARGIN = 4 << 30


def _shard_to_global(res: SearchResult, sharded: ShardedIndex, i: int) -> SearchResult:
    gid = sharded.seq_gid[i][res.seq_id]
    pos = res.pos + sharded.seq_off[i][res.seq_id]
    return SearchResult(res.query_id, gid.astype(np.int64), pos.astype(np.int64), res.errors)


def _resident_views(sharded: ShardedIndex, dev: torch.device, budget: int | None, verbose_cb=None) -> list | None:
    """The seed-and-verify views of every shard on ``dev`` (no reversed
    table), uploaded once and kept on ``sharded``; None when their bytes
    exceed ``budget`` (None: no limit)."""
    total = sum(device_bytes(h, include_rev=False) for h in sharded.shards)
    if budget is not None and total > budget:
        return None
    if sharded.resident is not None and sharded.resident[0].device.type == dev.type:
        return sharded.resident
    if verbose_cb:
        verbose_cb(f"resident SV views: {sharded.num_shards} shards, {total / 1e9:.1f}GB (no shard swapping)")
    sharded.resident = [DeviceIndex.from_host(h, device=dev, include_rev=False) for h in sharded.shards]
    return sharded.resident


def _free_card(dev: torch.device) -> None:
    """Return the blocks freed tensors held to the card, so that
    ``mem_get_info`` and the next upload see them."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def search_queries_sharded(
    sharded: ShardedIndex,
    queries,
    *,
    query_ids: np.ndarray | None = None,
    device=None,
    resident_budget: int | None = None,
    verbose_cb=None,
    **kw,
) -> SearchResult:
    """Search an interval-sharded index (``index/shard.py``): each shard's
    rows map back through its (global seqId, window offset) tables, and the
    merge keeps one row of each hit found in two overlapping windows.
    ``kw`` are ``search_queries``' keywords.

    Two regimes:

    - resident: where the bucket is one length, the engine ``auto`` or
      ``sv``, exact seed parts apply and every shard has a text store, the
      seed-and-verify views of all shards (no reversed table) are uploaded
      once, kept on ``sharded.resident``, and searched without swapping.
      The queries seed-and-verify cannot search alone are deferred: the
      views are freed, then each shard concerned is uploaded whole and
      they are searched by the work-queue engine.  ``max_hits`` caps the
      merged rows.
    - swap: otherwise, or where the views' bytes exceed the budget, one
      whole shard at a time is uploaded and searched by ``search_queries``
      (one stream: a shard's search queues behind its copy).  ``max_hits``
      caps each shard's rows, so a query can get up to ``max_hits`` rows
      from each shard.

    ``resident_budget`` is the card memory the views may take: by default
    the free memory less ``RESIDENT_MARGIN`` on a card, no limit on the CPU.
    ``verbose_cb`` also gets each swapped shard's upload seconds."""
    dev = resolve_device(device)
    k, mode, engine = kw.get("k", 0), kw.get("mode", "all"), kw.get("engine", "auto")
    lengths = {queries.shape[1]} if isinstance(queries, np.ndarray) else {len(q) for q in queries}
    sv_ok = (
        len(lengths) == 1
        and engine in ("auto", "sv")
        and mode in ("all", "besthits")
        and k <= MAX_K
        and all(h.text4 is not None for h in sharded.shards)
        and plan_parts(next(iter(lengths)), k) is not None
    )
    if sv_ok:
        budget = resident_budget
        if budget is None and dev.type == "cuda" and sharded.resident is None:
            _free_card(dev)
            budget = torch.cuda.mem_get_info(dev)[0] - RESIDENT_MARGIN
        if _resident_views(sharded, dev, budget, verbose_cb) is not None:
            with trace.tracing(kw.get("timer")):
                return _search_sharded_resident(sharded, queries, query_ids=query_ids, dev=dev,
                                                verbose_cb=verbose_cb, **kw)

    parts: list[SearchResult] = []
    for i, host in enumerate(sharded.shards):
        if verbose_cb:
            verbose_cb(f"shard {i + 1}/{sharded.num_shards}: n={host.n}")
        t0 = time.perf_counter()
        index = DeviceIndex.from_host(host, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if verbose_cb:
            verbose_cb(f"shard {i + 1}: uploaded in {time.perf_counter() - t0:.3f}s")
        res = search_queries(index, queries, query_ids=query_ids, device=dev, verbose_cb=verbose_cb, **kw)
        del index
        _free_card(dev)
        parts.append(_shard_to_global(res, sharded, i))
    merged = _merge_results(parts)
    # each shard's best hits hold its own least error: filter again after the merge
    return _besthits_filter(merged) if mode == "besthits" else merged


def _search_sharded_resident(
    sharded: ShardedIndex,
    queries,
    *,
    query_ids: np.ndarray | None,
    dev: torch.device,
    verbose_cb,
    k: int = 0,
    generator_name: str = "h2-k2",
    edit: bool = True,
    mode: str = "all",
    max_hits: int = 0,
    dynamic: bool = False,
    chunk: int = 16384,
    **_ignored,
) -> SearchResult:
    """The resident regime of ``search_queries_sharded``."""
    qarr = (np.ascontiguousarray(queries, dtype=np.uint8) if isinstance(queries, np.ndarray)
            else np.stack(queries).astype(np.uint8, copy=False))
    m = qarr.shape[1]
    qids = np.arange(len(qarr), dtype=np.int64) if query_ids is None else np.asarray(query_ids, dtype=np.int64)
    parts: list[SearchResult] = []
    fallback: list[np.ndarray] = []
    for i in range(sharded.num_shards):
        if verbose_cb:
            verbose_cb(f"shard {i + 1}/{sharded.num_shards} (resident): n={sharded.shards[i].n}")
        res, fb = _run_sv(sharded.resident[i], qarr, qids, k=k, edit=edit, chunk=chunk)
        fallback.append(fb)
        parts.append(_shard_to_global(res, sharded, i))
    if any(fb.any() for fb in fallback):
        # a whole shard also holds the reversed table: free the views first, so that it fits where they did
        sharded.resident = None
        _free_card(dev)
        for i, fb in enumerate(fallback):
            if not fb.any():
                continue
            if verbose_cb:
                verbose_cb(f"shard {i + 1}: {int(fb.sum())} repeat-saturated queries re-searched via the scheme "
                           "engine (full index swap-in)")
            full = DeviceIndex.from_host(sharded.shards[i], device=dev)
            tape = compile_tape(load_scheme(generator_name, 0, k, m, edit=edit, sigma=full.sigma, n_text=full.n,
                                            dynamic=dynamic))
            res_fb = _run_workq_grouped(full, qarr, tape, qids, edit=edit, active=fb, max_hits=0, chunk=chunk)
            del full
            _free_card(dev)
            parts.append(_shard_to_global(res_fb, sharded, i))
    merged = _merge_results(parts)
    if mode == "besthits":
        merged = _besthits_filter(merged)
    return _cap_hits_per_query(merged, max_hits)
