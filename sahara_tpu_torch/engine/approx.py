"""Frontier scheme engine: every (query, search) lane steps through its
compiled scheme tape in lockstep, keeping a bounded frontier of live
states, one K8 launch a step (``kernels/frontier.py``).

The counterpart of ``sahara_tpu/engine/approx.py``.  A lane keeps ``s_cap``
frontier slots (bidirectional cursor, error count, tape position and the
last edit with the edge-deletion bits, see ``kernels/frontier.py``) and an
``h_cap`` hit buffer.  A lane whose frontier or hit buffer overflows sets its
flag; ``run_scheme_search_chunked`` reads the flags once a search and
searches again, with the overflowing buffer doubled, only the queries with
an overflowing lane, at most ``max_retries`` attempts a chunk.  Hits are
unlocated SA intervals; the driver locates them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from sahara_tpu_torch import trace
from sahara_tpu_torch.engine.device import DeviceIndex
from sahara_tpu_torch.engine.tape import SchemeTape
from sahara_tpu_torch.kernels.frontier import SZ, FrontierContext, check_step, frontier_step, pack_tape


@dataclasses.dataclass
class SearchHits:
    """The hits of a scheme search over one bucket.

    On the index's device: ``lb``, ``sz``, ``err`` int32[nq, ns, h_cap] and
    ``count[q, s]``, the valid hits of lane (q, s).  On the host:
    ``frontier_overflow`` and ``hit_overflow`` bool[nq, ns], the lanes whose
    buffers overflowed."""

    lb: torch.Tensor
    sz: torch.Tensor
    err: torch.Tensor
    count: torch.Tensor
    frontier_overflow: torch.Tensor
    hit_overflow: torch.Tensor

    @property
    def any_overflow(self) -> bool:
        return bool(self.frontier_overflow.any() or self.hit_overflow.any())


@trace.spanned("approx.search")
def scheme_search(
    index: DeviceIndex,
    queries: torch.Tensor,
    tape: torch.Tensor,
    active: torch.Tensor,
    *,
    edit: bool,
    s_cap: int,
    h_cap: int,
    k: int,
    caps: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run every search of one scheme over int32[nq, m] ``queries`` in
    lockstep: m + 1 steps (+ k for edit distance), one ``frontier_step``
    each.  ``tape`` is ``pack_tape``'s int32[ns, m]; lanes of queries not
    ``active`` start empty.  ``caps``, int32[2, nq] or None: each query's
    own (s_cap, h_cap), at most ``s_cap`` and ``h_cap``, which are then the
    buffers' widths.  Returns (hits int32[3, B, h_cap] (lb, sz, err), hit
    counts int32[B], flags int32[2, B] (frontier, hit overflow)), lanes
    ordered query-major (lane = q * ns + s)."""
    if not index.bidirectional:
        raise ValueError("scheme search requires a bidirectional index")
    nq, m = queries.shape
    ns = tape.shape[0]
    b, dev = nq * ns, queries.device
    state = torch.empty((6, b, s_cap), dtype=torch.int32, device=dev)
    state[:, :, 0] = 0
    state[SZ, :, 0] = index.n  # one live slot, the whole text, in each active lane
    live = active.repeat_interleave(ns).to(torch.int32)
    nxt, nxt_live = torch.empty_like(state), torch.empty_like(live)
    hits = torch.zeros((3, b, h_cap), dtype=torch.int32, device=dev)
    hit_cnt = torch.zeros(b, dtype=torch.int32, device=dev)
    flags = torch.zeros((2, b), dtype=torch.int32, device=dev)
    ctx = FrontierContext(index.occ, index.c_arr, queries, tape, index.sigma, edit, ns, index.rev_word_off, s_cap,
                          h_cap, None if caps is None else caps.repeat_interleave(ns, dim=1).contiguous())
    check_step(ctx, state, live, nxt, nxt_live, hits, hit_cnt, flags)
    for _ in range(m + 1 + (k if edit else 0)):
        frontier_step(ctx, state, live, nxt, nxt_live, hits, hit_cnt, flags, checked=True)
        state, nxt, live, nxt_live = nxt, state, nxt_live, live
    return hits, hit_cnt, flags


def _concat_hits(parts: list[SearchHits], nq: int) -> SearchHits:
    """Chunked results along the query axis, hit buffers padded to the
    widest ``h_cap`` among the chunks."""
    h_cap = max(p.lb.shape[2] for p in parts)
    fields = {name: torch.cat([F.pad(getattr(p, name), (0, h_cap - p.lb.shape[2])) for p in parts])[:nq]
              for name in ("lb", "sz", "err")}
    return SearchHits(
        **fields,
        **{name: torch.cat([getattr(p, name) for p in parts])[:nq]
           for name in ("count", "frontier_overflow", "hit_overflow")},
    )


@trace.spanned("approx.ladder")
def run_scheme_search_chunked(
    index: DeviceIndex,
    queries: np.ndarray,
    tape: SchemeTape,
    *,
    edit: bool,
    active: np.ndarray | None = None,
    s_cap: int = 64,
    h_cap: int = 32,
    chunk: int = 1024,
    max_retries: int = 8,
) -> SearchHits:
    """Search int32[nq, m] ``queries`` in chunks of ``chunk``, each chunk
    on the reference's cap ladder: while any of its lanes overflowed, its
    next attempt doubles ``s_cap`` where a frontier did and ``h_cap`` where
    a hit buffer did, at most ``max_retries`` attempts (eight take s_cap
    from 64 to 8,192).  An attempt after the first searches only the
    chunk's queries with an overflowing lane (a lane that fits its buffers
    gives the same hits at any larger caps), in one search with the other
    chunks' (each query at its chunk's caps), ``chunk`` queries a search;
    each query keeps the hits, counts and flags of its last search."""
    if max_retries < 1:
        raise ValueError("max_retries must be at least 1")
    nq = queries.shape[0]
    ns = tape.num_searches
    dev = index.device
    q = trace.to_device(torch.from_numpy(np.ascontiguousarray(queries)), dev, "approx.queries").to(torch.int32)
    act = trace.to_device(torch.from_numpy(np.ones(nq, dtype=bool) if active is None
                                           else np.asarray(active, dtype=bool)), dev, "approx.active")
    words = trace.to_device(torch.from_numpy(pack_tape(tape.side, tape.qpos, tape.lo, tape.hi)), dev, "approx.tape")
    starts = range(0, max(nq, 1), chunk)
    parts: list[SearchHits | None] = [None] * len(starts)  # each chunk's, from its first search on
    caps = np.array([[s_cap, h_cap]] * len(starts), dtype=np.int32)  # each chunk's caps
    todo = {c: np.arange(lo, min(lo + chunk, nq)) for c, lo in enumerate(starts)}  # its queries to search
    for attempt in range(max_retries):
        chunks, sizes = np.array(list(todo)), [len(ids) for ids in todo.values()]
        owner, ids = np.repeat(chunks, sizes), np.concatenate(list(todo.values()))
        cap_of = np.repeat(caps[chunks], sizes, axis=0).T  # int32[2, n]: each query's caps
        over = np.zeros((2, len(ids)), dtype=bool)  # per query: a lane's frontier, hit buffer overflowed
        for lo in range(0, len(ids), chunk):
            b = slice(lo, lo + chunk)
            trace.count("approx.queries_searched", len(ids[b]))
            trace.count("approx.queries_retried", len(ids[b]) if attempt else 0)
            sel = trace.to_device(torch.from_numpy(ids[b]), dev, "approx.select")
            s_w, h_w = (int(x) for x in cap_of[:, b].max(axis=1))
            mixed = bool((cap_of[:, b].min(axis=1) != (s_w, h_w)).any())
            caps_b = trace.to_device(torch.from_numpy(cap_of[:, b].copy()), dev, "approx.caps") if mixed else None
            hits, cnt, flags = scheme_search(index, q[sel], words, act[sel], edit=edit, s_cap=s_w, h_cap=h_w,
                                             k=tape.max_errors, caps=caps_b)
            flg = trace.to_host(flags, "approx.flags").numpy().astype(bool).reshape(2, -1, ns)
            over[:, b] = flg.any(axis=2)
            hits, cnt = hits.reshape(3, -1, ns, h_w), cnt.reshape(-1, ns)
            for c in np.unique(owner[b]):
                if parts[c] is None:  # the first search: the whole chunk, in order
                    parts[c] = SearchHits(*hits, cnt, *(torch.from_numpy(f) for f in flg))
                    continue
                mine = np.flatnonzero(owner[b] == c)
                at = trace.to_device(torch.from_numpy(mine), dev, "approx.place")
                parts[c] = _place(parts[c], ids[b][mine] - starts[c], hits[:, at, :, : caps[c, 1]], cnt[at],
                                  flg[:, mine])
        todo = {}
        for c, lo, hi in zip(chunks, np.cumsum(sizes) - sizes, np.cumsum(sizes)):
            f, h = over[:, lo:hi]
            if attempt + 1 < max_retries and (f.any() or h.any()):
                todo[c] = ids[lo:hi][f | h]
                caps[c] *= (2 if f.any() else 1, 2 if h.any() else 1)
        if not todo:
            break
    return _concat_hits(parts if nq else [_empty_hits(ns, h_cap, dev)], nq)


def _empty_hits(ns: int, h_cap: int, dev) -> SearchHits:
    """The hits of no query."""
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)  # noqa: E731
    return SearchHits(zeros(0, ns, h_cap), zeros(0, ns, h_cap), zeros(0, ns, h_cap), zeros(0, ns),
                      torch.zeros((0, ns), dtype=torch.bool), torch.zeros((0, ns), dtype=torch.bool))


def _place(part: SearchHits, rows: np.ndarray, hits: torch.Tensor, cnt: torch.Tensor,
           flags: np.ndarray) -> SearchHits:
    """A chunk's ``part`` with its queries ``rows`` set to one search's
    hits int32[3, n, ns, h_cap], counts int32[n, ns] and flags bool[2, n,
    ns]; its hit buffers widen to that h_cap (a chunk's caps only grow)."""
    rows = torch.from_numpy(rows)
    r = trace.to_device(rows, cnt.device, "approx.place")
    fields = [F.pad(old, (0, hits.shape[3] - old.shape[2])) for old in (part.lb, part.sz, part.err)]
    for old, new in zip(fields, hits):
        old[r] = new
    part.count[r] = cnt
    part.frontier_overflow[rows], part.hit_overflow[rows] = torch.from_numpy(flags)
    return SearchHits(*fields, part.count, part.frontier_overflow, part.hit_overflow)
