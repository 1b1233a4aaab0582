"""Frontier scheme engine: every (query, search) lane steps through its
compiled scheme tape in lockstep, keeping a bounded frontier of live
states, one K8 launch a step (``kernels/frontier.py``).

The counterpart of ``sahara_tpu/engine/approx.py``.  A lane keeps ``s_cap``
frontier slots (bidirectional cursor, error count, tape position and the
last edit with the edge-deletion bits, see ``kernels/frontier.py``) and an
``h_cap`` hit buffer.  A lane whose frontier or hit buffer overflows sets its
flag; ``run_scheme_search`` reads the flags once per attempt and repeats
the chunk with the overflowing buffer doubled, at most ``max_retries``
attempts.  Hits are unlocated SA intervals; the driver locates them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from sahara_tpu_torch.engine.device import DeviceIndex
from sahara_tpu_torch.engine.tape import SchemeTape
from sahara_tpu_torch.kernels.frontier import SZ, FrontierContext, frontier_step, pack_tape


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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run every search of one scheme over int32[nq, m] ``queries`` in
    lockstep: m + 1 steps (+ k for edit distance), one ``frontier_step``
    each.  ``tape`` is ``pack_tape``'s int32[ns, m]; lanes of queries not
    ``active`` start empty.  Returns (hits int32[3, B, h_cap] (lb, sz, err),
    hit counts int32[B], flags int32[2, B] (frontier, hit overflow)), lanes
    ordered query-major (lane = q * ns + s)."""
    if not index.bidirectional:
        raise ValueError("scheme search requires a bidirectional index")
    nq, m = queries.shape
    ns = tape.shape[0]
    b, dev = nq * ns, queries.device
    state = torch.zeros((6, b, s_cap), dtype=torch.int32, device=dev)
    state[SZ, :, 0] = torch.where(active.repeat_interleave(ns), index.n, 0).to(torch.int32)
    nxt = torch.empty_like(state)
    hits = torch.zeros((3, b, h_cap), dtype=torch.int32, device=dev)
    hit_cnt = torch.zeros(b, dtype=torch.int32, device=dev)
    flags = torch.zeros((2, b), dtype=torch.int32, device=dev)
    ctx = FrontierContext(index.occ, index.c_arr, queries, tape, index.sigma, edit, ns, index.rev_word_off, s_cap,
                          h_cap)
    for _ in range(m + 1 + (k if edit else 0)):
        frontier_step(ctx, state, nxt, hits, hit_cnt, flags)
        state, nxt = nxt, state
    return hits, hit_cnt, flags


def run_scheme_search(
    index: DeviceIndex,
    queries: np.ndarray,
    tape: SchemeTape,
    *,
    edit: bool,
    active: np.ndarray | None = None,
    s_cap: int = 64,
    h_cap: int = 32,
    max_retries: int = 8,
) -> SearchHits:
    """Search one chunk, repeating it with doubled caps while any lane
    overflowed: ``s_cap`` where a frontier did, ``h_cap`` where a hit
    buffer did, at most ``max_retries`` attempts (eight take s_cap from 64
    to 8,192).  The last attempt's hits are returned, flags and all."""
    nq, m = queries.shape
    ns = tape.num_searches
    dev = index.device
    q = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.int32)).to(dev)
    act = torch.from_numpy(np.ones(nq, dtype=bool) if active is None else np.asarray(active, dtype=bool)).to(dev)
    words = torch.from_numpy(pack_tape(tape.side, tape.qpos, tape.lo, tape.hi)).to(dev)
    for attempt in range(max_retries):
        hits, cnt, flags = scheme_search(index, q, words, act, edit=edit, s_cap=s_cap, h_cap=h_cap,
                                         k=tape.max_errors)
        fovf, hovf = flags.cpu().numpy().astype(bool)
        if not (fovf.any() or hovf.any()) or attempt == max_retries - 1:
            return SearchHits(
                *(h.reshape(nq, ns, h_cap) for h in hits), count=cnt.reshape(nq, ns),
                frontier_overflow=torch.from_numpy(fovf.reshape(nq, ns)),
                hit_overflow=torch.from_numpy(hovf.reshape(nq, ns)),
            )
        if fovf.any():
            s_cap *= 2
        if hovf.any():
            h_cap *= 2
    raise ValueError("max_retries must be at least 1")


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
    """``run_scheme_search`` over chunks of ``chunk`` queries, the last
    padded with inactive lanes to the others' shape; each chunk retries on
    its own."""
    nq, m = queries.shape
    if nq <= chunk:
        return run_scheme_search(index, queries, tape, edit=edit, active=active, s_cap=s_cap, h_cap=h_cap,
                                 max_retries=max_retries)
    act = np.ones(nq, dtype=bool) if active is None else np.asarray(active, dtype=bool)
    parts = []
    for start in range(0, nq, chunk):
        q, a = queries[start : start + chunk], act[start : start + chunk]
        if q.shape[0] < chunk:
            pad = chunk - q.shape[0]
            q = np.concatenate([q, np.zeros((pad, m), dtype=q.dtype)])
            a = np.concatenate([a, np.zeros(pad, dtype=bool)])
        parts.append(run_scheme_search(index, q, tape, edit=edit, active=a, s_cap=s_cap, h_cap=h_cap,
                                       max_retries=max_retries))
    return _concat_hits(parts, nq)
