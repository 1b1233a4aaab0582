"""Work-queue scheme-search engine: one dense queue of live search states.

The counterpart of ``sahara_tpu/engine/workq.py``.  Every (query, search)
lane of a chunk starts as one state (lb, lbr, sz, meta) — the bidirectional
interval [lb, lb + sz) of the forward index, its mirror lbr on the reversed
text, and a packed meta word (op/edge flags | err | d | search | query, see
``MetaLayout``).  Each step extends every live state by one tape character:

1. dedup    every ``dedup_every``-th step after phase 0, merge states that a
            surviving state dominates (a min over a hash of the cursor, then
            a field-by-field check): ``kernels/dedup.py``, two launches
            with no read-back, or its plain version on the CPU;
2. step     K5 ``workq_step``, one launch: on drain steps (from step m on)
            states that consumed the whole query leave as hits (lane, lb,
            sz, err) unless an edge flag says a shorter span exists, and with
            ``cap_per_query`` the states of queries that emitted enough stop;
            every other live state is ranked and expanded, and its children,
            compacted in parent-major order, are the next step's queue.  The
            host reads the (children, hits) totals once.

Transition semantics are the reference's (match/sub/del/ins, minimal-span
edge flags, I-D adjacency suppression); with ``dedup=False`` the hit
multiset equals ``sahara_tpu``'s exactly.  Phase 0 (the exact prefix every
search shares, ``phase0_length``) runs through the same step: its tape
bounds admit only the match branch, so each lane keeps at most one state,
as the reference's lockstep phase 0 does.  One difference there: a query
rank of 0 (the sentinel) never matches, where the reference's phase 0 lets
it match a sequence boundary.

There is no capacity plan, no overflow flag and no retry: the step sizes
its outputs by their bound (every branch of every row, every row a hit),
reads its child count once and narrows the next queue to it.  A step
whose child count passes ``HARD_CAP`` raises ``QueueOverflow``; the driver
then halves the chunk's active queries.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sahara_tpu_torch import trace
from sahara_tpu_torch.engine.device import DeviceIndex
from sahara_tpu_torch.engine.tape import SchemeTape
from sahara_tpu_torch.kernels.dedup import workq_dedup
from sahara_tpu_torch.kernels.workq import StepContext, step_context, workq_step

MAX_NS = 8  # searches per tape (the driver splits bigger schemes into groups)
MAX_M = 511
MAX_ERR = 7
DEDUP_EVERY = 4  # the reference's default cadence (SAHARA_DEDUP_EVERY)

# Ceiling on one step's child count (rows).  Module attribute so tests can
# shrink it to exercise the driver's active-set split.
HARD_CAP = 1 << 23


def _i32(x: int) -> int:
    """A 32-bit pattern as the signed int32 value with the same bits."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


class QueueOverflow(RuntimeError):
    """A step's child count passed ``HARD_CAP``."""


@dataclasses.dataclass(frozen=True)
class MetaLayout:
    """Bit layout of the packed per-state meta word, sized to the
    workload: opf | err | d | s_id | q_id, the query id taking every spare
    bit (Hamming tapes carry no op/edge bits at all)."""

    opf_bits: int
    err_bits: int
    d_bits: int
    s_bits: int

    @property
    def err_shift(self) -> int:
        return self.opf_bits

    @property
    def d_shift(self) -> int:
        return self.opf_bits + self.err_bits

    @property
    def s_shift(self) -> int:
        return self.d_shift + self.d_bits

    @property
    def q_shift(self) -> int:
        return self.s_shift + self.s_bits

    @property
    def q_bits(self) -> int:
        return 32 - self.q_shift

    @property
    def max_nq(self) -> int:
        return 1 << self.q_bits

    @property
    def key_mask_i32(self) -> int:
        """d | s | q: the cursor's identity without op and err bits."""
        return _i32(~((1 << self.d_shift) - 1))

    @property
    def rest_mask_i32(self) -> int:
        """s | q: the bits a child copies from its parent."""
        return _i32(~((1 << self.s_shift) - 1))

    def decode(self, meta: torch.Tensor):
        """(opf, err, d, s_id, q_id) int32 tensors of packed meta words."""
        def field(shift: int, bits: int) -> torch.Tensor:
            return (meta >> shift) & ((1 << bits) - 1)

        return (
            field(0, self.opf_bits), field(self.err_shift, self.err_bits), field(self.d_shift, self.d_bits),
            field(self.s_shift, self.s_bits), field(self.q_shift, self.q_bits),
        )


def meta_layout(m: int, ns: int, k: int, edit: bool) -> MetaLayout:
    return MetaLayout(
        opf_bits=4 if edit else 0,
        err_bits=max(int(k).bit_length(), 1),
        d_bits=int(m).bit_length(),  # d reaches m
        s_bits=max(int(ns - 1).bit_length(), 1) if ns > 1 else 0,
    )


def max_chunk_queries(m: int, ns: int, k: int, edit: bool) -> int:
    """Largest per-call query count the meta packing supports."""
    return min(meta_layout(m, ns, k, edit).max_nq, 1 << 17)


@dataclasses.dataclass
class FlatHits:
    """Global hit list: parallel int32 arrays over hits."""

    lane: np.ndarray  # lane = query * ns + search
    lb: np.ndarray
    sz: np.ndarray
    err: np.ndarray
    n_hits: int


def main_tail_steps(m: int, ph0: int, k: int, edit: bool) -> tuple[int, int]:
    """(main_steps, tail_steps) after phase 0: no state can reach d == m
    during the main steps (d grows by at most one per step), and every
    state has finished or died after the tail."""
    main_steps = max(m - ph0 - 1, 0)
    tail_steps = (m - ph0) + 1 + (k if edit else 0) - main_steps
    return main_steps, tail_steps


def phase0_length(tape: SchemeTape, edit: bool) -> int:
    """Steps during which every search still has u == 0: one state per
    lane, extended by its exact match only."""
    ph0 = 0
    for t in range(tape.length):
        if (tape.hi[:, t] == 0).all():
            ph0 = t + 1
        else:
            break
    return ph0


def upload_tape(tape: SchemeTape, device) -> tuple[torch.Tensor, ...]:
    """(side, qpos, lo, hi) int32[ns, m] on the device, reused across chunks."""
    return tuple(trace.to_device(torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)), device, "workq.tape")
                 for a in (tape.side, tape.qpos, tape.lo, tape.hi))


def pack_lane_tape(queries: torch.Tensor, side, qpos, lo, hi) -> torch.Tensor:
    """Per-lane tape words int32[nq * ns * m]: side | lo<<1 | hi<<5 | qc<<9
    | maxlo<<17.  ``qc`` is the query character the step consumes (one
    integer gather), ``maxlo`` the largest lower bound from this step on,
    which gates the err-dominance merge."""
    maxlo = torch.flip(torch.cummax(torch.flip(lo, [1]), dim=1).values, [1])
    qc = queries.to(torch.int32)[:, qpos.long()]  # [nq, ns, m]
    word = side | (lo << 1) | (hi << 5) | (qc << 9) | (maxlo << 17)
    return word.reshape(-1).contiguous()


def start_queue(index: DeviceIndex, queries: torch.Tensor, device_tape, active: torch.Tensor, *, edit: bool,
                k: int, cap_per_query: int = 0) -> tuple[StepContext, tuple[torch.Tensor, ...]]:
    """The step context and the first queue: one state per active lane, in
    lane order, on the whole text at d = 0."""
    nq, m = queries.shape
    ns = device_tape[0].shape[0]
    sigma = index.sigma
    layout = meta_layout(m, ns, k, edit)
    if nq > layout.max_nq or ns > MAX_NS or m > MAX_M or k > MAX_ERR or sigma > 8:
        raise ValueError(
            f"workq meta packing limits exceeded (nq<={layout.max_nq} for this workload, "
            "ns<=8, m<=511, k<=7, sigma<=8)"
        )
    if not index.bidirectional:
        raise ValueError("scheme search requires a bidirectional index")
    lanes = torch.arange(nq * ns, dtype=torch.int64, device=index.device)
    with trace.sync("workq.lanes"):
        lanes = lanes[active[lanes // ns]]
    meta = ((lanes % ns) << layout.s_shift) | ((lanes // ns) << layout.q_shift)
    meta = torch.where(meta >= 1 << 31, meta - (1 << 32), meta).to(torch.int32)
    ctx = step_context(
        index.occ, index.c_arr, pack_lane_tape(queries, *device_tape), sigma=sigma,
        sl=max(min(index.sigma_live or sigma, sigma), 2), edit=edit, m=m, ns=ns, rev_off=index.rev_word_off,
        layout=layout, max_rows=max(meta.shape[0], HARD_CAP),
        hq_counts=torch.zeros(nq, dtype=torch.int32, device=index.device) if cap_per_query else None,
        cap_per_query=cap_per_query,
    )
    return ctx, (torch.zeros_like(meta), torch.zeros_like(meta), torch.full_like(meta, index.n), meta)


def expand_step(ctx: StepContext, state: tuple[torch.Tensor, ...], *, drain: bool = False):
    """One K5 step: (the next queue, this step's hits int32[4, h]).  On a
    drain step with the in-search cap, adds the hits to the per-query
    counts."""
    lb, lbr, sz, meta, hits = workq_step(ctx, *state, drain=drain)
    if sz.shape[0] > HARD_CAP:
        raise QueueOverflow(f"a step needs {sz.shape[0]} queue rows, over HARD_CAP={HARD_CAP}")
    if ctx.cap_per_query and hits.shape[1]:
        ctx.hq_counts.index_add_(0, (hits[0] // ctx.ns).long(), torch.ones_like(hits[0]))
    return (lb, lbr, sz, meta), hits


@trace.spanned("workq.search")
def workq_search(
    index: DeviceIndex,
    queries: torch.Tensor,
    device_tape: tuple[torch.Tensor, ...],
    active: torch.Tensor,
    *,
    edit: bool,
    k: int,
    ph0: int,
    dedup_every: int = 0,
    cap_per_query: int = 0,
) -> FlatHits:
    """Search one chunk: ``queries`` int[nq, m] and ``active`` bool[nq] on
    the index's device, ``device_tape`` from ``upload_tape``.

    ``cap_per_query`` > 0 stops expanding a query once it has emitted that
    many hit intervals (the reference's in-search bound; the count may
    overshoot by one step's worth, so the driver still caps rows).

    Traced (``trace.py``) as the span ``workq.search``, each dedup as
    ``workq.dedup``; counters ``workq.queue_rows`` (the rows entering each
    step, summed), ``workq.hit_intervals`` and ``workq.dedup_kills`` (the
    rows the dedups zeroed, read back with K5's counts on the card)."""
    m = queries.shape[1]
    ctx, state = start_queue(index, queries, device_tape, active, edit=edit, k=k, cap_per_query=cap_per_query)
    hits: list[torch.Tensor] = []
    main_steps, tail_steps = main_tail_steps(m, ph0, k, edit)
    for g in range(ph0 + main_steps + tail_steps):
        lb, lbr, sz, meta = state
        if sz.shape[0] == 0:
            break
        if dedup_every and g >= ph0 and (g - ph0) % dedup_every == 0:
            with trace.span("workq.dedup"):
                state = (lb, lbr, workq_dedup(ctx, lb, lbr, sz, meta), meta)
        trace.count("workq.queue_rows", sz.shape[0])
        # only from step m on can a state have consumed all m characters
        state, step_hits = expand_step(ctx, state, drain=g >= m)
        if step_hits.shape[1]:
            hits.append(step_hits)
    out = trace.to_host(torch.cat(hits, dim=1), "workq.hits").numpy() if hits else np.zeros((4, 0), dtype=np.int32)
    trace.count("workq.hit_intervals", out.shape[1])
    trace.count("workq.dedup_kills", ctx.dedup_kills)
    return FlatHits(lane=out[0], lb=out[1], sz=out[2], err=out[3], n_hits=out.shape[1])


def run_workq_search(
    index: DeviceIndex,
    queries: np.ndarray,
    tape: SchemeTape,
    *,
    edit: bool,
    active: np.ndarray | None = None,
    dedup: bool = False,
    max_hits: int = 0,
) -> FlatHits:
    """Host wrapper: upload the queries and the tape and search them in one
    call, with dedup every ``DEDUP_EVERY`` steps when ``dedup``.
    ``max_hits`` > 0 engages the in-search bound at 4x the cap, as the
    reference does."""
    dev = index.device
    act = np.ones(queries.shape[0], dtype=bool) if active is None else np.asarray(active, dtype=bool)
    return workq_search(
        index,
        trace.to_device(torch.from_numpy(np.ascontiguousarray(queries, dtype=np.int32)), dev, "workq.queries"),
        upload_tape(tape, dev),
        trace.to_device(torch.from_numpy(act), dev, "workq.active"),
        edit=edit, k=tape.max_errors, ph0=phase0_length(tape, edit), dedup_every=DEDUP_EVERY if dedup else 0,
        cap_per_query=4 * max_hits if max_hits > 0 else 0,
    )
