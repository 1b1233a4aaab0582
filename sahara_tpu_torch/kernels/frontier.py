"""K8 frontier_step: one step of the frontier engine for every (query,
search) lane in one launch (csrc/frontier.cu).

The Hopper counterpart of the ``lax.scan`` step of
``sahara_tpu/engine/approx.py::scheme_search``.  Lane b = q * ns + s holds
``s_cap`` frontier slots, int32 planes (lb, lbr, sz, err, d, op) of
``state[6, B, s_cap]``, and ``live[b]``: its live slots are the prefix
``0 .. live[b] - 1`` (each with sz > 0).  A step

1. appends the live slots that consumed the query (d >= m) and whose span
   ends in no deleted character (no edge bit in op) to the lane's hit
   buffers ``hits[3, B, h_cap]`` (lb, sz, err) at ``hit_cnt[b]``, and sets
   ``flags[1, b]`` when they do not fit;
2. ranks every other live slot at both interval ends on its side's table;
3. writes its children (match or substitution per symbol 1..sigma-1; for
   edit distance a deletion per symbol and one insertion), compacted, into
   ``out[6, B, s_cap]`` and their number, at most s_cap, into
   ``out_live[b]``, and sets ``flags[0, b]`` when they do not fit.

Children come out kind first (match/sub of symbol 1, of symbol 2, ...,
deletions, insertion), then by slot, the reference's order, so that the
hits a lane finds come in its order too.  Slots past ``out_live`` are left
as they were (the kernel) or zeroed (the plain version); no step reads them.

The tape word of search s at depth d is ``side | lo << 1 | hi << 5 |
qpos << 9`` (``pack_tape``).  ``frontier_step_plain`` is the same function
in PyTorch, a transcription of the reference's step, which the wrapper
takes for CPU tensors only.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from sahara_tpu_torch import trace
from sahara_tpu_torch.engine.rank import ROW_INTS, rank_all_offset
from sahara_tpu_torch.kernels import LAUNCHES, check, on_cuda, raise_on_error, stream_of
from sahara_tpu_torch.kernels._build import load

OP_MATCH, OP_INS, OP_DEL = 0, 1, 2
EDGE_L, EDGE_R = 4, 8
EDGES = EDGE_L | EDGE_R
LB, LBR, SZ, ERR, D, OP = range(6)  # the planes of a frontier state

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = load("frontier").sahara_frontier_step
        fn.restype = ctypes.c_int
        fn.argtypes = [_P] * 12 + [_I64, _I, _I, _I, _I, _I64, _I, _I, _P]
        _fn = fn
    return _fn


def pack_tape(side: np.ndarray, qpos: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """int32[ns, m] tape words of a scheme tape's arrays."""
    if hi.size and int(hi.max()) > 15:
        raise ValueError("the frontier step takes at most 15 errors")
    return (side | (lo << 1) | (hi << 5) | (qpos << 9)).astype(np.int32)


@dataclasses.dataclass
class FrontierContext:
    """What every step of one search reads: the stacked occ16 table, the C
    array, the int32[nq, m] queries, the packed tape and the sizes:
    ``s_cap`` and ``h_cap`` are the widths of a lane's slots and hits, and
    ``caps``, int32[2, B] or None, each lane's own caps (at most the
    widths) where lanes differ.  Built on the card, it checks them once and
    gathers ``qt``, int8[nq * ns, m]: each lane's query char at each tape
    position, which K8 reads in place of the query and the tape's qpos."""

    occ16: torch.Tensor
    c_arr: torch.Tensor
    queries: torch.Tensor
    tape: torch.Tensor
    sigma: int
    edit: bool
    ns: int
    rev_off: int  # word offset of the table that serves right extensions
    s_cap: int
    h_cap: int
    caps: torch.Tensor | None = None
    cuda: bool = dataclasses.field(init=False)
    qt: torch.Tensor | None = dataclasses.field(init=False, default=None)

    def __post_init__(self):
        self.cuda = on_cuda(self.occ16, self.c_arr, self.queries, self.tape,
                            *(() if self.caps is None else (self.caps,)))
        if self.cuda:
            _check_int32(("occ16", self.occ16, None), ("c_arr", self.c_arr, (self.sigma + 1,)),
                          ("queries", self.queries, None), ("tape", self.tape, (self.ns, self.m)),
                          *(() if self.caps is None else (("caps", self.caps, (2, self.lanes)),)))
            if self.occ16.shape[1] != ROW_INTS or not 2 <= self.sigma <= ROW_INTS // 2:
                raise ValueError(f"the frontier step takes occ16 rows [W, {ROW_INTS}] and 2 <= sigma <= 8")
            if min(self.s_cap, self.h_cap) < 1:
                raise ValueError("the frontier step takes s_cap and h_cap of at least 1")
        if self.caps is not None:  # K8 writes a lane's children and hits below its caps
            widths = trace.to_device(torch.tensor([[self.s_cap], [self.h_cap]], dtype=torch.int32),
                                     self.caps.device, "frontier.caps_widths")
            with trace.sync("frontier.caps_check"):
                fits = bool(((self.caps >= 1) & (self.caps <= widths)).all())
            if not fits:
                raise ValueError("each lane's caps must lie between 1 and (s_cap, h_cap)")
        if not self.cuda:
            return
        self.qt = self.queries[:, self.tape >> 9].to(torch.int8).reshape(self.lanes, self.m)

    @property
    def m(self) -> int:
        return self.queries.shape[1]

    @property
    def lanes(self) -> int:
        return self.queries.shape[0] * self.ns


def _check_int32(*args) -> None:
    """Raise unless each (name, tensor, shape) is contiguous int32 of that
    shape (shape None: any 2-D)."""
    for name, t, shape in args:
        check(name, t, torch.int32, 2 if shape is None else len(shape))
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")


def n_kinds(sigma: int, edit: bool) -> int:
    """Children a slot can have: match/sub per symbol 1..sigma-1, and for
    edit distance a deletion per symbol plus one insertion."""
    return 2 * (sigma - 1) + 1 if edit else sigma - 1


def frontier_step_plain(ctx: FrontierContext, state, live, out, out_live, hits, hit_cnt, flags) -> None:
    """One step (see the module docstring): reads ``state`` and ``live``,
    writes ``out`` and ``out_live``; updates ``hits``, ``hit_cnt`` and
    ``flags`` in place.  The reference's step, on the live slots only."""
    b, m, sigma = ctx.lanes, ctx.m, ctx.sigma
    s_lim, h_lim = ctx.caps if ctx.caps is not None else torch.tensor(
        [[ctx.s_cap], [ctx.h_cap]], dtype=torch.int32, device=live.device).expand(2, b)
    alive = torch.arange(ctx.s_cap, device=live.device) < live[:, None]
    d, op = state[D], state[OP]

    # 1. hits: finished slots in slot order after the lane's earlier hits
    done = alive & (d >= m)
    finished = done & ((op & EDGES) == 0)
    fidx = torch.cumsum(finished.to(torch.int32), dim=1) - 1 + hit_cnt[:, None]
    put = finished & (fidx < h_lim[:, None])
    lanes_h, slots_h = torch.nonzero(put, as_tuple=True)
    for plane, src in enumerate((LB, SZ, ERR)):
        hits[plane][lanes_h, fidx[put].long()] = state[src][lanes_h, slots_h]
    new_hits = finished.sum(dim=1, dtype=torch.int32)
    flags[1] |= (hit_cnt + new_hits > h_lim).to(torch.int32)
    hit_cnt.copy_(torch.minimum(hit_cnt + new_hits, h_lim))

    # 2. tape and ranks of the live slots, in (lane, slot) order
    lane, slot = torch.nonzero(alive & ~done, as_tuple=True)
    lb, lbr, sz, err, d, op = state[:, lane, slot]
    word = ctx.tape[lane % ctx.ns, d]
    side, lo_b, hi_b, qp = word & 1, (word >> 1) & 0xF, (word >> 5) & 0xF, word >> 9
    qc = ctx.queries[lane // ctx.ns, qp]
    primary = torch.where(side == 1, lbr, lb)
    secondary = torch.where(side == 1, lb, lbr)
    woff = side * ctx.rev_off
    r_lo = rank_all_offset(ctx.occ16, sigma, primary, woff)
    cnt = rank_all_offset(ctx.occ16, sigma, primary + sz, woff) - r_lo
    new_primary = ctx.c_arr[:sigma] + r_lo
    new_secondary = secondary[:, None] + torch.cumsum(cnt, dim=1, dtype=torch.int32) - cnt
    ext_lb = torch.where(side[:, None] == 1, new_secondary, new_primary)
    ext_lbr = torch.where(side[:, None] == 1, new_primary, new_secondary)

    # 3. children: (ok, lb, lbr, sz, err, d, op) of each kind
    ms_op = op & torch.where(side == 0, EDGE_R, EDGE_L)
    del_op = OP_DEL | (op & EDGES) | torch.where(side == 0, EDGE_L, EDGE_R)
    last = op & 3
    kinds = []
    for c in range(1, sigma):
        e2 = err + (qc != c).to(torch.int32)
        ok = (cnt[:, c] > 0) & (e2 <= hi_b) & (e2 >= lo_b)
        kinds.append((ok, ext_lb[:, c], ext_lbr[:, c], cnt[:, c], e2, d + 1, ms_op))
    if ctx.edit:
        for c in range(1, sigma):
            ok = (cnt[:, c] > 0) & (err + 1 <= hi_b) & (d > 0) & (last != OP_INS)
            kinds.append((ok, ext_lb[:, c], ext_lbr[:, c], cnt[:, c], err + 1, d, del_op))
        ok = (err + 1 <= hi_b) & (err + 1 >= lo_b) & (last != OP_DEL)
        kinds.append((ok, lb, lbr, sz, err + 1, d + 1, OP_INS | (op & EDGES)))
    c_ok, *fields = (torch.stack(f, dim=1) for f in zip(*kinds))

    # 4. compaction: a lane's children kind first, then by slot
    live_kid, kind = torch.nonzero(c_ok, as_tuple=True)
    order = torch.sort(lane[live_kid] * len(kinds) + kind, stable=True).indices
    live_kid, kind = live_kid[order], kind[order]
    kid_lane = lane[live_kid]
    total = torch.bincount(kid_lane, minlength=b)
    flags[0] |= (total > s_lim).to(torch.int32)
    out_live.copy_(torch.minimum(total, s_lim))
    first = torch.cumsum(total, dim=0) - total
    dest = torch.arange(len(kid_lane), device=kid_lane.device) - first[kid_lane]
    keep = dest < s_lim[kid_lane]
    out.zero_()
    for plane, f in enumerate(fields):
        out[plane][kid_lane[keep], dest[keep]] = f[live_kid[keep], kind[keep]].to(torch.int32)


def check_step(ctx: FrontierContext, state, live, out, out_live, hits, hit_cnt, flags) -> None:
    """Raise unless the step's buffers lie on the context's device and, on
    the card, have the dtypes and shapes K8 takes."""
    if on_cuda(ctx.occ16, state, live, out, out_live, hits, hit_cnt, flags) != ctx.cuda:
        raise ValueError("the frontier step's buffers must lie on its context's device")
    if not ctx.cuda:
        return
    b = ctx.lanes
    _check_int32(("state", state, (6, b, ctx.s_cap)), ("live", live, (b,)), ("out", out, (6, b, ctx.s_cap)),
                 ("out_live", out_live, (b,)), ("hits", hits, (3, b, ctx.h_cap)), ("hit_cnt", hit_cnt, (b,)),
                 ("flags", flags, (2, b)))


def frontier_step(ctx: FrontierContext, state, live, out, out_live, hits, hit_cnt, flags, *,
                  checked: bool = False) -> None:
    """One step (see ``frontier_step_plain``): the kernel on the card.
    ``checked``: the caller has passed these buffers through ``check_step``
    (``scheme_search`` does so once a search, then only launches)."""
    if not checked:
        check_step(ctx, state, live, out, out_live, hits, hit_cnt, flags)
    if not ctx.cuda:
        frontier_step_plain(ctx, state, live, out, out_live, hits, hit_cnt, flags)
        return
    if ctx.lanes == 0:
        return
    rc = _kernel()(
        ctx.occ16.data_ptr(), ctx.c_arr.data_ptr(), ctx.qt.data_ptr(), ctx.tape.data_ptr(), state.data_ptr(),
        live.data_ptr(), None if ctx.caps is None else ctx.caps.data_ptr(), out.data_ptr(), out_live.data_ptr(),
        hits.data_ptr(), hit_cnt.data_ptr(), flags.data_ptr(), ctx.lanes, ctx.sigma, int(ctx.edit), ctx.m, ctx.ns,
        ctx.rev_off, ctx.s_cap, ctx.h_cap, stream_of(state),
    )
    raise_on_error(rc, "frontier_step")
    LAUNCHES["frontier_step"] += 1
