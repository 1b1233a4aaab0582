"""K5 workq_step: one step of the work-queue engine in one launch
(csrc/workq.cu).

The Hopper counterpart of the step in ``sahara_tpu/engine/workq.py``
(``make_step``).  A step over a queue of n states (int32 lb, lbr, sz, meta)
drains the states that consumed the query (drain steps only), ranks every
live state at both interval ends on its side's table, and writes the child
states, compacted, with the step's hits (lane, lb, sz, err).  Children come
out parent-major: parents in queue order, each parent's children in branch
order (match/sub for symbols 1..sl-1, then for edit distance deletions
1..sl-1 and one insertion).

``step_context`` makes what every step of one search reads and checks it
once; on a CUDA device it also allocates the kernel's look-back scratch.
``workq_step_plain`` is the same function in PyTorch, which the wrapper
takes for CPU tensors only.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from sahara_tpu_torch import trace
from sahara_tpu_torch.engine.rank import ROW_INTS, rank_all_offset
from sahara_tpu_torch.kernels import LAUNCHES, check, on_cuda, raise_on_error, stream_of
from sahara_tpu_torch.kernels._build import load

OP_MATCH, OP_INS, OP_DEL = 0, 1, 2
EDGE_L, EDGE_R = 4, 8
EDGES = EDGE_L | EDGE_R

TILE = 256  # queue rows per block (kThreads in csrc/workq.cu)
MAX_ROWS = 1 << 23  # queue rows a step takes: the status word's fields are sized to it
EPOCHS = 1 << 11  # status-word tags; tag 0 marks a word never written

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_fn = None


class _Static(ctypes.Structure):
    """``StepStatic`` of csrc/workq.cu, field for field."""

    _fields_ = [(f, _P) for f in ("occ16", "c_arr", "tape", "hq_counts", "status", "counters")] + [
        (f, _I64) for f in ("sigma", "sl", "edit", "m", "ns", "rev_off", "opf_bits", "err_bits", "d_bits",
                            "s_bits", "cap_per_query", "max_tiles")
    ]


def _kernel():
    global _fn
    if _fn is None:
        fn = load("workq").sahara_workq_step
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.POINTER(_Static)] + [_P] * 4 + [_I64, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32]
                       + [_P, _I64, _P, _P])
        _fn = fn
    return _fn


def n_branches(sl: int, edit: bool) -> int:
    """Candidate branches per row: match/sub per live symbol, and for edit
    distance a deletion per live symbol plus one insertion."""
    return 2 * (sl - 1) + 1 if edit else sl - 1


@dataclasses.dataclass
class StepContext:
    """What every step of one search reads: the stacked occ table, the C
    array, the packed lane tape (``pack_lane_tape``), the static arguments,
    the in-search cap's per-query hit counts, and on a CUDA device the
    kernels' scratch: K5's tile status words, the counters, the ticket and
    epoch the host tracks, the dedup's (``kernels/dedup.py``) hash table
    and its tag, and the stream every launch of the search goes to."""

    occ16: torch.Tensor
    c_arr: torch.Tensor
    tape: torch.Tensor
    sigma: int
    sl: int
    edit: bool
    m: int
    ns: int
    rev_off: int
    layout: object  # engine.workq.MetaLayout
    hq_counts: torch.Tensor | None  # int32[nq] when cap_per_query > 0
    cap_per_query: int
    status: torch.Tensor | None = None  # int64[tiles]
    counters: torch.Tensor | None = None  # int32[4]: children total, hits total, ticket, the dedup's kills
    static: _Static | None = None
    tickets: int = 0
    epoch: int = 0
    dedup_kills: int = 0  # rows the search's dedups zeroed (kernels/dedup.py), as of the last count read-back
    dedup_table: torch.Tensor | None = None  # the dedup's hash table on a CUDA device, grown to the largest queue
    dedup_epoch: int = 0  # the last dedup's tag in that table
    stream: int = 0  # the CUDA stream current when the context was made, which K5 and the dedup launch on


def step_context(occ16, c_arr, tape, *, sigma, sl, edit, m, ns, rev_off, layout, max_rows, hq_counts=None,
                 cap_per_query=0) -> StepContext:
    """The step context of one search whose queues hold at most
    ``max_rows`` rows; checks the tensors once and, on a CUDA device,
    allocates the scratch."""
    if cap_per_query and hq_counts is None:
        raise ValueError("cap_per_query needs hq_counts")
    ctx = StepContext(occ16, c_arr, tape, sigma, sl, edit, m, ns, rev_off, layout, hq_counts, cap_per_query)
    tensors = [occ16, c_arr, tape] + ([hq_counts] if hq_counts is not None else [])
    if not on_cuda(*tensors):
        return ctx
    for name, t, ndim in (("occ16", occ16, 2), ("c_arr", c_arr, 1), ("tape", tape, 1), ("hq_counts", hq_counts, 1)):
        if t is not None:
            check(name, t, torch.int32, ndim)
    if occ16.shape[1] != ROW_INTS or not 2 <= sl <= sigma <= ROW_INTS // 2:
        raise ValueError(f"occ16 must be [W, {ROW_INTS}] with 2 <= sl <= sigma <= 8")
    if max_rows > MAX_ROWS:
        raise ValueError(f"the step kernel takes queues of at most {MAX_ROWS} rows")
    tiles = max(-(-max_rows // TILE), 1)
    ctx.status = torch.zeros(tiles, dtype=torch.int64, device=occ16.device)
    ctx.counters = torch.zeros(4, dtype=torch.int32, device=occ16.device)
    ctx.stream = stream_of(occ16)
    ctx.static = _Static(
        occ16.data_ptr(), c_arr.data_ptr(), tape.data_ptr(), hq_counts.data_ptr() if hq_counts is not None else None,
        ctx.status.data_ptr(), ctx.counters.data_ptr(), sigma, sl, int(edit), m, ns, rev_off, layout.opf_bits,
        layout.err_bits, layout.d_bits, layout.s_bits, cap_per_query, tiles,
    )
    return ctx


def workq_step_plain(ctx: StepContext, lb, lbr, sz, meta, *, drain: bool = False):
    """(lb, lbr, sz, meta) of the children, parent-major, and the hits
    int32[4, h] (lane, lb, sz, err) of a drain step, in queue order."""
    layout, sl, m, n_ms = ctx.layout, ctx.sl, ctx.m, ctx.sl - 1
    opf, err, d, s_id, q_id = layout.decode(meta)
    lane = q_id * ctx.ns + s_id
    word = ctx.tape[lane.long() * m + d.clamp(max=m - 1).long()]
    alive = sz > 0
    hit = torch.zeros_like(alive)
    if drain:
        if ctx.cap_per_query:
            alive &= ctx.hq_counts[q_id.long()] < ctx.cap_per_query
        done = alive & (d >= m)
        hit = done & ((opf & EDGES) == 0)
        alive &= ~done
    side = word & 1
    lo_b, hi_b, qc = (word >> 1) & 0xF, (word >> 5) & 0xF, (word >> 9) & 0xFF
    primary = torch.where(side == 1, lbr, lb)
    secondary = torch.where(side == 1, lb, lbr)
    woff = side * ctx.rev_off
    r_lo = rank_all_offset(ctx.occ16, ctx.sigma, primary, woff)[:, :sl]
    r_hi = rank_all_offset(ctx.occ16, ctx.sigma, primary + sz, woff)[:, :sl]
    cnt = r_hi - r_lo
    newp = ctx.c_arr[None, :sl] + r_lo
    news = secondary[:, None] + torch.cumsum(cnt, dim=1, dtype=torch.int32) - cnt
    ext_lb = torch.where(side[:, None] == 1, news, newp)[:, 1:]
    ext_lbr = torch.where(side[:, None] == 1, newp, news)[:, 1:]
    cnt, live = cnt[:, 1:], cnt[:, 1:] > 0

    # one column per branch: [flag, lb, lbr, sz, op, err, d], each [n, n_ms] or [n, 1]
    syms = torch.arange(1, sl, dtype=torch.int32, device=sz.device)[None, :]
    e_ms = err[:, None] + (qc[:, None] != syms).to(torch.int32)
    col = lambda x: x[:, None].expand(-1, n_ms)  # noqa: E731
    zero = torch.zeros_like(cnt)
    other_bit = torch.where(side == 0, EDGE_R, EDGE_L)
    branches = [(alive[:, None] & live & (e_ms <= hi_b[:, None]) & (e_ms >= lo_b[:, None]),
                 ext_lb, ext_lbr, cnt, col(opf & other_bit) if ctx.edit else zero, e_ms, col(d + 1))]
    if ctx.edit:
        last = opf & 3
        edge_bit = torch.where(side == 0, EDGE_L, EDGE_R)
        del_ok = alive & (err + 1 <= hi_b) & (d > 0) & (last != OP_INS)
        ins_ok = alive & (err + 1 <= hi_b) & (err + 1 >= lo_b) & (last != OP_DEL)
        branches.append((del_ok[:, None] & live, ext_lb, ext_lbr, cnt, col(OP_DEL | (opf & EDGES) | edge_bit),
                         col(err + 1), col(d)))
        branches.append(tuple(x[:, None] for x in (ins_ok, lb, lbr, sz, OP_INS | (opf & EDGES), err + 1, d + 1)))
    flag, c_lb, c_lbr, c_sz, c_op, c_err, c_d = (torch.cat(f, dim=1).reshape(-1) for f in zip(*branches))
    pick = torch.nonzero(flag)[:, 0]
    parent = pick // n_branches(sl, ctx.edit)
    c_meta = (c_op[pick] | (c_err[pick] << layout.err_shift) | (c_d[pick] << layout.d_shift)
              | (meta[parent] & layout.rest_mask_i32))
    fin = torch.nonzero(hit)[:, 0]
    hits = torch.stack([lane[fin], lb[fin], sz[fin], err[fin]]).to(torch.int32)
    return (*(x[pick].to(torch.int32) for x in (c_lb, c_lbr, c_sz)), c_meta.to(torch.int32), hits)


def workq_step(ctx: StepContext, lb, lbr, sz, meta, *, drain: bool = False):
    """One step (see ``workq_step_plain``): the kernel on CUDA tensors.
    Reads the (children, hits) totals once to narrow the outputs, and with
    them the dedup's running count of kills."""
    if not on_cuda(ctx.tape, lb, lbr, sz, meta):
        return workq_step_plain(ctx, lb, lbr, sz, meta, drain=drain)
    if ctx.static is None:
        raise ValueError("the step context was made for CPU tensors")
    for name, t in (("lb", lb), ("lbr", lbr), ("sz", sz), ("meta", meta)):
        check(name, t, torch.int32, 1)
        if t.shape != sz.shape:
            raise ValueError(f"{name}: every state vector must have the same length")
    n = sz.shape[0]
    tiles = -(-n // TILE)
    if tiles > ctx.static.max_tiles:
        raise ValueError(f"a queue of {n} rows is longer than the step context's {ctx.static.max_tiles * TILE}")
    cap, hit_cap = n_branches(ctx.sl, ctx.edit) * n, n if drain else 0
    out = torch.empty(4 * (cap + hit_cap), dtype=torch.int32, device=sz.device)
    children, hits = out[: 4 * cap].view(4, cap), out[4 * cap :].view(4, hit_cap)
    if n == 0:
        return (*children, hits)
    ctx.epoch += 1
    if ctx.epoch == EPOCHS:  # every tag used: retire the old words and start over
        ctx.status.zero_()
        ctx.epoch = 1
    rc = _kernel()(
        ctypes.byref(ctx.static), lb.data_ptr(), lbr.data_ptr(), sz.data_ptr(), meta.data_ptr(), n, int(drain),
        ctx.tickets & 0xFFFFFFFF, ctx.epoch, out.data_ptr(), cap, out.data_ptr() + 16 * cap if drain else None,
        ctx.stream,
    )
    raise_on_error(rc, "workq_step")
    LAUNCHES["workq_step"] += 1
    ctx.tickets += tiles
    with trace.sync("workq.step_counts"):
        n_kids, n_hits, _, ctx.dedup_kills = ctx.counters.tolist()
    return (*children[:, :n_kids], hits[:, :n_hits])
