"""K5 workq_step: the work-queue engine's step, count and emit
(csrc/workq.cu).

The Hopper counterpart of the step in
``sahara_tpu/engine/workq.py::workq_search`` (``expand_step``).  A step over
a queue of n states (int32 lb, lbr, sz, meta) is:

1. ``workq_count``: per row, rank-all at both interval ends on the side's
   table and the candidate flags, branch-major ``[e_used, n]``;
2. an inclusive ``torch.cumsum`` over the flags (the compaction scan);
3. ``workq_emit``: the child row of every flagged candidate, at its slot.

Dead rows (sz == 0) flag nothing and get zero products in both versions.
The plain versions below are the reference's arithmetic in PyTorch; the
children come out in the same branch-major order as the kernel's.
"""

from __future__ import annotations

import ctypes

import torch

from sahara_tpu_torch.engine.rank import ROW_INTS, rank_all_offset
from sahara_tpu_torch.kernels import LAUNCHES, check, on_cuda, raise_on_error, stream_of
from sahara_tpu_torch.kernels._build import load

OP_MATCH, OP_INS, OP_DEL = 0, 1, 2
EDGE_L, EDGE_R = 4, 8
EDGES = EDGE_L | EDGE_R

_fns: dict[str, ctypes._CFuncPtr] = {}

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(load("workq"), f"sahara_workq_{name}")
        fn.restype = ctypes.c_int
        if name == "count":
            fn.argtypes = [_P] * 7 + [_I64] + [_I] * 5 + [ctypes.c_int32] + [_I] * 4 + [_P] * 3
        else:
            fn.argtypes = [_P] * 8 + [_I64] + [_I] * 8 + [_P] * 5
        _fns[name] = fn
    return fn


def n_branches(sl: int, edit: bool) -> int:
    """Candidate columns per row: match/sub per live symbol, and for edit
    distance a deletion per live symbol plus one insertion."""
    return 2 * (sl - 1) + 1 if edit else sl - 1


def _tape_fields(tape: torch.Tensor, layout, meta: torch.Tensor, m: int, ns: int):
    opf, err, d, s_id, q_id = layout.decode(meta)
    lane = q_id.long() * ns + s_id.long()
    word = tape[lane * m + d.clamp(max=m - 1).long()]
    return opf, err, d, word


def workq_count_plain(occ16, c_arr, tape, lb, lbr, sz, meta, *, sigma, sl, edit, m, ns, rev_off, layout):
    """(prod int32[n, 3 * sl] = cnt | newp | news, flags uint8[e_used, n])."""
    alive = sz > 0
    opf, err, d, word = _tape_fields(tape, layout, meta, m, ns)
    side = word & 1
    lo_b, hi_b, qc = (word >> 1) & 0xF, (word >> 5) & 0xF, (word >> 9) & 0xFF
    primary = torch.where(side == 1, lbr, lb)
    secondary = torch.where(side == 1, lb, lbr)
    woff = side * rev_off
    r_lo = rank_all_offset(occ16, sigma, primary, woff)[:, :sl]
    r_hi = rank_all_offset(occ16, sigma, primary + sz, woff)[:, :sl]
    cnt = r_hi - r_lo
    prefix = torch.cumsum(cnt, dim=1, dtype=torch.int32) - cnt
    prod = torch.cat([cnt, c_arr[None, :sl] + r_lo, secondary[:, None] + prefix], dim=1)
    prod = torch.where(alive[:, None], prod, 0).to(torch.int32)
    syms = torch.arange(1, sl, dtype=torch.int32, device=sz.device)[None, :]
    live = cnt[:, 1:] > 0
    e_ms = err[:, None] + (qc[:, None] != syms).to(torch.int32)
    cols = [alive[:, None] & live & (e_ms <= hi_b[:, None]) & (e_ms >= lo_b[:, None])]
    if edit:
        last = opf & 3
        cols.append(alive[:, None] & live & ((err + 1) <= hi_b)[:, None] & (d > 0)[:, None]
                    & (last != OP_INS)[:, None])
        cols.append((alive & (err + 1 <= hi_b) & (err + 1 >= lo_b) & (last != OP_DEL))[:, None])
    flags = torch.cat(cols, dim=1).T.contiguous().to(torch.uint8)
    return prod, flags


def workq_emit_plain(flags, prod, tape, lb, lbr, sz, meta, *, sl, edit, m, ns, layout):
    """Child rows (lb, lbr, sz, meta) of the flagged candidates, in flat
    branch-major order."""
    n = sz.shape[0]
    n_ms = sl - 1
    cand = torch.nonzero(flags.reshape(-1))[:, 0]
    branch, parent = cand // n, cand % n
    p_meta = meta[parent]
    opf, err, d, word = _tape_fields(tape, layout, p_meta, m, ns)
    side = word & 1
    qc = (word >> 9) & 0xFF
    sym = torch.where(branch < n_ms, branch + 1, branch - n_ms + 1).clamp(1, sl - 1)
    p = prod[parent]
    g_cnt = p.gather(1, sym[:, None])[:, 0]
    g_newp = p.gather(1, (sl + sym)[:, None])[:, 0]
    g_news = p.gather(1, (2 * sl + sym)[:, None])[:, 0]
    new_lb = torch.where(side == 1, g_news, g_newp)
    new_lbr = torch.where(side == 1, g_newp, g_news)
    new_sz = g_cnt
    new_err = err + (qc != sym).to(torch.int32)
    new_d = d + 1
    new_op = torch.zeros_like(opf)
    if edit:
        is_del = (branch >= n_ms) & (branch < 2 * n_ms)
        is_ins = branch >= 2 * n_ms
        new_lb = torch.where(is_ins, lb[parent], new_lb)
        new_lbr = torch.where(is_ins, lbr[parent], new_lbr)
        new_sz = torch.where(is_ins, sz[parent], new_sz)
        new_err = torch.where(branch < n_ms, new_err, err + 1)
        new_d = torch.where(is_del, d, new_d)
        edge_bit = torch.where(side == 0, EDGE_L, EDGE_R)
        other_bit = torch.where(side == 0, EDGE_R, EDGE_L)
        del_op = OP_DEL | (opf & EDGES) | edge_bit
        ins_op = OP_INS | (opf & EDGES)
        new_op = torch.where(branch < n_ms, opf & other_bit, torch.where(is_del, del_op, ins_op))
    new_meta = new_op | (new_err << layout.err_shift) | (new_d << layout.d_shift) | (p_meta & layout.rest_mask_i32)
    return tuple(x.to(torch.int32) for x in (new_lb, new_lbr, new_sz, new_meta))


def _layout_args(layout) -> list[int]:
    return [layout.opf_bits, layout.err_bits, layout.d_bits, layout.s_bits]


def _check_state(occ16, c_arr, tape, lb, lbr, sz, meta, sigma, sl):
    check("occ16", occ16, torch.int32, 2)
    check("c_arr", c_arr, torch.int32, 1)
    check("tape", tape, torch.int32, 1)
    for name, t in (("lb", lb), ("lbr", lbr), ("sz", sz), ("meta", meta)):
        check(name, t, torch.int32, 1)
        if t.shape != sz.shape:
            raise ValueError(f"{name}: every state vector must have the same length")
    if occ16.shape[1] != ROW_INTS or not 2 <= sl <= sigma <= ROW_INTS // 2:
        raise ValueError(f"occ16 must be [W, {ROW_INTS}] with 2 <= sl <= sigma <= 8")


def workq_count(occ16, c_arr, tape, lb, lbr, sz, meta, *, sigma, sl, edit, m, ns, rev_off, layout):
    """Rank products and candidate flags of every queue row (see
    ``workq_count_plain``); the kernel on CUDA tensors."""
    tensors = (occ16, c_arr, tape, lb, lbr, sz, meta)
    if not on_cuda(*tensors):
        return workq_count_plain(*tensors, sigma=sigma, sl=sl, edit=edit, m=m, ns=ns, rev_off=rev_off,
                                 layout=layout)
    _check_state(*tensors, sigma, sl)
    n = sz.shape[0]
    prod = torch.empty((n, 3 * sl), dtype=torch.int32, device=sz.device)
    flags = torch.empty((n_branches(sl, edit), n), dtype=torch.uint8, device=sz.device)
    if n == 0:
        return prod, flags
    rc = _kernel("count")(
        *(t.data_ptr() for t in tensors), n, sigma, sl, int(edit), m, ns, rev_off, *_layout_args(layout),
        prod.data_ptr(), flags.data_ptr(), stream_of(sz),
    )
    raise_on_error(rc, "workq_count")
    LAUNCHES["workq_count"] += 1
    return prod, flags


def workq_emit(flags, pos, total, prod, tape, lb, lbr, sz, meta, *, sl, edit, m, ns, layout):
    """The ``total`` child rows of the flagged candidates; ``pos`` is the
    inclusive int32 scan of ``flags``.  The kernel on CUDA tensors."""
    if not on_cuda(flags, pos, prod, tape, lb, lbr, sz, meta):
        return workq_emit_plain(flags, prod, tape, lb, lbr, sz, meta, sl=sl, edit=edit, m=m, ns=ns,
                                layout=layout)
    n = sz.shape[0]
    check("flags", flags, torch.uint8, 2)
    check("pos", pos, torch.int32, 1)
    check("prod", prod, torch.int32, 2)
    if flags.shape != (n_branches(sl, edit), n) or pos.shape[0] != flags.numel() or prod.shape != (n, 3 * sl):
        raise ValueError("flags, pos and prod do not match the queue")
    out = [torch.empty(total, dtype=torch.int32, device=sz.device) for _ in range(4)]
    if n == 0 or total == 0:
        return tuple(out)
    rc = _kernel("emit")(
        flags.data_ptr(), pos.data_ptr(), prod.data_ptr(), tape.data_ptr(), lb.data_ptr(), lbr.data_ptr(),
        sz.data_ptr(), meta.data_ptr(), n, sl, int(edit), m, ns, *_layout_args(layout),
        *(t.data_ptr() for t in out), stream_of(sz),
    )
    raise_on_error(rc, "workq_emit")
    LAUNCHES["workq_emit"] += 1
    return tuple(out)
