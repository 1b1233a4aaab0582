"""The work-queue engine's dedup in one call: two launches, ``dedup_elect``
and ``dedup_kill`` (csrc/workq.cu, ``sahara_workq_dedup``).

The Hopper counterpart of ``_dedup_sz`` in ``sahara_tpu/engine/workq.py``
(``make_step``).
Every ``dedup_every``-th step after phase 0 each live state of the queue
hashes its cursor (lb, lbr, sz, d, s, q); a scatter-min elects per hash slot
the state of least (err, op/edge flags, row); a state dies only when that
winner has the same cursor, is not itself, and can reproduce every future
transition of it (equal err, or lower err once no later lower bound exceeds
it; a subset of its edge flags; a compatible last op).  Collisions and
non-dominating winners kill nothing, so the hit positions are unchanged.

The kernel decodes the meta words and reads the tape words itself, from the
step context (``kernels/workq.py::StepContext``), and adds its kills to the
context's counters, which K5's count read-back returns.  Its hash table
stays in the context: each entry carries the tag of the call that wrote it
(``dedup_epoch``), so no call clears it.
``workq_dedup_plain`` is the same function in PyTorch, which the wrapper
takes for CPU tensors only.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sahara_tpu_torch.kernels import LAUNCHES, check, on_cuda, raise_on_error
from sahara_tpu_torch.kernels._build import load
from sahara_tpu_torch.kernels.workq import EDGES, MAX_ROWS, StepContext, _Static

HASH = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)  # kHash0..3 of csrc/workq.cu
_I32_MAX = np.iinfo(np.int32).max
_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = load("workq").sahara_workq_dedup
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(_Static)] + [_P] * 4 + [_I64, _P, _P, _I64, ctypes.c_uint32, _P]
        _fn = fn
    return _fn


def table_bits(n: int) -> int:
    """cb of an n-row queue: the hash table has 2^cb slots, and a
    priority's row field is cb bits wide."""
    return (n - 1).bit_length()


def dedup_keys(lb, lbr, sz, meta, layout) -> tuple[torch.Tensor, torch.Tensor]:
    """(slot, priority) int64 of every row: the hash of its cursor cut to
    the table, and err << (cb + 2) | min(bad, 3) << cb | row, bad counting
    its op and edge flags; int32 max for a dead row, which elects nothing."""
    n = sz.shape[0]
    cb = table_bits(n)
    opf, err, _, _, _ = layout.decode(meta)
    key = meta & layout.key_mask_i32
    hsh = (lb.long() * HASH[0]) ^ (lbr.long() * HASH[1]) ^ (sz.long() * HASH[2]) ^ (key.long() * HASH[3])
    row = torch.arange(n, dtype=torch.int64, device=sz.device)
    bad = ((opf & 3) != 0).long() + ((opf >> 2) & 1) + ((opf >> 3) & 1)
    pri = (err.long() << (cb + 2)) | (bad.clamp(max=3) << cb) | row
    return hsh & ((1 << cb) - 1), torch.where(sz > 0, pri, _I32_MAX)


def workq_dedup_plain(ctx: StepContext, lb, lbr, sz, meta) -> torch.Tensor:
    """``sz`` with dominated states set to 0; adds the states it zeroed to
    ``ctx.dedup_kills``."""
    layout, m, n = ctx.layout, ctx.m, sz.shape[0]
    opf, err, d, s_id, q_id = layout.decode(meta)
    maxlo = (ctx.tape[(q_id.long() * ctx.ns + s_id) * m + d.clamp(max=m - 1)] >> 17) & 0xF
    hsh, pri = dedup_keys(lb, lbr, sz, meta, layout)
    ht = 1 << table_bits(n)
    table = torch.full((ht,), _I32_MAX, dtype=torch.int64, device=sz.device)
    table.scatter_reduce_(0, hsh, pri, reduce="amin")
    win = (table[hsh] & (ht - 1)).clamp(max=n - 1)
    w_meta = meta[win]
    w_opf, w_err, _, _, _ = layout.decode(w_meta)
    same = (lb[win] == lb) & (lbr[win] == lbr) & (sz[win] == sz) & (((w_meta ^ meta) & layout.key_mask_i32) == 0)
    err_dom = (w_err == err) | ((w_err < err) & (maxlo <= w_err))
    edge_dom = (w_opf & EDGES & ~opf) == 0
    op_dom = ((w_opf & 3) == 0) | ((w_opf & 3) == (opf & 3))
    kill = (sz > 0) & same & (win != torch.arange(n, device=sz.device)) & err_dom & edge_dom & op_dom
    ctx.dedup_kills += int(kill.sum())
    return torch.where(kill, 0, sz)


def workq_dedup(ctx: StepContext, lb, lbr, sz, meta) -> torch.Tensor:
    """The dedup (see ``workq_dedup_plain``): on CUDA tensors two launches
    on the context's stream (the current one when the search began, which
    K5 launches on too), no read-back;
    the kills go to ``ctx.counters[3]``.  A call allocates only its output;
    the context's table is made, zero, where a queue needs more slots than
    it has."""
    if not on_cuda(ctx.tape, lb, lbr, sz, meta):
        return workq_dedup_plain(ctx, lb, lbr, sz, meta)
    if ctx.static is None:
        raise ValueError("the step context was made for CPU tensors")
    for name, t in (("lb", lb), ("lbr", lbr), ("sz", sz), ("meta", meta)):
        check(name, t, torch.int32, 1)
        if t.shape != sz.shape:
            raise ValueError(f"{name}: every state vector must have the same length")
    n = sz.shape[0]
    if n > MAX_ROWS:
        raise ValueError(f"the dedup takes queues of at most {MAX_ROWS} rows")
    out = torch.empty_like(sz)
    if n == 0:
        return out
    ht = 1 << table_bits(n)
    if ctx.dedup_table is None or ctx.dedup_table.shape[0] < ht:
        ctx.dedup_table, ctx.dedup_epoch = torch.zeros(ht, dtype=torch.int64, device=sz.device), 0
    ctx.dedup_epoch += 1
    if ctx.dedup_epoch == 1 << 32:  # every tag used: retire the old entries and start over
        ctx.dedup_table.zero_()
        ctx.dedup_epoch = 1
    table = ctx.dedup_table
    rc = _kernel()(
        ctypes.byref(ctx.static), lb.data_ptr(), lbr.data_ptr(), sz.data_ptr(), meta.data_ptr(), n, out.data_ptr(),
        table.data_ptr(), table.shape[0], ctx.dedup_epoch, ctx.stream,
    )
    raise_on_error(rc, "workq_dedup")
    LAUNCHES["workq_dedup"] += 1
    return out
