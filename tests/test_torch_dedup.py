"""The work-queue dedup (``kernels/dedup.py``) on the CPU: the kernel's
32-bit hash and priority restated in numpy against the plain version's
int64 ones, and the wrapper's plain path on queues with planted duplicates.
The kernel itself is held against the plain version on the card
(``tests/test_torch_gpu.py -k dedup``)."""

import numpy as np
import pytest
import torch

from sahara_tpu_torch.engine import workq
from sahara_tpu_torch.engine.workq import MetaLayout, meta_layout
from sahara_tpu_torch.kernels import LAUNCHES
from sahara_tpu_torch.kernels.dedup import HASH, dedup_keys, table_bits, workq_dedup, workq_dedup_plain
from sahara_tpu_torch.kernels.workq import EDGES, MAX_ROWS, step_context
from tests import torch_support  # noqa: F401  (PyTorch on one thread)
from tests.test_torch_gpu import dedup_queue

NS, M = 2, 3
# opf | err | d | s | q: edit (q takes 13 bits) and Hamming (17 bits, no op or edge flags)
LAYOUTS = {"edit": MetaLayout(4, 3, 9, 3), "hamming": MetaLayout(0, 3, 9, 3)}


def kernel_keys(lb, lbr, sz, meta, layout):
    """csrc/workq.cu's slot and priority of every live row, in uint32
    arithmetic as the kernel computes them."""
    u = lambda x: x.astype(np.uint32)  # noqa: E731
    n = len(sz)
    cb = np.uint32(table_bits(n))
    key = u(meta) & np.uint32(~((1 << layout.d_shift) - 1) & 0xFFFFFFFF)
    h0, h1, h2, h3 = (np.uint32(x) for x in HASH)
    h = (u(lb) * h0) ^ (u(lbr) * h1) ^ (u(sz) * h2) ^ (key * h3)
    opf = u(meta) & np.uint32((1 << layout.opf_bits) - 1)
    err = (u(meta) >> np.uint32(layout.err_shift)) & np.uint32((1 << layout.err_bits) - 1)
    bad = (opf & 3 != 0).astype(np.uint32) + ((opf >> 2) & 1) + ((opf >> 3) & 1)
    return h & np.uint32((1 << int(cb)) - 1), kernel_priority(err, bad, np.arange(n, dtype=np.uint32), cb)


def kernel_priority(err, bad, row, cb):
    """err << (cb + 2) | min(bad, 3) << cb | row, in uint32."""
    return (err << (cb + 2)) | (np.minimum(bad, np.uint32(3)) << cb) | row


def context(layout, tape):
    return step_context(torch.zeros((1, 16), dtype=torch.int32), torch.zeros(8, dtype=torch.int32),
                        torch.from_numpy(tape), sigma=6, sl=5, edit=layout.opf_bits > 0, m=M, ns=NS, rev_off=0,
                        layout=layout, max_rows=1)


@pytest.mark.parametrize("n", [1, 2, 256, 257, 4097])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_kernel_keys_match_the_plain_keys(name, n):
    """For random int32 cursors, negative meta words among them, the
    kernel's uint32 slot and int32 priority equal the plain int64 ones."""
    layout = LAYOUTS[name]
    lb, lbr, sz, meta, _ = dedup_queue(np.random.default_rng(n), n, layout, ns=NS, m=M)
    lb[: n // 2] = np.random.default_rng(5).integers(-(1 << 31), 1 << 31, n // 2)  # any int32 bits
    hsh, pri = dedup_keys(*(torch.from_numpy(x) for x in (lb, lbr, sz, meta)), layout)
    k_hsh, k_pri = kernel_keys(lb, lbr, sz, meta, layout)
    live = sz > 0
    np.testing.assert_array_equal(k_hsh[live].astype(np.int64), hsh.numpy()[live])
    np.testing.assert_array_equal(k_pri[live].astype(np.int64), pri.numpy()[live])
    assert (pri.numpy()[~live] == np.iinfo(np.int32).max).all()
    if n > 2:
        assert (meta[live] < 0).any() and (meta[live] >= 0).any()


def test_priority_fits_int32_at_the_largest_queue():
    """At n = HARD_CAP, err = MAX_ERR and every flag set, the last row's
    priority does not wrap in uint32 and stays under 2^28, below the
    kernel's empty slot and int32's sign bit."""
    n = workq.HARD_CAP
    cb = table_bits(n)
    assert n <= MAX_ROWS and cb == 23
    top = kernel_priority(np.array([workq.MAX_ERR], np.uint32), np.array([3], np.uint32),
                          np.array([n - 1], np.uint32), np.uint32(cb))
    assert int(top[0]) == (workq.MAX_ERR << (cb + 2)) | (3 << cb) | (n - 1)
    assert int(top[0]) < 1 << 28 < 1 << 31


def test_table_entries_order_as_the_priorities():
    """The kernel's table entry epoch << 32 | ~pri: the largest of a call's
    entries is its least priority, whose low bits give the row back, and
    any entry of an earlier call is smaller than every one of this call."""
    rng = np.random.default_rng(7)
    pri = rng.choice(1 << 28, 1000, replace=False).astype(np.uint64)
    for epoch in (1, 2, (1 << 32) - 1):
        entry = (np.uint64(epoch) << np.uint64(32)) | (~pri & np.uint64(0xFFFFFFFF))
        assert entry.argmax() == pri.argmin()
        assert (~entry.max() & np.uint64(0xFFFFFFFF)) == pri.min()
        stale = (np.uint64(epoch - 1) << np.uint64(32)) | np.uint64(0xFFFFFFFF)
        assert stale < entry.min()


@pytest.mark.parametrize("n", [1, 2, 256, 257, 4097])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_dedup_on_the_cpu_kills_dominated_rows(name, n):
    """The wrapper takes the plain version on the CPU and launches nothing;
    it counts the rows it zeroes; each zeroed row's slot winner survives,
    has its cursor and dominates it; planted duplicates do die."""
    layout = LAYOUTS[name]
    lb, lbr, sz, meta, tape = dedup_queue(np.random.default_rng(100 + n), n, layout, ns=NS, m=M)
    ctx = context(layout, tape)
    q = tuple(torch.from_numpy(x) for x in (lb, lbr, sz, meta))
    launches = dict(LAUNCHES)
    got = workq_dedup(ctx, *q)
    assert LAUNCHES == launches
    killed = (got == 0) & (q[2] > 0)
    assert ctx.dedup_kills == int(killed.sum())
    assert torch.equal(got, torch.where(killed, 0, q[2]))
    assert torch.equal(workq_dedup_plain(ctx, *q), got) and ctx.dedup_kills == 2 * int(killed.sum())
    hsh, pri = dedup_keys(*q, layout)
    winner = {}
    for row in np.flatnonzero(sz > 0):
        slot = int(hsh[row])
        if slot not in winner or pri[row] < pri[winner[slot]]:
            winner[slot] = row
    opf, err, d, s, qid = (f.numpy() for f in layout.decode(q[3]))
    maxlo = (tape[(qid.astype(np.int64) * NS + s) * M + np.minimum(d, M - 1)] >> 17) & 0xF
    key = meta & layout.key_mask_i32
    for row in np.flatnonzero(killed.numpy()):
        w = winner[int(hsh[row])]
        assert w != row and got[w] > 0
        assert (lb[w], lbr[w], sz[w], key[w]) == (lb[row], lbr[row], sz[row], key[row])
        assert err[w] == err[row] or (err[w] < err[row] and maxlo[row] <= err[w])
        assert opf[w] & EDGES & ~opf[row] == 0 and (opf[w] & 3 == 0 or opf[w] & 3 == opf[row] & 3)
    assert killed.any() if n >= 256 else n > 1 or not killed.any()


def test_dedup_of_dead_rows_changes_nothing():
    layout = LAYOUTS["edit"]
    lb, lbr, sz, meta, tape = dedup_queue(np.random.default_rng(3), 300, layout, ns=NS, m=M, dead=1.0)
    ctx = context(layout, tape)
    got = workq_dedup(ctx, *(torch.from_numpy(x) for x in (lb, lbr, sz, meta)))
    assert not got.any() and ctx.dedup_kills == 0


def test_dedup_of_a_real_search_layout_on_cpu():
    """The search's own layout (100 bp, h2-k2's 3 searches, k=2, edit):
    the same function, the query id's field narrower."""
    layout = meta_layout(100, 3, 2, True)
    lb, lbr, sz, meta, tape = dedup_queue(np.random.default_rng(4), 2000, layout, ns=3, m=100)
    ctx = step_context(torch.zeros((1, 16), dtype=torch.int32), torch.zeros(8, dtype=torch.int32),
                       torch.from_numpy(tape), sigma=6, sl=5, edit=True, m=100, ns=3, rev_off=0, layout=layout,
                       max_rows=1)
    got = workq_dedup(ctx, *(torch.from_numpy(x) for x in (lb, lbr, sz, meta)))
    assert 0 < ctx.dedup_kills == int(((got == 0) & (torch.from_numpy(sz) > 0)).sum())


def test_dedup_refuses_other_devices():
    layout = LAYOUTS["edit"]
    ctx = context(layout, np.zeros(1 << 20, dtype=np.int32))
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        workq_dedup(ctx, meta, meta, meta, meta)
