"""sahara_tpu_torch's work-queue engine and its driver routes against
sahara_tpu's, on the CPU: hit multisets with dedup off, located rows with
dedup on, the HARD_CAP split, tape groups and the seed-and-verify fallback;
and the one-launch step against the step as a drain, a branch-major count
and an emit.  Every stage is integer, so every comparison is exact."""

import numpy as np
import pytest
import torch

from sahara_tpu.engine.device import DeviceIndex as JaxDeviceIndex
from sahara_tpu.engine.driver import search_queries as jax_search_queries
from sahara_tpu.engine.tape import compile_tape as jax_compile_tape
from sahara_tpu.engine.workq import run_workq_search as jax_run_workq_search
from sahara_tpu.index.build import build_bifmindex
from sahara_tpu.schemes import GENERATORS as JAX_GENERATORS
from sahara_tpu.schemes import expand as jax_expand
from sahara_tpu.schemes import limit_to_hamming as jax_limit_to_hamming
from sahara_tpu_torch.engine import seedverify, workq
from sahara_tpu_torch.engine.device import DeviceIndex
from sahara_tpu_torch.engine.driver import load_scheme, search_queries
from sahara_tpu_torch.engine.rank import pack_occ, rank_all_offset
from sahara_tpu_torch.engine.tape import compile_tape
from sahara_tpu_torch.index.fmindex import from_arrays
from sahara_tpu_torch.kernels.workq import EDGE_L, EDGE_R, EDGES, OP_DEL, OP_INS, workq_step_plain

from tests import torch_support  # noqa: F401  (PyTorch on one thread)
from tests.util import random_seqs

_ARRAYS = ("occ", "c_arr", "sampled", "sample_seq", "sample_pos", "seq_lens", "text4", "sa_abs", "occ_rev")


def _port_host(host):
    meta = {"kind": "bi", "sigma": host.sigma, "alphabet": host.alphabet_name, "rate": host.rate, "n": host.n,
            "mirrored": host.mirrored}
    return from_arrays({k: getattr(host, k) for k in _ARRAYS if getattr(host, k) is not None}, meta)


def _both(host):
    """(JAX device index, port host index, port CPU index) of one host index."""
    port_host = _port_host(host)
    return JaxDeviceIndex.from_host(host), port_host, DeviceIndex.from_host(port_host, device="cpu")


def _multiset(hits):
    return sorted(zip(hits.lane.tolist(), hits.lb.tolist(), hits.sz.tolist(), hits.err.tolist()))


@pytest.fixture(scope="module")
def three_seqs():
    """tests/test_workq.py's fixture: three random sequences, six 20-char
    queries, every other one with a substitution."""
    rng = np.random.default_rng(7)
    seqs = [rng.integers(1, 5, size=ln).astype(np.uint8) for ln in (300, 150, 80)]
    m, qs = 20, []
    for i in range(6):
        s = seqs[i % 3]
        p = (i * 13) % (len(s) - m)
        q = s[p : p + m].copy()
        if i % 2:
            q[5] = 1 + (q[5] % 4)
        qs.append(q)
    return (seqs, *_both(build_bifmindex(seqs, 6, "d_dna5")), np.stack(qs).astype(np.int32))


@pytest.fixture(scope="module")
def sv_workload():
    """tests/test_sv_driver.py's fixture: 24 reads of 36 chars over three
    short sequences, 20 with up to two substitutions and 4 random."""
    rng = np.random.default_rng(11)
    seqs = random_seqs(rng, 3, min_len=80, max_len=200, sigma=5)
    m, queries = 36, []
    for _ in range(20):
        s = seqs[int(rng.integers(0, len(seqs)))]
        p = int(rng.integers(0, len(s) - m))
        q = np.array(s[p : p + m], dtype=np.uint8)
        for _ in range(int(rng.integers(0, 3))):
            at = int(rng.integers(0, m))
            q[at] = 1 + (q[at] - 1 + 1) % 4
        queries.append(q)
    queries += [rng.integers(1, 5, m).astype(np.uint8) for _ in range(4)]
    return (*_both(build_bifmindex(seqs, 6, "d_dna5", rate=16)), queries)


@pytest.fixture(scope="module")
def repeat_workload():
    """tests/test_workq_split.py's fixture: 256 reads with one substitution
    over a tandem repeat, so intervals are wide and the queue is long."""
    rng = np.random.default_rng(0)
    ref = np.tile(rng.integers(1, 5, size=251).astype(np.uint8), 100)
    qs = []
    for _ in range(256):
        p = int(rng.integers(0, len(ref) - 36))
        q = ref[p : p + 36].copy()
        at = int(rng.integers(0, 36))
        q[at] = 1 + (q[at] - 1 + int(rng.integers(1, 4))) % 4
        qs.append(q)
    return (*_both(build_bifmindex([ref], 6, "d_dna5", rate=16)), qs)


def test_device_index_stacks_the_reversed_table(three_seqs):
    _, jdev, port_host, pdev, _ = three_seqs
    w = port_host.occ.shape[0]
    assert pdev.rev_rows == w and pdev.rev_word_off == w and pdev.bidirectional
    np.testing.assert_array_equal(pdev.occ[:w].numpy(), pack_occ(port_host.occ))
    np.testing.assert_array_equal(pdev.occ[w:].numpy(), pack_occ(port_host.occ_rev))
    assert pdev.sigma_live == jdev.sigma_live == 5
    sv_only = DeviceIndex.from_host(port_host, device="cpu", include_rev=False)
    assert sv_only.occ.shape[0] == w and not sv_only.bidirectional


@pytest.mark.parametrize("gen", ["optimum", "h2-k2"])
@pytest.mark.parametrize("edit", [True, False])
def test_flat_hits_multiset_equals_jax(three_seqs, gen, edit):
    """With dedup off the hit multiset is exact, phase 0 included (the port
    runs it through the general step)."""
    _, jdev, _, pdev, qarr = three_seqs
    jax_ess = jax_expand(JAX_GENERATORS[gen].generator(0, 2, 0, 0), qarr.shape[1])
    want = jax_run_workq_search(jdev, qarr, jax_compile_tape(jax_ess if edit else jax_limit_to_hamming(jax_ess)),
                                edit=edit)
    tape = compile_tape(load_scheme(gen, 0, 2, qarr.shape[1], edit=edit, sigma=6, n_text=pdev.n))
    got = workq.run_workq_search(pdev, qarr, tape, edit=edit)
    assert _multiset(got) == _multiset(want) and got.n_hits > 0


def test_active_mask_and_dedup(three_seqs):
    """Inactive queries start no lane; dedup shrinks the hit multiset and
    keeps its (lane, interval) set."""
    _, _, _, pdev, qarr = three_seqs
    tape = compile_tape(load_scheme("optimum", 0, 2, qarr.shape[1], edit=True, sigma=6, n_text=pdev.n))
    active = np.array([True, False, True, False, True, False])
    hits = workq.run_workq_search(pdev, qarr, tape, edit=True, active=active)
    assert set((hits.lane // tape.num_searches).tolist()) <= {0, 2, 4}
    full = workq.run_workq_search(pdev, qarr, tape, edit=True)
    dedup = workq.run_workq_search(pdev, qarr, tape, edit=True, dedup=True)
    assert dedup.n_hits < full.n_hits
    assert {h[:3] for h in _multiset(dedup)} == {h[:3] for h in _multiset(full)}


@pytest.mark.parametrize("mode", ["all", "besthits"])
@pytest.mark.parametrize("k", [1, 2])
def test_workq_rows_equal_jax(sv_workload, mode, k):
    jdev, _, pdev, queries = sv_workload
    kw = dict(k=k, edit=True, mode=mode, chunk=16, engine="workq")
    want = jax_search_queries(jdev, queries, **kw)
    got = search_queries(pdev, queries, device="cpu", **kw)
    assert got.rows() == want.rows() and len(want.rows()) >= 15


def test_workq_hamming_and_max_hits_rows_equal_jax(sv_workload):
    """The in-search cap (4 x max_hits) on a fixture where no query reaches
    it, and the Hamming scheme."""
    jdev, _, pdev, queries = sv_workload
    for kw in (dict(k=2, edit=False), dict(k=1, edit=True, max_hits=2)):
        want = jax_search_queries(jdev, queries, engine="workq", chunk=16, **kw)
        got = search_queries(pdev, queries, engine="workq", chunk=16, device="cpu", **kw)
        assert got.rows() == want.rows()


def test_auto_routes_short_reads_to_workq(sv_workload):
    """Too short for exact parts (20 chars at k=2): both packages' auto
    take one-error seeds, whose seed search is the work-queue engine's; same
    rows."""
    jdev, _, pdev, queries = sv_workload
    short = [q[:20] for q in queries[:6]]
    want = jax_search_queries(jdev, short, k=2, edit=True, chunk=8)
    assert search_queries(pdev, short, k=2, edit=True, chunk=8, device="cpu").rows() == want.rows()


def test_hard_cap_split_gives_the_same_rows(repeat_workload, monkeypatch):
    jdev, _, pdev, qs = repeat_workload
    kw = dict(k=1, generator_name="optimum", edit=True, mode="all", engine="workq")
    base = search_queries(pdev, qs, device="cpu", **kw)
    assert base.rows() == jax_search_queries(jdev, qs, **kw).rows() and len(base.rows()) > 256
    monkeypatch.setattr(workq, "HARD_CAP", 512)
    tape = compile_tape(load_scheme("optimum", 0, 1, 36, edit=True, sigma=6, n_text=pdev.n))
    with pytest.raises(workq.QueueOverflow):  # the whole chunk does not fit: the driver must split
        workq.run_workq_search(pdev, np.stack(qs), tape, edit=True, dedup=True)
    assert search_queries(pdev, qs, device="cpu", **kw).rows() == base.rows()
    monkeypatch.setattr(workq, "HARD_CAP", 2)
    with pytest.raises(RuntimeError, match="single query"):
        search_queries(pdev, qs[:4], device="cpu", **kw)


def test_wide_intervals_locate_the_same_on_both_walks(repeat_workload):
    """Work-queue hit intervals span many rows; the full-SA gather and the
    sampled LF-walk locate them alike, and no located row is a sentinel."""
    _, port_host, pdev, qs = repeat_workload
    kw = dict(k=1, generator_name="optimum", edit=True, engine="workq", device="cpu")
    full = search_queries(pdev, qs[:64], **kw)
    sampled = search_queries(DeviceIndex.from_host(port_host, device="cpu", full_sa=False), qs[:64], **kw)
    assert sampled.rows() == full.rows()
    assert ((full.pos >= 0) & (full.pos + 36 - 1 <= port_host.seq_lens[full.seq_id])).all()


def test_many_searches_split_into_tape_groups(three_seqs):
    """01*0 at k=3 has 10 searches, more than MAX_NS = 8."""
    seqs, jdev, _, pdev, _ = three_seqs
    assert compile_tape(load_scheme("01*0", 0, 3, 18, edit=False, sigma=6, n_text=pdev.n)).num_searches > workq.MAX_NS
    qs = [seqs[0][i * 11 : i * 11 + 18].copy() for i in range(3)]
    qs[1][4] = 1 + (qs[1][4] % 4)
    kw = dict(k=3, generator_name="01*0", edit=False)
    got = search_queries(pdev, qs, device="cpu", **kw)
    assert got.rows() == jax_search_queries(jdev, qs, **kw).rows() and len(got.rows()) >= 3


@pytest.fixture(scope="module")
def n_reads(sv_workload):
    """Reads with an N at the end of a seed part (where the j-mer table
    reads it), by the step between them: every third read (one of them
    random), and every read."""
    *_, queries = sv_workload
    out = {}
    for step in (3, 1):
        out[step] = [q.copy() for q in queries]
        for q in out[step][::step]:
            q[11] = 5
    return out


@pytest.mark.parametrize("mode,step", [("all", 3), ("besthits", 3), ("all", 1)], ids=["all", "besthits", "all-every"])
def test_sv_fallback_for_n_reads_equals_jax(sv_workload, n_reads, mode, step):
    jdev, _, pdev, _ = sv_workload
    qs = n_reads[step]
    kw = dict(k=2, edit=True, mode=mode, chunk=16)
    bad = seedverify.seed_bad_mask(pdev, torch.from_numpy(np.stack(qs)), seedverify.plan_parts(36, 2))
    assert bad is not None and bad.nonzero().flatten().tolist() == list(range(0, len(qs), step))
    want = jax_search_queries(jdev, qs, **kw)
    assert search_queries(pdev, qs, device="cpu", **kw).rows() == want.rows() and want.rows()


def test_sv_fallback_over_part_cap_equals_jax(sv_workload, monkeypatch):
    jdev, _, pdev, queries = sv_workload
    want = jax_search_queries(jdev, queries, k=2, edit=True, chunk=16, sv_part_cap=1)
    monkeypatch.setattr(seedverify, "PART_CAP", 1)
    got = search_queries(pdev, queries, k=2, edit=True, chunk=16, device="cpu")
    assert got.rows() == want.rows() and len(want.rows()) >= 20


def test_workq_needs_a_bidirectional_index(sv_workload):
    _, port_host, _, queries = sv_workload
    sv_only = DeviceIndex.from_host(port_host, device="cpu", include_rev=False)
    with pytest.raises(ValueError, match="bidirectional"):
        search_queries(sv_only, queries, k=2, engine="workq", device="cpu")
    assert torch.equal(sv_only.occ, DeviceIndex.from_host(port_host, device="cpu").occ[: sv_only.occ.shape[0]])


# The step as a drain, a count and an emit: the drain in PyTorch, then the
# rank products and branch-major candidate flags of every row, then the child
# of every flagged candidate in flat branch-major order.  The engine ran it so
# while the dedup-off multisets above held it against the JAX package.


def _tape_fields(tape, layout, meta, m, ns):
    opf, err, d, s_id, q_id = layout.decode(meta)
    lane = q_id.long() * ns + s_id.long()
    word = tape[lane * m + d.clamp(max=m - 1).long()]
    return opf, err, d, word


def _count_plain(occ16, c_arr, tape, lb, lbr, sz, meta, *, sigma, sl, edit, m, ns, rev_off, layout):
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
    syms = torch.arange(1, sl, dtype=torch.int32)[None, :]
    live = cnt[:, 1:] > 0
    e_ms = err[:, None] + (qc[:, None] != syms).to(torch.int32)
    cols = [alive[:, None] & live & (e_ms <= hi_b[:, None]) & (e_ms >= lo_b[:, None])]
    if edit:
        last = opf & 3
        cols.append(alive[:, None] & live & ((err + 1) <= hi_b)[:, None] & (d > 0)[:, None]
                    & (last != OP_INS)[:, None])
        cols.append((alive & (err + 1 <= hi_b) & (err + 1 >= lo_b) & (last != OP_DEL))[:, None])
    return prod, torch.cat(cols, dim=1).T.contiguous().to(torch.uint8)


def _emit_plain(flags, prod, tape, lb, lbr, sz, meta, *, sl, edit, m, ns, layout):
    """Child rows (lb, lbr, sz, meta) of the flagged candidates, in flat
    branch-major order."""
    n, n_ms = sz.shape[0], sl - 1
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


def _oracle_step(ctx, lb, lbr, sz, meta, *, drain):
    """The drain, count and emit above; the children stably reordered by
    parent, which is the one-launch step's order."""
    layout, m, ns = ctx.layout, ctx.m, ctx.ns
    hits = torch.zeros((4, 0), dtype=torch.int32)
    if drain:
        opf, err, d, s_id, q_id = layout.decode(meta)
        alive = sz > 0
        if ctx.cap_per_query:
            alive &= ctx.hq_counts[q_id.long()] < ctx.cap_per_query
        done = alive & (d >= m)
        fin = torch.nonzero(done & ((opf & EDGES) == 0))[:, 0]
        hits = torch.stack([q_id[fin] * ns + s_id[fin], lb[fin], sz[fin], err[fin]])
        sz = torch.where(alive & ~done, sz, 0)
    kw = dict(sl=ctx.sl, edit=ctx.edit, m=m, ns=ns, layout=layout)
    prod, flags = _count_plain(ctx.occ16, ctx.c_arr, ctx.tape, lb, lbr, sz, meta, sigma=ctx.sigma,
                               rev_off=ctx.rev_off, **kw)
    kids = _emit_plain(flags, prod, ctx.tape, lb, lbr, sz, meta, **kw)
    order = torch.sort(torch.nonzero(flags.reshape(-1))[:, 0] % sz.shape[0], stable=True).indices
    return (*(x[order] for x in kids), hits)


@pytest.mark.parametrize("cap", [0, 1])
@pytest.mark.parametrize("edit", [True, False])
@pytest.mark.parametrize("workload", ["three_seqs", "repeat_workload"])
def test_step_equals_drain_count_emit(request, monkeypatch, workload, edit, cap):
    """Every step of one chunk, dedup on: the one-launch step's children
    equal the branch-major oracle's reordered by parent, and its hits the
    PyTorch drain's, with and without the in-search cap."""
    if workload == "three_seqs":
        *_, pdev, qarr = request.getfixturevalue(workload)
        k = 2
    else:
        _, _, pdev, qs = request.getfixturevalue(workload)
        qarr, k = np.stack(qs), 1
    tape = compile_tape(load_scheme("optimum", 0, k, qarr.shape[1], edit=edit, sigma=6, n_text=pdev.n))
    seen = dict(steps=0, drains=0, children=0, hits=0, capped=0)
    expand_step = workq.expand_step

    def checked(ctx, state, *, drain=False):
        got = workq_step_plain(ctx, *state, drain=drain)
        want = _oracle_step(ctx, *state, drain=drain)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        if drain and cap:
            q_id = ctx.layout.decode(state[3])[4]
            seen["capped"] += int(((ctx.hq_counts[q_id.long()] >= cap) & (state[2] > 0)).sum())
        seen.update(steps=seen["steps"] + 1, drains=seen["drains"] + drain, children=seen["children"] + len(got[0]),
                    hits=seen["hits"] + got[4].shape[1])
        return expand_step(ctx, state, drain=drain)

    monkeypatch.setattr(workq, "expand_step", checked)
    workq.workq_search(pdev, torch.from_numpy(qarr.astype(np.int32)), workq.upload_tape(tape, "cpu"),
                       torch.ones(len(qarr), dtype=torch.bool), edit=edit, k=k, ph0=workq.phase0_length(tape, edit),
                       dedup_every=workq.DEDUP_EVERY, cap_per_query=cap)
    assert seen["drains"] > 0 and seen["steps"] > seen["drains"] and seen["children"] > 0 and seen["hits"] > 0
    # Hamming states all finish on the first drain step, before any cap can bind
    assert seen["capped"] > 0 or not (cap and edit)


# F2 (ROADMAP.md queue 3, a property of the reference): the 8 rows where the
# work-queue engine differs from SV-e1 on the first 4,096 reads of the
# short-read workload (36 bp, k=3; chip_smoke.py prints them as "rows only
# sv_e1 gives"): strand query, start in the 40 Mbp reference, the text from
# 30 chars before the start to 30 after the read's span, the read, its least
# edit distance at the start, and an alignment with it (I inserts a query
# char, D a text char, S substitutes).
_F2_I_D = "I" + "M" * 26 + "D"  # query position 0 inserted, a text char deleted before position 27
F2_ROWS = [
    (2998, 8413343, "CGAAAAGATCGTGATAGTTACTCGCTGACCTTGCTCTTTAGAGGTGTAGATATAAAGTTTGAGAGAACCTACCCGTGTGACCGACGCTTGACCCAT",
     "CTTGCTCTTTAGAGGTGTAGATATAAATTTGACAGA", 3, _F2_I_D + "M" * 5 + "S" + "M" * 3),
    (2998, 15295590, "CGAAAAGATCGTGATAGTTACTCGCTGACCTTGCTCTTTAGAGGTGTAGATATAAAGTTTGAGAGAACCTACCCGTGTGTCCGACGCTTGACCCAT",
     "CTTGCTCTTTAGAGGTGTAGATATAAATTTGACAGA", 3, _F2_I_D + "M" * 5 + "S" + "M" * 3),
    (3508, 29319969, "GCTTTGTAAGCCGTAATTGGGCGGTAGTCTCGAGACTAGCGGCCCATAGGGATGCAGTTGGATAAGACTCCCCTGCTTCATATGTATCACAACCGA",
     "TCGAGACTAGCGGCCCATAGGGATGCATTGGATAAG", 2, _F2_I_D + "M" * 9),
    (4848, 33505221, "TGAGGGAAAAAAAGCAAGCAGCTCGCTACATGCTGCTTATCGATGAAACTCTCTGTCAGGATATCATCCAGTGCTTCATCTTAAGAAGCAGGTAGG",
     "ATGCTGCTTATCGATGAAACTCTCTGTAGGAATATC", 3, _F2_I_D + "M" * 3 + "I" + "M" * 5),
    (6270, 8717704, "TGCTTGGCCGTACTCAGTCAGTATGAGTGACACTTCGTGTGAACGGTCCGACTATTGAGAGTGTAACCGTCATGAGTCCTGAGGTGCTTCGCTGCG",
     "ACACTTCGTGTGAACGGTCCGACTATTAGAGTGTAC", 3, _F2_I_D + "M" * 7 + "D" + "M" * 2),
    (6270, 22582606, "TGCTTGTCCGTACTCAGTCAGTATGAGTGACACTTCGTGTGAACGGTCCGACTATTGAGAGTGTAACCGTCATGAGTCCTGAGGTGCTTCGCTGCC",
     "ACACTTCGTGTGAACGGTCCGACTATTAGAGTGTAC", 3, _F2_I_D + "M" * 7 + "D" + "M" * 2),
    (6386, 9333325, "ATCCGGGGATCCGTCGTAGTGTGCAAAAGAGCCCTTTCCCGGGAAACAGCCAGGGGTCCTGCTAAATAGGATGTTGCAGGACCAGATTTACGTTAG",
     "AGCCCTTTCCCGGGAAACAGCCAGGGGCGTGCTAAA", 3, _F2_I_D + "M" + "S" + "M" * 7),
    (6386, 26231618, "ATCCGGGGATCCGTCGTAGTGTGCAAAAGAGCCCTTTCCCGGGAAACAGCCAGGGGTCCTGCTAAATAGGATGTTGCAGGACCAGATTTACGTTAG",
     "AGCCCTTTCCCGGGAAACAGCCAGGGGCGTGCTAAA", 3, _F2_I_D + "M" + "S" + "M" * 7),
]


def _least_edit_at(q: np.ndarray, text: np.ndarray, start: int, k: int) -> int:
    """Least edit distance of q to text[start, start + L) over L."""
    prev = np.arange(len(q) + 1)
    best = prev[-1]
    for c in text[start : start + len(q) + k]:
        cur = np.empty_like(prev)
        cur[0] = prev[0] + 1
        for i in range(1, len(q) + 1):
            cur[i] = min(prev[i] + 1, cur[i - 1] + 1, prev[i - 1] + (q[i - 1] != c))
        prev, best = cur, min(best, cur[-1])
    return int(best)


@pytest.mark.parametrize("qid,pos,window,read,least,ops", F2_ROWS, ids=[f"{r[0]}@{r[1]}" for r in F2_ROWS])
def test_f2_deletion_after_insertion_across_the_side_switch(qid, pos, window, read, least, ops):
    """The work-queue engine keeps one last op for both sides and forbids a
    deletion right after an insertion, even where the insertion ended the
    left run and the deletion starts the right run, at opposite ends of the
    span.  optimum, k=3, m=36 has 4 searches; search 3 consumes query
    positions 26..0 leftwards, then 27..35 rightwards.  Each row's
    least-error alignment inserts query position 0 (d=26) and deletes a
    text char before position 27 (d=27): search 3's bounds admit it, the
    other searches' bounds reject it, and both packages miss the start or
    report it at a higher error (their hit multisets are equal)."""
    from sahara_tpu_torch.alphabet import D_DNA5

    text, q = D_DNA5.char_to_rank(window), D_DNA5.char_to_rank(read).astype(np.int32)
    start, m = 30, len(read)
    assert _least_edit_at(q, text, start, 3) == least
    # the alignment: its errors, each query position's op, the deletions' gaps
    i = j = 0
    per_qpos, gaps = [], []
    for op in ops:
        if op in "MS":
            assert (q[i] == text[start + j]) == (op == "M")
        if op == "D":
            gaps.append(i)  # between query positions i - 1 and i
        else:
            per_qpos.append(op)
        i, j = i + (op != "D"), j + (op != "I")
    assert i == m and sum(op != "M" for op in ops) == least

    host = build_bifmindex([text], 6, "d_dna5")
    jdev, _, pdev = _both(host)
    tape = compile_tape(load_scheme("optimum", 0, 3, m, edit=True, sigma=6, n_text=pdev.n))
    got = workq.run_workq_search(pdev, q[None], tape, edit=True)
    jax_tape = jax_compile_tape(jax_expand(JAX_GENERATORS["optimum"].generator(0, 3, 0, 0), m))
    assert _multiset(got) == _multiset(jax_run_workq_search(jdev, q[None], jax_tape, edit=True))
    at_start = {int(got.err[h]) for h in range(got.n_hits)
                if start in host.sa_abs[got.lb[h] : got.lb[h] + got.sz[h]].tolist()}
    assert min(at_start, default=least + 1) > least

    def admits(s: int) -> bool:
        """The tape's bounds take the alignment: a deletion counts when the
        second query position beside its gap is consumed, before it."""
        consumed, err = set(), 0
        for d, qp in enumerate(tape.qpos[s].tolist()):
            for g in gaps:
                if qp in (g - 1, g) and {g - 1, g} & consumed:
                    err += 1
                    if err > tape.hi[s][d]:
                        return False
            err += per_qpos[qp] != "M"
            if not tape.lo[s][d] <= err <= tape.hi[s][d]:
                return False
            consumed.add(qp)
        return True

    side, qpos = tape.side[3].tolist(), tape.qpos[3].tolist()
    assert (side[26], qpos[26], per_qpos[0], side[27], qpos[27], gaps[0]) == (0, 0, "I", 1, 27, 27)
    assert tape.num_searches == 4 and admits(3) and not any(admits(s) for s in range(3))
