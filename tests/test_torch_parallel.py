"""sahara_tpu_torch.parallel on a mesh of eight CPU entries against the JAX
package: the cases of tests/test_parallel.py, held against sahara_tpu's
single-device rows (which its own tests show equal its mesh rows), and
against its mesh in two cases, the short-read mesh route and the interval
search.  A mesh never takes the CPU on its own."""

import numpy as np
import pytest
import torch

from sahara_tpu.engine.device import DeviceIndex as JaxDeviceIndex
from sahara_tpu.engine.driver import search_queries as jax_search_queries
from sahara_tpu.engine.seedverify import run_sv_search as jax_run_sv_search
from sahara_tpu.engine.tape import compile_tape as jax_compile_tape
from sahara_tpu.engine.workq import run_workq_search as jax_run_workq_search
from sahara_tpu.index.build import build_bifmindex as jax_build_bifmindex
from sahara_tpu.parallel import data_mesh as jax_data_mesh
from sahara_tpu.parallel import replicate_index as jax_replicate_index
from sahara_tpu.schemes import GENERATORS as JAX_GENERATORS
from sahara_tpu.schemes import expand as jax_expand
from sahara_tpu_torch.engine import approx, seedverify, workq
from sahara_tpu_torch.engine.device import DeviceIndex
from sahara_tpu_torch.engine.driver import search_queries
from sahara_tpu_torch.engine.tape import compile_tape
from sahara_tpu_torch.index.build import build_bifmindex
from sahara_tpu_torch.kernels.frontier import pack_tape
from sahara_tpu_torch.parallel import data_mesh, distributed_scheme_search, replicate_index, shard_queries
from sahara_tpu_torch.parallel.multihost import host_output_path, host_query_slice, merge_host_outputs
from sahara_tpu_torch.parallel.search import distributed_workq_search
from sahara_tpu_torch.parallel.sv import distributed_sv_search
from sahara_tpu_torch.schemes import expand, get_generator

from tests import torch_support  # noqa: F401  (PyTorch on one thread)

CPU8 = ["cpu"] * 8


def _mesh():
    return data_mesh(devices=CPU8)


def _tape(k, m, lib="port"):
    if lib == "port":
        return compile_tape(expand(get_generator("optimum").generator(0, k, 0, 0), m))
    return jax_compile_tape(jax_expand(JAX_GENERATORS["optimum"].generator(0, k, 0, 0), m))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    seqs = [rng.integers(1, 5, size=500).astype(np.uint8)]
    mesh = _mesh()
    host = build_bifmindex(seqs, 6, "d_dna5")
    return seqs, mesh, replicate_index(host, mesh), JaxDeviceIndex.from_host(jax_build_bifmindex(seqs, 6, "d_dna5"))


def test_mesh_devices_and_one_upload(setup):
    _, mesh, reps, _ = setup
    assert mesh.size == 8 and all(d == torch.device("cpu") for d in mesh.devices)
    assert len({id(r) for r in reps}) == 1  # entries on one device share its upload


def test_data_mesh_takes_cards_only():
    """``data_mesh(n)`` counts CUDA cards: with fewer than n it raises and
    never falls back to the CPU; a card it cannot see raises too."""
    n_cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"requested {n_cards + 1} devices, have {n_cards}"):
        data_mesh(n_cards + 1)
    with pytest.raises(ValueError, match="not a visible CUDA card"):
        data_mesh(devices=[torch.device("cuda", n_cards)])
    if n_cards == 0:
        with pytest.raises(ValueError, match="at least one device"):
            data_mesh()


def test_distributed_workq_matches_single_device(setup):
    seqs, mesh, reps, jdev = setup
    m, k = 20, 1
    qs = np.stack([seqs[0][i * 4 : i * 4 + m] for i in range(24)]).astype(np.int32)
    hits, total = distributed_workq_search(mesh, reps, qs, _tape(k, m), edit=True)
    ref = jax_run_workq_search(jdev, qs, _tape(k, m, "jax"), edit=True, dedup=True)
    got = set(zip(hits.lane.tolist(), hits.lb.tolist(), hits.sz.tolist(), hits.err.tolist()))
    want = set(zip(ref.lane.tolist(), ref.lb.tolist(), ref.sz.tolist(), ref.err.tolist()))
    # dedup winners depend on the queue's row order: the hit set is the contract
    assert total == len(hits.lane) and got == want and len(want) >= 24


def test_distributed_pads_non_divisible_batches(setup):
    seqs, mesh, reps, _ = setup
    m = 18
    qs = np.stack([seqs[0][i * 7 : i * 7 + m] for i in range(13)]).astype(np.int32)  # 13 % 8 != 0
    hits, total = distributed_workq_search(mesh, reps, qs, _tape(0, m), edit=False)
    assert total == 13  # each exact query matches its own position
    assert set(hits.lane.tolist()) == set(range(13))
    slices, nq = shard_queries(qs, mesh)
    assert nq == 13 and [len(s) for s in slices] == [2] * 8 and not slices[-1][-3:].any()


def test_distributed_scheme_search_matches_one_search(setup):
    """One frontier-engine search over the mesh (13 queries, padded to 16)
    against one search of the whole batch, on the JAX side too: the whole
    ``SearchHits`` (hits within the counts, counts, flags) and the total."""
    seqs, mesh, reps, jdev = setup
    from sahara_tpu.engine.approx import run_scheme_search_chunked as jax_chunked

    m, k = 20, 2
    qs = np.stack([seqs[0][i * 9 : i * 9 + m] for i in range(13)]).astype(np.int32)
    qs[::3, 4] = 1 + qs[::3, 4] % 4
    got, total = distributed_scheme_search(mesh, reps, qs, _tape(k, m), edit=True, s_cap=8, h_cap=4)
    words = torch.from_numpy(pack_tape(*(getattr(_tape(k, m), f) for f in ("side", "qpos", "lo", "hi"))))
    hits, cnt, flags = approx.scheme_search(reps[0], torch.from_numpy(qs), words, torch.ones(13, dtype=torch.bool),
                                            edit=True, s_cap=8, h_cap=4, k=k)
    ns = _tape(k, m).num_searches
    for name, a in zip(("lb", "sz", "err"), hits.reshape(3, 13, ns, 4)):
        assert torch.equal(getattr(got, name), a), name
    assert torch.equal(got.count, cnt.reshape(13, ns)) and total == int(cnt.sum())
    assert np.array_equal(np.stack([got.frontier_overflow, got.hit_overflow]),
                          flags.numpy().astype(bool).reshape(2, 13, ns))
    want = jax_chunked(jdev, qs, _tape(k, m, "jax"), edit=True, s_cap=8, h_cap=4, chunk=16, max_retries=1)
    assert np.array_equal(got.count.numpy(), want.count) and got.frontier_overflow.any()
    assert np.array_equal(got.frontier_overflow.numpy(), want.frontier_overflow)
    assert np.array_equal(got.hit_overflow.numpy(), want.hit_overflow)
    valid = np.arange(4) < want.count[:, :, None]
    for name in ("lb", "sz", "err"):
        assert np.array_equal(np.where(valid, getattr(got, name).numpy(), 0), np.where(valid, getattr(want, name), 0))


@pytest.fixture(scope="module")
def sv_setup():
    """tests/test_parallel.py's corpus: long enough for exact parts at
    m=36, and a tandem repeat for the fallback."""
    rng = np.random.default_rng(9)
    unit = rng.integers(1, 5, 12).astype(np.uint8)
    seqs = [
        rng.integers(1, 5, size=700).astype(np.uint8),
        np.concatenate([rng.integers(1, 5, 200).astype(np.uint8), np.tile(unit, 50)]),
    ]
    mesh = _mesh()
    reps = replicate_index(build_bifmindex(seqs, 6, "d_dna5", rate=16), mesh)
    return seqs, unit, mesh, reps, JaxDeviceIndex.from_host(jax_build_bifmindex(seqs, 6, "d_dna5", rate=16))


@pytest.mark.parametrize("edit", [True, False])
def test_distributed_sv_matches_single_device(sv_setup, edit):
    seqs, _, mesh, reps, jdev = sv_setup
    m, k = 36, 2
    rng = np.random.default_rng(21)
    qs = []
    for i in range(19):  # 19 % 8 != 0
        s = seqs[i % 2]
        q = np.array(s[(p := int(rng.integers(0, len(s) - m))) : p + m], dtype=np.int32)
        if i % 3 == 1:
            q[5] = 1 + (q[5] - 1 + 1) % 4
        qs.append(q)
    qs = np.stack(qs)
    hits, total = distributed_sv_search(mesh, reps, qs, k, edit=edit, chunk=2)
    ref = jax_run_sv_search(jdev, qs, k, edit=edit)
    got = set(zip(hits.q_idx.tolist(), hits.abs_pos.tolist(), hits.err.tolist()))
    want = set(zip(ref.q_idx.tolist(), ref.abs_pos.tolist(), ref.err.tolist()))
    assert got == want and total == len(hits.q_idx) and len(want) >= 19
    assert not hits.fallback.any()


@pytest.mark.parametrize("mode", ["all", "besthits"])
def test_search_queries_mesh_parity(sv_setup, mode, monkeypatch):
    """The driver on the mesh (seed-and-verify, the repeat-saturated query
    re-searched by the work-queue engine) against sahara_tpu's
    single-device driver at the same part budget, and against one device."""
    seqs, unit, mesh, reps, jdev = sv_setup
    m, k = 36, 2
    queries = [np.asarray(seqs[i % 2][7 * i : 7 * i + m], dtype=np.uint8) for i in range(10)]
    queries.append(np.tile(unit, 3).astype(np.uint8))  # repeat-saturated
    kw = dict(k=k, edit=True, mode=mode, chunk=4)
    want = jax_search_queries(jdev, queries, sv_part_cap=8, **kw).rows()
    monkeypatch.setattr(seedverify, "PART_CAP", 8)
    lines = []
    got = search_queries(reps, queries, mesh=mesh, device="cpu", verbose_cb=lines.append, **kw)
    assert got.rows() == want and len(want) > 10
    assert "engine: seed-verify (mesh[8], m=36, 11 queries)" in lines
    assert "seed-verify: 1 repeat-saturated queries re-searched via the scheme engine" in lines
    assert search_queries(reps[0], queries, device="cpu", **kw).rows() == want


def test_search_queries_mesh_n_reads_match_jax(sv_setup):
    """An N at the end of the first seed part of every third read: each
    device's slice flags it (``seed_bad_mask`` on its upload), the
    work-queue engine re-searches it, and the rows equal sahara_tpu's."""
    seqs, _, mesh, reps, jdev = sv_setup
    m, k = 36, 2
    queries = [seqs[0][9 * i : 9 * i + m].astype(np.uint8) for i in range(12)]  # copies: the fixture stays
    for q in queries[::3]:
        q[11] = 5  # the last char of the first 12-char part
    kw = dict(k=k, edit=True, chunk=4)
    hits, _ = distributed_sv_search(mesh, reps, np.stack(queries), k, edit=True, chunk=2)
    assert hits.fallback.nonzero()[0].tolist() == [0, 3, 6, 9] and not np.isin(hits.q_idx, [0, 3, 6, 9]).any()
    want = jax_search_queries(jdev, queries, **kw).rows()
    lines = []
    got = search_queries(reps, queries, mesh=mesh, device="cpu", verbose_cb=lines.append, **kw)
    assert got.rows() == want and len(want) >= 12
    assert "seed-verify: 4 repeat-saturated queries re-searched via the scheme engine" in lines


def test_search_queries_mesh_short_reads_take_workq(sv_setup):
    """Short reads on a mesh take the reference's mesh route, the
    work-queue engine (exact parts only; one device takes SV-e1): the rows
    of sahara_tpu's ``search_queries`` on its 8-device mesh."""
    seqs, _, mesh, reps, _ = sv_setup
    m, k = 20, 2  # 20 // 3 < MIN_PART: no exact parts
    queries = [np.asarray(seqs[0][5 * i : 5 * i + m], dtype=np.uint8) for i in range(9)]
    jmesh = jax_data_mesh(8)
    host = jax_build_bifmindex(seqs, 6, "d_dna5", rate=16)
    want = jax_search_queries(jax_replicate_index(host, jmesh), queries, k=k, edit=True, mesh=jmesh).rows()
    lines = []
    got = search_queries(reps, queries, k=k, edit=True, mesh=mesh, device="cpu", verbose_cb=lines.append)
    assert got.rows() == want and len(want) >= 9
    assert f"engine: workq (mesh[8], m={m}, 9 queries)" in lines


def test_distributed_sv_uint8_queries(sv_setup):
    seqs, _, mesh, reps, jdev = sv_setup
    m, k = 36, 1
    qs_u8 = np.stack([seqs[0][11 * i : 11 * i + m] for i in range(8)]).astype(np.uint8)
    hits, _ = distributed_sv_search(mesh, reps, qs_u8, k, edit=True, chunk=4)
    ref = jax_run_sv_search(jdev, qs_u8.astype(np.int32), k, edit=True)
    got = set(zip(hits.q_idx.tolist(), hits.abs_pos.tolist()))
    want = set(zip(ref.q_idx.tolist(), ref.abs_pos.tolist()))
    assert got == want and len(want) >= 8


def test_approx_on_a_mesh_raises(sv_setup):
    """The frontier engine has no mesh driver, in either package."""
    seqs, _, mesh, reps, _ = sv_setup
    queries = [np.asarray(seqs[0][:36], dtype=np.uint8)]
    with pytest.raises(ValueError, match="engine 'approx' has no distributed driver"):
        search_queries(reps, queries, k=2, engine="approx", mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="replicated index"):
        search_queries(reps[0], queries, k=2, mesh=mesh, device="cpu")


def test_host_query_slice_partitions():
    assert host_query_slice(100) == (0, 100)  # one process: the whole range
    assert [host_query_slice(26, r, 4) for r in range(4)] == [(0, 7), (7, 14), (14, 21), (21, 26)]
    assert host_query_slice(3, 3, 4) == (3, 3)
    assert host_output_path("out.txt", 1, 4) == "out.txt.h1of4"


def test_merge_host_outputs(tmp_path):
    paths = []
    for r in range(3):
        p = tmp_path / f"part{r}.txt"
        p.write_text(f"{r} 0 {r * 10}\n")
        paths.append(str(p))
    out = tmp_path / "merged.txt"
    merge_host_outputs(paths, str(out))
    assert out.read_text() == "0 0 0\n1 0 10\n2 0 20\n"


def test_mesh_parity_with_skewed_overflow(monkeypatch):
    """512 queries over the mesh, the first device's slice from a tandem
    array: with ``workq.HARD_CAP`` cut to 4,096 rows only that slice's
    searches pass it and halve their active set (as the reference's slice
    retries its capacities), and the rows equal sahara_tpu's one-device
    work-queue rows."""
    rng = np.random.default_rng(11)
    n_ref = 6_000
    ref = rng.integers(1, 5, size=n_ref).astype(np.uint8)
    motif = rng.integers(1, 5, size=23).astype(np.uint8)
    ref[1_000:1_400] = np.tile(motif, -(-400 // 23))[:400]
    m, k, nq = 36, 2, 512
    per_dev = nq // 8
    queries = np.empty((nq, m), dtype=np.uint8)
    for i in range(per_dev):  # device 0: reads from the tandem array
        p = 1_000 + int(rng.integers(0, 400 - m))
        queries[i] = ref[p : p + m]
    for i in range(per_dev, nq):  # the rest: unique-region reads with up to k substitutions
        q = ref[(p := int(rng.integers(1_500, n_ref - m))) : p + m].copy()
        for _ in range(int(rng.integers(0, k + 1))):
            at = int(rng.integers(0, m))
            q[at] = 1 + (q[at] - 1 + int(rng.integers(1, 4))) % 4
        queries[i] = q
    want = jax_search_queries(JaxDeviceIndex.from_host(jax_build_bifmindex([ref], 6, "d_dna5", rate=16)),
                              list(queries), k=k, edit=True, engine="workq", chunk=nq).rows()

    mesh = _mesh()
    reps = replicate_index(build_bifmindex([ref], 6, "d_dna5", rate=16), mesh)
    overflows, search, skewed = [], workq.workq_search, torch.from_numpy(queries[:per_dev])

    def counting(index, q, *args, **kw):
        try:
            return search(index, q, *args, **kw)
        except workq.QueueOverflow:
            overflows.append(torch.equal(q, skewed))
            raise

    monkeypatch.setattr(workq, "workq_search", counting)
    monkeypatch.setattr(workq, "HARD_CAP", 4096)
    got = search_queries(reps, list(queries), k=k, edit=True, engine="workq", mesh=mesh, chunk=per_dev,
                         device="cpu")
    assert got.rows() == want and len(want) >= nq  # repeat reads hit many places
    assert overflows and all(overflows)  # only the skewed slice's searches overflowed


@pytest.fixture(scope="module")
def interval_corpus():
    """tests/test_interval.py's corpus: a 900-char sequence split into
    windows and two short ones, 8 reads of 24 chars (every other with a
    substitution) and one across the first window's end."""
    rng = np.random.default_rng(17)
    seqs = [rng.integers(1, 5, size=n).astype(np.uint8) for n in (900, 200, 150)]
    m = 24
    queries = []
    for i in range(8):
        s = seqs[i % 3]
        p = (i * 37) % (len(s) - m)
        q = s[p : p + m].copy()
        if i % 2:
            q[7] = 1 + (q[7] % 4)
        queries.append(q)
    queries.append(seqs[0][390 : 390 + m].copy())
    return seqs, queries


def test_distributed_interval_search_matches_jax(interval_corpus):
    """The interval search, shard i on mesh entry i of eight, against
    sahara_tpu's ``distributed_interval_search`` on its 8-device mesh and
    against one unsharded index, at tests/test_interval.py's shapes."""
    from sahara_tpu.index.shard import build_sharded_bifmindex as jax_build_sharded
    from sahara_tpu.parallel.interval import distributed_interval_search as jax_interval
    from sahara_tpu_torch.index.shard import build_sharded_bifmindex
    from sahara_tpu_torch.kernels import LAUNCHES, reset_launches
    from sahara_tpu_torch.parallel.interval import distributed_interval_search

    seqs, queries = interval_corpus
    m, k = 24, 1
    qarr = np.stack([q for q in queries if len(q) == m]).astype(np.int32)
    want = jax_interval(jax_data_mesh(8), jax_build_sharded(seqs, 6, "d_dna5", max_chars=400, overlap=64), qarr,
                        _tape(k, m, "jax"), edit=True)
    sh = build_sharded_bifmindex(seqs, 6, "d_dna5", max_chars=400, overlap=64)
    assert sh.num_shards >= 3 and 0 in sh.windowed_gids.tolist()
    reset_launches()
    got = distributed_interval_search(_mesh(), sh, qarr, _tape(k, m), edit=True)
    rows = lambda r: list(zip(r.query_id.tolist(), r.seq_id.tolist(), r.pos.tolist(), r.errors.tolist()))  # noqa: E731
    assert rows(got) == rows(want) and len(rows(want)) >= len(qarr)
    one = search_queries(DeviceIndex.from_host(build_bifmindex(seqs, 6, "d_dna5"), device="cpu"), list(qarr), k=k,
                         generator_name="optimum", device="cpu")
    assert one.rows() == rows(got)
    assert not any(LAUNCHES.values())  # CPU tensors take the plain versions
    with pytest.raises(ValueError, match="shards > 2 devices"):
        distributed_interval_search(data_mesh(devices=["cpu"] * 2), sh, qarr, _tape(k, m), edit=True)
