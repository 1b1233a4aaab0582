"""The port's synthetic genome (sim/corpus.py) against sahara_tpu's: the same
array and report from the same generator, and one enriched-corpus search
(tests/test_fuzz.py's) through ``auto``, ``workq`` and ``approx`` in both
packages, row for row."""

import dataclasses

import numpy as np
import pytest

from sahara_tpu.engine.device import DeviceIndex as JaxDeviceIndex
from sahara_tpu.engine.driver import search_queries as jax_search_queries
from sahara_tpu.index.build import build_bifmindex as jax_build_bifmindex
from sahara_tpu.sim.corpus import make_genome as jax_make_genome
from sahara_tpu_torch.engine.device import DeviceIndex
from sahara_tpu_torch.engine.driver import search_queries
from sahara_tpu_torch.index.build import build_bifmindex
from sahara_tpu_torch.sim.corpus import make_genome

from tests import torch_support  # noqa: F401  (PyTorch on one thread)


@pytest.mark.parametrize("seed,n,kw", [
    (0, 4000, {}),
    (201, 4000, dict(satellite_frac=0.08, lowcomp_frac=0.04, n_gap_frac=0.02)),
    (7, 200_000, {}),
])
def test_make_genome_matches_jax(seed, n, kw):
    got, got_rep = make_genome(np.random.default_rng(seed), n, **kw)
    want, want_rep = jax_make_genome(np.random.default_rng(seed), n, **kw)
    assert got.dtype == want.dtype == np.uint8 and np.array_equal(got, want)
    assert dataclasses.asdict(got_rep) == dataclasses.asdict(want_rep)
    assert set(np.unique(got).tolist()) == {1, 2, 3, 4, 5}  # ACGT and N gaps


def test_enriched_corpus_search_matches_jax():
    """tests/test_fuzz.py's enriched corpus (seed 201: m=30, k=2, edit
    distance), 12 reads with planted edits and a poly-A query, through
    each engine of both packages."""
    seed, m, k = 201, 30, 2
    rng = np.random.default_rng(seed)
    ref, _ = make_genome(rng, 4000, satellite_frac=0.08, lowcomp_frac=0.04, n_gap_frac=0.02)
    seqs = [ref[:2500].copy(), ref[2500:].copy()]
    queries = []
    for i in range(12):
        s = seqs[i % 2]
        q = np.array(s[(p := int(rng.integers(0, len(s) - m - k))) : p + m], dtype=np.uint8)
        for _ in range(int(rng.integers(0, k + 1))):
            kind, at = int(rng.integers(0, 3)), int(rng.integers(0, len(q)))
            if kind == 0:
                q[at] = 1 + (q[at] - 1 + int(rng.integers(1, 4))) % 4
            elif kind == 1 and len(q) > 1:
                q = np.delete(q, at)
            else:
                q = np.insert(q, at, int(rng.integers(1, 5)))
        q = q[:m]
        if len(q) < m:
            q = np.concatenate([q, rng.integers(1, 5, m - len(q)).astype(np.uint8)])
        queries.append(q.astype(np.uint8))
    queries.append(np.ones(m, dtype=np.uint8))  # poly-A: the part budget's stressor

    jdev = JaxDeviceIndex.from_host(jax_build_bifmindex(seqs, 6, "d_dna5", rate=16))
    pdev = DeviceIndex.from_host(build_bifmindex(seqs, 6, "d_dna5", rate=16), device="cpu")
    for engine in ("auto", "workq", "approx"):
        kw = dict(k=k, generator_name="pigeon_opt", edit=True, engine=engine)
        want = jax_search_queries(jdev, queries, **kw).rows()
        assert search_queries(pdev, queries, device="cpu", **kw).rows() == want, engine
        assert len({q for q, *_ in want}) >= 12


def test_corpus_workload_is_the_recorded_recipe():
    """``sim.workload.corpus_workload`` (chip_smoke.py's phase corpus, cut
    to 20,000 chars and 300 reads): sahara_tpu's genome and reads, each read
    beside its reverse complement, less the reads one of whose strands is
    80% or more one base."""
    from sahara_tpu.alphabet import D_DNA5
    from sahara_tpu.sim.read_simulator import simulate_reads as jax_simulate_reads
    from sahara_tpu_torch.sim.workload import corpus_workload

    lens = (9_000, 6_000, 5_000)
    records, queries, low = corpus_workload(seed=3, record_lens=lens, n_reads=300, read_seed=4)
    genome, _ = jax_make_genome(np.random.default_rng(3), sum(lens))
    assert np.array_equal(np.concatenate(records), genome) and [len(r) for r in records] == list(lens)
    chars = np.frombuffer(b"\x00ACGTN", dtype=np.uint8)
    reads = jax_simulate_reads([chars[r].tobytes() for r in records], num_reads=300, read_length=100,
                               random_errors=2, seed=4)
    fwd = np.stack([D_DNA5.char_to_rank(r.seq) for r in reads])
    both = np.stack([fwd, np.stack([D_DNA5.reverse_complement_rank(x) for x in fwd])], axis=1).reshape(-1, 100)
    frac = np.stack([(both == b).mean(axis=1) for b in range(1, 5)]).max(axis=0).reshape(-1, 2)
    poly = (frac >= 0.8).any(axis=1).repeat(2)
    assert np.array_equal(queries, both[~poly]) and np.array_equal(low, both[poly])
    assert len(queries) + len(low) == 600
