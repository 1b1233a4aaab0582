"""The benchmark workload of ``bench.py``, regenerated from its seeds.

A 40 MB reference with human-like repeat structure (segmental duplications
at 1.5% divergence over ~35% of the text) and 65,536 100 bp reads with
exactly 2 planted errors each, drawn uniformly from substitution, insertion
and deletion; every read is searched on both strands.  Reference seed 1234,
read seed 99.  ``make_reference`` is a copy of ``bench.py::make_reference``.
``short_reads`` gives the short-read rows of ``tools/bench_variants.py``
(32,768 reads of 36 bp, 2 planted errors, seed 7) on the same reference.
``corpus_workload`` gives a synthetic genome with planted repeats,
low-complexity runs and N gaps (``sim/corpus.py`` at its default
densities), cut into records, and reads simulated from them.
"""

from __future__ import annotations

import numpy as np

from sahara_tpu_torch.alphabet import D_DNA5
from sahara_tpu_torch.sim.corpus import make_genome
from sahara_tpu_torch.sim.read_simulator import simulate_reads

_RANK_TO_CHAR = np.frombuffer(b"\x00ACGTN", dtype=np.uint8)
# corpus_workload's filter: the share of one base that marks a read low-complexity
LOW_COMPLEXITY = 0.8


def make_reference(rng: np.random.Generator, n: int, repeat_frac: float = 0.35, divergence: float = 0.015) -> np.ndarray:
    """Random DNA ranks overlaid with mutated segmental duplications."""
    ref = rng.integers(1, 5, size=n).astype(np.uint8)
    covered, target = 0, int(n * repeat_frac)
    while covered < target:
        seg = int(rng.integers(300, 5001))
        src = int(rng.integers(0, n - seg))
        dst = int(rng.integers(0, n - seg))
        chunk = ref[src : src + seg].copy()
        nmut = int(rng.binomial(seg, divergence))
        if nmut:
            at = rng.choice(seg, size=nmut, replace=False)
            chunk[at] = 1 + (chunk[at] - 1 + rng.integers(1, 4, size=nmut)) % 4
        ref[dst : dst + seg] = chunk
        covered += seg
    return ref


def bench_workload(
    ref_mb: float = 40, n_reads: int = 65536, read_len: int = 100, errors: int = 2
) -> tuple[np.ndarray, np.ndarray]:
    """(reference uint8[n], strand queries uint8[2 * n_reads, read_len]):
    each read followed by its reverse complement, as ``bench.py`` searches."""
    ref = make_reference(np.random.default_rng(1234), int(ref_mb * 1_000_000))
    return ref, short_reads(ref, n_reads, read_len, errors, seed=99)


def short_reads(ref: np.ndarray | list[np.ndarray], n_reads: int = 32768, read_len: int = 36, errors: int = 2,
                seed: int = 7) -> np.ndarray:
    """Strand queries uint8[2 * n_reads, read_len] of reads simulated from
    ``ref`` (one rank sequence or several records), each followed by its
    reverse complement."""
    refs = [ref] if isinstance(ref, np.ndarray) else ref
    records = simulate_reads(
        [_RANK_TO_CHAR[r].tobytes() for r in refs], num_reads=n_reads, read_length=read_len,
        random_errors=errors, seed=seed,
    )
    out = np.empty((2 * n_reads, read_len), dtype=np.uint8)
    for i, r in enumerate(records):
        q = D_DNA5.char_to_rank(r.seq)
        out[2 * i] = q
        out[2 * i + 1] = D_DNA5.reverse_complement_rank(q)
    return out


def corpus_workload(
    seed: int = 21,
    record_lens: tuple[int, ...] = (4_400_000, 3_600_000, 3_000_000, 2_700_000, 2_300_000),
    n_reads: int = 16640,
    read_seed: int = 5,
) -> tuple[list[np.ndarray], np.ndarray, np.ndarray]:
    """(records, strand queries, low-complexity strand queries):
    ``make_genome(default_rng(seed), total)`` at its default densities, cut
    into records of ``record_lens``, and ``short_reads`` of 100 bp with 2
    errors from them (the simulator replaces N with random bases), split by
    a low-complexity filter: a read one of whose strands is
    ``LOW_COMPLEXITY`` or more one base (the reads of the planted poly-A
    runs) goes to the third array."""
    genome, _ = make_genome(np.random.default_rng(seed), sum(record_lens))
    records = np.split(genome, np.cumsum(record_lens)[:-1])
    queries = short_reads(records, n_reads, 100, 2, seed=read_seed)
    frac = np.stack([(queries == b).mean(axis=1) for b in range(1, 5)]).max(axis=0)
    low = (frac.reshape(-1, 2) >= LOW_COMPLEXITY).any(axis=1).repeat(2)
    return records, queries[~low], queries[low]
