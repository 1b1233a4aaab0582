"""The benchmark workload of ``bench.py``, regenerated from its seeds.

A 40 MB reference with human-like repeat structure (segmental duplications
at 1.5% divergence over ~35% of the text) and 65,536 100 bp reads with
exactly 2 planted errors each, drawn uniformly from substitution, insertion
and deletion; every read is searched on both strands.  Reference seed 1234,
read seed 99.  ``make_reference`` is a copy of ``bench.py::make_reference``.
"""

from __future__ import annotations

import numpy as np

from sahara_tpu_torch.alphabet import D_DNA5
from sahara_tpu_torch.sim.read_simulator import simulate_reads

_RANK_TO_CHAR = np.frombuffer(b"\x00ACGTN", dtype=np.uint8)


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
    records = simulate_reads(
        [_RANK_TO_CHAR[ref].tobytes()], num_reads=n_reads, read_length=read_len,
        random_errors=errors, seed=99,
    )
    out = np.empty((2 * n_reads, read_len), dtype=np.uint8)
    for i, r in enumerate(records):
        q = D_DNA5.char_to_rank(r.seq)
        out[2 * i] = q
        out[2 * i + 1] = D_DNA5.reverse_complement_rank(q)
    return ref, out
