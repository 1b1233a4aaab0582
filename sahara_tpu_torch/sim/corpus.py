"""Synthetic genome generator with real-genome stress features.

A copy of ``sahara_tpu/sim/corpus.py``: from the same generator it gives
the same array and the same report.

Random DNA understates every hard part of a real genome: repeat-driven
candidate blowup (segmental duplications, tandem/satellite arrays,
LINE/SINE-like interspersed families), low-complexity runs (telomeric
hexamers, poly-A tails), and N gaps (assembly breaks).  This module is a
proxy for a human chromosome: each feature class is planted explicitly,
with densities defaulting to coarse human-like values, and the generator
reports what it planted so benches can relate engine behavior (SV fallback
rate, hit volume) to corpus structure.

Rank-space output ($=0, A..T=1..4, N=5 — alphabet.py d_dna5).
"""

from __future__ import annotations

import dataclasses

import numpy as np

_TELOMERE = np.array([4, 4, 1, 3, 3, 3], dtype=np.uint8)  # TTAGGG in ranks


@dataclasses.dataclass
class CorpusReport:
    """What the generator planted (fractions of total length)."""

    n: int
    segdup_frac: float
    line_frac: float
    satellite_frac: float
    lowcomp_frac: float
    n_gap_frac: float


def _mutate(chunk: np.ndarray, rng: np.random.Generator, divergence: float) -> np.ndarray:
    out = chunk.copy()
    nmut = int(rng.binomial(len(chunk), divergence))
    if nmut:
        at = rng.choice(len(chunk), size=nmut, replace=False)
        out[at] = 1 + (out[at] - 1 + rng.integers(1, 4, size=nmut)) % 4
    return out


def make_genome(
    rng: np.random.Generator,
    n: int,
    *,
    segdup_frac: float = 0.30,
    segdup_divergence: float = 0.015,
    line_frac: float = 0.15,
    line_family_len: int = 4000,
    line_divergence: float = 0.08,
    satellite_frac: float = 0.03,
    lowcomp_frac: float = 0.01,
    n_gap_frac: float = 0.005,
) -> tuple[np.ndarray, CorpusReport]:
    """Build an n-base rank-space genome with planted repeat structure.

    Layers (applied in order, later layers overwrite):
      1. uniform random ACGT background
      2. segmental duplications: 300-5000bp copies at ~1.5% divergence
      3. a LINE-like interspersed family: ONE master element, truncated
         diverged copies scattered genome-wide (5' truncation like L1)
      4. satellite arrays: short motifs (5-50bp) tandem-repeated into
         0.5-20kb arrays (the SV seed-blowup stressor)
      5. low-complexity: poly-A runs and telomeric TTAGGG arrays
      6. N gaps: runs of the N rank (assembly gaps; queries overlapping
         them exercise the engines' N handling)
    """
    ref = rng.integers(1, 5, size=n).astype(np.uint8)

    def _len(lo: int, hi: int) -> int:
        # clamp feature lengths so tiny corpora (tests) stay valid
        hi = min(hi, max(n // 4, lo + 1))
        return int(rng.integers(lo, hi + 1))

    covered = 0
    target = int(n * segdup_frac)
    while covered < target:
        seg = _len(min(300, n // 8), 5000)
        src = int(rng.integers(0, n - seg))
        dst = int(rng.integers(0, n - seg))
        ref[dst : dst + seg] = _mutate(ref[src : src + seg], rng, segdup_divergence)
        covered += seg

    # LINE-like family: diverged, 5'-truncated copies of one master
    master = rng.integers(1, 5, size=line_family_len).astype(np.uint8)
    covered = 0
    target = int(n * line_frac)
    while covered < target:
        ln = _len(min(300, n // 8), line_family_len)
        dst = int(rng.integers(0, n - ln))
        copy = _mutate(master[line_family_len - ln :], rng, line_divergence)
        ref[dst : dst + ln] = copy
        covered += ln

    covered = 0
    target = int(n * satellite_frac)
    while covered < target:
        motif = rng.integers(1, 5, size=int(rng.integers(5, 51))).astype(np.uint8)
        arr_len = _len(min(500, n // 8), 20000)
        dst = int(rng.integers(0, n - arr_len))
        reps = -(-arr_len // len(motif))
        arr = np.tile(_mutate(motif, rng, 0.0), reps)[:arr_len]
        # sprinkle divergence over the array (satellites drift)
        ref[dst : dst + arr_len] = _mutate(arr, rng, 0.01)
        covered += arr_len

    covered = 0
    target = int(n * lowcomp_frac)
    while covered < target:
        ln = _len(min(100, n // 16), 2000)
        dst = int(rng.integers(0, n - ln))
        if rng.integers(0, 2):
            ref[dst : dst + ln] = 1  # poly-A
        else:
            reps = -(-ln // len(_TELOMERE))
            ref[dst : dst + ln] = np.tile(_TELOMERE, reps)[:ln]
        covered += ln

    covered = 0
    target = int(n * n_gap_frac)
    while covered < target:
        ln = _len(min(50, n // 16), 5000)
        dst = int(rng.integers(0, n - ln))
        ref[dst : dst + ln] = 5  # N rank
        covered += ln

    report = CorpusReport(
        n=n, segdup_frac=segdup_frac, line_frac=line_frac,
        satellite_frac=satellite_frac, lowcomp_frac=lowcomp_frac,
        n_gap_frac=n_gap_frac,
    )
    return ref, report
