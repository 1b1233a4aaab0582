"""Alphabet tables: the DNA5 rank alphabet and the plain dna4 helpers.

Rank 0 is the sequence delimiter ('$'); real symbols are 1..sigma-1.  All
conversion happens on the host, so this module is NumPy only.
"""

from __future__ import annotations

import dataclasses

import numpy as np

INVALID_RANK = 255


@dataclasses.dataclass(frozen=True)
class Alphabet:
    name: str
    sigma: int
    char_to_rank_table: np.ndarray  # uint8[256], INVALID_RANK = invalid
    rank_to_char_table: np.ndarray  # uint8[sigma], canonical char per rank
    complement: np.ndarray  # uint8[sigma]

    def char_to_rank(self, data: bytes | str | np.ndarray) -> np.ndarray:
        if isinstance(data, str):
            data = data.encode()
        arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, bytes) else np.asarray(data, dtype=np.uint8)
        return self.char_to_rank_table[arr]

    def reverse_complement_rank(self, ranks: np.ndarray) -> np.ndarray:
        return self.complement[ranks[::-1]]


def _make_table(mapping: dict[int, str]) -> tuple[np.ndarray, np.ndarray]:
    c2r = np.full(256, INVALID_RANK, dtype=np.uint8)
    r2c = np.zeros(max(mapping) + 1, dtype=np.uint8)
    for rank, chars in mapping.items():
        r2c[rank] = ord(chars[0])
        for ch in chars:
            c2r[ord(ch)] = rank
    return c2r, r2c


def _alphabet(name: str, mapping: dict[int, str], complement_pairs: dict[int, int]) -> Alphabet:
    c2r, r2c = _make_table(mapping)
    sigma = max(mapping) + 1
    comp = np.arange(sigma, dtype=np.uint8)
    for a, b in complement_pairs.items():
        comp[a] = b
        comp[b] = a
    return Alphabet(name=name, sigma=sigma, char_to_rank_table=c2r, rank_to_char_table=r2c, complement=comp)


# d_dna5: sigma=6 ($,A,C,G,T,N); U/u are T-synonyms
D_DNA5 = _alphabet(
    "d_dna5",
    {0: "$", 1: "Aa", 2: "Cc", 3: "Gg", 4: "TtUu", 5: "Nn"},
    {1: 4, 2: 3},
)

# plain dna4 (no delimiter), used by the read simulator
_DNA4_C2R, _DNA4_R2C = _make_table({0: "Aa", 1: "Cc", 2: "Gg", 3: "TtUu"})


def dna4_char_to_rank(data: bytes) -> np.ndarray:
    return _DNA4_C2R[np.frombuffer(data, dtype=np.uint8)]


def dna4_rank_to_char(ranks: np.ndarray) -> bytes:
    return _DNA4_R2C[np.asarray(ranks, dtype=np.uint8)].tobytes()
