"""Occurrence (rank) table: per-symbol bit-planes + absolute checkpoints.

    occ  : int32[W, 2*sigma]   with W = N//32 + 1
           occ[w, :sigma]  = absolute counts of each symbol in bwt[0:32*w]
           occ[w, sigma:]  = 32-bit words of the per-symbol bit-planes
                             (bit i of word w <=> bwt[32*w + i] == symbol)

A rank-all query is one row read plus a popcount per symbol.  Rank is
defined for positions i in [0, N]: the +1 word makes i == N valid.
"""

from __future__ import annotations

import numpy as np


def build_occ(bwt: np.ndarray, sigma: int) -> np.ndarray:
    """Build the combined checkpoint+bits occ array from a BWT rank vector."""
    n = len(bwt)
    w = n // 32 + 1
    occ = np.zeros((w, 2 * sigma), dtype=np.int32)
    for c in range(sigma):
        plane = bwt == c
        packed = np.packbits(plane, bitorder="little")
        packed = np.pad(packed, (0, 4 * w - len(packed)))
        words = packed.view("<u4")
        occ[:, sigma + c] = words.view(np.int32)
        counts = np.bitwise_count(words).astype(np.int64)
        occ[1:, c] = np.cumsum(counts)[:-1].astype(np.int32)
    return occ


def rank_all_np(occ: np.ndarray, sigma: int, i: np.ndarray) -> np.ndarray:
    """int64[..., sigma]: for each position, the count of every symbol in
    bwt[0:i]."""
    i = np.asarray(i)
    w = i >> 5
    off = (i & 31).astype(np.uint32)
    row = occ[w]  # [..., 2*sigma]
    ckpt = row[..., :sigma].astype(np.int64)
    bits = row[..., sigma:].astype(np.int64) & 0xFFFFFFFF
    mask = ((np.uint64(1) << off.astype(np.uint64)) - np.uint64(1)).astype(np.int64)
    cnt = np.bitwise_count((bits & mask[..., None]).astype(np.uint64)).astype(np.int64)
    return ckpt + cnt
