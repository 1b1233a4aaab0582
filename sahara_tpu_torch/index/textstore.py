"""Packed text store: the indexed text kept beside the FM-index.

Seed-and-verify checks each candidate window against the text, so the text
is kept, packed 8 ranks per int32 (4 bits each, little-endian within the
word): n/2 bytes for alphabets with sigma <= 16.
"""

from __future__ import annotations

import numpy as np

RANKS_PER_WORD = 8


def pack_text4(text: np.ndarray) -> np.ndarray:
    """uint8[n] ranks (< 16) -> int32[ceil(n/8)] packed words."""
    text = np.asarray(text, dtype=np.uint8)
    if text.size and int(text.max()) > 15:
        raise ValueError("text4 packing requires ranks < 16")
    n = len(text)
    nw = -(-n // RANKS_PER_WORD) if n else 0
    padded = np.zeros(nw * RANKS_PER_WORD, dtype=np.uint32)
    padded[:n] = text
    words = np.zeros(nw, dtype=np.uint32)
    for j in range(RANKS_PER_WORD):
        words |= padded[j::RANKS_PER_WORD] << (4 * j)
    return words.view(np.int32)


def unpack_text4(words: np.ndarray, n: int) -> np.ndarray:
    """int32[nw] packed words -> uint8[n] ranks."""
    w = np.asarray(words).view(np.uint32)
    out = np.zeros(len(w) * RANKS_PER_WORD, dtype=np.uint8)
    for j in range(RANKS_PER_WORD):
        out[j::RANKS_PER_WORD] = (w >> (4 * j)) & 0xF
    return out[:n]
