"""Plain rank/LF primitives on the planar occ16 layout (PyTorch).

The device occ table keeps one row per 32 BWT positions, padded from
2*sigma to 16 int32 (64 B): ``occ16[w, :sigma]`` are the checkpoints,
``occ16[w, sigma:2*sigma]`` the bit-plane words, the rest zero (see
``pack_occ16``).  This is ``sahara_tpu``'s ``pack_occ16`` row without its
8-row fold, which existed only for the TPU's lane tiling.

The sampled-row table keeps its own [W, 2] layout (checkpoint, bit word).
Positions are int32 or int64 tensors; bit words are widened to int64 before
any shift, so no sign bit leaks into a mask.
"""

from __future__ import annotations

import numpy as np
import torch

ROW_INTS = 16


def pack_occ16(occ: np.ndarray) -> np.ndarray:
    """Host re-layout: int32[W, 2*sigma] -> int32[W, 16], zero-padded."""
    occ = np.asarray(occ)
    w, width = occ.shape
    if width > ROW_INTS:
        raise ValueError(f"occ16 rows hold sigma <= 8, got 2*sigma = {width}")
    out = np.zeros((w, ROW_INTS), dtype=np.int32)
    out[:, :width] = occ
    return out


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of 32-bit values held in an int64 tensor (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _low_mask(i: torch.Tensor) -> torch.Tensor:
    """(1 << (i & 31)) - 1 as int64."""
    return (torch.ones_like(i, dtype=torch.int64) << (i.long() & 31)) - 1


def _u32(words: torch.Tensor) -> torch.Tensor:
    return words.long() & 0xFFFFFFFF


def occ_row(occ16: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """The occ rows holding position(s) i: int32[..., 16]."""
    return occ16[i.long() >> 5]


def rank_all_from_row(row: torch.Tensor, sigma: int, i: torch.Tensor) -> torch.Tensor:
    """int32[..., sigma]: count of each symbol in bwt[0:i], given i's row."""
    bits = _u32(row[..., sigma : 2 * sigma]) & _low_mask(i)[..., None]
    return (row[..., :sigma].long() + popcount32(bits)).to(torch.int32)


def rank_sym(occ16: torch.Tensor, sigma: int, sym: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """int32[...]: count of symbol ``sym`` in bwt[0:i] (one symbol per lane)."""
    row = occ_row(occ16, i)
    sym = sym.long()[..., None]
    ckpt = row.gather(-1, sym)[..., 0].long()
    bits = _u32(row.gather(-1, sym + sigma)[..., 0]) & _low_mask(i)
    return (ckpt + popcount32(bits)).to(torch.int32)


def symbol_from_row(row: torch.Tensor, sigma: int, i: torch.Tensor) -> torch.Tensor:
    """BWT symbol at position i, decoded from the bit-planes (int64)."""
    sel = (_u32(row[..., sigma : 2 * sigma]) >> (i.long() & 31)[..., None]) & 1
    return sel.argmax(dim=-1)


def lf(occ16: torch.Tensor, c_arr: torch.Tensor, sigma: int, i: torch.Tensor) -> torch.Tensor:
    """LF-mapping: row of the suffix one position earlier in the text."""
    row = occ_row(occ16, i)
    c = symbol_from_row(row, sigma, i)
    rank_c = rank_all_from_row(row, sigma, i).gather(-1, c[..., None])[..., 0]
    return c_arr[c] + rank_c


def sampled_bit(sampled: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """1 iff SA row i is sampled (int32)."""
    bits = _u32(sampled[i.long() >> 5, 1])
    return ((bits >> (i.long() & 31)) & 1).to(torch.int32)


def sampled_rank(sampled: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Number of sampled rows before row i (the sample slot of row i)."""
    row = sampled[i.long() >> 5]
    bits = _u32(row[..., 1]) & _low_mask(i)
    return (row[..., 0].long() + popcount32(bits)).to(torch.int32)
