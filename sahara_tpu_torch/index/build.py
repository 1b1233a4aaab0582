"""Host-side FM-index construction: text layout, SA (native SA-IS), BWT,
occ bit-planes, sampled suffix array, packed text, full-SA sidecar.

Gives the same arrays as ``sahara_tpu.index.build`` for the same input.
"""

from __future__ import annotations

import numpy as np

from sahara_tpu_torch.index.fmindex import BiFMIndex, FMIndex
from sahara_tpu_torch.index.occtable import build_occ
from sahara_tpu_torch.index.textstore import pack_text4
from sahara_tpu_torch.native import suffix_array

# texts up to this many chars keep the full suffix array (4 bytes/char)
FULL_SA_MAX = 1 << 27


def build_text(seqs: list[np.ndarray], rate: int) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate sequences, padding each with sentinel zeros so that the
    next sequence starts at a multiple of ``rate`` (>=1 sentinel per seq).

    Returns (text uint8[N], starts int64[m]).  N is a multiple of rate."""
    starts = np.zeros(len(seqs), dtype=np.int64)
    pos = 0
    chunks = []
    for i, s in enumerate(seqs):
        starts[i] = pos
        padded = (len(s) + rate) // rate * rate  # next multiple, >= 1 pad
        chunk = np.zeros(padded, dtype=np.uint8)
        chunk[: len(s)] = s
        chunks.append(chunk)
        pos += padded
    return np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.uint8), starts


def _build_core(text: np.ndarray, sigma: int, rate: int, starts: np.ndarray):
    """SA -> BWT -> occ + sampled CSA for the forward text."""
    n = len(text)
    sa = suffix_array(text)
    bwt = text[(sa - 1) % n]
    occ = build_occ(bwt, sigma)

    counts = np.bincount(text, minlength=sigma).astype(np.int64)
    c_arr = np.zeros(sigma + 1, dtype=np.int64)
    c_arr[1:] = np.cumsum(counts)

    # sampled CSA: rows whose suffix position is a multiple of rate
    is_sampled = (sa % rate) == 0
    sampled = build_occ(is_sampled.astype(np.uint8), 2)[:, [1, 3]]  # plane of value 1
    sampled_positions = sa[is_sampled]
    seq_id = np.searchsorted(starts, sampled_positions, side="right") - 1
    seq_pos = sampled_positions - starts[seq_id]
    return dict(
        occ=occ,
        c_arr=c_arr.astype(np.int32),
        sampled=sampled.astype(np.int32),
        sample_seq=seq_id.astype(np.int32),
        sample_pos=seq_pos.astype(np.int32),
        sa_abs=sa.astype(np.int32) if n <= FULL_SA_MAX else None,
    )


def _rev_occ(text: np.ndarray, sigma: int) -> np.ndarray:
    """Reversed-text occ table for right extensions (no CSA on this side)."""
    rev = text[::-1].copy()
    sa_r = suffix_array(rev)
    bwt_r = rev[(sa_r - 1) % len(rev)]
    return build_occ(bwt_r, sigma)


def _build(seqs: list[np.ndarray], sigma: int, alphabet_name: str, rate: int):
    """(padded text, the FMIndex fields) of a sequence collection."""
    seqs = [np.asarray(s, dtype=np.uint8) for s in seqs]
    text, starts = build_text(seqs, rate)
    fields = _build_core(text, sigma, rate, starts)
    fields.update(
        sigma=sigma, alphabet_name=alphabet_name, rate=rate, n=len(text),
        seq_lens=np.array([len(s) for s in seqs], dtype=np.int64),
        text4=pack_text4(text) if sigma <= 15 else None,
    )
    return text, fields


def build_fmindex(seqs: list[np.ndarray], sigma: int, alphabet_name: str, rate: int = 16) -> FMIndex:
    return FMIndex(**_build(seqs, sigma, alphabet_name, rate)[1])


def build_bifmindex(seqs: list[np.ndarray], sigma: int, alphabet_name: str, rate: int = 16) -> BiFMIndex:
    """The forward index plus the reversed-text occ table."""
    text, fields = _build(seqs, sigma, alphabet_name, rate)
    return BiFMIndex(**fields, occ_rev=_rev_occ(text, sigma))
