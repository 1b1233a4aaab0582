"""Device-resident view of an FM-index (tensors on one device).

The counterpart of ``sahara_tpu/engine/device.py::DeviceIndex``: the occ
tables in the planar layout of ``engine/rank.py`` (occ16 rows up to sigma =
8, wider rows up to sigma = 128), the sampled suffix array, the packed text,
the j-mer seed table and the optional full suffix array.  Exact search and
locate take every row width; seed-and-verify and the work-queue engine take
only occ16 rows.

For a bidirectional host index the reversed-text occ table is stacked after
the forward one (``rev_rows`` words in), so the work-queue engine picks the
extension direction per state by a row offset.  Seed scan, locate and
verify read only the forward half; an SV-only caller skips the reversed
table with ``include_rev=False``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sahara_tpu_torch.engine.rank import pack_occ, row_ints
from sahara_tpu_torch.index.fmindex import BiFMIndex, FMIndex
from sahara_tpu_torch.index.jmer import build_jmer_lut, pick_lut_j


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; raises when there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class DeviceIndex:
    occ: torch.Tensor  # int32[W or 2W, row_ints] — engine/rank.py layout, forward table first
    c_arr: torch.Tensor  # int32[sigma+1]
    sampled: torch.Tensor  # int32[W, 2] — (checkpoint, bit word) of sampled rows
    sample_seq: torch.Tensor  # int32[S]
    sample_pos: torch.Tensor  # int32[S]
    sigma: int
    rate: int
    n: int
    # packed text and per-sequence start offsets in the padded layout;
    # present iff the host index carries a text store
    text4: torch.Tensor | None = None  # int32[ceil(n/8)]
    seq_starts: torch.Tensor | None = None  # int32[num_seqs]
    # (lo | hi) interval per length-lut_j DNA pattern, int32[2 * 4^lut_j]
    lut: torch.Tensor | None = None
    lut_j: int = 0
    # full suffix array (absolute padded-text positions): locate is one gather
    sa_full: torch.Tensor | None = None
    # word offset where the stacked reversed-text table starts (the forward
    # table's word count); 0 when none is stacked
    rev_rows: int = 0
    # 1 + the highest symbol rank present in the text: the work-queue step
    # enumerates branches only for symbols that can occur
    sigma_live: int = 0
    # the collection is closed under reversal: right extensions rank the
    # forward table, and no reversed table is stacked
    mirrored: bool = False

    @property
    def device(self) -> torch.device:
        return self.occ.device

    @property
    def row_ints(self) -> int:
        """int32 per occ row: 16 (occ16) for sigma <= 8, wider above."""
        return self.occ.shape[1]

    @property
    def bidirectional(self) -> bool:
        return self.rev_rows > 0 or self.mirrored

    @property
    def rev_word_off(self) -> int:
        """Word offset of the table that serves right extensions."""
        return 0 if self.mirrored else self.rev_rows

    @staticmethod
    def from_host(index: FMIndex, device=None, full_sa: bool = True, include_rev: bool = True) -> "DeviceIndex":
        """Upload a host index.  ``full_sa=False`` leaves the full suffix
        array on the host, so locate takes the sampled LF-walk;
        ``include_rev=False`` leaves the reversed-text table on the host
        (the view is then not bidirectional, and only seed-and-verify can
        search it)."""
        if index.n >= 2**31:
            raise ValueError("single-device index limited to text < 2^31 positions")
        dev = resolve_device(device)

        def put(x) -> torch.Tensor:
            return torch.tensor(np.ascontiguousarray(x, dtype=np.int32), device=dev)

        occ = pack_occ(index.occ)
        mirrored = bool(getattr(index, "mirrored", False))
        rev_rows = 0
        if isinstance(index, BiFMIndex) and index.occ_rev is not None and not mirrored and include_rev:
            if index.occ_rev.shape != index.occ.shape:
                raise ValueError("forward and reversed occ tables differ in shape")
            rev_rows = occ.shape[0]
            occ = np.concatenate([occ, pack_occ(index.occ_rev)])
        occ = put(occ)
        c_arr = put(index.c_arr)
        # symbol counts from the C-array: count(s) = C[s+1] - C[s]
        counts = np.diff(np.append(np.asarray(index.c_arr, dtype=np.int64)[: index.sigma], index.n))
        present = np.nonzero(counts[1:] > 0)[0]  # symbol ranks 1.. present
        sigma_live = min(int(present[-1]) + 2 if len(present) else 2, int(index.sigma))
        lut, lut_j = None, 0
        if index.text4 is not None and index.sigma <= 6:
            lut_j = pick_lut_j(index.n)
            lut = build_jmer_lut(occ, c_arr, index.sigma, index.n, lut_j)
        has_text = index.text4 is not None
        return DeviceIndex(
            occ=occ,
            c_arr=c_arr,
            sampled=put(index.sampled),
            sample_seq=put(index.sample_seq),
            sample_pos=put(index.sample_pos),
            sigma=int(index.sigma),
            rate=int(index.rate),
            n=int(index.n),
            text4=put(index.text4) if has_text else None,
            seq_starts=put(index.seq_starts()) if has_text else None,
            lut=lut,
            lut_j=lut_j,
            sa_full=(
                put(index.sa_abs) if full_sa and index.sa_abs is not None and has_text else None
            ),
            rev_rows=rev_rows,
            sigma_live=sigma_live,
            mirrored=mirrored,
        )


def device_bytes(index: FMIndex, full_sa: bool = True, include_rev: bool = True) -> int:
    """Bytes ``DeviceIndex.from_host(index, full_sa=..., include_rev=...)``
    puts on the card: the occ rows at their device width, the reversed
    table where it is stacked, the sampled suffix array, the packed text,
    the sequence starts, the j-mer table and the full suffix array."""
    n_words = index.occ.shape[0] * row_ints(index.sigma)
    if isinstance(index, BiFMIndex) and index.occ_rev is not None and not index.mirrored and include_rev:
        n_words *= 2
    n_words += len(index.c_arr) + index.sampled.size + len(index.sample_seq) + len(index.sample_pos)
    if index.text4 is not None:
        n_words += index.text4.size + len(index.seq_lens)
        if index.sigma <= 6:
            n_words += 2 * 4 ** pick_lut_j(index.n)
        if full_sa and index.sa_abs is not None:
            n_words += index.sa_abs.size
    return 4 * n_words


def pad_queries(queries: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Left-aligned queries padded to the longest: (uint8[B, L] symbols,
    int32[B] lengths)."""
    lens = np.fromiter((len(q) for q in queries), dtype=np.int32, count=len(queries))
    out = np.zeros((len(queries), int(lens.max(initial=0))), dtype=np.uint8)
    for i, q in enumerate(queries):
        out[i, : len(q)] = q
    return out, lens
