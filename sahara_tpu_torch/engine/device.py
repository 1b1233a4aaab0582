"""Device-resident view of an FM-index (tensors on one device).

The counterpart of ``sahara_tpu/engine/device.py::DeviceIndex``, reduced to
what the seed-and-verify path reads: the forward occ table in the planar
occ16 layout, the sampled suffix array, the packed text, the j-mer seed
table and the optional full suffix array.  No reverse table is uploaded:
seed scan and locate rank only the forward table.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sahara_tpu_torch.engine.rank import pack_occ16
from sahara_tpu_torch.index.fmindex import FMIndex
from sahara_tpu_torch.index.jmer import build_jmer_lut, pick_lut_j


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; raises when there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class DeviceIndex:
    occ16: torch.Tensor  # int32[W, 16] — engine/rank.py layout
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

    @property
    def device(self) -> torch.device:
        return self.occ16.device

    @staticmethod
    def from_host(index: FMIndex, device=None, full_sa: bool = True) -> "DeviceIndex":
        """Upload a host index.  ``full_sa=False`` leaves the full suffix
        array on the host, so locate takes the sampled LF-walk."""
        if index.n >= 2**31:
            raise ValueError("single-device index limited to text < 2^31 positions")
        dev = resolve_device(device)

        def put(x) -> torch.Tensor:
            return torch.tensor(np.asarray(x, dtype=np.int32), device=dev)

        occ16 = put(pack_occ16(index.occ))
        c_arr = put(index.c_arr)
        lut, lut_j = None, 0
        if index.text4 is not None and index.sigma <= 6:
            lut_j = pick_lut_j(index.n)
            lut = build_jmer_lut(occ16, c_arr, index.sigma, index.n, lut_j)
        has_text = index.text4 is not None
        return DeviceIndex(
            occ16=occ16,
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
        )
