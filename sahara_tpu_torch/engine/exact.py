"""Batched exact backward search against a device index.

The counterpart of ``sahara_tpu/engine/exact.py`` (the reference's
``fmc::search_no_errors::search``): every query's SA interval on the
forward index, one K6 launch for the batch on the card, its plain version
on the CPU, both starting the queries it covers from the index's j-mer
table.  Any alphabet a device index holds (sigma <= 128) is searched.
"""

from __future__ import annotations

import torch

from sahara_tpu_torch.engine.device import DeviceIndex
from sahara_tpu_torch.kernels import exact


def exact_search(index: DeviceIndex, queries, qlens) -> tuple[torch.Tensor, torch.Tensor]:
    """(lb, len) int32[B] of each query.  ``queries``: uint8[B, L]
    left-aligned symbols and ``qlens`` int32[B] (``device.pad_queries``),
    NumPy arrays or tensors; both go to the index's device."""
    q = torch.as_tensor(queries, dtype=torch.uint8, device=index.device).contiguous()
    lens = torch.as_tensor(qlens, dtype=torch.int32, device=index.device).contiguous()
    return exact.exact_search(index.occ, index.c_arr, q, lens, index.sigma, index.n, index.lut, index.lut_j)
