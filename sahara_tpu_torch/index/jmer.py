"""j-mer prefix lookup table: skip the first j steps of exact backward search.

The (lo, hi) SA interval of every length-j pattern over the DNA ranks
{1..4}, built once per index upload on the index's device, one rank_all
launch per level.  Codes are little-endian in consumption order: digit i
(weight 4^i) is the (rank - 1) of the i-th char consumed, i.e. the part's
(len-1-i)-th char.  Bit-identical to ``sahara_tpu.index.jmer.build_jmer_lut``.
"""

from __future__ import annotations

import numpy as np
import torch

from sahara_tpu_torch.kernels.rank import rank_all


MAX_J = 10  # = seedverify.MIN_PART: every seed part covers the table


def pick_lut_j(n: int) -> int:
    """Table depth: deep enough to be selective (4^j >= n is pointless)."""
    return min(max(int(np.log2(max(n, 16)) / 2), 2), MAX_J)


def build_jmer_lut(occ16: torch.Tensor, c_arr: torch.Tensor, sigma: int, n: int, j: int) -> torch.Tensor:
    """(lo | hi) intervals for all 4^j codes: int32[2 * 4^j].

    Level l extends every level-(l-1) interval by each digit d in 1..4:
    lo' = C[d] + rank_d(lo).  Digits with rank >= sigma give empty
    intervals (0, 0)."""
    dev = occ16.device
    lo = torch.zeros(1, dtype=torch.int32, device=dev)
    hi = torch.full((1,), n, dtype=torch.int32, device=dev)
    for level in range(j):
        sz = 4**level
        ranks = rank_all(occ16, sigma, torch.cat([lo, hi])).view(2, sz, sigma)
        ext = torch.zeros((2, 4, sz), dtype=torch.int32, device=dev)  # [lo|hi, digit, code]
        for d in range(1, min(5, sigma)):
            ext[:, d - 1] = c_arr[d] + ranks[:, :, d]
        lo, hi = ext[0].reshape(-1), ext[1].reshape(-1)
    return torch.cat([lo, hi])
