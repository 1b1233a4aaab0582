"""K7 lf_walk: the sampled LF walk of locate (csrc/lf_walk.cu).

The counterpart of the sampled branch of
``sahara_tpu/engine/locate.py::lf_walk`` on any occ row width: each SA row
steps back by LF until its row is sampled, at most ``rate`` steps, and its
(seq_id, pos) comes from the sample it reaches plus the steps taken.  The
kernel stops at the first sampled row; the plain version runs the
reference's fixed ``rate`` trips, whose later trips change nothing.
"""

from __future__ import annotations

import ctypes

import torch

from sahara_tpu_torch.engine.rank import lf, sampled_bit, sampled_rank
from sahara_tpu_torch.kernels import LAUNCHES, check, on_cuda, raise_on_error, stream_of
from sahara_tpu_torch.kernels._build import load

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = load("lf_walk").sahara_lf_walk
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # occ, c_arr, sampled
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,  # sample_seq, sample_pos, samples
            ctypes.c_void_p, ctypes.c_int64,  # rows, n_rows
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # row_ints, sigma, rate
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # seq_id, pos, stream
        ]
        _fn = fn
    return _fn


def lf_walk_plain(occ, c_arr, sampled, sample_seq, sample_pos, sigma: int, rate: int, rows):
    """(seq_id, pos) int32 of each SA row."""
    steps = torch.zeros_like(rows)
    for _ in range(rate):
        done = sampled_bit(sampled, rows) == 1
        rows = torch.where(done, rows, lf(occ, c_arr, sigma, rows))
        steps = torch.where(done, steps, steps + 1)
    slot = sampled_rank(sampled, rows).clamp(0, sample_seq.shape[0] - 1).long()
    return sample_seq[slot], sample_pos[slot] + steps


def lf_walk(occ, c_arr, sampled, sample_seq, sample_pos, sigma: int, rate: int, rows):
    """Text positions (seq_id, pos) int32[R] of SA rows ``rows`` (int32[R],
    each in [0, n)) by the sampled LF walk."""
    tensors = (occ, c_arr, sampled, sample_seq, sample_pos, rows)
    if not on_cuda(*tensors):
        return lf_walk_plain(occ, c_arr, sampled, sample_seq, sample_pos, sigma, rate, rows)
    for name, t, ndim in zip(("occ", "c_arr", "sampled", "sample_seq", "sample_pos", "rows"), tensors,
                             (2, 1, 2, 1, 1, 1)):
        check(name, t, torch.int32, ndim)
    if (not 1 <= sigma <= min(occ.shape[1] // 2, 128) or c_arr.shape[0] != sigma + 1 or sampled.shape[1] != 2
            or sample_seq.shape != sample_pos.shape or sample_seq.shape[0] < 1 or rate < 1
            or occ.data_ptr() % 16):
        raise ValueError(f"lf_walk: sigma {sigma}, occ rows of {occ.shape[1]} (16 B aligned), "
                         f"{c_arr.shape[0]} C entries, sampled {tuple(sampled.shape)}, "
                         f"{sample_seq.shape[0]} samples, rate {rate}")
    seq_id = torch.empty_like(rows)
    pos = torch.empty_like(rows)
    if rows.shape[0] == 0:
        return seq_id, pos
    rc = _kernel()(occ.data_ptr(), c_arr.data_ptr(), sampled.data_ptr(), sample_seq.data_ptr(),
                   sample_pos.data_ptr(), sample_seq.shape[0], rows.data_ptr(), rows.shape[0], occ.shape[1],
                   sigma, rate, seq_id.data_ptr(), pos.data_ptr(), stream_of(rows))
    raise_on_error(rc, "lf_walk")
    LAUNCHES["lf_walk"] += 1
    return seq_id, pos
