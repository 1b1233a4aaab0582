"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Every wrapper takes the plain version for tensors on the CPU and launches
its kernel for tensors on a CUDA device; any other device raises.  A wrapper
adds one to its entry in ``LAUNCHES`` each time it launches its kernel, so a
run can show which kernels its path went through.
"""

from __future__ import annotations

import torch

LAUNCHES = {"rank_all": 0, "seed_scan": 0, "verify": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on a mix or on
    any other device."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"tensors must all lie on the CPU or on one CUDA device, got {sorted(types)}")


def check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int) -> None:
    """Validate a kernel argument before its pointer is passed on."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on_error(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with CUDA error {rc}")
