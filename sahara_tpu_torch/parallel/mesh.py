"""The data mesh: the index replicated on every device, the queries split
into contiguous slices, one a device.

The counterpart of ``sahara_tpu/parallel/mesh.py``.  Where the reference
runs one SPMD program over a ``jax.sharding.Mesh``, each device of a
``DataMesh`` runs the port's single-device code on its own slice, and the
host sums the counts and merges the rows.  No device data crosses devices.

A mesh is an explicit list of devices.  ``data_mesh`` takes the visible
CUDA cards and never substitutes the CPU; a caller may list a device more
than once (the tests' ``[cpu] * 8``, a card shared by two slices).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sahara_tpu_torch.engine.device import DeviceIndex
from sahara_tpu_torch.index.fmindex import FMIndex

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """Devices along the one ``data`` axis, in slice order."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def _visible_cards() -> list[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def data_mesh(n_devices: int | None = None, devices=None) -> DataMesh:
    """A mesh over the first ``n_devices`` of ``devices`` (default: the
    visible CUDA cards).  Raises ``ValueError`` when there are fewer, or a
    listed card is not visible."""
    devs = _visible_cards() if devices is None else [torch.device(d) for d in devices]
    n_cards = torch.cuda.device_count()
    for d in devs:
        if d.type == "cuda" and (d.index is None or d.index >= n_cards):
            raise ValueError(f"{d} is not a visible CUDA card (give its index; {n_cards} visible)")
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return DataMesh(tuple(devs))


def replicate_index(host: FMIndex, mesh: DataMesh, **upload_kw) -> tuple[DeviceIndex, ...]:
    """One ``DeviceIndex`` a mesh entry, uploaded once a distinct device
    (entries that repeat a device share its upload).  ``upload_kw`` are
    ``DeviceIndex.from_host``'s."""
    uploads: dict[torch.device, DeviceIndex] = {}
    for d in mesh.devices:
        if d not in uploads:
            uploads[d] = DeviceIndex.from_host(host, device=d, **upload_kw)
    return tuple(uploads[d] for d in mesh.devices)


def check_replicas(index, mesh: DataMesh) -> tuple[DeviceIndex, ...]:
    """``index`` as ``replicate_index`` gives it for ``mesh``; raises
    otherwise."""
    if not isinstance(index, tuple) or len(index) != mesh.size:
        raise ValueError(f"a mesh of {mesh.size} takes the replicated index (parallel.replicate_index)")
    for rep, d in zip(index, mesh.devices):
        if rep.device != d:
            raise ValueError(f"a replica lies on {rep.device}, its mesh entry is {d}")
    return index


def shard_queries(queries: np.ndarray, mesh: DataMesh) -> tuple[list[torch.Tensor], int]:
    """Pad the [nq, m] batch with zero rows to a multiple of the mesh size
    and cut it into contiguous slices, each on its mesh entry's device.
    Returns (the slices, the original count); rows past it are padding."""
    nq, m = queries.shape
    pad = (-nq) % mesh.size
    if pad:
        queries = np.concatenate([queries, np.zeros((pad, m), dtype=queries.dtype)])
    per = queries.shape[0] // mesh.size
    return [torch.from_numpy(np.ascontiguousarray(queries[i * per : (i + 1) * per])).to(d)
            for i, d in enumerate(mesh.devices)], nq


def mesh_slices(nq: int, chunk: int, size: int) -> list[tuple[int, slice]]:
    """(mesh entry, rows) for ``nq`` queries: chunks of ``chunk`` queries a
    device, each cut into ``size`` contiguous slices of equal length but the
    last chunk's, whose slices hold ceil(rows / size) rows; empty slices
    are left out."""
    out = []
    for start in range(0, nq, chunk * size):
        per = -(-min(chunk * size, nq - start) // size)
        for d in range(size):
            lo, hi = start + d * per, min(start + (d + 1) * per, nq)
            if lo < hi:
                out.append((d, slice(lo, hi)))
    return out
