"""Seed-and-verify over a data mesh.

The counterpart of ``sahara_tpu/parallel/sv.py::distributed_sv_search``.
Queries go to the devices in chunks of ``chunk`` a device, each chunk cut
into contiguous slices, one a mesh entry; the index is replicated.  Each
device runs the exact-parts plan on its slice: seed (K2 ``seed_scan``),
expand under the per-part budget and its own ``seed_bad_mask``, locate and
verify (K3, or K3h under Hamming distance).  The host sums the hit counts.

Left out as TPU-only machinery (the port allocates exactly): the
candidate-capacity quantisation, the common capacity across devices, the
capacity slicing and the hit-buffer retry.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sahara_tpu_torch.engine.device import DeviceIndex
from sahara_tpu_torch.engine.seedverify import PART_CAP, plan_parts, seed_bad_mask, sv_fused
from sahara_tpu_torch.parallel.mesh import DataMesh, check_replicas, mesh_slices


@dataclasses.dataclass
class SvHits:
    """Verified, located hits at absolute padded-text positions."""

    q_idx: np.ndarray  # int64[H], query index in the input batch
    abs_pos: np.ndarray  # int64[H]
    err: np.ndarray  # int64[H]
    fallback: np.ndarray  # bool[nq]: queries seed-and-verify cannot search alone


def _sv_slice(index: DeviceIndex, queries: np.ndarray, active: np.ndarray, parts, *, k: int, edit: bool,
              part_cap: int) -> SvHits:
    """Exact-parts seed-and-verify of one device's slice (int32[n, m] host
    ``queries``): the active queries are uploaded and searched; those with
    a part interval over ``part_cap``, and those whose seeds the j-mer
    table cannot encode (``seed_bad_mask`` on the upload), are flagged in
    ``fallback``."""
    fallback = np.zeros(len(queries), dtype=bool)
    keep = np.flatnonzero(active)
    if len(keep) == 0:
        z = np.zeros(0, dtype=np.int64)
        return SvHits(z, z, z, fallback)
    q = torch.from_numpy((queries if len(keep) == len(queries) else queries[keep]).astype(np.uint8)).to(index.device)
    q_idx, abs_pos, err, over = sv_fused(index, q, parts, k=k, edit=edit, part_cap=part_cap,
                                         bad=seed_bad_mask(index, q, parts))
    fallback[keep[over]] = True
    return SvHits(keep[q_idx], abs_pos, err, fallback)


def distributed_sv_search(
    mesh: DataMesh,
    index: tuple[DeviceIndex, ...],
    queries: np.ndarray,
    k: int,
    *,
    edit: bool,
    chunk: int = 8192,
    part_cap: int = PART_CAP,
    active: np.ndarray | None = None,
) -> tuple[SvHits, int]:
    """Seed-and-verify of [nq, m] ``queries`` over the mesh, ``chunk``
    queries a device at a time, on ``index`` from ``replicate_index``.

    Returns (hits with ``q_idx`` over the input batch and ``fallback``
    flagging the queries a scheme engine must search, the hit count summed
    over the devices)."""
    replicas = check_replicas(index, mesh)
    # int32, as the reference casts: the rank arrays may come as uint8
    queries = np.asarray(queries, dtype=np.int32)
    nq, m = queries.shape
    parts = plan_parts(m, k)
    if parts is None:
        raise ValueError(f"seed-verify not applicable: m={m}, k={k}")
    act = np.ones(nq, dtype=bool) if active is None else np.asarray(active, dtype=bool)
    fallback = np.zeros(nq, dtype=bool)
    q_idx, abs_pos, err, total = [], [], [], 0
    for d, rows in mesh_slices(nq, chunk, mesh.size):
        hits = _sv_slice(replicas[d], queries[rows], act[rows], parts, k=k, edit=edit, part_cap=part_cap)
        fallback[rows] = hits.fallback
        q_idx.append(hits.q_idx + rows.start)
        abs_pos.append(hits.abs_pos)
        err.append(hits.err)
        total += len(hits.q_idx)
    cat = lambda a: np.concatenate(a) if a else np.zeros(0, dtype=np.int64)  # noqa: E731
    return SvHits(cat(q_idx), cat(abs_pos), cat(err), fallback), total
