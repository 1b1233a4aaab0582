"""The scheme engines over a data mesh.

The counterpart of ``sahara_tpu/parallel/search.py``: each device runs the
single-device engine on its slice of the queries against its replica of
the index, and the host sums the hit counts where the reference reduces
them with ``psum``.  ``distributed_workq_search`` runs the work-queue engine
(K5), ``distributed_scheme_search`` one frontier-engine search (K8) at
fixed caps, as the reference's does.
"""

from __future__ import annotations

import numpy as np
import torch

from sahara_tpu_torch.engine import workq
from sahara_tpu_torch.engine.approx import SearchHits, scheme_search
from sahara_tpu_torch.engine.device import DeviceIndex
from sahara_tpu_torch.engine.driver import _workq_hits
from sahara_tpu_torch.engine.tape import SchemeTape
from sahara_tpu_torch.kernels.frontier import pack_tape
from sahara_tpu_torch.parallel.mesh import DataMesh, check_replicas, mesh_slices, shard_queries


def distributed_scheme_search(
    mesh: DataMesh,
    index: tuple[DeviceIndex, ...],
    queries: np.ndarray,
    tape: SchemeTape,
    *,
    edit: bool,
    s_cap: int = 64,
    h_cap: int = 32,
) -> tuple[SearchHits, int]:
    """One frontier-engine search of [nq, m] ``queries`` over the mesh, at
    caps ``s_cap`` and ``h_cap`` (no retries).  Returns (the hits over the
    original queries, on the mesh's first device, the hit count summed over
    the devices)."""
    replicas = check_replicas(index, mesh)
    slices, nq = shard_queries(np.asarray(queries, dtype=np.int32), mesh)
    ns, per = tape.num_searches, slices[0].shape[0]
    words = pack_tape(tape.side, tape.qpos, tape.lo, tape.hi)
    first = mesh.devices[0]
    fields: list[list[torch.Tensor]] = [[] for _ in range(6)]
    total = 0
    for d, (rep, q) in enumerate(zip(replicas, slices)):
        act = torch.arange(d * per, (d + 1) * per, device=q.device) < nq  # padding rows start empty
        hits, cnt, flags = scheme_search(rep, q, torch.from_numpy(words).to(q.device), act, edit=edit,
                                         s_cap=s_cap, h_cap=h_cap, k=tape.max_errors)
        total += int(cnt.sum())
        for out, t in zip(fields, (*hits.reshape(3, per, ns, h_cap), cnt.reshape(per, ns))):
            out.append(t.to(first))
        for out, f in zip(fields[4:], flags.cpu().numpy().astype(bool).reshape(2, per, ns)):
            out.append(torch.from_numpy(f))
    lb, sz, err, count, f_ovf, h_ovf = (torch.cat(f)[:nq] for f in fields)
    return SearchHits(lb, sz, err, count, f_ovf, h_ovf), total


def distributed_workq_search(
    mesh: DataMesh,
    index: tuple[DeviceIndex, ...],
    queries: np.ndarray,
    tape: SchemeTape,
    *,
    edit: bool,
    active: np.ndarray | None = None,
) -> tuple[workq.FlatHits, int]:
    """Work-queue search of [nq, m] ``queries`` over the mesh, one
    contiguous slice a device, each searched as the driver searches a
    bucket (tape groups, meta-packing chunks, dedup on, the active set
    halved where a step passes ``workq.HARD_CAP``; ``RuntimeError`` where
    one query alone does).  ``active`` masks queries off.  Returns (hits
    with lanes ``query * ns + search`` over the original queries and the
    whole tape, their count)."""
    replicas = check_replicas(index, mesh)
    nq, ns = len(queries), tape.num_searches
    act = np.ones(nq, dtype=bool) if active is None else np.asarray(active, dtype=bool)
    lanes, fields = [], []
    for d, rows in mesh_slices(nq, max(-(-nq // mesh.size), 1), mesh.size):
        q = torch.from_numpy(np.ascontiguousarray(queries[rows], dtype=np.uint8)).to(replicas[d].device)
        for start, g0, ns_g, hits in _workq_hits(replicas[d], q, tape, edit=edit, active=act[rows], chunk=len(q)):
            q_of = rows.start + start + hits.lane.astype(np.int64) // ns_g
            lanes.append(q_of * ns + g0 + hits.lane % ns_g)
            fields.append((hits.lb, hits.sz, hits.err))
    lane = np.concatenate(lanes) if lanes else np.zeros(0, dtype=np.int64)
    lb, sz, err = (np.concatenate([f[i] for f in fields]) if fields else np.zeros(0, dtype=np.int32)
                   for i in range(3))
    return workq.FlatHits(lane=lane, lb=lb, sz=sz, err=err, n_hits=len(lane)), len(lane)
