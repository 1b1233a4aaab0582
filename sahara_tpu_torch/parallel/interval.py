"""Interval-parallel search: the index sharded by text interval across the
mesh, every query against every shard.

The counterpart of ``sahara_tpu/parallel/interval.py``.  Shard i of an
interval-sharded index (``index/shard.py``) lives on mesh entry i, at its
own size.  Each device runs the work-queue search (K5) of every query
against its shard, locates the hits by the sampled LF walk (K7) on its
own upload, and maps them to global coordinates through the shard's
(global seqId, window offset) tables; the host merges the rows.

Left out as TPU-only machinery: the padding of every shard to a common
word count (one SPMD program for all devices), the capacity memory and
its live-profile plans, and the overflow retries (the port's step
allocates exactly and halves the active set past ``workq.HARD_CAP``).
"""

from __future__ import annotations

import numpy as np
import torch

from sahara_tpu_torch.engine.device import DeviceIndex
from sahara_tpu_torch.engine.driver import (
    SearchResult, _locate_flat_hits, _merge_results, _shard_to_global, _workq_hits,
)
from sahara_tpu_torch.engine.tape import SchemeTape
from sahara_tpu_torch.index.shard import ShardedIndex
from sahara_tpu_torch.parallel.mesh import DataMesh


def distributed_interval_search(
    mesh: DataMesh,
    sh: ShardedIndex,
    queries: np.ndarray,
    tape: SchemeTape,
    *,
    edit: bool,
    chunk: int = 8192,
) -> SearchResult:
    """Search [nq, m] ``queries`` against every shard of ``sh``, shard i on
    ``mesh.devices[i]``, ``chunk`` queries a search.  Returns the merged
    global rows.  Raises ``ValueError`` when there are more shards than
    mesh entries."""
    if sh.num_shards > mesh.size:
        raise ValueError(f"{sh.num_shards} shards > {mesh.size} devices; use search_queries_sharded")
    nq = len(queries)
    ids = np.arange(nq, dtype=np.int64)
    parts: list[SearchResult] = []
    for i, (host, d) in enumerate(zip(sh.shards, mesh.devices)):
        index = DeviceIndex.from_host(host, device=d, full_sa=False)
        q = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.uint8)).to(d)
        found = _workq_hits(index, q, tape, edit=edit, active=np.ones(nq, dtype=bool), chunk=chunk)
        parts += [_shard_to_global(_locate_flat_hits(index, hits, ns, ids[start:]), sh, i)
                  for start, _, ns, hits in found]
    merged = _merge_results(parts)
    if len(sh.windowed_gids) and len(merged.query_id):
        # one row of each hit found in two overlapping windows
        windowed = np.isin(merged.seq_id, sh.windowed_gids)
        rows = np.stack([merged.query_id, merged.seq_id, merged.pos, merged.errors], axis=1)
        _, first_i = np.unique(rows, axis=0, return_index=True)
        keep = np.zeros(len(rows), dtype=bool)
        keep[first_i] = True
        keep |= ~windowed
        merged = SearchResult(merged.query_id[keep], merged.seq_id[keep], merged.pos[keep], merged.errors[keep])
    return merged
