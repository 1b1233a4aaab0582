"""Multi-host search: each process searches a contiguous slice of the
global query list and rank 0 merges the part files.

The counterpart of ``sahara_tpu/parallel/multihost.py``, over
``torch.distributed`` with the gloo backend: only host files cross ranks
(every process loads the same index file and the whole query file), so
the processes need no device collective, and several may share one card.

- ``initialize`` joins the process group (a no-op for one process);
- each process keeps its slice ``host_query_slice`` of the global query
  list (strand queries counted, so the slicing comes after the reverse
  complements are added), searches it with global queryIds and writes
  ``<output>.h<rank>of<n>``;
- ``merge_on_rank_zero`` waits for every rank, then rank 0 concatenates
  the part files in rank order, which is the single-process output byte
  for byte (the slices are contiguous and each file is sorted by queryId),
  and removes them.
"""

from __future__ import annotations

import os

import torch.distributed as dist


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the gloo process group: at ``tcp://<coordinator_address>`` with
    ``num_processes`` ranks when that is above 1; with a coordinator and no
    count, by the ``env://`` method (``WORLD_SIZE`` and ``RANK`` from the
    launcher's environment, the coordinator as ``MASTER_ADDR:MASTER_PORT``
    where those are unset).  Does nothing otherwise."""
    if num_processes is not None and num_processes > 1:
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                                rank=process_id)
    elif coordinator_address is not None:
        addr, port = coordinator_address.rsplit(":", 1)
        os.environ.setdefault("MASTER_ADDR", addr)
        os.environ.setdefault("MASTER_PORT", port)
        dist.init_process_group("gloo", init_method="env://")


def _rank_and_count(rank: int | None, n_proc: int | None) -> tuple[int, int]:
    """The given rank and count, else this process's (rank 0 of 1 outside
    a process group)."""
    joined = dist.is_available() and dist.is_initialized()
    if rank is None:
        rank = dist.get_rank() if joined else 0
    if n_proc is None:
        n_proc = dist.get_world_size() if joined else 1
    return rank, n_proc


def host_query_slice(num_queries: int, rank: int | None = None, n_proc: int | None = None) -> tuple[int, int]:
    """[start, end) of the global query list this process searches: blocks
    of ceil(num_queries / n_proc) by rank (default: this process's)."""
    rank, n_proc = _rank_and_count(rank, n_proc)
    per = -(-num_queries // n_proc)
    start = min(rank * per, num_queries)
    return start, min(start + per, num_queries)


def host_output_path(output: str, rank: int | None = None, n_proc: int | None = None) -> str:
    rank, n_proc = _rank_and_count(rank, n_proc)
    return f"{output}.h{rank}of{n_proc}"


def merge_host_outputs(paths: list[str], out_path: str) -> None:
    """Concatenate the part files in the order given (rank order)."""
    with open(out_path, "w") as out:
        for p in paths:
            with open(p) as fh:
                out.write(fh.read())


def merge_on_rank_zero(output: str) -> None:
    """After every rank wrote its part file (on a shared file system), rank
    0 merges them into ``output`` and removes them.  Waits for every rank
    first; a no-op for one process."""
    rank, n = _rank_and_count(None, None)
    if n <= 1:
        return
    dist.barrier()
    if rank == 0:
        parts = [host_output_path(output, rank=r, n_proc=n) for r in range(n)]
        merge_host_outputs(parts, output)
        for p in parts:
            os.remove(p)


def shutdown() -> None:
    """Leave the process group, where this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
