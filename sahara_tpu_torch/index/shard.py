"""Index sharding by text interval, and index-file dispatch by container kind.

The counterpart of ``sahara_tpu/index/shard.py``.  A device index addresses
its text with int32, so a larger reference is split into shards: each shard
is a complete bidirectional index over a subset of the sequences, and a
sequence longer than the shard budget is split into windows that overlap
by more than any hit's span, so every hit lies wholly inside some window.
Queries visit every shard; a shard's hits map back through (global seqId,
window offset), and a hit inside a window overlap is kept once
(``engine/driver.py::search_queries_sharded``).

The container is the one ``sahara_tpu`` writes (``kind`` = ``"sharded"``):
one plain index file per shard nested as npz bytes (``shard{i}``), the
shard's global sequence ids (``gid{i}``) and window offsets (``off{i}``),
``windowed_gids`` and the JSON ``meta``; each package loads the other's.
"""

from __future__ import annotations

import dataclasses
import io
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from sahara_tpu_torch.index.build import build_bifmindex
from sahara_tpu_torch.index.fmindex import BiFMIndex, FastNpz, FMIndex, load_index, read_meta, save_index

SHARD_FORMAT_VERSION = 2

# per-shard text budget: well under 2^31 addressable positions (sentinel
# padding included), large enough that chromosome-scale sequences never split
DEFAULT_MAX_CHARS = 2**31 - 2**27
DEFAULT_WINDOW_OVERLAP = 4096


@dataclasses.dataclass
class ShardedIndex:
    """Complete sub-indexes and the local-to-global sequence maps."""

    shards: list[BiFMIndex]
    seq_gid: list[np.ndarray]  # per shard: global sequence id of each local sequence
    seq_off: list[np.ndarray]  # per shard: text offset of each local window
    num_seqs: int
    windowed_gids: np.ndarray  # global ids of the sequences that were split
    # the shards' seed-and-verify views on the card, uploaded once by the
    # resident regime of search_queries_sharded and kept for later searches
    resident: list | None = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def sigma(self) -> int:
        return self.shards[0].sigma

    @property
    def num_shards(self) -> int:
        return len(self.shards)


def plan_shards(seq_lens: list[int], max_chars: int, overlap: int) -> list[list[tuple[int, int, int]]]:
    """Greedy packing of sequences into shards: per shard a list of
    (global sequence id, window start, window length); a sequence longer
    than ``max_chars`` is split into windows of at most ``max_chars``
    overlapping by ``overlap``."""
    pieces: list[tuple[int, int, int]] = []
    for gid, ln in enumerate(seq_lens):
        if ln <= max_chars:
            pieces.append((gid, 0, ln))
            continue
        start = 0
        while start < ln:
            end = min(start + max_chars, ln)
            pieces.append((gid, start, end - start))
            if end == ln:
                break
            start = end - overlap
    shards: list[list[tuple[int, int, int]]] = [[]]
    used = 0
    for piece in pieces:
        if used and used + piece[2] > max_chars:
            shards.append([])
            used = 0
        shards[-1].append(piece)
        used += piece[2]
    return shards


def build_sharded_bifmindex(
    seqs: list[np.ndarray],
    sigma: int,
    alphabet_name: str,
    rate: int = 16,
    max_chars: int = DEFAULT_MAX_CHARS,
    overlap: int = DEFAULT_WINDOW_OVERLAP,
    threads: int = 1,
) -> BiFMIndex | ShardedIndex:
    """One bidirectional index when every sequence fits one shard unsplit,
    else a ``ShardedIndex``.  ``threads`` >= 2 builds shards on a thread
    pool (SA-IS releases the GIL); with more threads than shards each shard
    also overlaps its two suffix sorts."""
    plan = plan_shards([len(s) for s in seqs], max_chars, overlap)
    if len(plan) == 1 and all(w == 0 for _, w, _ in plan[0]):
        return build_bifmindex(seqs, sigma, alphabet_name, rate=rate, threads=threads)
    windowed = sorted({gid for shard in plan for gid, w, _ in shard if w > 0})

    def one(shard) -> BiFMIndex:
        sub = [np.asarray(seqs[gid][w : w + ln], dtype=np.uint8) for gid, w, ln in shard]
        return build_bifmindex(sub, sigma, alphabet_name, rate=rate, threads=2 if threads > len(plan) else 1)

    if threads >= 2 and len(plan) > 1:
        workers = min(len(plan), threads if threads <= len(plan) else (threads + 1) // 2)
        with ThreadPoolExecutor(workers) as ex:
            shards = list(ex.map(one, plan))
    else:
        shards = [one(shard) for shard in plan]
    return ShardedIndex(
        shards=shards,
        seq_gid=[np.array([gid for gid, _, _ in shard], dtype=np.int64) for shard in plan],
        seq_off=[np.array([w for _, w, _ in shard], dtype=np.int64) for shard in plan],
        num_seqs=len(seqs),
        windowed_gids=np.array(windowed, dtype=np.int64),
    )


def save_sharded(path, sh: ShardedIndex) -> None:
    arrays: dict[str, np.ndarray] = {}
    for i, shard in enumerate(sh.shards):
        buf = io.BytesIO()
        save_index(buf, shard)
        arrays[f"shard{i}"] = np.frombuffer(buf.getvalue(), dtype=np.uint8)
        arrays[f"gid{i}"] = sh.seq_gid[i]
        arrays[f"off{i}"] = sh.seq_off[i]
    meta = {
        "format_version": SHARD_FORMAT_VERSION,
        "kind": "sharded",
        "sigma": sh.sigma,
        "num_shards": sh.num_shards,
        "num_seqs": sh.num_seqs,
    }
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    arrays["windowed_gids"] = sh.windowed_gids
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)


def peek_index_kind(path) -> str:
    """An index file's container kind ('bi', 'uni' or 'sharded'), from its
    metadata member alone."""
    return read_meta(path).get("kind", "plain")


def load_any_index(path) -> FMIndex | ShardedIndex:
    """Load a plain index file or a sharded container."""
    with FastNpz(path) as data:
        meta = json.loads(bytes(data["meta"]).decode())
        if meta.get("kind") == "sharded":
            if meta["format_version"] != SHARD_FORMAT_VERSION:
                raise ValueError(f"unknown file format version for sharded index: {meta['format_version']}")
            n = meta["num_shards"]
            return ShardedIndex(
                shards=[load_index(io.BytesIO(bytes(data[f"shard{i}"]))) for i in range(n)],
                seq_gid=[data[f"gid{i}"] for i in range(n)],
                seq_off=[data[f"off{i}"] for i in range(n)],
                num_seqs=meta["num_seqs"],
                windowed_gids=data["windowed_gids"],
            )
    return load_index(path)
