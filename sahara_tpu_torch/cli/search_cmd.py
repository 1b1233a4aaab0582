"""`search` / `uni-search` / `rbi-search` / `rbi-search-dna4` subcommands:
flag surface, config echo, search on the card, ``queryId seqId pos``
output, stats block.

The counterpart of ``sahara_tpu/cli/search_cmd.py``.  ``--device``
(default ``cuda``) is where the index is uploaded and searched; without a
card the search commands raise unless ``--device cpu`` is given.
``--devices N`` searches over a data mesh of N devices (``parallel/``): N
cards, or N entries of the CPU under ``--device cpu``.  ``search`` with
``--mh_num_processes`` above 1 is one rank of a multi-host run
(``parallel/multihost.py``).  ``search`` on an interval-sharded index runs
``search_queries_sharded``.  ``uni-search`` is exact search and locate on a
unidirectional index (K6, and K7 where the index has no full suffix
array)."""

from __future__ import annotations

import itertools
import os
import queue as queue_mod
import threading

import numpy as np
import torch

from sahara_tpu_torch.alphabet import D_DNA5, DR_DNA4, DR_DNA5, INVALID_RANK, by_sigma
from sahara_tpu_torch.cli.common import format_hit_block, load_queries_ranked, write_hits
from sahara_tpu_torch.engine.device import DeviceIndex, pad_queries, resolve_device
from sahara_tpu_torch.engine.driver import SearchResult, _merge_results, search_queries, search_queries_sharded
from sahara_tpu_torch.engine.exact import exact_search
from sahara_tpu_torch.engine.locate import locate
from sahara_tpu_torch.index.fmindex import load_index, peek_sigma
from sahara_tpu_torch.index.shard import ShardedIndex, load_any_index, peek_index_kind
from sahara_tpu_torch.io.fasta import NotSimpleFasta, iter_fasta_seq_matrix_blocks, read_fasta
from sahara_tpu_torch.parallel import multihost
from sahara_tpu_torch.parallel.mesh import data_mesh, replicate_index
from sahara_tpu_torch.utils.errors import SaharaError
from sahara_tpu_torch.utils.stopwatch import Timings

STREAM_MIN_BYTES = 128 << 20  # read files from this size stream by default


def _local_mesh(n_req: int, dev: torch.device, multihost: bool = False):
    """A data mesh over this process's devices, or None for one device.

    ``n_req`` 0 takes every visible card under ``--device cuda`` and one
    device under ``--device cpu``; under ``--mh_*`` a mesh is opt-in (0
    means one device).  Under ``--device cpu`` a mesh of N holds the CPU N
    times."""
    if n_req == 0:
        n_use = 1 if multihost or dev.type == "cpu" else torch.cuda.device_count()
    else:
        n_use = n_req
    if n_use <= 1:
        return None
    if dev.type == "cpu":
        return data_mesh(devices=[dev] * n_use)
    if torch.cuda.device_count() < n_use:
        raise SaharaError(f"--devices {n_use} requested but only {torch.cuda.device_count()} local devices")
    return data_mesh(n_use)


def _upload(host, dev: torch.device, mesh):
    """The index on ``dev``, or replicated over ``mesh`` (echoed)."""
    if mesh is None:
        return DeviceIndex.from_host(host, device=dev)
    print(f"devices:             {mesh.size}")
    return replicate_index(host, mesh)


def _check_index_path(path) -> None:
    if not os.path.exists(path):
        raise SaharaError(f"no valid index path at {path}")


def _print_config(args, *, reverse: bool) -> None:
    print("config:")
    print(f"  query:               {args.query}")
    print(f"  index:               {args.index}")
    print(f"  generator:           {args.generator}")
    print(f"  dynamic expansion:   {args.dynamic_generator}")
    print(f"  allowed errors:      {args.errors}")
    if reverse:
        print(f"  reverse complements: {not args.no_reverse}")
    print(f"  search mode:         {args.search_mode}")
    print(f"  max hits:            {args.max_hits}")
    print(f"  output path:         {args.output}")


def _search_kw(args, dev, *, edit: bool, mesh=None) -> dict:
    return dict(
        k=args.errors, generator_name=args.generator, edit=edit, mode=args.search_mode,
        max_hits=args.max_hits, dynamic=args.dynamic_generator, engine=args.engine, device=dev, mesh=mesh,
    )


def _put(q: queue_mod.Queue, item, alive) -> bool:
    """Put ``item`` on a bounded queue unless ``alive()`` turns false while
    the queue is full; returns whether it was put."""
    while alive():
        try:
            q.put(item, timeout=0.05)
            return True
        except queue_mod.Full:
            continue
    return False


def _try_stream_search(args, alphabet, dev) -> bool:
    """Large-file path: stream FASTA blocks through the search, with the
    parse (reader thread) and the hit formatting and writing (writer
    thread) overlapping the device search, hits appended per block.

    Correct because blocks arrive in ascending queryId order and every
    per-query contract (canonical sort, dedup, besthits, max_hits) is
    local to a query: the concatenated per-block outputs are the global
    output.

    Engages only for simple uniform 2-line FASTA files of 128 MB or more
    (``SAHARA_STREAM=1`` / ``0`` forces it on / off), a plain index and one
    process.
    Returns False to fall back to the buffered path, which re-reads the
    file: on a file that is not simple, at its start or further in.  An
    exception in either thread is raised here."""
    force = os.environ.get("SAHARA_STREAM", "")
    if force == "0" or args.mh_num_processes > 1:
        return False
    try:
        fsize = os.path.getsize(args.query)
    except OSError:
        return False
    if force != "1" and fsize < STREAM_MIN_BYTES:
        return False
    if peek_index_kind(args.index) == "sharded":
        return False  # the sharded driver has its own resident regime
    gen = iter_fasta_seq_matrix_blocks(args.query)
    try:
        first_mat = next(gen)
    except (NotSimpleFasta, StopIteration):
        return False

    timing = Timings()
    timing.mark("ld queries")
    _print_config(args, reverse=True)
    print("  streaming:           True")

    mesh = _local_mesh(args.devices, dev)
    index = _upload(load_index(args.index), dev, mesh)
    timing.mark("ld index")

    add_rc = not args.no_reverse
    per_read = 2 if add_rc else 1
    limit = args.limit_queries or 0
    stop = threading.Event()
    blocks: queue_mod.Queue = queue_mod.Queue(maxsize=2)
    lines: queue_mod.Queue = queue_mod.Queue(maxsize=4)
    wr_err: list[BaseException] = []

    def rank_block(mat):
        ranks = alphabet.char_to_rank_table[mat]
        bad_r, bad_c = np.nonzero(ranks == INVALID_RANK)
        if len(bad_r):
            i, pos = int(bad_r[0]), int(bad_c[0])
            ch = int(mat[i, pos])
            raise SaharaError(f"query has invalid character at position {pos} '{chr(ch)}'({ch:x})")
        if not add_rc:
            return ranks
        out = np.empty((2 * len(ranks), ranks.shape[1]), dtype=np.uint8)
        out[0::2] = ranks
        out[1::2] = alphabet.complement[ranks[:, ::-1]]
        return out

    def running() -> bool:
        return not stop.is_set()

    def reader():
        base = 0
        try:
            for mat in itertools.chain([first_mat], gen):
                if stop.is_set() or (limit and base >= limit):
                    break
                b = rank_block(mat)
                if not _put(blocks, (base, b), running):
                    return
                base += len(b)
            _put(blocks, None, running)
        except Exception as e:  # raised on the main thread
            _put(blocks, e, running)

    def writer():
        try:
            with open(args.output, "w") as fh:
                while (item := lines.get()) is not None:
                    fh.write(item)
        except Exception as e:  # raised on the main thread
            wr_err.append(e)

    def writer_alive() -> bool:
        if wr_err:
            raise wr_err[0]
        return wt.is_alive()

    rt = threading.Thread(target=reader, daemon=True)
    wt = threading.Thread(target=writer, daemon=True)
    rt.start()
    wt.start()

    kw = _search_kw(args, dev, edit=args.distance_metric == "lev", mesh=mesh)
    n_queries = n_hits = 0
    try:
        while True:
            item = blocks.get()
            if item is None:
                break
            if isinstance(item, NotSimpleFasta):
                return False  # a shape violation further in: re-run buffered
            if isinstance(item, BaseException):
                raise item
            base, block = item
            if limit and base + len(block) > limit:
                block = block[: limit - base]
            if len(block):
                res = search_queries(index, block, query_ids=np.arange(base, base + len(block), dtype=np.int64), **kw)
                n_queries += len(block)
                n_hits += len(res.query_id)
                _put(lines, format_hit_block(res.query_id, res.seq_id, res.pos), writer_alive)
            if limit and base + len(block) >= limit:
                break
    finally:
        stop.set()
        _put(lines, None, wt.is_alive)
        wt.join()
        rt.join()
    if wr_err:
        raise wr_err[0]
    fwd = n_queries // per_read
    print(f"fwd queries: {fwd}")
    print(f"bwd queries: {n_queries - fwd}")
    timing.mark("search")
    timing.mark("locate")
    timing.mark("result")
    timing.print_stats(n_queries=n_queries, n_hits=n_hits)
    return True


def cmd_search(args):
    dev = resolve_device(args.device)
    _check_index_path(args.index)
    alphabet = by_sigma(peek_sigma(args.index))
    if _try_stream_search(args, alphabet, dev):
        return
    # a multi-host rank searches its contiguous slice of the global strand
    # queries under their global ids, writes its part file, and rank 0
    # merges the parts
    multihost_run = args.mh_num_processes > 1
    if multihost_run:
        multihost.initialize(args.mh_coordinator, args.mh_num_processes, args.mh_process_id)
    try:
        _search(args, alphabet, dev, multihost_run)
    finally:
        multihost.shutdown()


def _search(args, alphabet, dev, multihost_run: bool):
    timing = Timings()
    queries = load_queries_ranked(args.query, alphabet, add_revcomp=not args.no_reverse)
    if args.limit_queries:
        queries = queries[: args.limit_queries]
    if not queries:
        raise SaharaError(f"query file {args.query} was empty - abort")
    query_ids, output_path = None, args.output
    if multihost_run:
        start, end = multihost.host_query_slice(len(queries))
        queries = queries[start:end]
        query_ids = np.arange(start, end, dtype=np.int64)
        output_path = multihost.host_output_path(args.output)
    timing.mark("ld queries")

    _print_config(args, reverse=True)
    fwd = len(queries) // (1 if args.no_reverse else 2)
    print(f"fwd queries: {fwd}")
    print(f"bwd queries: {len(queries) - fwd}")

    host = load_any_index(args.index)
    kw = _search_kw(args, dev, edit=args.distance_metric == "lev")
    if isinstance(host, ShardedIndex):
        timing.mark("ld index")
        result = search_queries_sharded(host, queries, query_ids=query_ids, verbose_cb=print, **kw)
    else:
        kw["mesh"] = _local_mesh(args.devices, dev, multihost=multihost_run)
        index = _upload(host, dev, kw["mesh"])
        timing.mark("ld index")
        result = search_queries(index, queries, query_ids=query_ids, verbose_cb=print, **kw)
    timing.mark("search")
    timing.mark("locate")

    n = write_hits(output_path, (result.query_id, result.seq_id, result.pos))
    if multihost_run:
        multihost.merge_on_rank_zero(args.output)
    timing.mark("result")
    timing.print_stats(n_queries=len(queries), n_hits=n)


def cmd_uni_search(args):
    dev = resolve_device(args.device)
    timing = Timings()
    queries = load_queries_ranked(args.query, D_DNA5, add_revcomp=not args.no_reverse)
    if not queries:
        raise SaharaError(f"query file {args.query} was empty - abort")
    timing.mark("ld queries")

    print("config:")
    print(f"  query:               {args.query}")
    print(f"  index:               {args.index}")
    print(f"  reverse complements: {not args.no_reverse}")
    print(f"  output path:         {args.output}")
    fwd = len(queries) // (1 if args.no_reverse else 2)
    print(f"fwd queries: {fwd}")
    print(f"bwd queries: {len(queries) - fwd}")

    _check_index_path(args.index)
    index = DeviceIndex.from_host(load_index(args.index), device=dev)
    timing.mark("ld index")

    lb, ln = exact_search(index, *pad_queries(queries))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    timing.mark("search")

    # rows come out by query, each query's in SA order
    src, seq_id, pos = (t.cpu().numpy() for t in locate(index, lb, ln))
    timing.mark("locate")

    n = write_hits(args.output, (src, seq_id, pos))
    timing.mark("result")
    timing.print_stats(n_queries=len(queries), n_hits=n)


def _rbi_search(args, alphabet, unknown_random_ranks: bool):
    dev = resolve_device(args.device)
    timing = Timings()
    # rbi queries are not revcomp-expanded: the dr alphabet is
    # strand-symmetric and the index carries the mirror text
    if unknown_random_ranks:
        # unknown chars become random rank 1 or 2, drawn in record order
        rng = np.random.default_rng(0)
        queries = []
        for record in read_fasta(args.query):
            ranks = alphabet.char_to_rank(record.seq)
            bad = ranks == INVALID_RANK
            if bad.any():
                ranks = ranks.copy()
                ranks[bad] = rng.integers(1, 3, size=int(bad.sum()))
            queries.append(ranks)
    else:
        queries = load_queries_ranked(args.query, alphabet, add_revcomp=False)
    if not queries:
        raise SaharaError(f"query file {args.query} was empty - abort")
    timing.mark("ld queries")

    _print_config(args, reverse=False)
    print(f"fwd queries: {len(queries)}")

    _check_index_path(args.index)
    host = load_any_index(args.index)
    if isinstance(host, ShardedIndex):
        raise SaharaError(f"{args.index} is a sharded index; rbi search takes a plain one")
    mesh = _local_mesh(args.devices, dev)
    index = _upload(host, dev, mesh)
    timing.mark("ld index")

    # rbi search is always edit distance
    result = search_queries(index, queries, verbose_cb=print, **_search_kw(args, dev, edit=True, mesh=mesh))
    timing.mark("search")
    timing.mark("locate")
    if args.orig_coords:
        # mirror copies have seqIds [m, 2m) and reversed coordinates: a
        # mirror hit at reversed position p touches original position
        # L - 1 - p, the original-strand base aligned to the query's first
        # character (forward hits already start there)
        n_orig = len(host.seq_lens) // 2
        sid = result.seq_id.copy()
        pos = result.pos.copy()
        mirror = sid >= n_orig
        lens = np.asarray(host.seq_lens, dtype=np.int64)
        pos[mirror] = lens[sid[mirror]] - 1 - pos[mirror]
        sid[mirror] -= n_orig
        result = _merge_results([SearchResult(result.query_id, sid, pos, result.errors)])
    n = write_hits(args.output, (result.query_id, result.seq_id, result.pos))
    timing.mark("result")
    timing.print_stats(n_queries=len(queries), n_hits=n)


def cmd_rbi_search(args):
    _rbi_search(args, DR_DNA5, unknown_random_ranks=False)


def cmd_rbi_search_dna4(args):
    _rbi_search(args, DR_DNA4, unknown_random_ranks=True)


def _add_search_flags(p, *, metric: bool, reverse: bool, limit: bool):
    p.add_argument("-q", "--query", required=True, help="path to a query file")
    p.add_argument("-i", "--index", required=True, help="path to the index file")
    p.add_argument("-o", "--output", default="sahara-output.txt", help="output path")
    p.add_argument("-g", "--generator", default="h2-k2", help="picking optimum search scheme generator")
    p.add_argument("--dynamic_generator", action="store_true",
                   help="should generator run expand search scheme with dynamic extension")
    p.add_argument("-e", "--errors", type=int, default=0,
                   help="number of allowed errors (number of allowed differences insert/substitute and deletions)")
    if reverse:
        p.add_argument("--no-reverse", action="store_true", help="do not search for reversed complements")
    p.add_argument("-m", "--search_mode", choices=["all", "besthits"], default="all",
                   help="search mode, all (default) or besthits")
    if metric:
        p.add_argument("-d", "--distance-metric", dest="distance_metric", choices=["ham", "lev"],
                       default="lev",
                       help="which distance metric to use. ham: hamming or lev: levenshtein(edit) distance")
    p.add_argument("--max_hits", type=int, default=0, help="maximum number of hits per query")
    if limit:
        p.add_argument("--limit_queries", type=int, default=0, help="only run the given number of queries")
    p.add_argument("--engine", choices=["auto", "sv", "workq", "approx"], default="auto",
                   help="search engine: auto (seed-verify when eligible, else workq), "
                        "sv (seed-and-verify), workq (work-queue scheme engine), "
                        "approx (per-lane frontier scheme engine)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the index is uploaded and searched: the CUDA card (default) or the CPU")
    p.add_argument("--devices", type=int, default=0,
                   help="devices for data-parallel search: 0 means every visible card (one under --device cpu, "
                        "and one under --mh_*), N a mesh of N cards, or of the CPU N times under --device cpu")
    p.add_argument("--mh_coordinator", default=None, help="multi-host coordinator address (host:port)")
    p.add_argument("--mh_num_processes", type=int, default=0, help="number of distributed processes")
    p.add_argument("--mh_process_id", type=int, default=0, help="this process's rank")


def _add_orig_coords_flag(p):
    p.add_argument(
        "--orig_coords", action="store_true",
        help="map mirror hits (seqId in [m, 2m)) back to original-sequence "
             "coordinates: seqId -= m, pos = seqLen - 1 - pos (the "
             "original-strand base aligned to the query's first character; "
             "forward hits already report that base as their start)",
    )


def register(subparsers):
    p = subparsers.add_parser("search", help="search for a given pattern")
    _add_search_flags(p, metric=True, reverse=True, limit=True)
    p.set_defaults(func=cmd_search)

    p = subparsers.add_parser("uni-search", help="search for a given pattern")
    p.add_argument("-q", "--query", required=True)
    p.add_argument("-i", "--index", required=True)
    p.add_argument("-o", "--output", default="sahara-output.txt")
    p.add_argument("--no-reverse", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the index is uploaded and searched: the CUDA card (default) or the CPU")
    p.set_defaults(func=cmd_uni_search)

    p = subparsers.add_parser("rbi-search", help="search for a given pattern")
    _add_search_flags(p, metric=False, reverse=False, limit=False)
    _add_orig_coords_flag(p)
    p.set_defaults(func=cmd_rbi_search)

    p = subparsers.add_parser("rbi-search-dna4", help="search for a given pattern")
    _add_search_flags(p, metric=False, reverse=False, limit=False)
    _add_orig_coords_flag(p)
    p.set_defaults(func=cmd_rbi_search_dna4)
