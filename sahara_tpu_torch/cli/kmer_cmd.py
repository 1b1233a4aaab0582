"""`kmer-index` / `kmer-search` subcommands.

The counterpart of ``sahara_tpu/cli/kmer_cmd.py``: the reference is
sketched into kmer space (winnowing minimizers or mod-mers), its sketch
values get dense ids in first-appearance order, and an FM-index is built
over the dense alphabet.  Queries are kmerized with the index's stored
config and dropped when any kmer is unseen or fewer than 6 survive; the
rest (and their reversed kmer strings) are searched exactly in kmer space,
on the card unless ``--device cpu``."""

from __future__ import annotations

import os

import numpy as np

from sahara_tpu_torch.adaptive_kmer_index import AdaptiveKmerIndex, KmerConfig
from sahara_tpu_torch.alphabet import D_DNA5
from sahara_tpu_torch.cli.common import load_reference_ranked, write_hits
from sahara_tpu_torch.engine.device import resolve_device
from sahara_tpu_torch.io.fasta import read_fasta
from sahara_tpu_torch.kmer import kmerize
from sahara_tpu_torch.utils.errors import SaharaError
from sahara_tpu_torch.utils.stopwatch import Timings


def dense_ids(values: list[np.ndarray]) -> tuple[dict[int, int], list[np.ndarray]]:
    """Dense ids 1, 2, ... of sketch values in order of first appearance
    across the sequences: the map (in that order) and each sequence's ids."""
    flat = np.concatenate(values) if values else np.zeros(0, dtype=np.uint64)
    keys, first, inverse = np.unique(flat, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    ids = np.empty(len(keys), dtype=np.int64)
    ids[order] = np.arange(1, len(keys) + 1)
    dense = np.split(ids[inverse.reshape(-1)], np.cumsum([len(v) for v in values])[:-1]) if values else []
    return dict(zip(keys[order].tolist(), range(1, len(keys) + 1))), dense


def cmd_kmer_index(args):
    print(f"constructing an index for {args.input}")
    timing = Timings()

    seqs = load_reference_ranked(args.input, D_DNA5, ignore_unknown=args.ignore_unknown, unknown_policy="N")
    values = [kmerize(r, mode=args.kmer_mode, k=args.kmer, window=args.window, mod_exp=args.mod) for r in seqs]
    uniq, ref_kmer = dense_ids(values)

    print("config:")
    print(f"  file:            {args.input}")
    print(f"  references:      {len(ref_kmer):>10}")
    print(f"  totalSize:       {sum(len(r) for r in seqs):>10}")
    if args.kmer_mode == "winnowing":
        print(f"  kmerMode:        {'winnowing':>10}")
        print(f"  windowSize       {args.window:>10}")
    else:
        print(f"  kmerMode:        {'mod':>10}")
        print(f"  modFactor        {f'2^{args.mod}':>10}")
    print(f"  different kmers: {len(uniq):>10}")
    print(f"  kmer-seq-len:    {sum(len(d) for d in ref_kmer):>10}")
    timing.mark("ld queries")

    config = KmerConfig(mode=args.kmer_mode, kmer_len=args.kmer, window=args.window, mod_exp=args.mod,
                        largest_value=len(uniq))
    index = AdaptiveKmerIndex(config, kmer_seqs=ref_kmer)
    timing.mark("index creation")

    index.save(str(args.input) + ".kmer.idx", uniq)
    timing.mark("saving to disk")
    timing.print_stats()


def cmd_kmer_search(args):
    dev = resolve_device(args.device)
    timing = Timings()

    print("config:")
    print(f"  query:               {args.query}")
    print(f"  index:               {args.index}")
    print(f"  generator:           {args.generator}")
    print(f"  dynamic expansion:   {args.dynamic_generator}")
    print(f"  reverse complements: {not args.no_reverse}")
    print(f"  search mode:         {args.search_mode}")
    print(f"  max hits:            {args.max_hits}")
    print(f"  output path:         {args.output}")

    if not os.path.exists(args.index):
        raise SaharaError(f"no valid index path at {args.index}")
    index, uniq = AdaptiveKmerIndex.load(args.index)
    config = index.config
    print(f"  kmer mode:           {config.mode}")
    if config.mode == "winnowing":
        print(f"  window:           {config.window}")
    else:
        print(f"  kmer mod:            {config.mod_exp}")
    timing.mark("ld index")

    keys = np.fromiter(uniq.keys(), dtype=np.uint64, count=len(uniq))
    order = np.argsort(keys)
    keys, vals = keys[order], np.fromiter(uniq.values(), dtype=np.int64, count=len(uniq))[order]
    queries: list[np.ndarray] = []
    skipped = 0
    kmer_total = 0
    smallest, longest = None, 0
    for record in read_fasta(args.query):
        ranks = D_DNA5.char_to_rank(record.seq)
        if (pos := D_DNA5.verify_rank(ranks)) is not None:
            raise SaharaError(f"query '{record.id}' has invalid character at position {pos}")
        values = kmerize(ranks, mode=config.mode, k=config.kmer_len, window=config.window, mod_exp=config.mod_exp)
        at = np.minimum(np.searchsorted(keys, values), max(len(keys) - 1, 0))
        if len(values) and (not len(keys) or (keys[at] != values).any()):
            continue  # an unseen kmer drops the query (not counted as skipped)
        if len(values) >= 6:
            arr = vals[at]
            kmer_total += len(arr)
            smallest = len(arr) if smallest is None else min(smallest, len(arr))
            longest = max(longest, len(arr))
            queries.append(arr)
            if not args.no_reverse:
                queries.append(arr[::-1].copy())
        else:
            skipped += 1 + (0 if args.no_reverse else 1)

    print(f"skipped {skipped} of {skipped + len(queries)} queries")
    if queries:
        print(f"avg kmer len: {kmer_total * 1.0 / len(queries)}")
        print(f"smallest/longest kmer len: {smallest}/{longest}")
    print(f"index uniq {len(uniq)}")
    if not queries:
        raise SaharaError(f"query file {args.query} was empty - abort")
    fwd = len(queries) // (1 if args.no_reverse else 2)
    print(f"fwd queries: {fwd}")
    print(f"bwd queries: {len(queries) - fwd}")
    timing.mark("ld queries")

    rows = index.search_rows(queries, device=dev)
    timing.mark("search")

    n = write_hits(args.output, rows)
    timing.mark("result")
    timing.print_stats(n_queries=len(queries), n_hits=n)


def register(subparsers):
    p = subparsers.add_parser("kmer-index", help="construct an index over a given input file")
    p.add_argument("input")
    p.add_argument("--kmer", type=int, default=1, help="splitting the text into kmers")
    p.add_argument("--kmer_mode", choices=["winnowing", "mod"], default="winnowing",
                   help="valid modes are: winnowing and mod")
    p.add_argument("--window", type=int, default=1,
                   help="using windows (only valid for '--kmer_mode winnowing' mode")
    p.add_argument("--mod", type=int, default=4,
                   help="take every 'mod' element (only valid for '--kmer_mode mod' mode")
    p.add_argument("--ignore_unknown", action="store_true")
    p.set_defaults(func=cmd_kmer_index)

    p = subparsers.add_parser("kmer-search", help="search for a given pattern")
    p.add_argument("--query", required=True, help="path to a query file")
    p.add_argument("--index", required=True, help="path to the index file")
    p.add_argument("--output", default="sahara-output.txt", help="output path")
    p.add_argument("--generator", default="h2-k2")
    p.add_argument("--dynamic_generator", action="store_true")
    p.add_argument("--no-reverse", action="store_true")
    p.add_argument("--search_mode", choices=["all", "besthits"], default="all")
    p.add_argument("--max_hits", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the index is uploaded and searched: the CUDA card (default) or the CPU")
    p.set_defaults(func=cmd_kmer_search)
