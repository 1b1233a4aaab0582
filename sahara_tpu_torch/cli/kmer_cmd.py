"""`kmer-index` / `kmer-search` subcommands: registered with the flags of
``sahara_tpu``'s, not ported (ROADMAP.md queue 1 item 11)."""

from __future__ import annotations

from sahara_tpu_torch.cli.search_cmd import EXACT_NOT_PORTED


def cmd_not_ported(args):
    raise NotImplementedError(EXACT_NOT_PORTED)


def register(subparsers):
    p = subparsers.add_parser("kmer-index", help="construct an index over a given input file (not ported)")
    p.add_argument("input")
    p.add_argument("--kmer", type=int, default=1, help="splitting the text into kmers")
    p.add_argument("--kmer_mode", choices=["winnowing", "mod"], default="winnowing",
                   help="valid modes are: winnowing and mod")
    p.add_argument("--window", type=int, default=1,
                   help="using windows (only valid for '--kmer_mode winnowing' mode")
    p.add_argument("--mod", type=int, default=4,
                   help="take every 'mod' element (only valid for '--kmer_mode mod' mode")
    p.add_argument("--ignore_unknown", action="store_true")
    p.set_defaults(func=cmd_not_ported)

    p = subparsers.add_parser("kmer-search", help="search for a given pattern (not ported)")
    p.add_argument("--query", required=True, help="path to a query file")
    p.add_argument("--index", required=True, help="path to the index file")
    p.add_argument("--output", default="sahara-output.txt", help="output path")
    p.add_argument("--generator", default="h2-k2")
    p.add_argument("--dynamic_generator", action="store_true")
    p.add_argument("--no-reverse", action="store_true")
    p.add_argument("--search_mode", choices=["all", "besthits"], default="all")
    p.add_argument("--max_hits", type=int, default=0)
    p.set_defaults(func=cmd_not_ported)
