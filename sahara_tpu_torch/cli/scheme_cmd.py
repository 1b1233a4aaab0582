"""`search_scheme` subcommand: offline search-scheme analysis and export
(single-scheme info, the all-generator table, YAML, Columba searches.txt
files, TikZ diagrams).  A copy of ``sahara_tpu/cli/scheme_cmd.py``."""

from __future__ import annotations

import os

from sahara_tpu_torch.schemes import (
    GENERATORS,
    expand,
    expand_count,
    get_generator,
    is_complete,
    is_non_redundant,
    is_valid,
    limit_to_hamming,
)
from sahara_tpu_torch.schemes.costs import (
    expand_by_wnc,
    expand_by_wnc_topdown,
    node_count,
    optimize_by_wnc,
    optimize_by_wnc_topdown,
    weighted_node_count,
)
from sahara_tpu_torch.tikz import generate_tikz
from sahara_tpu_torch.utils.errors import SaharaError

# canonical generator print order
ORDER = [
    "backtracking", "optimum", "01*0", "01*0_opt", "pigeon", "pigeon_opt",
    "suffix", "h2-k1", "h2-k2", "h2-k3", "kianfar", "kucherov-k1",
    "kucherov-k2", "lam", "hato", "pex-td", "pex-td-l", "pex-bu", "pex-bu-l",
]


def _generate_counts(ss, args):
    if not ss:
        return []
    parts = ss[0].parts
    if args.expansion_mode == "uniform":
        return expand_count(parts, args.length)
    if args.expansion_mode == "bottomup":
        return optimize_by_wnc(ss, args.length, args.sigma, args.ref_length)
    if args.expansion_mode == "topdown":
        return optimize_by_wnc_topdown(ss, args.length, args.sigma, args.ref_length)
    raise SaharaError("invalid parameter for expansion mode")


def _fmt_search(s):
    return (
        "{" + ", ".join(map(str, s.pi)) + "}, "
        "{" + ", ".join(map(str, s.l)) + "}, "
        "{" + ", ".join(map(str, s.u)) + "}"
    )


def print_single_scheme(args):
    entry = get_generator(args.generator)
    sss = entry.generator(args.min_error, args.max_error, args.sigma, args.ref_length)
    ss = expand(sss, args.length)
    dss = expand_by_wnc(sss, args.length, args.sigma, args.ref_length, edit=True)
    parts = sss[0].parts if sss else 0

    print("# Search Scheme Information")
    print(f"name:                       {entry.name}")
    print(f"description:                {entry.description}")
    print(f"alphabet size:              {args.sigma}")
    print(f"min errors:                 {args.min_error}")
    print(f"max errors:                 {args.max_error}")
    print(f"reference length:           {args.ref_length}")
    print(f"number of parts:            {parts}")
    print(f"number of searches:         {len(ss)}")
    print(f"valid:                      {is_valid(sss)}")
    print(f"complete:                   {is_complete(sss, args.min_error, args.max_error)}")
    print(f"non-redundant:              {is_non_redundant(sss, args.min_error, args.max_error)}")
    print(f"node count (ham):           {node_count(ss, args.sigma, edit=False)}")
    print(f"weighted node count (ham):  {weighted_node_count(ss, args.sigma, args.ref_length, edit=False)}")
    print(f"dynamic wnc (ham):          {weighted_node_count(dss, args.sigma, args.ref_length, edit=False)}")
    print(f"node count (edit):          {node_count(ss, args.sigma, edit=True)}")
    print(f"weighted node count (edit): {weighted_node_count(ss, args.sigma, args.ref_length, edit=True)}")
    print(f"dynamic wnc (edit):         {weighted_node_count(dss, args.sigma, args.ref_length, edit=True)}")

    print(f"searches:  {'pi':^{parts * 3}}  {'L':^{parts * 3}}  {'U':^{parts * 3}}")
    for s in sss:
        print(f"           {_fmt_search(s)}")
    print("expanded:")
    for s in ss:
        print(f"           {_fmt_search(s)}")
    print("limited for hamming distance:")
    for s in limit_to_hamming(ss):
        print(f"           {_fmt_search(s)}")


def print_table(args):
    print("# Search Scheme Information")
    print(f"alphabet size:       {args.sigma}")
    print(f"min errors:          {args.min_error}")
    print(f"max errors:          {args.max_error}")
    print(f"reference length:    {args.ref_length}")
    print(
        f"{'name':^15} | {'parts':^6} {'searches':^8} {'valid':^6} {'complete':^8} "
        f"{'non-red':^10} | {'node count ham/edit':^32} | {'weighted nnc ham/edit':^25} | "
        f"{'dyn exp (bu)':^25} | {'dyn exp (td)':^25}"
    )
    for name in ORDER:
        if name not in GENERATORS:
            print(f"Warning: generator {name} doesn't exists")
            continue
        e = GENERATORS[name]
        sss = e.generator(args.min_error, args.max_error, args.sigma, args.ref_length)
        counts = _generate_counts(sss, args)
        ss = expand(sss, counts)
        dss_ham = expand_by_wnc(sss, args.length, args.sigma, args.ref_length, edit=False)
        dss_edit = expand_by_wnc(sss, args.length, args.sigma, args.ref_length, edit=True)
        tds_ham = expand_by_wnc_topdown(sss, args.length, args.sigma, args.ref_length, edit=False)
        tds_edit = expand_by_wnc_topdown(sss, args.length, args.sigma, args.ref_length, edit=True)
        parts = sss[0].parts if sss else 0
        valid = is_valid(sss)
        complete = is_complete(sss, args.min_error, args.max_error)
        nonred = is_non_redundant(sss, args.min_error, args.max_error)
        print(
            f"{e.name:>15} | {parts:>6} {len(sss):>8} {str(valid):^6} {str(complete):^8} {str(nonred):^10} | "
            f"{node_count(ss, args.sigma, edit=False):>15.0f} {node_count(ss, args.sigma, edit=True):>15.0f}  | "
            f"{weighted_node_count(ss, args.sigma, args.ref_length, edit=False):>12.2f} "
            f"{weighted_node_count(ss, args.sigma, args.ref_length, edit=True):>12.2f} | "
            f"{weighted_node_count(dss_ham, args.sigma, args.ref_length, edit=False):>12.2f} "
            f"{weighted_node_count(dss_edit, args.sigma, args.ref_length, edit=True):>12.2f} | "
            f"{weighted_node_count(tds_ham, args.sigma, args.ref_length, edit=False):>12.2f} "
            f"{weighted_node_count(tds_edit, args.sigma, args.ref_length, edit=True):>12.2f}"
        )


def print_columba(args):
    os.makedirs(args.columba, exist_ok=True)
    for name, e in GENERATORS.items():
        safe = name.replace("*", "_star_")
        gdir = os.path.join(args.columba, safe)
        os.makedirs(gdir, exist_ok=True)
        with open(os.path.join(gdir, "name.txt"), "w") as fh:
            fh.write(name)
        for k in range(args.min_error, args.max_error + 1):
            sss = e.generator(args.min_error, k, args.sigma, args.ref_length)
            if not sss:
                continue
            kdir = os.path.join(gdir, str(k))
            os.makedirs(kdir, exist_ok=True)
            with open(os.path.join(kdir, "searches.txt"), "w") as fh:
                for s in sss:
                    fh.write(
                        "{" + ",".join(map(str, s.pi)) + "} "
                        "{" + ",".join(map(str, s.l)) + "} "
                        "{" + ",".join(map(str, s.u)) + "}\n"
                    )


def print_yaml(args):
    print("# Search Scheme Information")
    print(f"alphabet size:       {args.sigma}")
    print(f"min errors:          {args.min_error}")
    print(f"max errors:          {args.max_error}")
    print(f"reference length:    {args.ref_length}")
    print("---")
    for k in range(args.min_error, args.max_error + 1):
        for name, e in GENERATORS.items():
            sss = e.generator(args.min_error, k, args.sigma, args.ref_length)
            counts = _generate_counts(sss, args)
            ss = expand(sss, counts)
            parts = sss[0].parts if sss else 0
            print(f'- name: "{e.name}"')
            print(f"  parts: {parts}")
            print(f"  counts: [{', '.join(map(str, counts))}]")
            print(f"  searchCt: {len(ss)}")
            print(f"  valid: {is_valid(sss)}")
            print(f"  complete: {is_complete(sss, args.min_error, k)}")
            print(f"  nodeCount: {node_count(ss, args.sigma, edit=False)}")
            print(f"  weightedNodeCount: {weighted_node_count(ss, args.sigma, args.ref_length, edit=False):.2f}")
            print("  searches:")
            for s in sss:
                print(f"  - pi: [{', '.join(map(str, s.pi))}]")
                print(f"    l: [{', '.join(map(str, s.l))}]")
                print(f"    u: [{', '.join(map(str, s.u))}]")


def print_tikz(args):
    entry = get_generator(args.generator)
    sss = entry.generator(args.min_error, args.max_error, args.sigma, args.ref_length)
    counts = _generate_counts(sss, args)
    for i, s in enumerate(sss):
        filename = f"{args.tikz}-{i:02}.tikz"
        with open(filename, "w") as fh:
            fh.write(generate_tikz(s, counts, False, 4, True) + "\n")


def cmd_search_scheme(args):
    if args.list_generators:
        for name, e in GENERATORS.items():
            print(f"{e.name:>15} - {e.description}")
        return
    if args.all and args.columba:
        print_columba(args)
    elif args.all and args.yaml:
        print_yaml(args)
    elif args.all:
        print_table(args)
    elif args.tikz:
        print_tikz(args)
    else:
        print_single_scheme(args)


def register(subparsers):
    p = subparsers.add_parser("search_scheme", help="generates and info about search schemes")
    p.add_argument("list_generators", nargs="?", choices=["list-generators"], default=None,
                   help="show a list of generators")
    p.add_argument("-g", "--generator", default="pigeon", help="which generator to use?")
    p.add_argument("-l", "--length", type=int, default=150,
                   help="the assumed query length, when applying node count")
    p.add_argument("--ref-length", type=int, default=1_000_000_000, dest="ref_length",
                   help="the assumed length of the reference text")
    p.add_argument("--min-error", type=int, default=0, dest="min_error",
                   help="minimum errors that have to appear, such that the search scheme accepts it")
    p.add_argument("-k", "--max-error", type=int, default=2, dest="max_error",
                   help="maximum errors that can appear")
    p.add_argument("--sigma", type=int, default=4,
                   help="Size of the alphabet, e.g.: '4' for ACGT or  '5' for ACGTN")
    p.add_argument("-a", "--all", action="store_true", help="print information table about all generators")
    p.add_argument("-y", "--yaml", action="store_true", help="print in a yaml compatible format")
    p.add_argument("--columba", default=None, help="generates columba compatible files")
    p.add_argument("--tikz", default=None, help="generate a tikz diagram")
    p.add_argument("--expansion_mode", choices=["uniform", "bottomup", "topdown"], default="uniform",
                   help="mode to use for generation: uniform, bottomup, topdown")
    p.set_defaults(func=cmd_search_scheme)
