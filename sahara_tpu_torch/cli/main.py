"""CLI entry point: ``python -m sahara_tpu_torch <subcommand>`` parses argv,
dispatches to the registered subcommand and turns a ``SaharaError`` into a
message and exit code 1."""

from __future__ import annotations

import argparse
import sys

from sahara_tpu_torch.cli import columba_cmd, index_cmd, kmer_cmd, scheme_cmd, search_cmd, sim_cmd
from sahara_tpu_torch.utils.errors import SaharaError


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="sahara-torch",
        description="approximate pattern matching on a CUDA card (FM-index + optimum search schemes)",
    )
    subparsers = parser.add_subparsers(dest="command", required=True)
    index_cmd.register(subparsers)
    search_cmd.register(subparsers)
    kmer_cmd.register(subparsers)
    scheme_cmd.register(subparsers)
    sim_cmd.register(subparsers)
    columba_cmd.register(subparsers)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        args.func(args)
    except SaharaError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
