"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place with one guarantee of the
configuration broken, which the comparison has to find.

The configuration states every hit within ``k`` edits; the control is the
reference at ``k - 1`` edits.  For each seed it makes the cell's read pool,
answers every batch with the control, and compares the answers with the
reference at ``k``, as a run compares the program's; it prints one JSON
line a seed with the numbers compared.  The benchmark's runs do not run it.

    python3 benchmark/control.py --workload <cell> --seeds <n>[,<n>...] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import check, genome, harness, reads, reference  # noqa: E402


def control_numbers(config: dict, traffic: dict, seed: int, device: str, cache_dir: str) -> dict[str, int]:
    """The numbers compared when the control answers every batch of the
    pool of ``seed``."""
    k, m = config["search"]["k"], traffic["read_length"]
    if k < 1:
        raise ValueError("the control needs k >= 1")
    text = genome.load_text(config, cache_dir)
    pool = reads.make_pool(text, traffic, seed)
    table = reference.Text([text], reference.g_for(m, k), device)
    want = [reference.hits(table, batch, k) for batch in pool]
    got = [(b, reference.hits(table, batch, k - 1)) for b, batch in enumerate(pool)]
    return check.judge(want, got)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    _, config, traffic = harness.find_cell(bench, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers = control_numbers(config, traffic, seed, args.device, harness.CACHE_DIR)
        print(json.dumps(dict(workload=args.workload, seed=seed, correct=check.verdict(numbers),
                              checks=check.as_json(numbers))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
