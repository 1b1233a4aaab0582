"""Run one cell of the benchmark on the card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Standard error carries the set-up's
spans and, as its last lines, each number compared with its limit; the
last line of standard output is the result as one JSON object.  Exits with
1, and prints no result, where there is no CUDA card or fewer cards than
the cell asks for; with 3 where a JAX module or the JAX package was
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


HOST_THREADS = 1  # PyTorch's pool for operators on host tensors: one thread, so no idle worker spins on a core


def log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import check, harness

    bench = harness.load_json(ROOT, "BENCHMARK.json")
    cell = harness.find_cell(bench, args.workload)[0]
    import torch

    torch.set_num_threads(HOST_THREADS)
    t_imported = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"benchmark: the cell needs {cell['chips']} CUDA card(s), "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 1
    t_looked = time.perf_counter()
    result, record = harness.run(bench, args.workload, seed=args.seed, seconds=args.seconds, traced=bool(args.trace),
                                 t_start=T_START, log=log)
    record["spans"].update(imports_s=t_imported - T_START, cuda_look_s=t_looked - t_imported)
    loaded = harness.forbidden_modules(sys.modules)
    if loaded:
        log(f"benchmark: the run loaded {', '.join(loaded)}")
        return 3
    log("spans s: " + json.dumps({k: round(v, 4) for k, v in record["spans"].items()}))
    log(f"setup_s {record['setup_s']:.4f}, window {record['window_s']:.4f} s (cpu {record['cpu_s']:.4f} s: "
        f"{json.dumps({k: round(v, 2) for k, v in record['threads_cpu_s'].items()})}), "
        f"{len(record['batch_s'])} batches, {record['reads_done']} reads, "
        f"launches {json.dumps({k: v for k, v in record['launches'].items() if v})}")
    tenth = max(1, len(record["batch_s"]) // 10)
    med = [sorted(record["batch_s"][i : i + tenth])[len(record["batch_s"][i : i + tenth]) // 2] * 1e3
           for i in range(0, len(record["batch_s"]), tenth)]
    log("batch ms, median of each tenth of the window: " + " ".join(f"{v:.1f}" for v in med))
    if record.get("stages_ms"):
        log("stages ms: " + json.dumps({k: round(v, 3) for k, v in record["stages_ms"].items()}))
    for line in check.lines(record["checks"]):
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
