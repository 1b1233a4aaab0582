"""One run of one cell: set-up, the measured window, the traced batches,
the comparison with the plain reference, and the metrics.

A cell names a configuration (``configs/<name>.json``, by its entry in
``BENCHMARK.json``) and a traffic mix (``traffic/<name>.json``).  The
window drives the program's search entry in a closed loop with one
client: one batch of the read pool at a time, cycling through the pool,
each batch's located rows back on the host before the next is sent.  Every
metric is read from the run's record by a reader of its own,
``metrics/<metric name>.py``, whose ``read(record)`` returns a number or
None (nothing to read).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import time

from benchmark import check, genome, reads, reference, system, trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE_DIR = os.path.join(HERE, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "sahara_tpu")
ATTRIBUTED_BATCHES = 1  # batches traced with Python stacks, for the idle gaps' host functions
PROFILE_TRIES = 3  # the profiler has been seen to record no device activity


def forbidden_modules(names) -> list[str]:
    """The forbidden packages among module names, by whole top-level name."""
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def thread_cpu() -> dict[str, float]:
    """CPU seconds of the process's threads so far: the main thread's as
    ``main``, the others' summed by thread name; empty without ``/proc``."""
    out: dict[str, float] = {}
    tick = os.sysconf("SC_CLK_TCK")
    try:
        tids = os.listdir("/proc/self/task")
    except OSError:
        return out
    for tid in tids:
        try:
            with open(f"/proc/self/task/{tid}/stat") as fh:
                stat = fh.read()
        except OSError:  # the thread ended
            continue
        name = "main" if int(tid) == os.getpid() else stat[stat.index("(") + 1 : stat.rindex(")")]
        utime, stime = stat[stat.rindex(")") + 2 :].split()[11:13]
        out[name] = out.get(name, 0.0) + (int(utime) + int(stime)) / tick
    return out


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def find_cell(bench: dict, name: str) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic mix) of a cell named in ``bench``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; cells: {sorted(cells)}")
    cell = cells[name]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return cell, load_json(ROOT, entry["file"]), load_json(HERE, "traffic", cell["traffic"] + ".json")


def metrics_of(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The cell's end-to-end metrics (untraced run) or per-layer ones."""
    entries = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark.metrics." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def run(bench: dict, cell_name: str, *, seed: int, seconds: float, traced: bool, device: str = "cuda",
        cache_dir: str = CACHE_DIR, t_start: float | None = None, config: dict | None = None,
        traffic: dict | None = None, wrap=None, log=print) -> tuple[dict, dict]:
    """(result, record) of one run.  ``t_start`` is the process's start on
    ``time.perf_counter``; ``config`` and ``traffic`` replace the cell's
    files; ``wrap(search)`` replaces the program's search (to plant a
    fault)."""
    import torch

    now = time.perf_counter
    t_start = now() if t_start is None else t_start
    cell, cfg, mix = find_cell(bench, cell_name)
    cfg, mix = config or cfg, traffic or mix
    cuda = torch.device(device).type == "cuda"
    spans = {"start_s": now() - t_start}  # the interpreter, imports, the look for a card

    def span(name, fn, *args):
        t0 = now()
        out = fn(*args)
        spans[name] = now() - t0
        return out

    # set-up
    if cuda:
        span("kernels.build_s", system.build_kernels)
    text = span("text_s", genome.load_text, cfg, cache_dir)
    path = span("index.build_s", system.index_path, cfg, cache_dir, [text])
    host = span("index.load_s", system.load_index, path)
    index = span("index.upload_s", system.upload, host, cfg, device)
    del host
    pool = span("pool_s", reads.make_pool, text, mix, seed)
    search = system.searcher(index, cfg, device)
    if wrap is not None:
        search = wrap(search)

    def attempt(b: int, timer=None):
        try:
            return search(pool[b], timer=timer)
        except RuntimeError as exc:  # the program's refusal of a batch (e.g. buffers still overflowing)
            log(f"batch {b} raised: {exc}")
            return None

    t0 = now()
    for b in range(len(pool)):
        attempt(b)
    spans["warm_s"] = now() - t0
    if cuda:
        torch.cuda.synchronize()
    setup_s = now() - t_start

    # the window
    per_batch = mix["batch_reads"]
    before = system.launches()
    timer = system.stage_timer(device) if traced else None
    answers, latency = [], []
    c0, threads0 = time.process_time(), thread_cpu()
    w0 = now()
    i = 0
    while True:
        b = i % len(pool)
        s0 = now()
        rows = attempt(b, timer)
        s1 = now()
        answers.append((b, rows))
        latency.append(s1 - s0)
        i += 1
        if s1 - w0 >= seconds:
            break
    window_s = s1 - w0
    cpu_s = time.process_time() - c0
    threads = {name: s - threads0.get(name, 0.0) for name, s in thread_cpu().items()}
    after = system.launches()
    done = sum(per_batch for _, rows in answers if rows is not None)
    record = dict(
        cell=cell, config=cfg, traffic=mix, setup_s=setup_s, spans=spans, window_s=window_s, cpu_s=cpu_s,
        threads_cpu_s={name: s for name, s in threads.items() if s > 0},
        batch_s=latency, reads_done=done, reads_attempted=per_batch * len(answers),
        launches={name: after[name] - before.get(name, 0) for name in after},
        stages_ms=timer.totals() if timer is not None else None,
        memory_peak_bytes=torch.cuda.max_memory_allocated() if cuda else 0,
    )

    # the traced batches: one cycle of the pool, then a few with Python stacks
    traced_answers = []
    if traced:
        def cycle():
            for b in range(len(pool)):
                traced_answers.append((b, attempt(b)))

        summary = None
        for _ in range(PROFILE_TRIES):
            summary = trace.summarize(trace.profile(cycle))
            if summary is not None:
                break
        if summary is None:
            raise RuntimeError("the profiler recorded no device operation in the traced batches")

        def some():
            for b in range(min(ATTRIBUTED_BATCHES, len(pool))):
                traced_answers.append((b, attempt(b)))

        summary.update(reads=per_batch * len(pool), port_kernels=system.kernel_names(),
                       idle=trace.idle_by_host(trace.profile(some, with_stack=True)))
        record["trace"] = summary

    # free the program's state, then the reference
    del index, search
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = now()
    k, m = cfg["search"]["k"], mix["read_length"]
    if not cfg["search"]["edit"]:
        raise ValueError("the reference implements edit distance only")
    text_ref = reference.Text([text], reference.g_for(m, k), device)
    want = [reference.hits(text_ref, batch, k) for batch in pool]
    del text_ref
    numbers = check.judge(want, answers + traced_answers)
    record["spans"]["reference_s"] = now() - t0

    metrics = {}
    for entry in metrics_of(bench, cell_name, traced):
        value = reader(entry["name"])(record)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(torch.device(device)) if cuda else "cpu",
        "count": cell["chips"],
        "memory_peak_bytes": record["memory_peak_bytes"],
    }
    result = dict(correct=check.verdict(numbers), attempted=record["reads_attempted"],
                  failed=record["reads_attempted"] - done, metrics=metrics, device=dev)
    if traced:
        dev.update(busy_s=record["trace"]["busy_s"], window_s=record["trace"]["window_s"])
        result["breakdown"] = {"device_ops": record["trace"]["top"], "idle_gaps": record["trace"]["idle"]}
    result["checks"] = check.as_json(numbers)
    record["checks"] = numbers
    return result, record
