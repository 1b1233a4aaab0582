"""Nothing of the benchmark imports JAX or the JAX package, by whole
top-level name; the reference, the generators and the arithmetic import
nothing of the program either; ``BENCHMARK.json`` keeps to its contract,
and every entry accepted so far stands where it stood."""

import ast
import copy
import json
import os
import re
import subprocess
import sys

import pytest

from benchmark import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
# the yardstick: what the program may not reach
PLAIN = ("genome", "reads", "reference", "check", "stats", "trace", "control")


def sources():
    for base, _, files in os.walk(HERE):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(base, name)


def top_level_imports(path: str) -> set[str]:
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_forbidden_names_are_whole_top_level_names():
    assert harness.forbidden_modules(["sahara_tpu_torch", "sahara_tpu_torch.engine", "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen", "sahara_tpu.engine.driver"]) == [
        "flax", "jax", "jaxlib", "sahara_tpu"]


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        assert not harness.forbidden_modules(top_level_imports(path)), path


def test_the_yardstick_imports_nothing_of_the_program():
    for name in PLAIN:
        assert "sahara_tpu_torch" not in top_level_imports(os.path.join(HERE, name + ".py")), name
    probe = ("import sys; sys.path.insert(0, %r); " % ROOT
             + "; ".join(f"import benchmark.{name}" for name in PLAIN)
             + "; print(sorted({m.split('.')[0] for m in sys.modules}))")
    loaded = json.loads(subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, check=True,
                                       timeout=120).stdout.replace("'", '"'))
    assert "sahara_tpu_torch" not in loaded and not harness.forbidden_modules(loaded)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_to_its_contract():
    with open(os.path.join(ROOT, "BENCHMARK.json"), "rb") as fh:
        raw = fh.read()
    assert len(raw) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and all(one_line(w) for w in b["command"]) and len(b["command"]) <= 32
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check with 24 cells fits
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["name"] in used
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert one_line(c["source"]) and one_line(c["why"]) and len(c["reduced"]) <= 16
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    assert len({c["source"] for c in b["configs"]}) == len(b["configs"])
    assert len({c["file"] for c in b["configs"]}) == len(b["configs"])
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs)) and 1 <= len(pairs) <= 24
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1 and one_line(w["why"])
        assert NAME.match(w["traffic"]) and os.path.exists(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and one_line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", [])) <= {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(HERE, "metrics", m["name"] + ".py")), m["name"]
    for w in b["workloads"]:  # every cell reports setup_s, another end-to-end metric and a per-layer one
        cell = w["name"]
        assert len(harness.metrics_of(b, cell, False)) >= 2 and harness.metrics_of(b, cell, True)
    for base, _, files in os.walk(HERE):
        for f in files:
            rel = os.path.relpath(os.path.join(base, f), ROOT)
            if "__pycache__" not in rel and ".cache" not in rel:
                assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


# The entries accepted so far, in their order.  A later entry is appended
# after them; only a change that retires or reorders entries edits this.
ACCEPTED = {
    "configs": ("chr21-100bp-k2-sv", "chr21-100bp-k2-oss", "chr21-100bp-k2-workq"),
    "workloads": ("chr21-100bp-k2-sv.mapped", "chr21-100bp-k2-oss.mapped", "chr21-100bp-k2-oss.hostdep",
                  "chr21-100bp-k2-workq.mapped"),
    "end_to_end": ("reads_per_s", "setup_s"),
    "per_layer": ("kernels.device_ms", "device.idle_pct", "device.launches", "sv.stage_ms", "approx.k8_launches",
                  "host.cpu_ms", "index.load_s", "index.upload_s", "driver.merge_ms", "driver.sync_wait_ms",
                  "driver.syncs", "sv.bad_mask_ms", "approx.ladder_ms", "approx.launch_us", "approx.retry_share",
                  "workq.k5_launches", "workq.step_us", "workq.dedup_ms", "workq.queue_rows"),
}


def moved_lists(b: dict) -> list[str]:
    """The lists of ``b`` that do not start with their accepted entries in
    their order: an entry inserted among them, moved or dropped."""
    return [key for key, names in ACCEPTED.items() if tuple(e["name"] for e in b[key][: len(names)]) != names]


def appended(b: dict) -> dict:
    """``b`` with one configuration, one cell and one per-layer metric more,
    each after the last entry of its list."""
    b = copy.deepcopy(b)
    config, cell = "chr21-36bp-k3-sve1", "chr21-36bp-k3-sve1.mapped"
    b["configs"].append(dict(b["configs"][0], name=config, file=f"benchmark/configs/{config}.json"))
    b["workloads"].append(dict(b["workloads"][0], name=cell, config=config))
    b["per_layer"].append(dict(b["per_layer"][0], name="sve1.seed_ms", workloads=[cell]))
    return b


def test_accepted_entries_stay_a_prefix(bench):
    """``BENCHMARK.json`` starts each list with the accepted entries, and
    so does a copy with entries appended: an addition passes this check
    without an edit to it."""
    assert moved_lists(bench) == []
    grown = appended(bench)
    assert moved_lists(grown) == []
    assert [len(grown[k]) - len(bench[k]) for k in ("configs", "workloads", "per_layer")] == [1, 1, 1]


@pytest.mark.parametrize("key", list(ACCEPTED))
@pytest.mark.parametrize("change", ["inserted", "swapped", "dropped"])
def test_an_accepted_entry_out_of_place_fails_the_prefix_check(bench, key, change):
    """An entry inserted before the last accepted one, two accepted entries
    swapped, or one dropped: the check names that list alone."""
    b = appended(bench)
    at = len(ACCEPTED[key]) - 1
    if change == "inserted":
        b[key].insert(at, dict(b[key][at], name="new." + key))
    elif change == "swapped":
        b[key][at - 1], b[key][at] = b[key][at], b[key][at - 1]
    else:
        del b[key][at]
    assert moved_lists(b) == [key]


@pytest.mark.parametrize("where", ["checkout", "benchmark_only"])
def test_run_refuses_without_a_card(tmp_path, where):
    """Without a CUDA card, in the checkout or in a directory holding only
    the benchmark, a run exits non-zero and prints no result."""
    cwd = ROOT
    if where == "benchmark_only":
        cwd = str(tmp_path)
        subprocess.run(["cp", "-r", HERE, os.path.join(cwd, "benchmark")], check=True)
        subprocess.run(["cp", os.path.join(ROOT, "BENCHMARK.json"), cwd], check=True)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "chr21-100bp-k2-sv.mapped", "--seed",
                          "2147483999", "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
