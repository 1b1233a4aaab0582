"""sahara_tpu_torch stands alone: no module of it (nor chip_smoke.py) pulls
in jax or sahara_tpu, and its copy of the workload generator gives the
same workload as bench.py and sahara_tpu.sim."""

import os
import subprocess
import sys

import numpy as np

import bench
from sahara_tpu.alphabet import D_DNA5
from sahara_tpu.sim.read_simulator import simulate_reads as jax_simulate_reads
from sahara_tpu_torch.sim.read_simulator import simulate_reads
from sahara_tpu_torch.sim.workload import bench_workload, make_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import sahara_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sahara_tpu_torch.__path__, "sahara_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "sahara_tpu") or m.startswith(("jax.", "sahara_tpu.")))
print(len(names), bad)
"""


def test_port_imports_neither_jax_nor_sahara_tpu():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, timeout=120, check=True
    )
    n_modules, bad = out.stdout.strip().split(" ", 1)
    assert int(n_modules) >= 20
    assert bad == "[]"


def test_make_reference_matches_bench():
    a = make_reference(np.random.default_rng(1234), 30_000)
    b = bench.make_reference(np.random.default_rng(1234), 30_000)
    np.testing.assert_array_equal(a, b)


def test_simulate_reads_matches_jax_package():
    rng = np.random.default_rng(9)
    refs = [bytes(rng.choice(list(b"ACGTN"), size=n)) for n in (400, 900)]
    for kw in (dict(random_errors=3), dict(sub_errors=1, ins_errors=1, del_errors=2)):
        got = simulate_reads(refs, num_reads=60, read_length=50, seed=5, **kw)
        want = jax_simulate_reads(refs, num_reads=60, read_length=50, seed=5, **kw)
        assert [(r.id, r.seq) for r in got] == [(r.id, r.seq) for r in want]


def test_bench_workload_matches_bench_py():
    ref, queries = bench_workload(ref_mb=0.02, n_reads=40)
    want_ref = bench.make_reference(np.random.default_rng(1234), 20_000)
    np.testing.assert_array_equal(ref, want_ref)
    reads = bench.make_queries(want_ref, 40, seed=99)
    want = [s for q in reads for s in (q, D_DNA5.reverse_complement_rank(q).astype(np.uint8))]
    np.testing.assert_array_equal(queries, np.stack(want))
