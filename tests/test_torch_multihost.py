"""Multi-host search through the port's CLI: processes of
``python -m sahara_tpu_torch search --mh_*`` on the CPU (gloo), each
searching its slice of the strand queries, must give, once rank 0 has
merged the part files, the single-process output byte for byte, and
sahara_tpu's CLI output.  The cases of tests/test_multihost.py: two
processes, four over slices that do not divide evenly, and two with a
local mesh of two (``--devices 2``)."""

import contextlib
import io
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from sahara_tpu.cli.main import main as jax_main
from sahara_tpu_torch.cli.main import main
from sahara_tpu_torch.io.fasta import FastaRecord, write_fasta

from tests import torch_support

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (seed, record lengths, reads, read seed, processes, extra flags)
CASES = [
    (11, (600,), 10, 4, 2, []),
    (13, (500, 350), 13, 9, 4, []),  # 26 strand queries -> slices of 7, 7, 7, 5
    (12, (700,), 10, 6, 2, ["--devices", "2"]),
]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _quiet(fn, argv) -> int:
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(argv)


@pytest.mark.parametrize("seed,lens,n_reads,read_seed,n_proc,extra", CASES, ids=["2proc", "4proc_uneven", "2proc_mesh"])
def test_multi_process_run_matches_single_process(tmp_path, seed, lens, n_reads, read_seed, n_proc, extra):
    rng = np.random.default_rng(seed)
    ref = tmp_path / "ref.fasta"
    write_fasta(ref, [FastaRecord(id=f"chr{i}", seq=bytes(b"ACGT"[j] for j in rng.integers(0, 4, size=n)))
                      for i, n in enumerate(lens)])
    reads = tmp_path / "reads.fasta"
    assert _quiet(main, ["read_simulator", "-i", str(ref), "-o", str(reads), "-n", str(n_reads), "-l", "36", "-e",
                         "1", "--seed", str(read_seed)]) == 0
    assert _quiet(main, ["index", str(ref)]) == 0
    search = ["search", "-q", str(reads), "-i", str(ref) + ".idx", "-e", "1", "-g", "optimum"]

    single, jax_out = tmp_path / "single.txt", tmp_path / "jax.txt"
    assert _quiet(main, search + ["-o", str(single), "--device", "cpu"]) == 0
    assert _quiet(jax_main, search + ["-o", str(jax_out)]) == 0

    port, multi = _free_port(), tmp_path / "multi.txt"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]),
               **torch_support.ONE_THREAD_ENV)
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "sahara_tpu_torch", *search, "-o", str(multi), "--device", "cpu", *extra,
             "--mh_coordinator", f"127.0.0.1:{port}", "--mh_num_processes", str(n_proc), "--mh_process_id", str(r)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for r in range(n_proc)
    ]
    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        logs.append(out.decode(errors="replace"))
        assert p.returncode == 0, logs[-1][-2000:]
    assert multi.read_text() == single.read_text() == jax_out.read_text()
    assert len(single.read_text().splitlines()) >= 2 * n_reads // 2
    assert not list(tmp_path.glob("multi.txt.h*"))  # rank 0 removed the part files
    per = -(-2 * n_reads // n_proc)
    for r, log in enumerate(logs):
        n = min(per, 2 * n_reads - r * per)
        assert f"fwd queries: {n // 2}" in log and f"bwd queries: {n - n // 2}" in log
        assert ("devices:             2" in log) == bool(extra)
