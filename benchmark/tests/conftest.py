"""A tiny configuration and traffic mix that the harness runs on the CPU,
with the program's plain kernels: each cell's files with the text cut to
30,000 chars, chunks of 64 queries and batches of 48 reads.  PyTorch's
pool for operators on host tensors holds one thread, as in a run."""

import copy
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

# Under pytest-xdist every worker would take a thread a core: a tiny batch
# then took 1.0-1.6 s, not 0.06-0.09, and a 1 s window held one batch.
torch.set_num_threads(1)


@pytest.fixture(scope="session")
def bench():
    return harness.load_json(ROOT, "BENCHMARK.json")


@pytest.fixture(scope="session")
def tiny(bench):
    """``tiny(cell)``: (config, traffic) of a cell, cut to run on the CPU in
    seconds."""

    def cut(cell_name: str, length: int = 30_000, batch_reads: int = 48):
        _, cfg, mix = harness.find_cell(bench, cell_name)
        cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
        cfg["genome"]["length"] = length
        cfg["search"]["chunk"] = 64
        mix["batch_reads"] = batch_reads
        mix["pool_batches"] = 2
        return cfg, mix

    return cut


@pytest.fixture(scope="session")
def cache_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_cache"))


@pytest.fixture
def read(monkeypatch):
    """``read(name, rec, rep)``: the metric's reader on ``rec`` with the
    program's report (``program_trace.report()``) replaced by ``rep``."""
    from benchmark import program_trace

    def call(name, rec, rep):
        monkeypatch.setattr(program_trace, "report", lambda: rep)
        return harness.reader(name)(rec)

    return call
