"""A tiny configuration and traffic mix that the harness runs on the CPU,
with the program's plain kernels: each cell's files with the text cut to
30,000 chars, chunks of 64 queries and batches of 48 reads."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


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
