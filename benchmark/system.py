"""The system under test, ``sahara_tpu_torch``: the only module of the
benchmark that imports it.  It builds and loads the index as the program's
``index`` command does, uploads it, and searches a batch; and it hands out
the program's counters (kernel launches), its stage timer and the names of
its kernels."""

from __future__ import annotations

import os
import re

import numpy as np

from benchmark.genome import atomic_write, cache_key

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "sahara_tpu_torch", "kernels", "csrc")
BUILD_THREADS = 2  # the forward and reversed suffix arrays side by side, on the first run in a checkout


def kernel_names() -> list[str]:
    """The ``__global__`` functions of the program's CUDA sources."""
    names = set()
    for name in sorted(os.listdir(CSRC)):
        if name.endswith(".cu"):
            with open(os.path.join(CSRC, name)) as fh:
                names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", fh.read()))
    return sorted(names)


def build_kernels() -> None:
    """Build every kernel library the checkout lacks, all at once (a
    no-op once they are built)."""
    from sahara_tpu_torch.kernels._build import build_all

    build_all()


def index_path(config: dict, cache_dir: str, records: list[np.ndarray]) -> str:
    """The configuration's index file, built by the program from
    ``records`` on the first run and kept in the cache."""
    from sahara_tpu_torch.index.build import build_bifmindex
    from sahara_tpu_torch.index.fmindex import save_index

    spec = config["index"]
    path = os.path.join(cache_dir, cache_key(config), "index.idx")
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        host = build_bifmindex(records, spec["sigma"], spec["alphabet"], rate=spec["rate"], threads=BUILD_THREADS)
        if spec["full_sa"] != (host.sa_abs is not None):
            raise ValueError("the built index does not hold the full suffix array the configuration states")
        atomic_write(path, lambda fh: save_index(fh, host))
    return path


def load_index(path: str):
    from sahara_tpu_torch.index.fmindex import load_index as load

    return load(path)


def upload(host, config: dict, device: str):
    """The device index, with the work done on the device finished."""
    import torch

    from sahara_tpu_torch.engine.device import DeviceIndex

    index = DeviceIndex.from_host(host, device=device, full_sa=config["index"]["full_sa"],
                                  include_rev=config["upload"]["include_rev"])
    if index.device.type == "cuda":
        torch.cuda.synchronize(index.device)
    return index


def searcher(index, config: dict, device: str):
    """``search(queries, timer=None)``: one batch through the program's
    search entry, its located rows as host arrays."""
    from sahara_tpu_torch.engine.driver import search_queries

    kw = dict(config["search"])

    def search(queries: np.ndarray, timer=None) -> dict[str, np.ndarray]:
        res = search_queries(index, queries, device=device, timer=timer, **kw)
        return dict(query=res.query_id, seq=res.seq_id, pos=res.pos, errors=res.errors)

    return search


def stage_timer(device: str):
    import torch

    from sahara_tpu_torch.engine.seedverify import StageTimer

    return StageTimer(torch.device(device))


def launches() -> dict[str, int]:
    """The program's kernel launch counts so far."""
    from sahara_tpu_torch.kernels import LAUNCHES

    return dict(LAUNCHES)
