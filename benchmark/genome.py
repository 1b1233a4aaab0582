"""The reference text of a configuration, made from its own seed and kept
in the benchmark's cache directory.

``make_reference`` is the repeat-structured model of ``bench.py`` (random
ACGT overlaid with mutated segmental duplications), copied so that the
benchmark makes its text without the program.  Ranks are those of the
program's DNA alphabet: A=1, C=2, G=3, T=4 (0 is the sentinel).
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile

import numpy as np


def make_reference(rng: np.random.Generator, n: int, repeat_frac: float = 0.35, divergence: float = 0.015) -> np.ndarray:
    """Random DNA ranks overlaid with mutated segmental duplications."""
    ref = rng.integers(1, 5, size=n).astype(np.uint8)
    covered, target = 0, int(n * repeat_frac)
    while covered < target:
        seg = int(rng.integers(300, 5001))
        src = int(rng.integers(0, n - seg))
        dst = int(rng.integers(0, n - seg))
        chunk = ref[src : src + seg].copy()
        nmut = int(rng.binomial(seg, divergence))
        if nmut:
            at = rng.choice(seg, size=nmut, replace=False)
            chunk[at] = 1 + (chunk[at] - 1 + rng.integers(1, 4, size=nmut)) % 4
        ref[dst : dst + seg] = chunk
        covered += seg
    return ref


def make_text(genome: dict) -> np.ndarray:
    """The text a configuration's ``genome`` section describes."""
    if genome["model"] != "segmental_duplications":
        raise ValueError(f"unknown genome model {genome['model']!r}")
    return make_reference(np.random.default_rng(genome["seed"]), genome["length"], genome["repeat_frac"],
                          genome["divergence"])


def cache_key(config: dict) -> str:
    """Names the cache entry of what a configuration's text and index
    sections determine; configurations that share both share the entry."""
    blob = json.dumps({"genome": config["genome"], "index": config["index"]}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def atomic_write(path: str, write) -> None:
    """``write(fh)`` into a private file beside ``path``, then move it into
    place, so a reader never sees a partial file."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".part")
    try:
        with os.fdopen(fd, "wb") as fh:
            write(fh)
        os.replace(tmp, path)
    except BaseException:
        os.remove(tmp)
        raise


def load_text(config: dict, cache_dir: str) -> np.ndarray:
    """The configuration's text: read from ``<cache_dir>/<key>/text.npy``,
    or made and written there on the first run."""
    entry = os.path.join(cache_dir, cache_key(config))
    path = os.path.join(entry, "text.npy")
    if os.path.exists(path):
        return np.load(path)
    os.makedirs(entry, exist_ok=True)
    text = make_text(config["genome"])
    atomic_write(path, lambda fh: np.save(fh, text))
    return text
