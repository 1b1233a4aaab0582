"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own into a shared library with a
plain C interface, ``_build/lib<name>-<hash>.so`` beside this file
(git-ignored), at first use.  The hash covers the source, the shared headers
and the flags, so an edited source is rebuilt and a stale library is never
loaded.  Each build writes a private temporary file and moves it into place
with ``os.replace``, so concurrent builds never load a partial library.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
KERNEL_SOURCES = ("rank", "seed", "verify", "rank_smem", "workq", "exact", "lf_walk", "frontier")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def lib_path(src: str) -> str:
    """The library of source file ``src``; its hash covers the source, the
    headers beside it and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src, *sorted(glob.glob(os.path.join(os.path.dirname(src), "*.cuh")))]:
        with open(path, "rb") as fh:
            h.update(fh.read())
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build_all(sources=None) -> dict[str, str]:
    """Compile the library of every source file (default: the kernels of
    ``KERNEL_SOURCES``) that is missing, all nvcc processes at once.

    Returns each source's ptxas report (registers, spills) by its file name
    without ``.cu``, kept beside its library, so a library built earlier
    reports too.  Raises with nvcc's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    jobs, reports = {}, {}
    for src in sources or [source(name) for name in KERNEL_SOURCES]:
        name, out = os.path.splitext(os.path.basename(src))[0], lib_path(src)
        if os.path.exists(out):
            if os.path.exists(out + ".ptxas"):
                with open(out + ".ptxas") as fh:
                    reports[name] = fh.read()
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode == 0:
            with open(tmp + ".ptxas", "w") as fh:
                fh.write(log)
            os.replace(tmp + ".ptxas", out + ".ptxas")
            os.replace(tmp, out)
            reports[name] = log
        else:
            os.remove(tmp)
            failed.append(f"{name}.cu:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([source(name)])
            lib = ctypes.CDLL(lib_path(source(name)))
            _libs[name] = lib
        return lib
