"""ctypes binding for the host native code (``sahara_native.cpp``): the SA-IS
suffix sorter and XXH64.

The library is compiled with ``g++`` at first use into ``_build/`` beside
this file (git-ignored), under a name keyed by the source's hash.  Several
processes may build at once (pytest workers): each compiles to a private
temporary name and moves it into place with ``os.replace``, so a reader
never sees a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "sahara_native.cpp")
_BUILD_DIR = os.path.join(_HERE, "_build")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _lib_path() -> str:
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:12]
    return os.path.join(_BUILD_DIR, f"sahara_native-{digest}.so")


def _build(path: str) -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib() -> ctypes.CDLL:
    """Load the native library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path = _lib_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            lib.sahara_sais_i32.restype = ctypes.c_int
            lib.sahara_sais_i32.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
            ]
            lib.sahara_xxh64.restype = ctypes.c_uint64
            lib.sahara_xxh64.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]
            lib.sahara_xxh64_batch_u64.restype = None
            lib.sahara_xxh64_batch_u64.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p,
            ]
            _lib = lib
        return _lib


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array of a rank text (uint8 values in [0, 255)).

    The text need not end with a unique sentinel; ties are broken by suffix
    order like any general suffix sort.  Texts of 2^31 - 1 chars or more
    are refused, as the device index refuses them.  Returns int64 positions."""
    text = np.ascontiguousarray(text, dtype=np.uint8)
    n = len(text)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    if n + 1 >= 2**31:
        raise ValueError(f"text of {n} chars: suffix arrays need n + 1 < 2^31")
    lib = get_lib()
    # shift ranks +1 and append the unique smallest sentinel 0
    shifted = np.empty(n + 1, dtype=np.int32)
    shifted[:n] = text
    shifted[:n] += 1
    shifted[n] = 0
    sa = np.empty(n + 1, dtype=np.int32)
    rc = lib.sahara_sais_i32(shifted.ctypes.data, sa.ctypes.data, n + 1, int(shifted.max()) + 1)
    if rc != 0:
        raise RuntimeError(f"SA-IS failed ({rc})")
    # drop the sentinel suffix (always sa[0] == n)
    return sa[1:].astype(np.int64)


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of a byte string."""
    return int(get_lib().sahara_xxh64(data, len(data), seed))


def xxh64_u64(value: int, seed: int = 0) -> int:
    """XXH64 of one uint64 (its little-endian bytes), the kmer hash."""
    return xxh64(int(value).to_bytes(8, "little"), seed)


def xxh64_batch_u64(values: np.ndarray, seed: int = 0) -> np.ndarray:
    """XXH64 of each uint64 key: uint64[len(values)]."""
    values = np.ascontiguousarray(values, dtype=np.uint64)
    out = np.empty(len(values), dtype=np.uint64)
    get_lib().sahara_xxh64_batch_u64(values.ctypes.data, len(values), seed, out.ctypes.data)
    return out
