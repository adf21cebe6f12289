"""The benchmark's trace maker: each AIR's frozen host loop
(``airs/<air>.cpp``), built once with the host C++ compiler into
``build/benchmark/`` under the checkout, named by the AIR and a hash of
its source, and loaded with ctypes.  A copy of the program's native
loops at the time the benchmark was written, so that a change to the
program's trace code never moves the benchmark's inputs.  Traces are
returned in the program's storage words: (T,) u32 for a field below
2^32, (2, T) (hi, lo) planes a column for Goldilocks, (C, ...) for C
columns."""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

import numpy as np

from benchmark import airs

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(HERE), "build", "benchmark")
FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC"]

_libs: dict = {}
_lock = threading.Lock()


def _compiler() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("g++"),
                 shutil.which("c++")):
        if cand:
            return cand
    raise RuntimeError("no host C++ compiler (g++ or c++) on PATH")


def library(air: str) -> ctypes.CDLL:
    """The AIR's loaded trace loop, built first if this checkout lacks
    it."""
    with _lock:
        if air in _libs:
            return _libs[air]
        source = airs.path(air, ".cpp")
        with open(source, "rb") as fh:
            tag = hashlib.sha256(fh.read() + " ".join(FLAGS).encode())
        stem = re.sub(r"\W", "_", air)
        path = os.path.join(BUILD_DIR,
                            f"libtrace-{stem}-{tag.hexdigest()[:16]}.so")
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            subprocess.run([_compiler(), *FLAGS, "-o", tmp, source],
                           check=True, capture_output=True)
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        lib.bench_trace.argtypes = [ctypes.c_uint64, ctypes.c_uint64,
                                    ctypes.c_size_t, ctypes.c_void_p]
        lib.bench_trace.restype = None
        _libs[air] = lib
        return lib


def values(air: str, p: int, witness: int, rows: int) -> np.ndarray:
    """The trace's field values from the witness (numpy uint64; (rows,)
    for one column, (C, rows) for C)."""
    cols = airs.load(air).COLUMNS
    out = np.empty((cols, rows), dtype=np.uint64)
    library(air).bench_trace(p, witness % p, rows, out.ctypes.data)
    return out[0] if cols == 1 else out


def storage_words(vals: np.ndarray, p: int) -> np.ndarray:
    """Field values -> the program's storage words (numpy uint32): the
    same shape below 2^32, else the (hi, lo) planes before the trace
    axis."""
    if p < 1 << 32:
        return vals.astype(np.uint32)
    return np.stack([(vals >> np.uint64(32)).astype(np.uint32),
                     (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)],
                    axis=-2)
