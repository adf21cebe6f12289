"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Route: ``nvcc`` into a shared library with a plain C interface, loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds).  Each
library is built at first use into ``build/stark_tpu_torch/`` under the
checkout, named by a hash of its sources, so an edited source rebuilds
and an unchanged one loads at once.  Nothing here runs at import time:
the package imports and its CPU tests collect on machines with no CUDA
toolkit.  A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "stark_tpu_torch")
HEADERS = ("sha256.cuh",)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# library name -> {C function: argtypes}; every function returns a
# cudaError_t (as int) from cudaGetLastError() after its launches
_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
SIGNATURES = {
    "ntt": {"stark_ntt_two_step": [_P, _P, _P, _P, _P, _P, _I, _I,
                                   _U, _U, _U, _U, _P]},
    "sha256_tree": {"stark_sha_leaves": [_P, _P, _I, _P],
                    "stark_sha_nodes": [_P, _P, _I, _P]},
    "sha_chain": {"stark_sha_chain": [_P, _P, _P, _P, _I, _P]},
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "stark_tpu_torch are built from csrc/ at first use")


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for fn in (f"{name}.cu",) + HEADERS:
        with open(os.path.join(CSRC, fn), "rb") as fh:
            h.update(fn.encode() + fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _compile_cmd(name: str, out: str) -> list:
    return [_nvcc(), *NVCC_FLAGS, "-o", out, os.path.join(CSRC, f"{name}.cu")]


def _load(name: str, path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def build_all(names=None) -> dict:
    """Compile (concurrently) every library not yet built, then load them.
    Returns {name: path}."""
    names = list(names or SIGNATURES)
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        paths = {n: _lib_path(n) for n in names}
        procs = {}
        for n in names:
            if n not in _libs and not os.path.exists(paths[n]):
                tmp = f"{paths[n]}.{os.getpid()}.tmp"
                procs[n] = (tmp, subprocess.Popen(
                    _compile_cmd(n, tmp), stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
        errors = []
        for n, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for csrc/{n}.cu:\n{log}")
            else:
                os.replace(tmp, paths[n])
        if errors:
            raise RuntimeError("\n".join(errors))
        for n in names:
            if n not in _libs:
                _libs[n] = _load(n, paths[n])
    return paths


def lib(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    if name not in _libs:
        build_all([name])
    return _libs[name]


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError_t {err}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require(t, name: str, shape: tuple, dtype=None, align: int = 4) -> None:
    """Check a kernel operand: a contiguous int32 CUDA tensor of `shape`
    whose data pointer is `align`-byte aligned."""
    import torch

    dtype = dtype or torch.int32
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer not {align}-byte aligned")


def plain_device(t) -> bool:
    """True when `t` lies on the CPU (the wrappers then run their kernel's
    plain version); False for a CUDA tensor (they launch the kernel);
    anything else raises."""
    if t.device.type == "cpu":
        return True
    if t.is_cuda:
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")
