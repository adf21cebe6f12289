"""Build and load the hand-written CUDA kernels (``csrc/*.cu``) and the
native host library (``native/*.cpp``).

Route: ``nvcc`` (or, for a host library, the host C++ compiler) into a
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  Each library is built at
first use into ``build/stark_tpu_torch/`` under the checkout, named by a
hash of its sources and flags, so an edited source rebuilds and an
unchanged one loads at once.  Nothing here runs at import time: the
package imports and its CPU tests collect on machines with no CUDA
toolkit.  A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
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
CXX_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC"]

# library name -> {C function: argtypes}; every CUDA function returns a
# cudaError_t (as int) from cudaGetLastError() after its launches
_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
_U64, _SZ, _LL = ctypes.c_uint64, ctypes.c_size_t, ctypes.c_longlong
SIGNATURES = {
    "ntt": {"stark_ntt": [_P] * 7 + [_I] * 5 + [_U] * 3 + [_P]},
    "ntt64": {"stark_ntt64": [_P, _LL] + [_P] * 6 + [_I] * 5 + [_U64, _P]},
    "sha256_tree": {"stark_sha_subtree": [_P, _P] + [_LL] * 4 + [_I] * 6
                                         + [_LL, _I, _P],
                    "stark_sha_nodes": [_P, _P, _I, _LL, _LL, _I, _P]},
    "sha_chain": {"stark_sha_chain": [_P] * 4 + [_I, _LL, _LL, _I, _P],
                  "stark_query_chain": [_P] * 6 + [_I] * 7 + [_U, _I]
                                       + [_P] * 4 + [_I] * 4 + [_LL] * 2
                                       + [_I, _P],
                  "stark_enable_peer": [_I],
                  "stark_query_chain_max_rows": [_I],
                  "stark_dep_latency": [_P, _I, _I, _P]},
    "host_trace": {fn: [_U64, _U64, _U64, _SZ, _P]
                   for fn in ("stark_fib_trace", "stark_mimc_trace",
                              "stark_fibmul_trace")},
    "host_hash": {"stark_sha256": [_P, _SZ, _P],
                  "stark_merkle_build": [_P, _SZ, _P],
                  "stark_merkle_validate": [_P, _P, _SZ, _SZ, _P, _SZ],
                  "stark_channel_absorb": [_P, _SZ, _P, _SZ, _P]},
}
# host libraries (C++ for the CPU, functions return void unless RESTYPES
# names them): name -> source under the package; every other library is
# csrc/<name>.cu
HOST_SOURCES = {"host_trace": os.path.join("native", "host_trace.cpp"),
                "host_hash": os.path.join("native", "host_hash.cpp")}
RESTYPES = {"stark_merkle_build": _SZ, "stark_merkle_validate": _I}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "stark_tpu_torch are built from csrc/ at first use")


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("g++"),
                 shutil.which("c++")):
        if cand and shutil.which(cand):
            return cand
    raise RuntimeError("no host C++ compiler found (set CXX): the native "
                       "library of stark_tpu_torch is built from native/ at "
                       "first use")


def _sources(name: str) -> list:
    """Paths (relative to the package) whose bytes name the library."""
    if name in HOST_SOURCES:
        return [HOST_SOURCES[name]]
    return [os.path.join("csrc", fn) for fn in (f"{name}.cu",) + HEADERS]


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for rel in _sources(name):
        with open(os.path.join(_PKG, rel), "rb") as fh:
            h.update(rel.encode() + fh.read())
    h.update(" ".join(CXX_FLAGS if name in HOST_SOURCES
                      else NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _compile_cmd(name: str, out: str) -> list:
    src = os.path.join(_PKG, _sources(name)[0])
    if name in HOST_SOURCES:
        return [_cxx(), *CXX_FLAGS, "-o", out, src]
    return [_nvcc(), *NVCC_FLAGS, "-o", out, src]


def _load(name: str, path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = RESTYPES.get(
            fn, None if name in HOST_SOURCES else ctypes.c_int)
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
                errors.append(f"build of {_sources(n)[0]} failed:\n{log}")
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
    _require(t, name, shape, dtype, align)
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def require_planes(t, name: str, shape: tuple) -> int:
    """Check a kernel operand of planes: an int32 CUDA tensor of `shape`
    whose planes (its rows along the last axis) are each contiguous and
    lie a fixed stride apart, in order: a contiguous tensor, or a slice of
    one along its last axis.  Returns that stride in words."""
    _require(t, name, shape)
    n, planes = int(t.shape[-1]), tuple(t.shape[:-1])
    ld = t.stride(-2) if math.prod(planes) > 1 else n
    nested = all(t.stride(k) == ld * math.prod(planes[k + 1:])
                 for k in range(len(planes)) if planes[k] > 1)
    if (n > 1 and t.stride(-1) != 1) or ld < n or not nested:
        raise ValueError(f"{name}: expected contiguous planes a fixed "
                         f"stride apart, got strides {t.stride()}")
    return ld


def _require(t, name, shape, dtype=None, align=4) -> None:
    import torch

    dtype = dtype or torch.int32
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
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
