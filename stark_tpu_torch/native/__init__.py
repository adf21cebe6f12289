"""Native host traces (counterpart of ``stark_tpu/native`` ``host_trace``:
the Fibonacci-square, MiMC and two-column FibMul loops).

The C++ loop (``native/host_trace.cpp``) is built with the host C++
compiler at first use into ``build/stark_tpu_torch/`` and loaded with
``ctypes`` by the same route as the CUDA kernels (``_build.py``).  A
failed build raises: unlike the JAX package, nothing falls back to a
Python loop.
"""

from __future__ import annotations

import numpy as np

from stark_tpu_torch import _build


def _run(fn: str, p: int, arg0: int, arg1: int, shape) -> np.ndarray:
    if not 0 < p < 1 << 64:
        raise ValueError(f"modulus {p} not in (0, 2^64)")
    out = np.empty(shape, dtype=np.uint64)
    getattr(_build.lib("host_trace"), fn)(p, arg0 % p, arg1 % p,
                                          shape[-1], out.ctypes.data)
    return out


def fib_trace(p: int, a0: int, a1: int, n: int) -> np.ndarray:
    """a_{i+2} = a_{i+1}^2 + a_i^2 mod p, `n` values from a_0, a_1, as a
    numpy uint64 array.  Exact for 0 < p < 2^64."""
    return _run("stark_fib_trace", p, a0, a1, (n,))


def mimc_trace(p: int, x0: int, k: int, n: int) -> np.ndarray:
    """x_{i+1} = (x_i + k)^3 mod p, `n` values from x_0 (uint64)."""
    return _run("stark_mimc_trace", p, x0, k, (n,))


def fibmul_trace(p: int, a0: int, b0: int, n: int) -> np.ndarray:
    """a_{i+1} = b_i, b_{i+1} = a_i * b_i mod p: the (2, n) uint64 array
    of the columns a and b."""
    return _run("stark_fibmul_trace", p, a0, b0, (2, n))
