"""Native host trace (counterpart of ``stark_tpu/native`` ``host_trace``,
Fibonacci-square only; the MiMC and FibMul loops wait for ROADMAP Queue 1
item 11).

The C++ loop (``native/host_trace.cpp``) is built with the host C++
compiler at first use into ``build/stark_tpu_torch/`` and loaded with
``ctypes`` by the same route as the CUDA kernels (``_build.py``).  A
failed build raises: unlike the JAX package, nothing falls back to a
Python loop.
"""

from __future__ import annotations

import numpy as np

from stark_tpu_torch import _build


def fib_trace(p: int, a0: int, a1: int, n: int) -> np.ndarray:
    """a_{i+2} = a_{i+1}^2 + a_i^2 mod p, `n` values from a_0, a_1, as a
    numpy uint64 array.  Exact for 0 < p < 2^64."""
    if not 0 < p < 1 << 64:
        raise ValueError(f"modulus {p} not in (0, 2^64)")
    out = np.empty(n, dtype=np.uint64)
    _build.lib("host_trace").stark_fib_trace(p, a0 % p, a1 % p, n,
                                            out.ctypes.data)
    return out
