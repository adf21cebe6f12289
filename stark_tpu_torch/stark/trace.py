"""Trace generation + trace polynomial (counterpart of
``stark_tpu/stark/trace.py``; Fibonacci-square, u32 field).

The trace is a sequential recurrence, so it is built on the host: a loop
over Python ints (about a second at 2^20 rows; the JAX package's C loop
in ``stark_tpu.native`` cannot be imported without JAX), then uploaded
to the device in one copy.

The trace polynomial is one INTT plus a closed-form degree correction:
INTT of (trace ++ [0]) gives the interpolant with value 0 at the unused
point g^(N-1); subtracting coeffs0[N-1] * g^(i+1) zeroes the top
coefficient while keeping the interpolated values — STARK-101's f.
"""

from __future__ import annotations

import numpy as np
import torch

from stark_tpu_torch.fields.fp import Fp, store
from stark_tpu_torch.ntt.ntt import intt
from stark_tpu_torch.ntt.reference_ntt import root_of_unity


def fibonacci_square_host(p: int, length: int, a0: int = 1,
                          a1: int = 3141592) -> np.ndarray:
    """a_{i+2} = a_{i+1}^2 + a_i^2 mod p, `length` values, numpy uint32."""
    out = [0] * length
    x, y = a0 % p, a1 % p
    for i in range(length):
        out[i] = x
        x, y = y, (x * x + y * y) % p
    return np.asarray(out, dtype=np.uint32)


def trace_polynomial(trace: torch.Tensor, p: int) -> torch.Tensor:
    """Coefficients (N,) of STARK-101's trace interpolant over the order-N
    subgroup, top coefficient identically zero (degree <= N-2)."""
    f = Fp.get(p)
    n = int(trace.shape[-1]) + 1
    if n & (n - 1):
        raise ValueError("trace length must be 2^k - 1")
    padded = torch.zeros(n, dtype=torch.int32, device=trace.device)
    padded[: n - 1] = trace
    coeffs0 = intt(padded, p)
    g = root_of_unity(p, n)
    g_t = torch.tensor(g, device=trace.device)
    gp = f.mul(f.powers(g, n, trace.device), g_t)  # g^(i+1)
    return store(f.sub(coeffs0, f.mul(gp, coeffs0[n - 1])))
