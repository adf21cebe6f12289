"""Trace generation + trace polynomial (counterpart of
``stark_tpu/stark/trace.py``).

Each AIR's trace is a sequential recurrence, so it is built on the host
by the native C++ loops (``stark_tpu_torch/native``), then uploaded to
the device in one copy.  :func:`fibonacci_square_host`, the same
recurrence over Python ints, is the oracle the tests hold the native
loop against.

The trace polynomial is one INTT plus a closed-form degree correction:
INTT of (trace ++ [0]) gives the interpolant with value 0 at the unused
point g^(N-1); subtracting coeffs0[N-1] * g^(i+1) zeroes the top
coefficient while keeping the interpolated values — STARK-101's f.
"""

from __future__ import annotations

import numpy as np
import torch

from stark_tpu_torch import native
from stark_tpu_torch.fields.fp import Fp, host_words, upload_u32
from stark_tpu_torch.ntt.ntt import intt
from stark_tpu_torch.ntt.reference_ntt import root_of_unity


def upload_trace(host_u64, p: int, device="cuda") -> torch.Tensor:
    """Canonical field values (numpy uint64, the trace axis last) -> the
    trace's storage words on `device`: (n,) / (C, n) u32, (2, n) /
    (C, 2, n) limb planes for Goldilocks."""
    arr = np.asarray(host_u64, dtype=np.uint64)
    return upload_u32(host_words(arr, Fp.get(p).width), device)


def host_or_device_trace(kind: str, p: int, arg0: int, arg1: int, n: int,
                         device_fallback=None, device="cuda"):
    """The AIR trace `kind` ("fib", "mimc", "fibmul"; ``native.host_trace``)
    from the native host loop, uploaded to `device` in one copy.  The
    port always has that loop (a failed build raises), so
    `device_fallback`, the JAX package's device scan for a machine
    without a C++ compiler, is accepted and never called."""
    return upload_trace(native.host_trace(kind, p, arg0, arg1, n), p,
                        device)


def fibonacci_square_trace(p: int, length: int, a0: int = 1,
                           a1: int = 3141592, device="cuda"):
    """(length,) trace of the Fibonacci-square AIR on `device`; (2,
    length) limb planes for Goldilocks."""
    return host_or_device_trace("fib", p, a0, a1, length, device=device)


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
    subgroup, top coefficient identically zero (degree <= N-2); for a
    (C, N-1) multi-column trace, (C, N): each column interpolated on its
    own by one batched INTT.  A Goldilocks trace is (2, N-1) or
    (C, 2, N-1) limb planes, and so are its coefficients."""
    f = Fp.get(p)
    n = int(trace.shape[-1]) + 1
    if n & (n - 1):
        raise ValueError("trace length must be 2^k - 1")
    padded = torch.zeros(trace.shape[:-1] + (n,), dtype=torch.int32,
                         device=trace.device)
    padded[..., : n - 1] = trace
    coeffs0 = f.arith(intt(padded, p))
    g = root_of_unity(p, n)
    gp = f.mul(f.powers(g, n, trace.device), f.const(g, trace.device))
    # each column's top coefficient, kept as a (.., 1) axis to broadcast
    return f.storage(f.sub(coeffs0, f.mul(gp, coeffs0[..., n - 1:])))
