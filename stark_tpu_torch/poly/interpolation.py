# Copied from stark_tpu/poly/interpolation.py (host-only), with its stark_tpu imports
# rewritten to the port: the port must not import stark_tpu, whose
# package init imports JAX.
"""Lagrange interpolation — host oracle.

Mirrors the reference's interpolation module
(reference: src/polynomial/interpolation.rs:9-152): Z(x) = prod (x - x_j)
computed once, each basis polynomial L_i = Z / (x - x_i) * denom_i^-1,
then sum y_i * L_i.  The reference's only parallelism is a rayon par-iter
over i (interpolation.rs:80-115); here the per-i work is a numpy-vectorized
synthetic division, and production interpolation uses the INTT
(stark_tpu_torch.ntt) — this module is the small-n oracle (SURVEY §2 row
"Interpolation").
"""

from __future__ import annotations

import numpy as np

from stark_tpu_torch.poly.ops import Polynomial


def gen_polynomial_from_roots(roots, modulus: int) -> Polynomial:
    """prod (x - r) (interpolation.rs:9-23) — sequential monomial products
    with O(n) vectorized updates per step (numpy u64 when p < 2^32)."""
    p = modulus
    rv = [int(r) % p for r in roots]
    n = len(rv)
    if p < 1 << 32 and n:
        pp = np.uint64(p)
        c = np.zeros(n + 1, dtype=np.uint64)
        c[0] = 1
        for r in rv:
            # multiply by (x - r): c <- shift_up(c) + (p - r) * c
            shifted = np.concatenate((np.zeros(1, dtype=np.uint64), c[:-1]))
            c = (shifted + np.uint64((p - r) % p) * c) % pp
        return Polynomial(c.tolist(), p)
    coeffs = [1]
    for r in rv:
        coeffs = [(-r * coeffs[0]) % p] + [
            (coeffs[i] - r * coeffs[i + 1]) % p for i in range(len(coeffs) - 1)
        ] + [1]
        coeffs[-1] = 1
    return Polynomial(coeffs, p)


def _synthetic_div(z: list[int], xi: int, p: int) -> list[int]:
    """Z(x) / (x - xi), exact, O(n) (replaces long division at
    interpolation.rs:103)."""
    n = len(z) - 1
    out = [0] * n
    acc = 0
    for k in range(n - 1, -1, -1):
        acc = (z[k + 1] + acc * xi) % p
        out[k] = acc
    return out


def _lagrange_matrix(xv: list[int], p: int) -> "np.ndarray":
    """(n, n) u64 matrix B with B[i] = coefficients of L_i.

    Same math as the reference (Z / (x - x_i) scaled by 1/denom_i,
    interpolation.rs:46-115) but vectorized over the basis index i — the
    reference's rayon axis (interpolation.rs:89) becomes the numpy axis.
    Requires p < 2^32 (u64 products); larger moduli use the scalar path.
    """
    n = len(xv)
    pp = np.uint64(p)
    x = np.asarray(xv, dtype=np.uint64)
    z = np.asarray(gen_polynomial_from_roots(xv, p).coeffs, dtype=np.uint64)
    # denominators: prod_{j != i} (x_i - x_j), row-wise product mod p
    diff = (x[:, None] + pp - x[None, :]) % pp
    diff[np.arange(n), np.arange(n)] = 1
    denom = np.ones(n, dtype=np.uint64)
    for j in range(n):
        denom = (denom * diff[:, j]) % pp
    dinv = np.array([pow(int(d), p - 2, p) for d in denom], dtype=np.uint64)
    # synthetic division Z/(x - x_i), vectorized over i
    out = np.zeros((n, n), dtype=np.uint64)
    acc = np.zeros(n, dtype=np.uint64)
    for k in range(n - 1, -1, -1):
        acc = (np.uint64(z[k + 1]) + acc * x) % pp
        out[:, k] = acc
    return (out * dinv[:, None]) % pp


def gen_lagrange_polynomials(xs, modulus: int) -> list[Polynomial]:
    """All Lagrange basis polynomials (interpolation.rs:46-115)."""
    p = modulus
    xv = [int(x) % p for x in xs]
    if len(set(xv)) != len(xv):
        raise ValueError("interpolation points must be distinct")
    if p < 1 << 32:
        mat = _lagrange_matrix(xv, p)
        return [Polynomial(row.tolist(), p) for row in mat]
    z = gen_polynomial_from_roots(xv, p).coeffs
    out = []
    for i, xi in enumerate(xv):
        denom = 1
        for j, xj in enumerate(xv):
            if i != j:
                denom = denom * (xi - xj) % p
        dinv = pow(denom, p - 2, p)
        li = _synthetic_div(z, xi, p)
        out.append(Polynomial([c * dinv % p for c in li], p))
    return out


def interpolate_lagrange(xs, ys, modulus: int) -> Polynomial:
    """sum y_i * L_i (interpolation.rs:121-152)."""
    if len(xs) != len(ys):
        raise ValueError("xs and ys must have equal length")
    p = modulus
    n = len(xs)
    xv = [int(x) % p for x in xs]
    if len(set(xv)) != len(xv):
        raise ValueError("interpolation points must be distinct")
    if p < 1 << 32 and n:
        pp = np.uint64(p)
        mat = _lagrange_matrix(xv, p)
        yv = np.asarray([int(y) % p for y in ys], dtype=np.uint64)
        acc = np.zeros(n, dtype=np.uint64)
        for i in range(n):  # sum y_i * L_i without u64 overflow
            acc = (acc + yv[i] * mat[i]) % pp
        return Polynomial(acc.tolist(), p)
    basis = gen_lagrange_polynomials(xs, p)
    acc = [0] * n
    for yi, li in zip(ys, basis):
        yv = int(yi) % p
        for k, c in enumerate(li.coeffs):
            acc[k] = (acc[k] + yv * c) % p
    return Polynomial(acc, p)
