"""Batched prime-field arithmetic on torch tensors (counterpart of
``stark_tpu/fields/fp.py``).

Representation, decided once for the whole port:

* **Storage** is ``torch.int32`` holding the uint32 bit pattern — the
  same bytes as the JAX package's ``uint32`` arrays, so
  ``np.asarray(jax_arr).view(np.int32)`` <-> ``torch.from_numpy`` is free
  (``stark_tpu_torch.interop``) and the CUDA kernels read the buffers as
  ``uint32_t*``.
* **Compute** in the plain torch ops is ``torch.int64`` holding values in
  [0, 2^32): torch has no uint32 add/shift/compare on the CPU, so every
  method here lifts its inputs (:func:`lift`) and returns int64;
  :func:`store` turns a result back into int32 storage.

Products never overflow int64: Montgomery REDC follows ``_mulhilo32``'s
16-bit limbs (``stark_tpu/fields/fp.py:36-51``), and the canonical-domain
``mul`` splits one operand into 16-bit halves.  Every output is a
canonical field value, so results are bit-identical to the JAX package.

Width 1 only (2 < p < 2^32); Goldilocks waits for ROADMAP Queue 1 item 12.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def lift(x: torch.Tensor) -> torch.Tensor:
    """int32 storage (or int64 compute) -> int64 values in [0, 2^32)."""
    if x.dtype == torch.int64:
        return x
    return x.to(torch.int64) & MASK32


def store(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 storage (same bits)."""
    return x.to(torch.int32)


def _mulhilo32(a, b):
    """(hi, lo) 32-bit halves of a*b for int64 tensors in [0, 2^32)."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    t = a0 * b0
    mid1 = a1 * b0 + (t >> 16)
    mid2 = a0 * b1 + (mid1 & 0xFFFF)
    hi = a1 * b1 + (mid1 >> 16) + (mid2 >> 16)
    lo = (t & 0xFFFF) | ((mid2 & 0xFFFF) << 16)
    return hi, lo


def _mullo32(a, c: int):
    """(a * c) mod 2^32 for an int64 tensor a in [0, 2^32), int c < 2^32."""
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


@functools.lru_cache(maxsize=None)
def _get(modulus: int) -> "Fp":
    p = int(modulus)
    if p >= 1 << 32:
        raise NotImplementedError(
            f"modulus {p} >= 2^32: the port is width 1 only; 64-bit fields "
            "(Goldilocks) wait for ROADMAP Queue 1 item 12")
    return Fp(p)


class Fp:
    """Field context for a fixed modulus.  Use :meth:`Fp.get` (cached)."""

    get = staticmethod(_get)
    width = 1

    def __init__(self, modulus: int):
        p = int(modulus)
        if p <= 2 or p % 2 == 0:
            raise ValueError(f"Fp requires an odd modulus > 2, got {p}")
        if p >= 1 << 32:
            raise NotImplementedError(
                f"modulus {p} >= 2^32: see ROADMAP Queue 1 item 12")
        self.p = p
        self.ninv = (-pow(p, -1, 1 << 32)) % (1 << 32)  # -p^-1 mod 2^32
        self.r = (1 << 32) % p  # mont(1)
        self.r2 = self.r * self.r % p

    # -- canonical-domain ops (inputs int32 or int64; output int64) -------
    def add(self, a, b):
        s = lift(a) + lift(b)
        return torch.where(s >= self.p, (s - self.p) & MASK32, s)

    def sub(self, a, b):
        a, b = lift(a), lift(b)
        return torch.where(a < b, a - b + self.p, a - b)

    def neg(self, a):
        a = lift(a)
        return torch.where(a == 0, a, self.p - a)

    def mul(self, a, b):
        """(a * b) mod p for canonical inputs: one operand split into 16-bit
        halves, so every partial product stays below 2^49."""
        a, b = lift(a), lift(b)
        p = self.p
        return ((a * (b >> 16)) % p * 65536 + a * (b & 0xFFFF)) % p

    # -- Montgomery domain -------------------------------------------------
    def _redc(self, hi, lo):
        """(hi*2^32 + lo) * R^-1 mod p — the exact semantics of the JAX
        ``_redc`` (wrapping adds and the single conditional subtract)."""
        m = _mullo32(lo, self.ninv)
        mn_hi, _ = _mulhilo32(m, torch.full_like(m, self.p))
        s = hi + mn_hi + (lo != 0).to(torch.int64)
        return torch.where(s >= self.p, (s - self.p) & MASK32, s)

    def mont_mul(self, a, b):
        a, b = lift(a), lift(b)
        hi, lo = _mulhilo32(a, b)
        return self._redc(hi, lo)

    def to_mont(self, a):
        a = lift(a)
        return self.mont_mul(a, torch.full_like(a, self.r2))

    def from_mont(self, a):
        a = lift(a)
        return self._redc(torch.zeros_like(a), a)

    # -- powers / inversion -------------------------------------------------
    def pow_static(self, a, exp: int):
        """a ** exp for a Python-int exponent (square-and-multiply in the
        Montgomery domain)."""
        exp = int(exp)
        if exp < 0:
            raise ValueError("negative exponent; invert first")
        a = lift(a)
        if exp == 0:
            return torch.ones_like(a)
        am = self.to_mont(a)
        acc = None
        while exp:
            if exp & 1:
                acc = am if acc is None else self.mont_mul(acc, am)
            exp >>= 1
            if exp:
                am = self.mont_mul(am, am)
        return self.from_mont(acc)

    def inv_rolled(self, a):
        """Batched Fermat inverse a^(p-2) (0 maps to 0, as in JAX).  The
        JAX version rolls the chain into a fori_loop for program size;
        eager torch has no program, so this is the same chain as a loop."""
        return self.pow_static(a, self.p - 2)

    # -- host table builders (numpy, u64-safe since operands < 2^32) --------
    def host_powers(self, base: int, count: int, mont: bool = False):
        """numpy uint32 [base^0 .. base^(count-1)], canonical (or mont)."""
        p = self.p
        base = int(base) % p
        out = np.ones(1, dtype=np.uint64)
        c = 1
        while c < count:
            out = np.concatenate(
                [out, out * np.uint64(pow(base, c, p)) % np.uint64(p)])
            c *= 2
        out = out[:count]
        if mont:
            out = out * np.uint64(self.r) % np.uint64(p)
        return out.astype(np.uint32)

    def host_geometric_table(self, ratios, count: int, mont: bool = False):
        """numpy uint32 T[i, j] = ratios[i]^j, canonical (or mont)."""
        p = np.uint64(self.p)
        r = np.asarray(ratios, dtype=np.uint64) % p
        cols = np.ones(r.shape + (1,), dtype=np.uint64)
        cur = r[..., None]
        c = 1
        while c < count:
            cols = np.concatenate([cols, cols * cur % p], axis=-1)[..., :count]
            cur = cur * cur % p
            c *= 2
        if mont:
            cols = cols * np.uint64(self.r) % p
        return cols.astype(np.uint32)

    def host_coset_domain(self, offset: int, omega: int, size: int):
        """numpy uint32 {offset * omega^i : i < size}."""
        pw = self.host_powers(omega, size).astype(np.uint64)
        return (pw * np.uint64(int(offset) % self.p)
                % np.uint64(self.p)).astype(np.uint32)

    def powers(self, base: int, count: int, device) -> torch.Tensor:
        """[base^0 .. base^(count-1)] canonical, as int64 on `device`."""
        return torch.from_numpy(
            self.host_powers(base, count).astype(np.int64)).to(device)

    def coset_domain(self, offset: int, omega: int, size: int, device):
        """{offset * omega^i} as int32 storage on `device`."""
        return upload_u32(self.host_coset_domain(offset, omega, size), device)


def upload_u32(arr, device) -> torch.Tensor:
    """numpy uint32 -> int32 storage tensor on `device`."""
    return torch.from_numpy(
        np.ascontiguousarray(arr, dtype=np.uint32).view(np.int32)).to(device)
