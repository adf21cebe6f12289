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

Width 1 (2 < p < 2^32) here; :meth:`Fp.get` dispatches the Goldilocks
prime 2^64 - 2^32 + 1 to the width-2 context of ``fields/fp64.py`` and
refuses every other modulus >= 2^32, as the JAX package does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
# Fp.powers multiplies at most this many entries at a time: the int64
# temporaries of a Montgomery product stay near 10 x 32 MB, not 10 x
# 8 * count bytes (a 2^26-entry coset domain)
POWERS_CHUNK = 1 << 22


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


def tree_sum(add, a: torch.Tensor, axis: int) -> torch.Tensor:
    """Modular sum of `a` along `axis` by pairwise halving with the
    field's `add` (the JAX ``Fp.sum``), the axis squeezed."""
    n = int(a.shape[axis])
    while n > 1:
        half = n // 2
        s = add(a.narrow(axis, 0, half), a.narrow(axis, half, half))
        if n % 2:
            s = torch.cat([s, a.narrow(axis, 2 * half, 1)], dim=axis)
        a, n = s, int(s.shape[axis])
    return a.squeeze(axis)


def doubling_table(mul, cat, ones, ratio, count: int):
    """`ones` times ratio^j for j < count, along the last axis, by
    doubling: each step appends the table times ratio^(2^k).  `mul` is
    the field's product and `cat` joins along the last axis (torch or
    numpy), so one loop serves the tables of both fields and both
    sides."""
    c = 1
    while c < count:
        ones = cat([ones, mul(ones, ratio)])[..., :count]
        ratio = mul(ratio, ratio)
        c *= 2
    return ones


def torch_cat(parts):
    return torch.cat(parts, dim=-1)


def numpy_cat(parts):
    return np.concatenate(parts, axis=-1)


@functools.lru_cache(maxsize=None)
def _get(modulus: int):
    p = int(modulus)
    if p >= 1 << 32:
        from stark_tpu_torch.fields.fp64 import GOLDILOCKS, Fp64Goldilocks

        if p == GOLDILOCKS:
            return Fp64Goldilocks(p)
        raise ValueError(
            f"no device path for modulus {p} >= 2^32 (only the Goldilocks "
            "prime 2^64 - 2^32 + 1 is supported above 32 bits)")
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
            raise ValueError(f"Fp is the width-1 context (p < 2^32), got "
                             f"{p}; Fp.get dispatches Goldilocks")
        self.p = p
        self.ninv = (-pow(p, -1, 1 << 32)) % (1 << 32)  # -p^-1 mod 2^32
        self.r = (1 << 32) % p  # mont(1)
        self.r2 = self.r * self.r % p

    # -- layout (width-generic callers) -------------------------------------
    def const(self, value: int, device=None) -> torch.Tensor:
        """A canonical constant as a 0-dim int64 tensor."""
        return torch.tensor(int(value) % self.p, device=device)

    def const_mont(self, value: int, device=None) -> torch.Tensor:
        """mont(value) as a 0-dim int64 tensor (width-generic plan code)."""
        return torch.tensor(int(value) % self.p * self.r % self.p,
                            device=device)

    def ones_mont(self, count: int, device=None) -> torch.Tensor:
        """(count,) int64 of mont(1), a width-generic twiddle filler."""
        return torch.full((count,), self.r, dtype=torch.int64,
                          device=device)

    @property
    def one_mont(self) -> int:
        return self.r

    def array(self, values, device=None) -> torch.Tensor:
        """A flat sequence of Python ints -> int64 canonical values (the
        width-1 counterpart of ``Fp64Goldilocks.array``)."""
        return torch.tensor([int(v) % self.p for v in values],
                            dtype=torch.int64, device=device)

    @staticmethod
    def to_ints(arr) -> list[int]:
        """Storage words or values (a tensor or an array) -> Python ints,
        flattened, each word read unsigned."""
        a = np.asarray(arr.cpu() if torch.is_tensor(arr) else arr)
        return [int(v) & MASK32 for v in a.astype(np.int64).reshape(-1)]

    @staticmethod
    def arith(x: torch.Tensor) -> torch.Tensor:
        """Storage -> the layout the ops take (the same, width 1)."""
        return x

    @staticmethod
    def storage(y: torch.Tensor) -> torch.Tensor:
        """An op's int64 result -> int32 storage."""
        return store(y)

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

    def sqr(self, a):
        return self.mul(a, a)

    def double(self, a):
        return self.add(a, a)

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

    def mont_sqr(self, a):
        return self.mont_mul(a, a)

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

    def pow(self, a, exp):
        """a ** exp for an exponent tensor of uint32 words (the shape of
        `a`): 32 square-and-multiply rounds in the Montgomery domain."""
        am = self.to_mont(a)
        e = lift(exp)
        acc = torch.full_like(am, self.r)
        for _ in range(32):
            acc = torch.where((e & 1) == 1, self.mont_mul(acc, am), acc)
            am = self.mont_mul(am, am)
            e = e >> 1
        return self.from_mont(acc)

    def inv(self, a):
        """Batched Fermat inverse a^(p-2) (0 maps to 0, as in JAX)."""
        return self.pow_static(a, self.p - 2)

    # the JAX version rolls the chain into a fori_loop for program size;
    # eager torch has no program, so it is the same chain
    inv_rolled = inv

    def sum(self, a, axis=None):
        """Modular sum along `axis` (all values when None)."""
        a = lift(a)
        if axis is None:
            a, axis = a.reshape(-1), 0
        return tree_sum(self.add, a, axis)

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
        r = np.asarray(ratios, dtype=np.uint64)[..., None] % p
        cols = doubling_table(lambda a, b: a * b % p, numpy_cat,
                              np.ones_like(r), r, count)
        if mont:
            cols = cols * np.uint64(self.r) % p
        return cols.astype(np.uint32)

    def geometric_table(self, ratios, count: int) -> torch.Tensor:
        """T[i, j] = ratios[i]^j for j < count, int64 on the ratios'
        device: (m,) canonical in, (m, count) out (batched doubling)."""
        rm = self.to_mont(ratios)[..., None]
        return self.from_mont(doubling_table(
            self.mont_mul, torch_cat, torch.full_like(rm, self.r), rm,
            count))

    def powers(self, base: int, count: int, device) -> torch.Tensor:
        """[base^0 .. base^(count-1)] canonical, as int64 built on `device`:
        the outer product base^(i*2^k) * base^j of two host tables of about
        sqrt(count) entries, one Montgomery product on the device (the JAX
        ``Fp.powers`` doubles on the device; the values are the same).  No
        count-entry table is built on the host or uploaded."""
        base = int(base) % self.p
        k = (max(count, 1).bit_length()) // 2
        cols = 1 << k
        lo = self.host_powers(base, cols, mont=True)
        hi = self.host_powers(pow(base, cols, self.p), -(-count // cols))
        lo_t = torch.from_numpy(lo.astype(np.int64)).to(device)
        hi_t = torch.from_numpy(hi.astype(np.int64)).to(device)
        out = torch.empty(len(hi) * cols, dtype=torch.int64, device=device)
        rows = max(1, POWERS_CHUNK // cols)
        for r in range(0, len(hi), rows):
            out[r * cols:(r + rows) * cols] = self.mont_mul(
                hi_t[r:r + rows, None], lo_t[None, :]).reshape(-1)
        return out[:count]

    def two_adic_root(self, order: int, generator: int) -> int:
        """A primitive `order`-th root of unity (host int)."""
        if (self.p - 1) % order != 0:
            raise ValueError(f"{order} does not divide p-1 = {self.p - 1}")
        return pow(int(generator), (self.p - 1) // order, self.p)

    def coset_domain(self, offset: int, omega: int, size: int, device):
        """{offset * omega^i} as int32 storage, built on `device`."""
        pw = self.powers(omega, size, device)
        return store(self.mul(pw, torch.full_like(pw, int(offset) % self.p)))


@functools.lru_cache(maxsize=None)
def device_const(p: int, value: int, device: str) -> torch.Tensor:
    """``Fp.get(p).const(value, device)`` built once per (field, value,
    device): each ``const`` call is an upload, which a CUDA graph capture
    (the single-dispatch prove, ``stark/prover.py``) refuses."""
    return _get(p).const(value, torch.device(device))


def upload_u32(arr, device) -> torch.Tensor:
    """numpy uint32 -> int32 storage tensor on `device`."""
    return torch.from_numpy(
        np.ascontiguousarray(arr, dtype=np.uint32).view(np.int32)).to(device)


def host_words(values, width: int) -> np.ndarray:
    """Field values (numpy uint64, the trace axis last) -> numpy uint32 in
    the storage layout of a field of `width` limbs: the same shape for
    width 1; for width 2 the (hi, lo) limb planes right before the trace
    axis, (n,) -> (2, n) and (C, n) -> (C, 2, n) (the JAX layout,
    ``stark_tpu/stark/trace.py``).  :func:`upload_u32` uploads either."""
    v = np.asarray(values, dtype=np.uint64)
    if width == 1:
        return v.astype(np.uint32)
    return np.stack([(v >> np.uint64(32)).astype(np.uint32),
                     (v & np.uint64(MASK32)).astype(np.uint32)], axis=-2)


def host_values(words, width: int) -> np.ndarray:
    """The inverse of :func:`host_words`: storage words -> numpy uint64
    field values, the trace axis last."""
    w = np.asarray(words).astype(np.uint32).astype(np.uint64)
    if width == 1:
        return w
    return (w[..., 0, :] << np.uint64(32)) | w[..., 1, :]
