"""The Goldilocks field p = 2^64 - 2^32 + 1 on torch limb planes
(counterpart of ``stark_tpu/fields/fp64.py``).

Representation, as in the JAX package: an element array has its limb
plane LEADING, ``(2,) + lanes`` with ``a[0]`` the high u32 word and
``a[1]`` the low, so every op indexes ``a[0]`` / ``a[1]`` and a ``(2,)``
pair (a drawn challenge) or a ``(2, 1)`` constant broadcasts against a
``(2, n)`` codeword plane by plane.  Storage is int32 holding the uint32
words (a JAX ``(2, n)`` uint32 array viewed as int32, see
``interop.limbs_to_tensor``); a C-column codeword is stored ``(C, 2, n)``
and moved to ``(2, C, n)`` for arithmetic.

Compute is int64 holding limbs in [0, 2^32), like ``fields/fp.py``: the
products go through ``_mulhilo32``'s 16-bit halves, and the 31 spare
bits of an int64 carry every add's overflow, so a carry is a shift, not
a compare.  The reduction uses 2^64 = 2^32 - 1 and 2^96 = -1 (mod p).
Every output is canonical, so results are bit-identical to the JAX
package's.

The "Montgomery domain" is the identity (``to_mont`` / ``from_mont``
return their input, ``r == 1``), as in JAX, so Montgomery-generic code
runs unchanged.  ``Fp.get`` dispatches the Goldilocks modulus here.
"""

from __future__ import annotations

import numpy as np
import torch

from stark_tpu_torch.fields.fp import (MASK32, _mulhilo32, doubling_table,
                                      host_words, lift, numpy_cat, torch_cat,
                                      tree_sum)

GOLDILOCKS = (1 << 64) - (1 << 32) + 1
# Fp64Goldilocks.powers multiplies at most this many entries at a time
POWERS_CHUNK = 1 << 22


def _pair(hi, lo):
    return torch.stack([hi, lo])


def _canon(hi, lo):
    """(hi, lo), both in [0, 2^32), reduced into [0, p): the value is
    below 2^64 < 2p, so at most one p comes off (p = (2^32 - 1, 1))."""
    ge = ((hi == MASK32) & (lo >= 1)).to(torch.int64)
    return _pair(hi * (1 - ge), lo - ge)


def _fold(hi, lo):
    """hi * 2^32 + lo mod p, for hi in [-2, 2^33 + 3) and lo in
    (-2^34, 2^34), as canonical limbs."""
    hi = hi + (lo >> 32)  # lo's carry or borrow (arithmetic shift)
    lo = lo & MASK32
    for _ in range(2):
        # hi's bits above 32 stand for t * 2^64 = t * (2^32 - 1)
        t = hi >> 32
        hi = hi & MASK32
        lo = lo + t * MASK32
        hi = hi + (lo >> 32)
        lo = lo & MASK32
    return _canon(hi, lo)


class Fp64Goldilocks:
    """Field context of the Goldilocks prime; duck-types ``Fp``.  Use
    ``Fp.get(GOLDILOCKS)`` (cached)."""

    width = 2  # u32 limbs an element

    def __init__(self, modulus: int = GOLDILOCKS):
        if int(modulus) != GOLDILOCKS:
            raise ValueError(
                f"Fp64Goldilocks supports only p = 2^64 - 2^32 + 1, got "
                f"{modulus}; other moduli >= 2^32 have no device path")
        self.p = GOLDILOCKS
        self.r = 1  # the identity "Montgomery" domain

    @staticmethod
    def get(modulus: int):
        from stark_tpu_torch.fields.fp import Fp

        return Fp.get(modulus)

    # -- construction -----------------------------------------------------
    def const(self, value: int, device=None) -> torch.Tensor:
        """A canonical constant as a (2, 1) int64 pair (broadcasts against
        any (2, ...) element array plane by plane)."""
        v = int(value) % self.p
        return torch.tensor([[v >> 32], [v & MASK32]], dtype=torch.int64,
                            device=device)

    def const_mont(self, value: int, device=None) -> torch.Tensor:
        return self.const(value, device)

    def ones_mont(self, count: int, device=None) -> torch.Tensor:
        """(2, count) int64 limb planes of 1."""
        return torch.stack([torch.zeros(count, dtype=torch.int64,
                                        device=device),
                            torch.ones(count, dtype=torch.int64,
                                       device=device)])

    def array(self, values, device=None) -> torch.Tensor:
        """Python ints -> (2,) + shape int64 limb planes."""
        flat = [int(v) % self.p
                for v in np.asarray(values, dtype=object).reshape(-1)]
        shape = np.shape(values)
        hi = np.asarray([v >> 32 for v in flat], dtype=np.int64)
        lo = np.asarray([v & MASK32 for v in flat], dtype=np.int64)
        return torch.from_numpy(np.stack([hi.reshape(shape),
                                          lo.reshape(shape)])).to(device)

    def to_ints(self, a) -> list[int]:
        """(2, ...) limb planes (tensor or array) -> Python ints, lanes
        flattened."""
        a = np.asarray(a.cpu() if torch.is_tensor(a) else a).astype(np.int64)
        hi, lo = a[0].reshape(-1) & MASK32, a[1].reshape(-1) & MASK32
        return [int(h) << 32 | int(l) for h, l in zip(hi, lo)]

    @staticmethod
    def arith(x: torch.Tensor) -> torch.Tensor:
        """Storage ((2, n), or (C, 2, n) for C columns) -> the layout the
        ops take, the limb plane leading ((2, C, n))."""
        return x.movedim(-2, 0)

    @staticmethod
    def storage(y: torch.Tensor) -> torch.Tensor:
        """An op's (2, ...) int64 result -> int32 storage, the limb plane
        back before the last axis."""
        return y.movedim(0, -2).to(torch.int32).contiguous()

    # -- canonical ops (inputs int32 storage or int64; output int64) ------
    def canon(self, a):
        """A (2,) + lanes pair of values in [0, 2^64) reduced into [0, p)."""
        return _canon(lift(a[0]), lift(a[1]))

    def add(self, a, b):
        alo, blo = lift(a[1]), lift(b[1])
        lo = alo + blo
        hi = lift(a[0]) + lift(b[0]) + (lo >> 32)
        lo = lo & MASK32
        # a + b < 2p: subtract p = (2^32 - 1, 1) once if it is reached
        ge = ((hi > MASK32) | ((hi == MASK32) & (lo >= 1))).to(torch.int64)
        lo = lo - ge
        hi = hi - ge * MASK32 + (lo >> 32)
        return _pair(hi, lo & MASK32)

    def sub(self, a, b):
        lo = lift(a[1]) - lift(b[1])
        hi = lift(a[0]) - lift(b[0]) + (lo >> 32)
        lo = lo & MASK32
        # a - b in (-p, p): add p once where it is negative
        neg = (hi < 0).to(torch.int64)
        lo = lo + neg
        hi = hi + neg * MASK32 + (lo >> 32)
        return _pair(hi, lo & MASK32)

    def neg(self, a):
        return self.sub(torch.zeros_like(lift(a)), a)

    def mul(self, a, b):
        """The 128-bit product as four 32-bit limbs c0..c3, reduced as
        c0 + c1 * 2^32 + c2 * (2^32 - 1) - c3."""
        ahi, alo = lift(a[0]), lift(a[1])
        bhi, blo = lift(b[0]), lift(b[1])
        h00, l00 = _mulhilo32(alo, blo)
        h01, l01 = _mulhilo32(alo, bhi)
        h10, l10 = _mulhilo32(ahi, blo)
        h11, l11 = _mulhilo32(ahi, bhi)
        t1 = h00 + l01 + l10
        t2 = h01 + h10 + l11 + (t1 >> 32)
        c2 = t2 & MASK32
        c3 = h11 + (t2 >> 32)
        return _fold((t1 & MASK32) + c2, l00 - c2 - c3)

    def sqr(self, a):
        return self.mul(a, a)

    def double(self, a):
        return self.add(a, a)

    # -- "Montgomery" domain (the identity) -------------------------------
    def mont_mul(self, a, b):
        return self.mul(a, b)

    def mont_sqr(self, a):
        return self.mul(a, a)

    def to_mont(self, a):
        return lift(a)

    def from_mont(self, a):
        return lift(a)

    @property
    def one_mont(self) -> int:
        return 1

    # -- powers / inversion -------------------------------------------------
    def pow_static(self, a, exp: int):
        """a ** exp for a Python-int exponent (square and multiply)."""
        exp = int(exp)
        if exp < 0:
            raise ValueError("negative exponent; invert first")
        a = lift(a)
        if exp == 0:
            return torch.stack([torch.zeros_like(a[0]),
                                torch.ones_like(a[0])])
        acc = None
        while exp:
            if exp & 1:
                acc = a if acc is None else self.mul(acc, a)
            exp >>= 1
            if exp:
                a = self.mul(a, a)
        return acc

    def inv(self, a):
        """Batched Fermat inverse a^(p-2), 0 mapping to 0."""
        return self.pow_static(a, self.p - 2)

    inv_rolled = inv  # the JAX version's fori_loop, as a loop

    def sum(self, a, axis=None):
        """Modular sum along a lane axis (all lanes when None) of
        (2,) + lanes limb planes; axis 0 is the limb plane."""
        a = lift(a)
        if axis is None:
            a, axis = a.reshape(2, -1), 1
        if axis == 0:
            raise ValueError("axis 0 is the limb plane")
        return tree_sum(self.add, a, axis)

    def geometric_table(self, ratios, count: int) -> torch.Tensor:
        """T[:, i, j] = ratios[:, i]^j: (2, m) limb planes in, (2, m,
        count) int64 out, on the ratios' device."""
        cur = lift(ratios)[..., None]
        ones = self.ones_mont(int(cur.shape[1]), cur.device)[..., None]
        return doubling_table(self.mul, torch_cat, ones, cur, count)

    # -- host tables (numpy uint64) ----------------------------------------
    @staticmethod
    def _np_mulmod(a, b):
        """(a * b) mod p on wrapping numpy uint64 (the JAX package's
        ``Fp64Goldilocks._np_mulmod``)."""
        m32 = np.uint64(MASK32)
        s32 = np.uint64(32)
        with np.errstate(over="ignore"):
            a0, a1 = a & m32, a >> s32
            b0, b1 = b & m32, b >> s32
            ll, lh, hl, hh = a0 * b0, a0 * b1, a1 * b0, a1 * b1
            m = lh + hl
            cm = (m < lh).astype(np.uint64)
            lo = ll + ((m & m32) << s32)
            cl = (lo < ll).astype(np.uint64)
            hi = hh + (m >> s32) + (cm << s32) + cl
            n1, n2 = hi & m32, hi >> s32
            t = lo - n2
            t = np.where(lo < n2, t - m32, t)  # 2^64 = 2^32 - 1 (mod p)
            r = t + n1 * m32
            r = np.where(r < t, r + m32, r)
            pp = np.uint64(GOLDILOCKS)
            return np.where(r >= pp, r - pp, r)

    def host_powers(self, base: int, count: int, mont: bool = False):
        """numpy uint32 (2, count) limb planes of [base^0 ..
        base^(count-1)] (mont is the identity here)."""
        base = int(base) % self.p
        out = np.ones(1, dtype=np.uint64)
        c = 1
        while c < count:
            out = np.concatenate(
                [out, self._np_mulmod(out, np.uint64(pow(base, c, self.p)))])
            c *= 2
        return host_words(out[:count], 2)

    def host_geometric_table(self, ratios, count: int, mont: bool = False):
        """numpy uint32 (2, m, count) limb planes of T[i, j] = r_i^j from
        (2, m) limb-pair ratios (mont is the identity here)."""
        r = np.asarray(ratios, dtype=np.uint64)
        r = ((r[0] << np.uint64(32)) | r[1])[..., None]
        cols = doubling_table(self._np_mulmod, numpy_cat, np.ones_like(r),
                              r, count)
        return np.stack([(cols >> np.uint64(32)).astype(np.uint32),
                         (cols & np.uint64(MASK32)).astype(np.uint32)])

    def powers(self, base: int, count: int, device) -> torch.Tensor:
        """(2, count) int64 [base^0 .. base^(count-1)] built on `device`:
        the outer product of two host tables of about sqrt(count)
        entries, one product on the device (as ``Fp.powers``)."""
        base = int(base) % self.p
        k = (max(count, 1).bit_length()) // 2
        cols = 1 << k
        lo = torch.from_numpy(self.host_powers(base, cols).astype(
            np.int64)).to(device)
        hi = torch.from_numpy(self.host_powers(
            pow(base, cols, self.p), -(-count // cols)).astype(
                np.int64)).to(device)
        nrows = int(hi.shape[1])
        out = torch.empty((2, nrows * cols), dtype=torch.int64, device=device)
        step = max(1, POWERS_CHUNK // cols)
        for r in range(0, nrows, step):
            out[:, r * cols:(r + step) * cols] = self.mul(
                hi[:, r:r + step, None], lo[:, None, :]).reshape(2, -1)
        return out[:, :count]

    def two_adic_root(self, order: int, generator: int) -> int:
        """A primitive `order`-th root of unity (host int)."""
        if (self.p - 1) % order != 0:
            raise ValueError(f"{order} does not divide p-1 = {self.p - 1}")
        return pow(int(generator), (self.p - 1) // order, self.p)

    def coset_domain(self, offset: int, omega: int, size: int, device):
        """{offset * omega^i} as (2, size) int32 storage, built on
        `device`."""
        pw = self.powers(omega, size, device)
        return self.mul(pw, self.const(offset, device)).to(torch.int32)
