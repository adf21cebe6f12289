# Copied from stark_tpu/poly/ops.py (host-only), with its stark_tpu imports
# rewritten to the port: the port must not import stark_tpu, whose
# package init imports JAX.
"""Dense coefficient-form polynomials — host oracle + API parity layer.

Mirrors the reference's ``Polynomial<const M: u64>``
(reference: src/polynomial/ops.rs:10-548): dense low-to-high coefficient
vector, trailing zeros trimmed, degree == -1 for the zero polynomial,
Horner evaluation, long division, Horner-in-the-exponent composition, and
the callable sugar (``p(x)`` evaluates, ``p(q)`` composes — the nightly
Fn-trait impls at ops.rs:490-530).

This is NOT the TPU compute path.  The framework works in evaluation form
on 2-adic cosets (see stark_tpu_torch.ntt); this class exists as the algebra
oracle for tests, for small host-side manipulations (e.g. building the
FRI final polynomial), and for API parity with the reference.  Heavy ops
delegate to numpy (vectorized u64) when the modulus permits, and ``mul``
upgrades from schoolbook to NTT when both the size warrants it and the
field is 2-adic enough — fixing the reference's O(n^2) hot spot
(ops.rs:114-138, the 280 ms deg-1000 mul in BASELINE.md).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from stark_tpu_torch.fields.element import FieldElement

_NTT_MUL_THRESHOLD = 128  # total coeff count above which mul tries NTT


def _coerce(value, modulus: int) -> int:
    if isinstance(value, FieldElement):
        if value.modulus != modulus:
            raise ValueError("field mismatch")
        return value.value
    return int(value) % modulus


class Polynomial:
    """Polynomial over GF(modulus), low-to-high coefficients."""

    __slots__ = ("coeffs", "modulus")

    def __init__(self, coeffs: Sequence, modulus: int):
        vals = [_coerce(c, modulus) for c in coeffs]
        while vals and vals[-1] == 0:  # trim (ops.rs:19-37)
            vals.pop()
        self.coeffs = vals
        self.modulus = modulus

    # -- constructors -----------------------------------------------------
    @classmethod
    def zero(cls, modulus: int) -> "Polynomial":
        return cls([], modulus)

    @classmethod
    def one(cls, modulus: int) -> "Polynomial":
        return cls([1], modulus)

    @classmethod
    def x(cls, modulus: int) -> "Polynomial":
        return cls([0, 1], modulus)

    @classmethod
    def monomial(cls, degree: int, coeff, modulus: int) -> "Polynomial":
        return cls([0] * degree + [_coerce(coeff, modulus)], modulus)

    @classmethod
    def from_iter(cls, it: Iterable, modulus: int) -> "Polynomial":
        return cls(list(it), modulus)

    @classmethod
    def random(cls, degree: int, modulus: int, rng=None) -> "Polynomial":
        rng = rng or np.random.default_rng()
        c = rng.integers(0, modulus, size=degree + 1, dtype=np.uint64).tolist()
        if c and c[-1] == 0:
            c[-1] = 1  # ensure exact degree, like ops.rs:542-548
        return cls(c, modulus)

    # -- basics -----------------------------------------------------------
    @property
    def degree(self) -> int:
        """-1 for the zero polynomial (ops.rs:10-13 isize convention)."""
        return len(self.coeffs) - 1

    def is_zero(self) -> bool:
        return not self.coeffs

    def __len__(self) -> int:
        return len(self.coeffs)

    def __getitem__(self, i: int) -> int:
        return self.coeffs[i] if 0 <= i < len(self.coeffs) else 0

    def __eq__(self, other) -> bool:
        if not isinstance(other, Polynomial):
            return NotImplemented
        return self.modulus == other.modulus and self.coeffs == other.coeffs

    def __hash__(self):
        return hash((tuple(self.coeffs), self.modulus))

    def __repr__(self) -> str:
        return f"Poly[GF({self.modulus})]({self.coeffs})"

    def _check(self, other: "Polynomial"):
        if self.modulus != other.modulus:
            raise ValueError("field mismatch")

    # -- evaluation -------------------------------------------------------
    def evaluate(self, x) -> FieldElement:
        """Horner, O(n) (ops.rs:76-83)."""
        p = self.modulus
        xv = _coerce(x, p)
        acc = 0
        for c in reversed(self.coeffs):
            acc = (acc * xv + c) % p
        return FieldElement(acc, p)

    def evaluate_batch(self, xs: np.ndarray) -> np.ndarray:
        """Vectorized Horner over many points (host, numpy u64)."""
        p = self.modulus
        if p >= 1 << 32:
            return np.array([self.evaluate(int(x)).value for x in xs], dtype=object)
        xs = np.asarray(xs, dtype=np.uint64) % p
        acc = np.zeros_like(xs)
        for c in reversed(self.coeffs):
            acc = (acc * xs + np.uint64(c)) % np.uint64(p)
        return acc

    # -- ring ops ---------------------------------------------------------
    def __add__(self, other) -> "Polynomial":
        if isinstance(other, (int, FieldElement)):
            other = Polynomial([other], self.modulus)
        self._check(other)
        n = max(len(self.coeffs), len(other.coeffs))
        return Polynomial(
            [(self[i] + other[i]) % self.modulus for i in range(n)], self.modulus
        )

    __radd__ = __add__

    def __sub__(self, other) -> "Polynomial":
        if isinstance(other, (int, FieldElement)):
            other = Polynomial([other], self.modulus)
        self._check(other)
        n = max(len(self.coeffs), len(other.coeffs))
        return Polynomial(
            [(self[i] - other[i]) % self.modulus for i in range(n)], self.modulus
        )

    def __rsub__(self, other) -> "Polynomial":
        return Polynomial([other], self.modulus) - self

    def __neg__(self) -> "Polynomial":
        return Polynomial([-c % self.modulus for c in self.coeffs], self.modulus)

    def scalar_mul(self, s) -> "Polynomial":
        sv = _coerce(s, self.modulus)
        return Polynomial([c * sv % self.modulus for c in self.coeffs], self.modulus)

    def scalar_div(self, s) -> "Polynomial":
        sv = _coerce(s, self.modulus)
        inv = pow(sv, self.modulus - 2, self.modulus)
        return self.scalar_mul(inv)

    def __mul__(self, other) -> "Polynomial":
        if isinstance(other, (int, FieldElement)):
            return self.scalar_mul(other)
        self._check(other)
        if self.is_zero() or other.is_zero():
            return Polynomial.zero(self.modulus)
        p = self.modulus
        na, nb = len(self.coeffs), len(other.coeffs)
        if na + nb > _NTT_MUL_THRESHOLD and p < 1 << 32:
            out = _try_ntt_mul(self.coeffs, other.coeffs, p)
            if out is not None:
                # values are already canonical ints — skip re-coercion
                while out and out[-1] == 0:
                    out.pop()
                prod = Polynomial.__new__(Polynomial)
                prod.coeffs = out
                prod.modulus = p
                return prod
        # schoolbook with exact Python ints (oracle-grade; cf. ops.rs:114-138)
        out = [0] * (na + nb - 1)
        for i, a in enumerate(self.coeffs):
            if a == 0:
                continue
            for j, b in enumerate(other.coeffs):
                out[i + j] = (out[i + j] + a * b) % p
        return Polynomial(out, p)

    __rmul__ = __mul__

    def __divmod__(self, other) -> tuple["Polynomial", "Polynomial"]:
        """Long division (ops.rs:141-191)."""
        self._check(other)
        if other.is_zero():
            raise ZeroDivisionError("polynomial division by zero")
        p = self.modulus
        if self.degree < other.degree:
            return Polynomial.zero(p), self
        rem = list(self.coeffs)
        q = [0] * (self.degree - other.degree + 1)
        dlead_inv = pow(other.coeffs[-1], p - 2, p)
        db = other.degree
        for k in range(len(q) - 1, -1, -1):
            c = rem[k + db] * dlead_inv % p
            q[k] = c
            if c:
                for j, b in enumerate(other.coeffs):
                    rem[k + j] = (rem[k + j] - c * b) % p
        return Polynomial(q, p), Polynomial(rem, p)

    def div_rem(self, other):
        return divmod(self, other)

    def __floordiv__(self, other) -> "Polynomial":
        return divmod(self, other)[0]

    def __truediv__(self, other) -> "Polynomial":
        """Exact division; raises if remainder nonzero (ops.rs:412-421
        panics — we raise)."""
        if isinstance(other, (int, FieldElement)):
            return self.scalar_div(other)
        q, r = divmod(self, other)
        if not r.is_zero():
            raise ValueError("non-exact polynomial division")
        return q

    def __mod__(self, other) -> "Polynomial":
        return divmod(self, other)[1]

    def __pow__(self, n: int) -> "Polynomial":
        if n < 0:
            raise ValueError("negative polynomial power")
        result = Polynomial.one(self.modulus)
        base = self
        while n:
            if n & 1:
                result = result * base
            base = base * base
            n >>= 1
        return result

    def compose(self, other: "Polynomial") -> "Polynomial":
        """self(other(x)).

        Fast path: evaluate `other` on a 2-adic domain covering the result
        degree (NTT), batch-Horner `self` over those values (numpy u64),
        interpolate back (INTT) — O(d_a * n + n log n) vs the reference's
        Horner-in-the-exponent with full polynomial products
        (ops.rs:212-237, 16 ms at deg 100; this is ~3 ms at deg 100 *over
        a 2^30-adic field*).  Falls back to the reference algorithm for
        fields without enough 2-adicity.
        """
        self._check(other)
        p = self.modulus
        if not self.is_zero() and other.degree >= 1 and p < 1 << 32:
            from stark_tpu_torch.ntt.reference_ntt import ntt_available, ntt_host

            res_deg = self.degree * other.degree
            n = 1
            while n <= res_deg:
                n *= 2
            if n > 64 and ntt_available(p, n):
                pp = np.uint64(p)
                b_pad = np.zeros(n, dtype=np.uint64)
                b_pad[: len(other.coeffs)] = np.asarray(other.coeffs, dtype=np.uint64)
                b_vals = ntt_host(b_pad, p)
                acc = np.zeros(n, dtype=np.uint64)
                for c in reversed(self.coeffs):
                    acc = (acc * b_vals + np.uint64(c)) % pp
                out = ntt_host(acc, p, inverse=True)
                poly = Polynomial.__new__(Polynomial)
                coeffs = out[: res_deg + 1].tolist()
                while coeffs and coeffs[-1] == 0:
                    coeffs.pop()
                poly.coeffs = coeffs
                poly.modulus = p
                return poly
        acc = Polynomial.zero(p)
        for c in reversed(self.coeffs):
            acc = acc * other + Polynomial([c], p)
        return acc

    def __call__(self, arg):
        """p(x) evaluates, p(q) composes (ops.rs:490-530 Fn impls)."""
        if isinstance(arg, Polynomial):
            return self.compose(arg)
        return self.evaluate(arg)

    # -- conversions ------------------------------------------------------
    def to_u32(self) -> np.ndarray:
        if self.modulus >= 1 << 32:
            raise ValueError("modulus too large for u32 device arrays")
        return np.asarray(self.coeffs, dtype=np.uint32)

    @classmethod
    def interpolate(cls, xs, ys, modulus: int) -> "Polynomial":
        from stark_tpu_torch.poly.interpolation import interpolate_lagrange

        return interpolate_lagrange(xs, ys, modulus)


def _try_ntt_mul(a: list[int], b: list[int], p: int):
    """NTT-based product when the field has enough 2-adicity, else None."""
    from stark_tpu_torch.ntt.reference_ntt import ntt_available, ntt_mul_host

    n = 1
    need = len(a) + len(b) - 1
    while n < need:
        n *= 2
    if not ntt_available(p, n):
        return None
    return ntt_mul_host(a, b, p, n)


def poly(coeffs: Sequence, modulus: int) -> Polynomial:
    """Terse constructor, analog of the reference's ``poly!`` macro
    (src/utils.rs:5-10)."""
    return Polynomial(coeffs, modulus)
