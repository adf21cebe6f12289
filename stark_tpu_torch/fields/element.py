# Copied from stark_tpu/fields/element.py (host-only), with its stark_tpu imports
# rewritten to the port: the port must not import stark_tpu, whose
# package init imports JAX.
"""Scalar prime-field element — the host-side bit-exactness oracle.

Mirrors the reference's ``FieldElement<const MODULUS: u64>``
(reference: src/fields/element.rs:8-147) semantically:

* construction reduces mod p (element.rs:13-17)
* ``pow`` is square-and-multiply (element.rs:38-51)
* ``inverse`` is Fermat: a^(p-2) (element.rs:53-57)
* ``to_bytes`` is the **8-byte big-endian** canonical value
  (element.rs:59-61) — this encoding is what the whole transcript and
  Merkle layer hash, so it is frozen here.

Python ints are arbitrary precision, so unlike the reference this scalar
mirror is correct for any modulus (the reference's ``pow`` silently
overflows for moduli >= 2^32, element.rs:47 — we do not replicate bugs
that live outside the serialized transcript).

This class is NOT the compute path.  Device math lives in
``stark_tpu_torch.fields.fp`` as batched int32 tensors; this mirror exists for
transcripts, tests, and tiny host-side glue.
"""

from __future__ import annotations

import secrets


class FieldElement:
    """An element of GF(modulus). Immutable."""

    __slots__ = ("value", "modulus")

    def __init__(self, value: int, modulus: int):
        if modulus <= 1:
            raise ValueError(f"modulus must be > 1, got {modulus}")
        object.__setattr__(self, "modulus", modulus)
        object.__setattr__(self, "value", value % modulus)

    def __setattr__(self, *a):  # immutability
        raise AttributeError("FieldElement is immutable")

    # -- constructors -----------------------------------------------------
    @classmethod
    def zero(cls, modulus: int) -> "FieldElement":
        return cls(0, modulus)

    @classmethod
    def one(cls, modulus: int) -> "FieldElement":
        return cls(1, modulus)

    @classmethod
    def random(cls, modulus: int) -> "FieldElement":
        # OS entropy like the reference (element.rs:31-35); modulo bias is
        # irrelevant for its uses (tests / nonce-ish values).
        return cls(secrets.randbelow(modulus), modulus)

    # -- arithmetic -------------------------------------------------------
    def _check(self, other: "FieldElement") -> None:
        if self.modulus != other.modulus:
            raise ValueError(f"field mismatch: {self.modulus} vs {other.modulus}")

    def __add__(self, other: "FieldElement") -> "FieldElement":
        self._check(other)
        return FieldElement(self.value + other.value, self.modulus)

    def __sub__(self, other: "FieldElement") -> "FieldElement":
        self._check(other)
        return FieldElement(self.value - other.value, self.modulus)

    def __mul__(self, other: "FieldElement") -> "FieldElement":
        self._check(other)
        return FieldElement(self.value * other.value, self.modulus)

    def __truediv__(self, other: "FieldElement") -> "FieldElement":
        self._check(other)
        return self * other.inverse()

    def __neg__(self) -> "FieldElement":
        return FieldElement(-self.value, self.modulus)

    def pow(self, exp: int) -> "FieldElement":
        if exp < 0:
            return self.inverse().pow(-exp)
        return FieldElement(pow(self.value, exp, self.modulus), self.modulus)

    __pow__ = pow

    def inverse(self) -> "FieldElement":
        if self.modulus <= 2:
            raise ValueError("modulus must be > 2 for inverse")
        if self.value == 0:
            raise ZeroDivisionError("inverse of zero")
        return FieldElement(pow(self.value, self.modulus - 2, self.modulus), self.modulus)

    # -- encoding ---------------------------------------------------------
    def to_bytes(self) -> bytes:
        """8-byte big-endian canonical value (element.rs:59-61)."""
        return self.value.to_bytes(8, "big")

    @classmethod
    def from_bytes(cls, data: bytes, modulus: int) -> "FieldElement":
        """Inverse of :meth:`to_bytes` (the API the reference's disabled
        verifier called but never defined, fri_verify.rs:58)."""
        return cls(int.from_bytes(data, "big"), modulus)

    # -- dunder glue ------------------------------------------------------
    def __eq__(self, other: object) -> bool:
        if isinstance(other, FieldElement):
            return self.modulus == other.modulus and self.value == other.value
        if isinstance(other, int):
            return self.value == other % self.modulus
        return NotImplemented

    def __hash__(self) -> int:
        return hash((self.value, self.modulus))

    def __int__(self) -> int:
        return self.value

    def __repr__(self) -> str:
        return f"F{self.modulus}({self.value})"


def fe(value: int, modulus: int) -> FieldElement:
    """Terse constructor, analog of the reference's ``fe!`` macro
    (reference: src/utils.rs:12-17)."""
    return FieldElement(value, modulus)
