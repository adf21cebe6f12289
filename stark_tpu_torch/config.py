# Copied from stark_tpu/config.py (host-only), with its stark_tpu imports
# rewritten to the port: the port must not import stark_tpu, whose
# package init imports JAX.
"""Prover configuration.

The reference hardcodes its parameters (modulus as a Rust const generic,
reference: src/fields/element.rs:8; FRI layer size literally ``8192 >> i``,
reference: src/fri/fri_verify.rs:108).  Here everything is one explicit
config object; the modulus stays *static per jit* so XLA constant-folds the
Montgomery constants — the moral equivalent of const-generic
monomorphization.
"""

from __future__ import annotations

import dataclasses

# STARK-101 field: 3 * 2^30 + 1.  2-adic (2^30 roots of unity) so radix-2
# NTTs exist at every power-of-two size we care about.  The reference's
# bench prime 2^31 - 1 (benches/field_bench.rs:7) is NOT 2-adic and is
# supported for field/poly ops but not NTT-based paths.
DEFAULT_MODULUS = 3 * 2**30 + 1  # 3221225473
# Multiplicative generator of F_p^* for the default modulus.
DEFAULT_GENERATOR = 5

# Tiny 2-adic field for hand-checkable tests, mirroring the reference's
# GF(7) fixture strategy (SURVEY §4): 97 = 3 * 2^5 + 1 has 2^5 roots of unity.
TEST_MODULUS = 97
TEST_GENERATOR = 5  # 5 generates F_97^* (order 96).


@dataclasses.dataclass(frozen=True)
class ProverConfig:
    """All knobs of a STARK prove run.

    Replaces the reference's scattered hardcoded constants (SURVEY §5.6).
    """

    modulus: int = DEFAULT_MODULUS
    generator: int = DEFAULT_GENERATOR
    # Trace length is 2^log2_trace - 1 rows interpolated over a subgroup of
    # size 2^log2_trace (STARK-101 shape: 1023 rows over |G| = 1024).
    log2_trace: int = 10
    # LDE blowup factor (evaluation domain = blowup * 2^log2_trace).
    blowup: int = 8
    num_queries: int = 16
    # Offset of the evaluation coset (STARK-101 uses the field generator).
    coset_offset: int | None = None
    # Mesh shape for sharded proving; None = single device.
    mesh_shape: tuple[int, ...] | None = None
    mesh_axis_names: tuple[str, ...] = ("shard",)

    @property
    def trace_domain_size(self) -> int:
        return 1 << self.log2_trace

    @property
    def trace_length(self) -> int:
        return (1 << self.log2_trace) - 1

    @property
    def eval_domain_size(self) -> int:
        return self.blowup * self.trace_domain_size

    @property
    def offset(self) -> int:
        return self.generator if self.coset_offset is None else self.coset_offset

    def validate(self) -> None:
        p = self.modulus
        if p <= 2 or p % 2 == 0:
            raise ValueError(f"modulus must be an odd prime > 2, got {p}")
        if self.log2_trace < 2:
            raise ValueError(f"log2_trace must be >= 2, got {self.log2_trace}")
        b = self.blowup
        if b < 2 or (b & (b - 1)) != 0:
            raise ValueError(f"blowup must be a power of two >= 2, got {b}")
        if self.num_queries < 1:
            raise ValueError(f"num_queries must be >= 1, got {self.num_queries}")
        n = self.eval_domain_size
        if (p - 1) % n != 0:
            raise ValueError(
                f"field 2-adicity too small: eval domain {n} does not divide p-1={p - 1}"
            )
