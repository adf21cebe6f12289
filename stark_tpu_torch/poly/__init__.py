# Copied from stark_tpu/poly/__init__.py (host-only), with its stark_tpu imports
# rewritten to the port: the port must not import stark_tpu, whose
# package init imports JAX.
from stark_tpu_torch.poly.ops import Polynomial, poly
from stark_tpu_torch.poly.interpolation import (
    gen_polynomial_from_roots,
    gen_lagrange_polynomials,
    interpolate_lagrange,
)

__all__ = [
    "Polynomial",
    "poly",
    "gen_polynomial_from_roots",
    "gen_lagrange_polynomials",
    "interpolate_lagrange",
]
