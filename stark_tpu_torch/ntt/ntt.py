"""NTT/INTT and coset evaluation over GF(p) on torch tensors (counterpart
of ``stark_tpu/ntt/ntt.py`` + ``ntt/fourstep.py``).

:func:`ntt` / :func:`intt` go through the K1 wrapper
(``ntt/cuda_ntt.py``): a CUDA tensor of any power-of-two size up to 2^22
launches the kernel — the trace INTT included, which on the TPU took the
XLA plan because it ran inside an outer ``jax.jit`` — and a CPU tensor
runs ``ntt_plain``, the radix-2 Stockham dataflow of the JAX ``NTTPlan``
in torch ops.  Field arithmetic is exact, so every route gives the same
bits.
"""

from __future__ import annotations

import torch

from stark_tpu_torch.fields.fp import Fp, store
from stark_tpu_torch.ntt.cuda_ntt import ntt_two_step


def ntt(x: torch.Tensor, p: int) -> torch.Tensor:
    """Forward NTT, natural order: X[k] = sum_j x[j] w^(jk)."""
    return ntt_two_step(x, p, False)


def intt(x: torch.Tensor, p: int) -> torch.Tensor:
    """Inverse NTT (includes the n^-1 scale)."""
    return ntt_two_step(x, p, True)


def scale_pad(coeffs: torch.Tensor, p: int, big_n: int,
              offset: int) -> torch.Tensor:
    """coeffs[i] * offset^i, zero-padded to big_n (``_scale_pad_jit``)."""
    f = Fp.get(p)
    n = int(coeffs.shape[-1])
    out = torch.zeros(big_n, dtype=torch.int32, device=coeffs.device)
    out[:n] = store(f.mul(coeffs, f.powers(offset, n, coeffs.device)))
    return out


def coset_evaluate(coeffs: torch.Tensor, p: int, big_n: int,
                   offset: int) -> torch.Tensor:
    """Evaluate a coefficient vector on {offset * W^i : i < big_n}."""
    return ntt(scale_pad(coeffs, p, big_n, int(offset) % p), p)


def coset_interpolate(evals: torch.Tensor, p: int,
                      offset: int) -> torch.Tensor:
    """Coefficients of the polynomial whose values on {offset * w^i} are
    `evals` (inverse of :func:`coset_evaluate` at big_n == n)."""
    f = Fp.get(p)
    n = int(evals.shape[-1])
    offset_inv = pow(int(offset) % p, p - 2, p)
    return store(f.mul(intt(evals, p), f.powers(offset_inv, n, evals.device)))
