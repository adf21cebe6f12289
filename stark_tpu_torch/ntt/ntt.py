"""NTT/INTT and coset evaluation over GF(p) on torch tensors (counterpart
of ``stark_tpu/ntt/ntt.py`` + ``ntt/fourstep.py``).

:func:`ntt` / :func:`intt` go through the kernel wrappers
(``ntt/cuda_ntt.py``): n <= 2^MAX_LOG_N (2^22) by the K1 route, larger n
(up to 2^30) by the K2 route (read at call time); both launch the same
two-pass kernels.  A CUDA tensor launches them — the trace INTT included,
which on the TPU took the XLA plan because it ran inside an outer
``jax.jit`` — and a CPU tensor runs their plain version
``ntt_passes_plain``.  Field arithmetic is exact, so every route gives
the same bits as the JAX ``NTTPlan``.  Every function takes an (n,)
vector or a (C, n) batch of columns (a multi-column trace), transformed
along the last axis in one call of the wrapper.
"""

from __future__ import annotations

import torch

from stark_tpu_torch.fields.fp import Fp, store
from stark_tpu_torch.ntt import cuda_ntt
from stark_tpu_torch.ntt.cuda_ntt import ntt_k1, ntt_k2


def _transform(x: torch.Tensor, p: int, inverse: bool) -> torch.Tensor:
    if int(x.shape[-1]) <= 1 << cuda_ntt.MAX_LOG_N:
        return ntt_k1(x, p, inverse)
    return ntt_k2(x, p, inverse)


def ntt(x: torch.Tensor, p: int) -> torch.Tensor:
    """Forward NTT, natural order: X[k] = sum_j x[j] w^(jk), of an (n,)
    vector or of each row of a (C, n) batch of columns."""
    return _transform(x, p, False)


def intt(x: torch.Tensor, p: int) -> torch.Tensor:
    """Inverse NTT (includes the n^-1 scale)."""
    return _transform(x, p, True)


def scale_pad(coeffs: torch.Tensor, p: int, big_n: int,
              offset: int) -> torch.Tensor:
    """coeffs[..., i] * offset^i, zero-padded to big_n along the last axis
    (``_scale_pad_jit``)."""
    f = Fp.get(p)
    n = int(coeffs.shape[-1])
    out = torch.zeros(coeffs.shape[:-1] + (big_n,), dtype=torch.int32,
                      device=coeffs.device)
    out[..., :n] = store(f.mul(coeffs, f.powers(offset, n, coeffs.device)))
    return out


def coset_evaluate(coeffs: torch.Tensor, p: int, big_n: int,
                   offset: int) -> torch.Tensor:
    """Evaluate a coefficient vector (or each row of a (C, n) batch) on
    {offset * W^i : i < big_n}."""
    return ntt(scale_pad(coeffs, p, big_n, int(offset) % p), p)


def coset_interpolate(evals: torch.Tensor, p: int,
                      offset: int) -> torch.Tensor:
    """Coefficients of the polynomial whose values on {offset * w^i} are
    `evals` (inverse of :func:`coset_evaluate` at big_n == n)."""
    f = Fp.get(p)
    n = int(evals.shape[-1])
    offset_inv = pow(int(offset) % p, p - 2, p)
    return store(f.mul(intt(evals, p), f.powers(offset_inv, n, evals.device)))
