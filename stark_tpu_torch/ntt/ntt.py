"""NTT/INTT and coset evaluation over GF(p) on torch tensors (counterpart
of ``stark_tpu/ntt/ntt.py`` + ``ntt/fourstep.py``).

The route is chosen by the field's width, never by a failure:

* a u32 field goes through the kernel wrappers (``ntt/cuda_ntt.py``):
  n <= 2^MAX_LOG_N (2^22) by the K1 route, larger n (up to 2^30) by the
  K2 route (read at call time); both launch the same two-pass kernels.
  A CUDA tensor launches them — the trace INTT included, which on the
  TPU took the XLA plan because it ran inside an outer ``jax.jit`` — and
  a CPU tensor runs their plain version ``ntt_passes_plain``;
* the Goldilocks field: a CUDA tensor launches the 64-bit two-pass
  kernels (``ntt/cuda_ntt64.py``, any n up to 2^28), a CPU tensor runs
  :func:`ntt_limbs`, a radix-2 Stockham in torch ops on the limb planes
  and the kernels' plain reference.  The JAX package computes that NTT
  outside any Pallas kernel (the width-generic XLA Stockham /
  four-step), so the kernels port no TPU kernel.

Field arithmetic is exact, so every route gives the same bits as the JAX
``NTTPlan``.  Every function takes one column ((n,) u32, (2, n)
Goldilocks) or C columns ((C, n), (C, 2, n)), transformed along the last
axis in one call.
"""

from __future__ import annotations

import torch

from stark_tpu_torch import _build
from stark_tpu_torch.fields.fp import Fp
from stark_tpu_torch.ntt import cuda_ntt
from stark_tpu_torch.ntt.cuda_ntt import _stage_twiddles, ntt_k1, ntt_k2
from stark_tpu_torch.ntt.cuda_ntt64 import ntt64
from stark_tpu_torch.ntt.reference_ntt import ntt_available


def ntt_limbs(x: torch.Tensor, p: int, inverse: bool = False):
    """NTT (or INTT) of Goldilocks values in torch ops: x is (2, n) or
    (C, 2, n) int32 limb planes, natural order in and out; radix-2
    Stockham autosort along the last axis (the JAX ``NTTPlan``'s
    dataflow), the columns a batch dimension."""
    f = Fp.get(p)
    n = int(x.shape[-1])
    if n & (n - 1) or not ntt_available(p, n):
        raise ValueError(f"GF({p}) has no order-{n} subgroup")
    xm = f.arith(x)  # (2, [C,] n)
    batch = tuple(xm.shape[1:-1])
    l, m = n, 1
    for t in _stage_twiddles(p, n, inverse, str(x.device)):
        lh = l // 2
        v = xm.reshape((2,) + batch + (l, m))
        a, b = v[..., :lh, :], v[..., lh:, :]
        tw = t.reshape((2,) + (1,) * len(batch) + (lh, 1))
        xm = torch.stack([f.add(a, b), f.mul(tw, f.sub(a, b))],
                         dim=-2).reshape((2,) + batch + (n,))
        l, m = lh, 2 * m
    if inverse:
        xm = f.mul(xm, f.const(pow(n, p - 2, p), x.device))
    return f.storage(xm)


def _transform(x: torch.Tensor, p: int, inverse: bool) -> torch.Tensor:
    if Fp.get(p).width > 1:
        if _build.plain_device(x):
            return ntt_limbs(x, p, inverse)
        return ntt64(x, p, inverse)
    if int(x.shape[-1]) <= 1 << cuda_ntt.MAX_LOG_N:
        return ntt_k1(x, p, inverse)
    return ntt_k2(x, p, inverse)


def ntt(x: torch.Tensor, p: int) -> torch.Tensor:
    """Forward NTT, natural order: X[k] = sum_j x[j] w^(jk), of one column
    or of each of C columns."""
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
    out[..., :n] = f.storage(f.mul(f.arith(coeffs),
                                   f.powers(offset, n, coeffs.device)))
    return out


def coset_evaluate(coeffs: torch.Tensor, p: int, big_n: int,
                   offset: int) -> torch.Tensor:
    """Evaluate a coefficient vector (or each of C columns) on
    {offset * W^i : i < big_n}."""
    return ntt(scale_pad(coeffs, p, big_n, int(offset) % p), p)


def lde(values: torch.Tensor, p: int, blowup: int,
        offset: int) -> torch.Tensor:
    """Low-degree extension: read `values` (one column or C columns) as
    evaluations on the size-n subgroup (natural w^i order) and return the
    same polynomial's evaluations on the coset {offset * W^i} of size
    blowup * n, W the canonical primitive (blowup * n)-th root.  An INTT
    and a coset evaluation: on a CUDA u32 tensor two launches of K1 or K2
    each, by their sizes; on a CUDA Goldilocks tensor two launches of the
    64-bit kernels."""
    n = int(values.shape[-1])
    return coset_evaluate(intt(values, p), p, blowup * n, int(offset) % p)


def coset_interpolate(evals: torch.Tensor, p: int,
                      offset: int) -> torch.Tensor:
    """Coefficients of the polynomial whose values on {offset * w^i} are
    `evals` (inverse of :func:`coset_evaluate` at big_n == n)."""
    f = Fp.get(p)
    n = int(evals.shape[-1])
    offset_inv = pow(int(offset) % p, p - 2, p)
    return f.storage(f.mul(f.arith(intt(evals, p)),
                           f.powers(offset_inv, n, evals.device)))
