"""The Fibonacci-square prover's forward step as one function
(counterpart of ``stark_tpu/stark/pipeline.py``): everything between two
Fiat-Shamir interactions, with the challenges passed in — trace
interpolation (INTT, K1/K2), coset LDE (NTT, K1/K2), the trace Merkle
tree (K3 + K4), the composition and the first FRI fold.  The unit a
compile check or a timing harness drives.
"""

from __future__ import annotations

import functools

import torch

from stark_tpu_torch.config import ProverConfig
from stark_tpu_torch.fields.fp import Fp
from stark_tpu_torch.fri.commit import _fold_fn, _inv_domain
from stark_tpu_torch.merkle.tree import MerkleTree
from stark_tpu_torch.ntt.ntt import coset_evaluate
from stark_tpu_torch.stark.air import _FibContext
from stark_tpu_torch.stark.trace import trace_polynomial


@functools.lru_cache(maxsize=None)
def build_prove_core(cfg: ProverConfig, device="cuda"):
    """Returns fn(trace, alphas(3,), beta, a0, a_last) ->
    (trace_root_digest (1, 8), cp_evals (M,), folded (M/2,)) on `device`
    (the card unless the caller asks for the CPU): `trace` the (T,) u32
    storage words of a Fibonacci-square trace on that device, the
    challenges device scalars or ints, a0 / a_last the publics."""
    cfg.validate()
    if Fp.get(cfg.modulus).width != 1:
        raise ValueError("the forward step runs over a u32 field")
    p, M, h = cfg.modulus, cfg.eval_domain_size, cfg.offset
    device = torch.device(device)
    ctx = _FibContext(cfg, device)
    inv_dom = _inv_domain(p, M, h, str(device))
    fold = _fold_fn(p, M)
    f = Fp.get(p)

    def core(trace, alphas, beta, a0, a_last):
        f_evals = coset_evaluate(trace_polynomial(trace, p), p, M, h)
        tree = MerkleTree(f_evals)
        cp = ctx.compose(f_evals, alphas, {"a0": a0, "a_last": a_last})
        beta = beta if torch.is_tensor(beta) else f.const(beta, device)
        folded = f.storage(fold(cp, beta, inv_dom))
        return tree.buffer[-1:], cp, folded

    return core
