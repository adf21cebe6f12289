"""Batched (data-parallel) proving: B statements of one family, their
device phases run together (counterpart of ``stark_tpu/stark/batch.py``).

The batch rides a leading axis through every device phase, so B proofs
launch each kernel as often as one prove does, not B times:

* the trace INTT and the LDE: one NTT call each, the B x C columns as
  the batched NTT's (C, n) rows (K1/K2; torch ops for Goldilocks);
* every Merkle tree: each launch of the single tree's build
  (``merkle/tree.py``: K3's subtree form, K4 a level, the tail) once for
  the B trees (the tree as grid y, ``hash/cuda_sha.py``
  ``sha_subtree_batch``, ``sha_nodes_batch``, ``sha_tail_batch``); every
  level is stored, as the JAX batch stores them (``_batched_levels``);
* every Fiat-Shamir interaction: one launch of K5's chain form for the B
  chains (a DeviceFS of (B, 8) states; ``sha_chain_batch``, one block a
  chain);
* the query phase: one launch of K5's query form for all B proofs
  (``query_chain_batch``, one block a proof, the plan's tables shared);
* the FRI folds: torch ops over the batch; the composition: torch ops
  proof by proof, so its int64 temporaries are one proof's (the JAX
  package's are XLA code too).

Then ONE device->host copy, and each proof's canonical transcript is
replayed on the host, every device-derived challenge checked against the
host derivation.  The proofs are byte-identical to B ``prove()`` calls:
batching is a throughput optimisation only.
"""

from __future__ import annotations

import numpy as np
import torch

from stark_tpu_torch.channel.channel import Channel
from stark_tpu_torch.channel.device_channel import DeviceFS, absorb_value
from stark_tpu_torch.channel.device_query import query_chain_batch
from stark_tpu_torch.config import ProverConfig
from stark_tpu_torch.fields.fp import Fp, upload_u32
from stark_tpu_torch.fri.commit import (_inv_domain, finish_deferred,
                                        layer_layout)
from stark_tpu_torch.merkle.tree import build_tree
from stark_tpu_torch.ntt.ntt import coset_evaluate
from stark_tpu_torch.stark.prover import (StarkProof, _finish_proof,
                                          get_air_context, query_plan)
from stark_tpu_torch.stark.trace import trace_polynomial
from stark_tpu_torch.utils import metrics as _metrics
from stark_tpu_torch.utils.gather import fetch_packed


def _batched_tree(values: torch.Tensor, out: torch.Tensor, *, rows: bool,
                  wide: bool) -> torch.Tensor:
    """The B trees over `values` ((B, n), (B, 2, n), or with `rows` the
    (B, C, n) columns) into `out`, a (B, 2n - 1, 8) view: the launches of
    one tree's build, each once for all B trees."""
    return build_tree(values, out, rows=rows, wide=wide, batch=True)


def _batched_fold(f, evals: torch.Tensor, beta: torch.Tensor,
                  inv_dom: torch.Tensor) -> torch.Tensor:
    """FRI fold of B layers along the last axis: evals (B, m) u32 storage
    or (B, 2, m) limb planes, beta (B,) or (2, B) (the batched draws),
    inv_dom (m/2,) or (2, m/2) -> (B, m/2) / (B, 2, m/2) storage."""
    m = int(evals.shape[-1])
    inv2 = f.const(pow(2, f.p - 2, f.p), evals.device)
    if f.width > 1:
        x = f.arith(evals)  # (2, B, m)
        bb, idm, inv2 = beta[:, :, None], inv_dom[:, None, :], \
            inv2.view(2, 1, 1)
    else:
        x, bb, idm = evals, beta[:, None], inv_dom
    v, s = x[..., :m // 2], x[..., m // 2:]
    odd = f.mul(f.mul(f.sub(v, s), idm), bb)
    return f.storage(f.mul(f.add(f.add(v, s), odd), inv2))


def _proof_payloads(fs: DeviceFS, fetched, i: int) -> list:
    """Proof i's share of a batched DeviceFS log's fetched payloads: its
    row of each root and u32 draw, its column of each (2, B) Goldilocks
    draw."""
    kinds = [kind for kind, _ in fs.log if kind != "mark"]
    return [h[:, i] if kind == "draw" and fs.width == 2 else h[i]
            for kind, h in zip(kinds, fetched)]


def _family_param(air):
    """What every statement of a batch must share beyond the family name:
    a spec's bound params, MiMC's round key."""
    if hasattr(air, "params_spec"):
        return tuple(sorted(air._param_values.items()))
    return getattr(air, "k", None)


def prove_batch(cfg: ProverConfig, airs: list, *,
                device="cuda") -> list[StarkProof]:
    """Prove B same-config statements with batched device phases, on
    `device` (the card unless the caller asks for the CPU, where each
    batched kernel runs its plain version proof by proof).

    `airs`: AIR instances of ONE family and parameterization (only the
    per-statement secrets differ).  Returns proofs byte-identical to B
    sequential ``prove()`` calls."""
    if not airs:
        return []
    air0 = airs[0]
    air0.validate(cfg)
    if any(a.name != air0.name or _family_param(a) != _family_param(air0)
           for a in airs):
        raise ValueError(
            "prove_batch needs AIRs of one family/parameterization")
    f = Fp.get(cfg.modulus)
    wide = f.width > 1
    ncols = air0.num_columns
    if wide and ncols > 1:
        raise ValueError(
            "prove_batch supports wide (64-bit) fields for single-column "
            "AIRs only; batch multi-column wide statements sequentially")
    device = torch.device(device)
    p, M, h = cfg.modulus, cfg.eval_domain_size, cfg.offset
    B, num_folds = len(airs), air0.num_folds(cfg)
    plan = query_plan(cfg, air0, pruned=False)

    # -- traces and their LDE: one upload, one INTT and one NTT call -------
    hosts = [a.host_trace(cfg) for a in airs]
    publics = [a.publics_from_host(cfg, hs) for a, hs in zip(airs, hosts)]
    traces = upload_u32(np.stack(hosts), device)  # (B[, C | 2], T)
    if not wide:  # the B x C columns as rows of one batched transform
        traces = traces.reshape(B * ncols, -1)
    f_evals = coset_evaluate(trace_polynomial(traces, p), p, M, h)
    if ncols > 1:
        f_evals = f_evals.reshape(B, ncols, M)

    # -- trace commit, alpha draws -----------------------------------------
    fs = DeviceFS(p, device=device)  # B chains: (B, 8) states
    fs.mark("trace-commit")
    trace_rows = 2 * M - 1
    trace_trees = _batched_tree(
        f_evals, torch.empty((B, trace_rows, 8), dtype=torch.int32,
                             device=device), rows=ncols > 1, wide=wide)
    fs.absorb_root(trace_trees[:, -1])
    alphas = [fs.draw() for _ in range(air0.num_alphas)]

    # -- composition, proof by proof ----------------------------------------
    fs.mark("composition")
    layout, vtotal, dtotal = layer_layout(plan.fri_lengths, f.width)
    values = torch.empty((B, vtotal), dtype=torch.int32, device=device)
    digests = torch.empty((B, dtotal, 8), dtype=torch.int32, device=device)

    def layer(k):
        ln, voff, _ = layout[k]
        return values[:, voff:voff + f.width * ln].view(
            (B, 2, ln) if wide else (B, ln))

    def tree(k):
        ln, _, doff = layout[k]
        out = digests[:, doff:doff + 2 * ln - 1]
        _batched_tree(layer(k), out, rows=False, wide=wide)
        return out[:, -1]

    # one proof at a time, as a batch of one: the batch axis leads the
    # lanes (publics and alphas (1, 1) u32 words, (2, 1, 1) Goldilocks
    # pairs; the LDE (1[, C], M) or (2, 1, M) limbs), so the composition's
    # int64 temporaries are one proof's, not B proofs' at once
    ctx = get_air_context(air0, cfg, device)
    lde = f.arith(f_evals) if wide else f_evals
    for i in range(B):
        pick = slice(i, i + 1)
        if wide:
            al = [a[:, pick, None] for a in alphas]
            pubs = {k: f.array([v], device)[:, :, None]
                    for k, v in publics[i].items()}
            lde_i = lde[:, pick]
        else:
            al = [a[pick, None] for a in alphas]
            pubs = {k: torch.tensor([v % p], device=device)[:, None]
                    for k, v in publics[i].items()}
            lde_i = lde[pick]
        layer(0)[pick].copy_(ctx.compose(lde_i, al, pubs))

    # -- FRI commit, batched folds -----------------------------------------
    fs.mark("fri-commit")
    fs.absorb_root(tree(0))
    size, off = M, h % p
    for k in range(1, num_folds + 1):
        beta = fs.draw()
        layer(k).copy_(_batched_fold(f, layer(k - 1), beta,
                                     _inv_domain(p, size, off, str(device))))
        fs.absorb_root(tree(k))
        size //= 2
        off = off * off % p
    last = layer(num_folds)
    if wide:
        hi, lo = last[:, 0, 0], last[:, 1, 0]
    else:
        hi, lo = torch.zeros_like(last[:, 0]), last[:, 0]
    fs.state = absorb_value(fs.state, hi, lo)

    # -- every proof's query phase in one launch, then ONE fetch -----------
    dev = query_chain_batch(fs.state, f_evals.reshape(B, -1), trace_trees,
                            values, digests, plan.pack(device))
    n_pay = len(fs.payloads())
    fetched = fetch_packed([*fs.payloads(), last, *dev])
    payload_h, (last_h, final_h, idxs_h, vals_h, digs_h) = (
        fetched[:n_pay], fetched[n_pay:])

    proofs = []
    for i, air in enumerate(airs):
        ch = Channel(p)
        fs.replay_fetched(ch, _proof_payloads(fs, payload_h, i))
        finish_deferred(p, last_h[i], ch)
        ch.mark_phase("queries")
        plan.replay(ch, final_h[i], idxs_h[i], vals_h[i], digs_h[i])
        proofs.append(_finish_proof(cfg, air, ch, publics[i],
                                    _metrics.GLOBAL))
    return proofs
