"""FRI commit / fold — prover side (counterpart of ``stark_tpu/fri/commit.py``;
the deferred, single-device branch that the single-fetch prove uses).

Each fold is one pointwise pass over the evaluations:

    next[i] = (E[i] + E[i+m/2]) / 2 + beta * (E[i] - E[i+m/2]) / (2 * D[i])

which is even(x^2) + beta * odd(x^2).  Per layer the device draws beta
from the device Fiat-Shamir state, folds, builds the layer's Merkle tree
and absorbs its root; nothing reaches the host until the prove's single
fetch.

Storage: all layers' values live in one int32 buffer and all layers'
trees in one (rows, 8) digest buffer, each at static offsets, so the
query phase gathers every FRI opening of a query with one index
operation per buffer.  A Goldilocks layer of m values holds 2m words,
its hi plane then its lo plane, and its tree hashes the limb pairs
(K3's 64-bit mode).  Each layer's tree stores only its levels of at most
2^PRUNE_KEEP_LOG nodes (``merkle/tree.py`` ``prune_depth_for``), so the
digest buffer holds the stored levels only.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from stark_tpu_torch.channel.channel import Channel
from stark_tpu_torch.fields.fp import Fp
from stark_tpu_torch.merkle.tree import (MerkleTree, prune_depth_for,
                                         tree_scratch)
from stark_tpu_torch.ntt.reference_ntt import root_of_unity


def _fold_fn(p: int, m: int):
    """The fold for layer size m: (evals[m], beta, inv_half_domain[m/2])
    -> evals[m/2] (int64 values; limb planes for Goldilocks, whose halves
    are cut along the last axis)."""
    f = Fp.get(p)
    inv2 = pow(2, p - 2, p)

    def fold(evals, beta, inv_dom):
        v, s = evals[..., : m // 2], evals[..., m // 2:]
        odd = f.mul(f.mul(f.sub(v, s), inv_dom), beta)
        return f.mul(f.add(f.add(v, s), odd), f.const(inv2, evals.device))

    return fold


@functools.lru_cache(maxsize=None)
def _inv_domain(p: int, m: int, offset: int, device: str) -> torch.Tensor:
    """[1 / (offset * w^i)] for i < m/2, w the canonical order-m root."""
    f = Fp.get(p)
    w_inv = pow(root_of_unity(p, m), p - 2, p)
    off_inv = pow(offset % p, p - 2, p)
    return f.coset_domain(off_inv, w_inv, m // 2, torch.device(device))


def layer_layout(lengths, width: int = 1,
                 prunes=None) -> tuple[list, int, int]:
    """Static layout of the FRI buffers for layers of the given lengths,
    field width and tree prune depths (default: none pruned): per layer
    (length, value offset, digest-row offset), plus the two buffer sizes
    (values in words, stored digest rows)."""
    out, voff, doff = [], 0, 0
    for ln, prune in zip(lengths, prunes or (0,) * len(lengths)):
        out.append((ln, voff, doff))
        voff += width * ln
        doff += 2 * (ln >> prune) - 1
    return out, voff, doff


@dataclasses.dataclass
class FRIProof:
    """All layers + trees (views into `values` / `digests`) and the final
    constant, which stays None until :func:`finish_deferred`."""

    fri_layers: list[torch.Tensor]
    fri_merkles: list[MerkleTree]
    final_value: int | None
    offsets: list[int]  # coset offset per layer (o, o^2, o^4, ...)
    values: torch.Tensor  # every layer's evaluations, concatenated
    digests: torch.Tensor  # every layer's stored tree levels, concatenated
    layout: list[tuple[int, int, int]]  # (length, value off, digest off)
    prunes: tuple  # each layer's tree prune depth


def finish_deferred(p: int, final_vals_host, channel: Channel) -> int:
    """Constant check + the final-value send, given the fetched last
    layer's words (a Goldilocks layer: its hi plane, then its lo)."""
    words = [int(v) & 0xFFFFFFFF for v in final_vals_host]
    if Fp.get(p).width == 1:
        final_ints = words
    else:
        half = len(words) // 2
        final_ints = [h << 32 | l for h, l in zip(words[:half],
                                                  words[half:])]
    final_value = final_ints[0]
    if any(v != final_value for v in final_ints):
        raise ValueError(
            "FRI did not fold to a constant — codeword degree exceeds "
            "2^num_folds, so the proof would be rejected")
    channel.send(final_value.to_bytes(8, "big"))
    return final_value


def fri_commit(evals: torch.Tensor, p: int, offset: int, fs,
               num_folds: int | None = None, prunes=None) -> FRIProof:
    """Commit phase with the caller's active DeviceFS `fs` (deferred: the
    host channel is untouched; the caller fetches ``fs.payloads()`` and
    the last layer, replays, and calls :func:`finish_deferred`).  Layer
    k's tree drops its first ``prunes[k]`` levels (default: each layer's
    ``prune_depth_for``), all layers through one scratch."""
    n = int(evals.shape[-1])
    if n & (n - 1):
        raise ValueError("FRI domain size must be a power of two")
    f = Fp.get(p)
    wide = f.width == 2
    if num_folds is None:
        num_folds = max(n.bit_length() - 4, 0)  # log2(n) - 3
    if num_folds >= n.bit_length():
        raise ValueError(f"cannot fold size {n} domain {num_folds} times")
    lengths = [n >> k for k in range(num_folds + 1)]
    if prunes is None:
        prunes = [prune_depth_for(ln) for ln in lengths]
    prunes = tuple(int(x) for x in prunes)
    layout, vtotal, dtotal = layer_layout(lengths, f.width, prunes)
    dev = evals.device
    scratch = tree_scratch(zip(lengths, prunes), dev)
    values = torch.empty(vtotal, dtype=torch.int32, device=dev)
    digests = torch.empty((dtotal, 8), dtype=torch.int32, device=dev)

    def layer(k):
        ln, voff, _ = layout[k]
        return values[voff:voff + f.width * ln].view(
            (2, ln) if wide else (ln,))

    def tree(k):
        ln, _, doff = layout[k]
        rows = 2 * (ln >> prunes[k]) - 1
        return MerkleTree(layer(k), out=digests[doff:doff + rows],
                          wide=wide, prune=prunes[k], scratch=scratch)

    layer(0).copy_(evals)
    offset = int(offset) % p
    offsets, trees = [offset], [tree(0)]
    fs.mark("fri-commit")
    fs.absorb_root(trees[0].root_digest)
    size, off = n, offset
    for k in range(1, num_folds + 1):
        beta = fs.draw()  # device scalar, feeds the fold directly
        folded = _fold_fn(p, size)(layer(k - 1), beta,
                                   _inv_domain(p, size, off, str(dev)))
        layer(k).copy_(f.storage(folded))
        trees.append(tree(k))
        fs.absorb_root(trees[k].root_digest)
        size //= 2
        off = off * off % p
        offsets.append(off)
    return FRIProof([layer(k) for k in range(num_folds + 1)], trees, None,
                    offsets, values, digests, layout, prunes)
