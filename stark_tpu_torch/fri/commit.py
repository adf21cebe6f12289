"""FRI commit / fold / decommit — prover side (counterpart of
``stark_tpu/fri/commit.py``).

Each fold is one pointwise pass over the evaluations:

    next[i] = (E[i] + E[i+m/2]) / 2 + beta * (E[i] - E[i+m/2]) / (2 * D[i])

which is even(x^2) + beta * odd(x^2).  Per layer the device draws beta
from the device Fiat-Shamir state, folds, builds the layer's Merkle tree
and absorbs its root.  :func:`fri_commit` either continues a prove's
active DeviceFS and leaves the host channel alone (``fs=..., defer=True``,
the single-fetch prove: nothing reaches the host until the prove's one
fetch), or runs on its own DeviceFS from the host channel's state and
replays it into the channel from one fetch (the per-phase prove and the
standalone commit).

Storage: all layers' values live in one int32 buffer and all layers'
trees in one (rows, 8) digest buffer, each at static offsets, so the
query phase gathers every FRI opening of a query with one index
operation per buffer.  A Goldilocks layer of m values holds 2m words,
its hi plane then its lo plane, and its tree hashes the limb pairs
(K3's 64-bit mode).  On the deferred path each layer's tree stores only
its levels of at most 2^PRUNE_KEEP_LOG nodes (``merkle/tree.py``
``prune_depth_for``), so the digest buffer holds the stored levels only;
otherwise every level is stored, as the host query loop needs.

The query phase (:func:`decommit_fri`) draws each index from the channel
and opens every layer: on the device in one launch of K5's query form
(``channel/device_query.py``), or, for a configuration that plan does not
take or under ``STARK_TPU_TORCH_HOST_QUERIES``, one :class:`BatchGather`
(one gather and one fetch) a query.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from stark_tpu_torch.channel.channel import Channel
from stark_tpu_torch.channel.device_channel import DeviceFS
from stark_tpu_torch.fields.fp import Fp
from stark_tpu_torch.merkle.tree import (MerkleTree, prune_depths,
                                         tree_scratch)
from stark_tpu_torch.ntt.reference_ntt import root_of_unity
from stark_tpu_torch.utils.gather import BatchGather


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


def finish_deferred(p: int, final_vals_host, channel: Channel,
                    strict: bool = True) -> int:
    """Constant check (unless not `strict`) + the final-value send, given
    the fetched last layer's words (a Goldilocks layer: its hi plane,
    then its lo)."""
    words = [int(v) & 0xFFFFFFFF
             for v in np.asarray(final_vals_host).reshape(-1)]
    if Fp.get(p).width == 1:
        final_ints = words
    else:
        half = len(words) // 2
        final_ints = [h << 32 | l for h, l in zip(words[:half],
                                                  words[half:])]
    final_value = final_ints[0]
    if strict and any(v != final_value for v in final_ints):
        raise ValueError(
            "FRI did not fold to a constant — codeword degree exceeds "
            "2^num_folds, so the proof would be rejected; pass "
            "strict=False to emit the doomed transcript anyway (testing "
            "only)")
    channel.send(final_value.to_bytes(8, "big"))
    return final_value


def fri_commit(evals: torch.Tensor, p: int, offset: int, channel: Channel,
               num_folds: int | None = None, strict: bool = True, fs=None,
               defer: bool = False) -> FRIProof:
    """Commit phase (fri_commit.rs:72-122): Merkle each layer, absorb the
    root, draw beta, fold; finally send the constant.

    `evals`: canonical evaluations on {offset * w^i : i < n} ((n,) u32
    words, (2, n) Goldilocks limb planes).  `num_folds`: folds to perform;
    default log2(n) - 3 (stop at a size-8 layer like STARK-101's 8192 ->
    8).

    `fs`: an ACTIVE DeviceFS to continue (the single-fetch prove); when
    None a fresh one is made from ``channel.state`` on the values' device.
    With `defer=True` (which needs `fs`) nothing touches the host channel
    — no fetch, no replay, no final send; every tree is pruned as
    ``merkle.tree.prune_depths`` says (as the prove's query plan) and the
    caller fetches ``fs.payloads()`` and the last layer, replays, and
    calls :func:`finish_deferred`.
    Otherwise every tree is stored whole, and the log is replayed into
    `channel` from one fetch, then the constant is checked (`strict`)
    and sent."""
    n = int(evals.shape[-1])
    if n & (n - 1):
        raise ValueError("FRI domain size must be a power of two")
    f = Fp.get(p)
    wide = f.width == 2
    if num_folds is None:
        num_folds = max(n.bit_length() - 4, 0)  # log2(n) - 3
    if num_folds >= n.bit_length():
        raise ValueError(f"cannot fold size {n} domain {num_folds} times")
    if defer and fs is None:
        raise ValueError(
            "defer=True needs the caller's DeviceFS (fs=...): a "
            "locally-created one would be dropped and its roots/betas "
            "never replayed into the transcript")
    lengths = [n >> k for k in range(num_folds + 1)]
    prunes = prune_depths(lengths, defer)
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
    if fs is None:
        channel.mark_phase("fri-commit")
        fs = DeviceFS(p, channel.state, device=dev)
    else:
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
    proof = FRIProof([layer(k) for k in range(num_folds + 1)], trees, None,
                     offsets, values, digests, layout, prunes)
    if not defer:
        (last,) = fs.finalize(channel, extras=[proof.fri_layers[-1]])
        proof.final_value = finish_deferred(p, last, channel, strict)
    return proof


def open_layout(layer: torch.Tensor) -> torch.Tensor:
    """A value tensor in BatchGather's row layout: (2, n) Goldilocks limb
    planes as an (n, 2) view, so a gathered row is one element (both
    limbs); u32 values pass through."""
    return layer.T if layer.dim() == 2 else layer


def collect_query_arrays(fri_layers, fri_merkles, extra_arrays=()):
    """Deduplicated tuple of every device tensor a query opening reads
    (the extra arrays, the layers in open_layout, then each tree's digest
    buffer), with an id -> slot map for BatchGather.  Returns (arrays,
    slots, open_layers): a layer's values are gathered with
    ``slots[id(open_layers[i])]``, a tree's digests with
    ``slots[id(tree.buffer)]``."""
    arrays: list = []
    slots: dict[int, int] = {}

    def add(a):
        if id(a) not in slots:
            slots[id(a)] = len(arrays)
            arrays.append(a)
        return a

    for a in extra_arrays:
        add(a)
    open_layers = [add(open_layout(layer)) for layer in fri_layers]
    for tree in fri_merkles:
        add(tree.buffer)
    return tuple(arrays), slots, open_layers


def plan_fri_query(bg: BatchGather, slots, index: int, open_layers,
                   fri_merkles) -> list:
    """Queue one query's openings (fri_commit.rs:137-165 order: per layer
    value, auth path, sibling, sibling path; the len==1 quirk — final
    value sent, then re-sent as idx/sibling, fri_commit.rs:146-148 — is
    replicated for parity).  `open_layers`: the layers in open_layout
    (axis 0 = elements).  Returns the send plan for :func:`emit_plan`."""
    plan = []
    for layer, tree in zip(open_layers, fri_merkles):
        length = int(layer.shape[0])
        if length == 1:
            plan.append(("v", bg.want(slots[id(layer)], 0)))
        idx = index % length
        sib = (idx + length // 2) % length
        for j in (idx, sib):
            plan.append(("v", bg.want(slots[id(layer)], j)))
            plan.append(("p", [bg.want(slots[id(tree.buffer)], row)
                               for row in tree.path_rows(j)]))
    return plan


def emit_plan(plan, bg: BatchGather, channel: Channel) -> None:
    """Send a resolved plan in transcript order (8-byte BE values, row
    messages of concatenated column values, concatenated sibling
    digests)."""
    for kind, h in plan:
        if kind == "v":
            channel.send(bg.value_u64(h).to_bytes(8, "big"))
        elif kind == "vrow":  # multi-column trace row opening
            channel.send(
                b"".join(bg.value_u64(x).to_bytes(8, "big") for x in h))
        else:
            channel.send(b"".join(bg.digest(x) for x in h))


def decommit_fri_layers(index: int, fri_layers: list,
                        fri_merkles: list[MerkleTree], channel: Channel,
                        _collected=None) -> None:
    """One query's decommitment: one batched gather + ONE device->host
    copy for the whole query."""
    arrays, slots, open_layers = _collected or collect_query_arrays(
        fri_layers, fri_merkles)
    bg = BatchGather(arrays)
    plan = plan_fri_query(bg, slots, index, open_layers, fri_merkles)
    bg.run()
    emit_plan(plan, bg, channel)


def host_queries() -> bool:
    """Whether STARK_TPU_TORCH_HOST_QUERIES asks for the per-query
    BatchGather loop instead of the device query plan (read at call
    time)."""
    return bool(os.environ.get("STARK_TPU_TORCH_HOST_QUERIES"))


def decommit_fri(num_queries: int, max_index: int, fri_layers: list,
                 fri_merkles: list[MerkleTree], channel: Channel) -> None:
    """Query phase (fri_commit.rs:168-179): draw each index from the
    channel (shown in the proof), then decommit all layers.

    When the device query plan takes the layers (power-of-two lengths,
    unpruned trees), the whole phase is ONE launch of K5's query form on
    a CUDA device and one fetch (``channel/device_query.py``); otherwise,
    or under STARK_TPU_TORCH_HOST_QUERIES, one BatchGather and one fetch
    a query.  The layers and trees are those of :func:`fri_commit`
    without `defer` (every level stored)."""
    from stark_tpu_torch.channel import device_query as _dq

    channel.mark_phase("fri-query")
    lengths = tuple(int(layer.shape[-1]) for layer in fri_layers)
    rng = max_index + 1
    width = Fp.get(int(channel.modulus)).width
    if (not host_queries() and all(not t.prune for t in fri_merkles)
            and _dq.supported(rng, None, lengths, elem_width=width)):
        values = torch.cat([layer.reshape(-1) for layer in fri_layers])
        digests = torch.cat([t.buffer for t in fri_merkles])
        _dq.DeviceQueryPlan(rng, num_queries, (), None, lengths,
                            elem_width=width).run(channel, None, None,
                                                  values, digests)
        return
    collected = collect_query_arrays(fri_layers, fri_merkles)
    for _ in range(num_queries):
        idx = channel.receive_random_int(0, max_index, True)
        decommit_fri_layers(idx, fri_layers, fri_merkles, channel, collected)
