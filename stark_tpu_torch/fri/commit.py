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
from stark_tpu_torch.dist.comm import fri_fold_schedule
from stark_tpu_torch.dist.merkle import dist_merkle_tree
from stark_tpu_torch.dist.mesh import Sharded, replicated, sharded
from stark_tpu_torch.fields.fp import Fp, device_const
from stark_tpu_torch.merkle.tree import (MerkleTree, prune_depths,
                                         tree_scratch)
from stark_tpu_torch.ntt.reference_ntt import root_of_unity
from stark_tpu_torch.utils.gather import BatchGather
from stark_tpu_torch.utils.metrics import span


def _fold_pair(p: int, v, s, beta, inv_dom):
    """(v + s) / 2 + beta (v - s) / (2 x) lane by lane: v = E[i], s =
    E[i + m/2], inv_dom = 1 / x_i (int64 values; limb planes for
    Goldilocks)."""
    f = Fp.get(p)
    odd = f.mul(f.mul(f.sub(v, s), inv_dom), beta)
    return f.mul(f.add(f.add(v, s), odd),
                 device_const(p, pow(2, p - 2, p), str(v.device)))


def _fold_fn(p: int, m: int):
    """The fold for layer size m: (evals[m], beta, inv_half_domain[m/2])
    -> evals[m/2] (int64 values; limb planes for Goldilocks, whose halves
    are cut along the last axis)."""

    def fold(evals, beta, inv_dom):
        return _fold_pair(p, evals[..., : m // 2], evals[..., m // 2:], beta,
                          inv_dom)

    return fold


@functools.lru_cache(maxsize=None)
def _inv_domain(p: int, m: int, offset: int, device: str, start: int = 0,
                count: int | None = None) -> torch.Tensor:
    """[1 / (offset * w^i)] for i < m/2 (or start <= i < start + count),
    w the canonical order-m root."""
    f = Fp.get(p)
    w_inv = pow(root_of_unity(p, m), p - 2, p)
    off_inv = pow(offset % p, p - 2, p) * pow(w_inv, start, p) % p
    return f.coset_domain(off_inv, w_inv, m // 2 if count is None else count,
                          torch.device(device))


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
    constant, which stays None until :func:`finish_deferred`.  On a mesh
    (:func:`fri_commit` with `mesh`) a layer is a ``Sharded`` or a tensor
    on the first shard, a tree a ``DistMerkleTree`` or a ``MerkleTree``,
    `values` / `digests` the lists of buffers K5's query form reads
    (``DeviceQueryPlan`` with shards), `layout` None, and `last` the last
    layer whole on the first shard."""

    fri_layers: list
    fri_merkles: list
    final_value: int | None
    offsets: list[int]  # coset offset per layer (o, o^2, o^4, ...)
    values: torch.Tensor | list  # every layer's evaluations, concatenated
    digests: torch.Tensor | list  # every layer's stored tree levels, too
    layout: list[tuple[int, int, int]] | None  # (length, value off, dig off)
    prunes: tuple  # each layer's tree prune depth
    last: torch.Tensor | None = None

    @property
    def final_layer(self) -> torch.Tensor:
        """The last layer, whole, on one device (the final-constant send
        reads it)."""
        return self.fri_layers[-1] if self.last is None else self.last


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


def fri_commit(evals, p: int, offset: int, channel: Channel,
               num_folds: int | None = None, strict: bool = True, fs=None,
               defer: bool = False, mesh=None, out=None) -> FRIProof:
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
    and sent.

    `mesh`: commit over a ``dist.mesh.Mesh`` (`evals` a ``Sharded`` or a
    tensor to split): :func:`_commit_mesh`; trees are never pruned there
    and the Fiat-Shamir state lives on the first shard.

    `out`: (values, digests, scratch) buffers to commit into, sized by
    :func:`layer_layout` and ``merkle.tree.tree_scratch`` (scratch None
    when no tree needs one), on one device (the single-dispatch prove's
    static buffers); allocated when None."""
    n = int(evals.shape[-1])
    if n & (n - 1):
        raise ValueError("FRI domain size must be a power of two")
    if num_folds is None:
        num_folds = max(n.bit_length() - 4, 0)  # log2(n) - 3
    if num_folds >= n.bit_length():
        raise ValueError(f"cannot fold size {n} domain {num_folds} times")
    if defer and fs is None:
        raise ValueError(
            "defer=True needs the caller's DeviceFS (fs=...): a "
            "locally-created one would be dropped and its roots/betas "
            "never replayed into the transcript")
    if fs is None:
        channel.mark_phase("fri-commit")
        fs = DeviceFS(p, channel.state, mesh=mesh,
                      device=None if mesh is not None else evals.device)
    else:
        fs.mark("fri-commit")
    if mesh is not None:
        proof = _commit_mesh(evals, p, int(offset) % p, num_folds, fs, mesh)
    else:
        proof = _commit(evals, p, int(offset) % p, num_folds, fs, defer,
                        out)
    if not defer:
        (last,) = fs.finalize(channel, extras=[proof.final_layer])
        proof.final_value = finish_deferred(p, last, channel, strict)
    return proof


def _commit(evals: torch.Tensor, p: int, offset: int, num_folds: int, fs,
            defer: bool, out=None) -> FRIProof:
    """The commit on one device, into one value and one digest buffer
    (`out`'s, when given)."""
    f = Fp.get(p)
    wide = f.width == 2
    n = int(evals.shape[-1])
    lengths = [n >> k for k in range(num_folds + 1)]
    prunes = prune_depths(lengths, defer)
    layout, vtotal, dtotal = layer_layout(lengths, f.width, prunes)
    dev = evals.device
    if out is None:
        out = (torch.empty(vtotal, dtype=torch.int32, device=dev),
               torch.empty((dtotal, 8), dtype=torch.int32, device=dev),
               tree_scratch(zip(lengths, prunes), dev))
    values, digests, scratch = out
    if values.shape != (vtotal,) or digests.shape != (dtotal, 8):
        raise ValueError(f"FRI buffers of {vtotal} words and {dtotal} digest "
                         f"rows needed, got {tuple(values.shape)} and "
                         f"{tuple(digests.shape)}")

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
    with span("layer-tree"):
        offsets, trees = [offset], [tree(0)]
    size, off = n, offset
    for k in range(1, num_folds + 1):
        with span("fri-draw"):
            fs.absorb_root(trees[k - 1].root_digest)
            beta = fs.draw()  # device scalar, feeds the fold directly
        with span("fold"):
            folded = _fold_fn(p, size)(layer(k - 1), beta,
                                       _inv_domain(p, size, off, str(dev)))
            layer(k).copy_(f.storage(folded))
        with span("layer-tree"):
            trees.append(tree(k))
        size //= 2
        off = off * off % p
        offsets.append(off)
    fs.absorb_root(trees[-1].root_digest)
    return FRIProof([layer(k) for k in range(num_folds + 1)], trees, None,
                    offsets, values, digests, layout, prunes)


def _fold_sharded(layer, beta, p: int, size: int, off: int):
    """One fold of a layer sharded in S blocks of L: block d holds E[i],
    block d + S/2 holds E[i + size/2] for the same i, so the two shards
    swap halves (L/2 values each way; on a process mesh the pairs on two
    ranks are the messages of one all-to-all) and each folds one half.  Output block 2d
    (next[d L .. d L + L/2)) stays with block d's shard, 2d + 1 with
    block d + S/2's: the owners interleave."""
    f, mesh = Fp.get(p), layer.mesh
    s, k = mesh.size, layer.block_len
    h = k // 2
    shape = tuple(layer._any().shape[:-1]) + (h,)
    betas = replicated(mesh, beta)
    items = []
    for d in range(s // 2):
        lo, hi = layer.blocks[d], layer.blocks[d + s // 2]
        o_lo, o_hi = layer.owners[d], layer.owners[d + s // 2]
        items += [(o_hi, o_lo, None if hi is None else hi[..., :h], shape),
                  (o_lo, o_hi, None if lo is None else lo[..., h:], shape)]
    got = mesh.exchange(items, "fri")

    def fold(v, w, own, start):
        inv = _inv_domain(p, size, off, str(mesh.devices[own]), start, h)
        return f.storage(_fold_pair(p, v, w, betas[own], inv))

    blocks, owners = [None] * s, [None] * s
    for d in range(s // 2):
        lo, hi = layer.blocks[d], layer.blocks[d + s // 2]
        o_lo, o_hi = layer.owners[d], layer.owners[d + s // 2]
        owners[2 * d], owners[2 * d + 1] = o_lo, o_hi
        if mesh.owns(o_lo):
            blocks[2 * d] = fold(lo[..., :h], got[2 * d], o_lo, d * k)
        if mesh.owns(o_hi):
            blocks[2 * d + 1] = fold(got[2 * d + 1], hi[..., h:], o_hi,
                                     d * k + h)
    return Sharded(blocks, mesh, owners)


def _gather(layer) -> torch.Tensor:
    """A sharded layer whole on the first shard (the FRI tail gather; on
    a process mesh an all-gather, the layer replicated on every rank)."""
    shape = tuple(layer._any().shape)
    got = layer.mesh.exchange([(o, None, b, shape) for b, o in
                               zip(layer.blocks, layer.owners)], "fri")
    return torch.cat(got, dim=-1)


def _commit_mesh(evals, p: int, offset: int, num_folds: int, fs,
                 mesh) -> FRIProof:
    """The commit over a mesh, folding as ``dist.comm.fri_fold_schedule``
    says: sharded folds (shard d with d + S/2), the tail gathered to the
    first shard once a layer is below 8 S (on a process mesh to every
    rank, which then folds it alike), local folds after that.  A
    sharded layer's tree is a ``dist_merkle_tree``, a local one's a
    ``MerkleTree`` on the first shard; a sharded last layer is gathered
    for the final-constant send."""
    f = Fp.get(p)
    wide = f.width == 2
    cur = evals if isinstance(evals, Sharded) else sharded(mesh, evals)
    n = int(cur.shape[-1])
    sched = fri_fold_schedule(n, mesh.size, num_folds, elem=4 * f.width)
    gathers = {st["layer"] for st in sched if st["op"] == "gather_tail"}
    if mesh.size == 1:
        cur = cur.blocks[0]

    def tree(layer):
        if isinstance(layer, Sharded):
            return dist_merkle_tree(layer, mesh, wide=wide)
        return MerkleTree(layer, wide=wide)

    layers, trees, offsets = [cur], [tree(cur)], [offset]
    fs.absorb_root(trees[0].root_digest)
    size, off = n, offset
    for k in range(num_folds):
        beta = fs.draw()
        if k in gathers:
            cur = _gather(cur)
        if isinstance(cur, Sharded):
            cur = _fold_sharded(cur, beta, p, size, off)
        else:
            cur = f.storage(_fold_fn(p, size)(
                cur, beta, _inv_domain(p, size, off, str(cur.device))))
        layers.append(cur)
        trees.append(tree(cur))
        fs.absorb_root(trees[-1].root_digest)
        size //= 2
        off = off * off % p
        offsets.append(off)
    values, digests = [], []
    for layer, t in zip(layers, trees):
        blocks = layer.blocks if isinstance(layer, Sharded) else (layer,)
        values += [None if b is None else b.reshape(-1) for b in blocks]
        digests += t.entries
    last = _gather(cur) if isinstance(cur, Sharded) else None
    return FRIProof(layers, trees, None, offsets, values, digests, None,
                    (0,) * len(layers), last)


def open_layout(layer):
    """A value tensor in BatchGather's row layout: (2, n) Goldilocks limb
    planes as an (n, 2) view, so a gathered row is one element (both
    limbs); u32 values pass through; a ``Sharded`` layer as its row
    view."""
    if isinstance(layer, Sharded):
        return layer.rows()
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
