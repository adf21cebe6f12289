"""Sharded Merkle commitment (counterpart of ``stark_tpu/dist/merkle.py``).

Leaves are sharded in contiguous blocks, so each shard owns a complete
subtree: its leaf digests (K3, in its u32, 64-bit or row form) and every
level up to its subtree root (K4) build on its own device with no
communication.  The S subtree roots, 32 bytes each, are copied to the
first shard, where ``hash_levels`` builds the top log2(S) levels (K4's
tail, one launch for a power-of-two S; K4 a level for another); on a
process mesh they are all-gathered and every rank builds the top levels
(replicated, on its first shard), so every rank holds the root.

Because subtrees are contiguous, the concatenated subtree levels are the
global tree's levels, so roots and authentication paths equal those of
the single-device ``MerkleTree`` / ``from_columns``.  Storage: each
subtree is a ``MerkleTree`` buffer on its shard, the top levels one
(2S - 1, 8) buffer (the roots, then the levels above them) on the first
shard.  Mesh trees store every level, never pruned, as the JAX
package's dist trees.  On a process mesh a rank holds the subtrees of
its blocks only (None for the others).
"""

from __future__ import annotations

import torch

from stark_tpu_torch.dist.mesh import Mesh, Sharded, sharded
from stark_tpu_torch.hash.sha256 import digest_to_bytes
from stark_tpu_torch.merkle.tree import (MerkleTree, hash_levels,
                                         level_offsets)


def shards_tree(n: int, s: int) -> bool:
    """Whether a tree of n leaves splits into s subtrees (else it is built
    whole on the first shard, as JAX falls back)."""
    return s > 1 and not n % s and not (n // s) & (n // s - 1) and n >= 2 * s


class DistMerkleTree:
    """A tree over a :class:`Sharded` value array: one subtree a block on
    its owner's device, the top levels on the first shard.  Quacks like
    an unpruned ``MerkleTree`` of n leaves (``root``, ``root_digest``,
    ``path_rows`` / ``buffer`` for BatchGather, authentication paths);
    ``entries`` are its buffers as K5's query form reads them."""

    prune = 0

    def __init__(self, values: Sharded, columns: bool, wide: bool):
        mesh = values.mesh
        s = mesh.size
        self.mesh = mesh
        self.block_leaves = values.block_len
        self.num_leaves = self.block_leaves * s
        self.offsets = level_offsets(self.num_leaves)
        build = MerkleTree.from_columns if columns else MerkleTree
        self.subtrees = [None if b is None else build(b, wide=wide)
                         for b in values.blocks]
        roots = mesh.exchange([(o, None, None if t is None
                                else t.root_digest[None], (1, 8))
                               for t, o in zip(self.subtrees, values.owners)],
                              "merkle")
        top = torch.empty((2 * s - 1, 8), dtype=torch.int32,
                          device=mesh.first)
        top[:s] = torch.cat(roots)
        self.top = hash_levels(top, s)
        self._sub_offsets = level_offsets(self.block_leaves)
        self._top_offsets = level_offsets(s)

    @property
    def entries(self) -> list[torch.Tensor]:
        """The subtree buffers in block order (None for another
        process's), then the top buffer."""
        return [None if t is None else t.buffer
                for t in self.subtrees] + [self.top]

    @property
    def root_digest(self) -> torch.Tensor:
        return self.top[-1]

    def root(self) -> str:
        return digest_to_bytes(self.root_digest.cpu().tolist()).hex()

    def locate(self, row: int):
        """Global buffer row (the ``level_offsets(n)`` layout of a whole
        tree) -> (buffer, local row); a row of another process's subtree
        raises."""
        for l, (off, size) in enumerate(self.offsets):
            if row < off + size:
                node = row - off
                break
        else:
            raise IndexError(f"row {row} out of range")
        log_l = self.block_leaves.bit_length() - 1
        if l < log_l:
            shift = log_l - l
            sub = self.subtrees[node >> shift]
            if sub is None:
                raise ValueError(f"row {row} lies in another process's "
                                 "subtree")
            return (sub.buffer,
                    self._sub_offsets[l][0] + (node & ((1 << shift) - 1)))
        return self.top, self._top_offsets[l - log_l][0] + node

    @property
    def buffer(self) -> "DistMerkleTree":
        """The tree's rows as BatchGather takes them (``locate``)."""
        return self

    @property
    def shape(self) -> tuple:
        return (self.offsets[-1][0] + 1, 8)

    def path_rows(self, index: int) -> list[int]:
        return MerkleTree.path_rows(self, index)

    @property
    def levels(self) -> list[torch.Tensor]:
        """Every level, whole, on the first shard (tests)."""
        first = self.mesh.first
        log_l = self.block_leaves.bit_length() - 1
        out = [torch.cat([t.buffer[o:o + m].to(first) for t in self.subtrees])
               for o, m in self._sub_offsets[:log_l]]
        return out + [self.top[o:o + m] for o, m in self._top_offsets]

    def get_authentication_path(self, index: int) -> bytes:
        sibs = []
        for row in self.path_rows(index):
            buf, local = self.locate(row)
            sibs.append(buf[local].cpu().tolist())
        return b"".join(digest_to_bytes(s) for s in sibs)


def dist_merkle_tree(values, mesh: Mesh, columns: bool = False, *,
                     wide: bool = False):
    """The tree over `values` (a tensor, split over the mesh, or a
    :class:`Sharded`): (n,) u32 values, (2, n) Goldilocks limb planes
    with `wide`, or with `columns` the (C, n) / (C, 2, n) columns
    committed as row leaves (``MerkleTree.from_columns``).  Digests and
    paths equal the single-device tree's.  A size that does not split
    into mesh.size subtrees of a power-of-two size (at least 2 leaves)
    builds whole on the first shard."""
    vs = values if isinstance(values, Sharded) else sharded(mesh, values)
    if not shards_tree(int(vs.shape[-1]), mesh.size):
        whole = vs.join()
        return (MerkleTree.from_columns(whole, wide=wide) if columns
                else MerkleTree(whole, wide=wide))
    return DistMerkleTree(vs, columns, wide)
