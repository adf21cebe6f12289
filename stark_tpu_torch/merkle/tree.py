"""Merkle commitment over field-element codewords (counterpart of
``stark_tpu/merkle/tree.py``).

Node semantics are the reference's rs_merkle wrapper:

* leaf hash = SHA-256(8-byte big-endian field value)   (merkle/mod.rs:14-16);
  for a multi-column codeword (:meth:`MerkleTree.from_columns`),
  SHA-256 of the row's values, 8 big-endian bytes each.  A u32 field's
  value has high word 0; a Goldilocks value is its (hi, lo) limb pair,
  and every entry takes that width as ``wide``, never from the shape (a
  (2, n) tensor is two u32 columns or one Goldilocks column)
* node hash = SHA-256(left_digest || right_digest)
* odd node  = promoted unhashed to the next level      (rs_merkle v1.4)
* root      = lowercase hex string                     (merkle/mod.rs:24-26)

Storage: one int32 buffer of digest rows in natural node order, level
after level (leaves first, root last), at static offsets
(:func:`level_offsets`): (2n-1, 8) for a power-of-two tree; level l of
any tree holds ceil(n / 2^l) nodes.  The children of parent j of a level
are rows 2j and 2j+1 of the level below, so a node hash reads 64
contiguous bytes, and the authentication path of leaf j is the rows
``offset_l + ((j >> l) ^ 1)``, skipping the levels where the node is
the odd one out (promoted, so it has no sibling).  Digests do not depend
on the storage layout, so roots and paths equal the JAX package's.

On a CUDA tensor a power-of-two tree builds in few launches
(``hash/cuda_sha.py``): K3's subtree form hashes 2^SUBTREE_LOG leaves a
block and the SUBTREE_LEVELS node levels above them in shared memory;
K4 (``sha_nodes``) hashes each larger level above that, one launch a
level; K4's tail hashes every level of at most 2^TAIL_LOG nodes up to
the root in one block (the JAX package's ``_tail_scan``), and is the
whole build of a tree of at most 2^TAIL_LOG leaves.  An odd-size tree
hashes its leaves with K3 alone and every level with K4, the promoted
node of an odd level copied after its pairs, until a level of a
power-of-two size goes to the tail.  On a CPU tensor the same launches
run their plain versions, over the same spans and into the same rows:
the split is made before the device is looked at.  The three sizes are
read at call time, so a test may shrink them.

Pruned storage (``prune=``, the JAX package's ``prune_depth_for``): the
single-fetch prove stores only the levels of at most 2^PRUNE_KEEP_LOG
nodes of each tree; the query phase recomputes the siblings of the first
``prune`` levels from the leaf values inside K5's query form
(``channel/device_query.py``).  The stored levels are one
(2 (n >> prune) - 1, 8) buffer at the offsets of a tree of n >> prune
leaves.  The kernels write only the stored levels, so the unstored ones
of the subtree kernel and of the tail never reach device memory; only
when ``prune`` exceeds the subtree kernel's fused levels do the levels
between go through a scratch buffer, which the caller may share between
trees.  A pruned tree of at least 2^CHUNK_MIN_LOG leaves builds in
chunks of 2^CHUNK_LOG consecutive leaves, each writing its slice of the
first stored level, so the leaf-digest level is never held whole.
Digests do not depend on either, so roots and transcripts are those of
the full tree.
"""

from __future__ import annotations

import hashlib
import os

import torch

from stark_tpu_torch.hash.cuda_sha import (sha_leaves, sha_nodes,
                                           sha_nodes_batch, sha_row_leaves,
                                           sha_subtree, sha_subtree_batch,
                                           sha_tail, sha_tail_batch)
from stark_tpu_torch.hash.sha256 import digest_to_bytes


# the stored levels of a pruned tree hold at most 2^PRUNE_KEEP_LOG nodes;
# pruned trees of at least 2^CHUNK_MIN_LOG leaves build in chunks of
# 2^CHUNK_LOG leaves (the JAX package's values).  The subtree kernel's
# block hashes 2^SUBTREE_LOG leaves and the SUBTREE_LEVELS levels above
# them (1024 leaves keep 5 levels in whole warps); the tail takes every
# level of at most 2^TAIL_LOG nodes (the JAX package's _TAIL_SIZE).  Read
# at call time, so a test may set them.
PRUNE_KEEP_LOG = int(os.environ.get("STARK_TPU_TORCH_PRUNE_KEEP_LOG", "22"))
CHUNK_MIN_LOG = int(os.environ.get("STARK_TPU_TORCH_CHUNK_TREE_LOG", "27"))
CHUNK_LOG = 24
SUBTREE_LOG, SUBTREE_LEVELS = 10, 5
TAIL_LOG = 10


def prune_depth_for(n: int) -> int:
    """How many leading levels a size-n tree drops under pruned storage
    (0 = store everything; only power-of-two trees prune, and none when
    STARK_TPU_TORCH_NO_PRUNE is set)."""
    if os.environ.get("STARK_TPU_TORCH_NO_PRUNE") or n & (n - 1):
        return 0
    return max(0, (n.bit_length() - 1) - PRUNE_KEEP_LOG)


def prune_depths(lengths, pruned: bool = True) -> tuple:
    """Each size's prune depth (``prune_depth_for``), or all 0 when not
    `pruned`: the one rule for a prove's trees and its query plan."""
    return tuple(prune_depth_for(n) if pruned else 0 for n in lengths)


def chunk_log(n: int, prune: int) -> int:
    """log2 of the leaves one pass of a pruned build of n leaves hashes:
    all of them below 2^CHUNK_MIN_LOG leaves, else 2^CHUNK_LOG (at least
    2^prune, at most n)."""
    log_n = n.bit_length() - 1
    if log_n < CHUNK_MIN_LOG:
        return log_n
    return min(log_n, max(CHUNK_LOG, prune))


def _passes(n: int, prune: int) -> tuple[int, int, int]:
    """(log2 of the leaves a pass hashes, the subtree kernel's block span
    log, its fused node levels) of a power-of-two tree of n leaves above
    the tail."""
    c = chunk_log(n, prune) if prune else n.bit_length() - 1
    s = min(SUBTREE_LOG, c)
    return c, s, min(SUBTREE_LEVELS, s)


def _tail_builds(n: int) -> bool:
    """Whether the tail alone builds a tree of n leaves."""
    return not n & (n - 1) and n <= 1 << TAIL_LOG


def scratch_rows(n: int, prune: int) -> int:
    """Digest rows of the scratch a pruned build of n leaves needs: none
    where the kernels write every level from `prune` up (the tail builds
    the tree, or `prune` is within the subtree kernel's fused levels);
    else one pass's top fused level, then half as many again when more
    than one level lies between it and the first stored level (those
    alternate between the two regions).  0 without pruning."""
    if not prune or _tail_builds(n):
        return 0
    c, _, f = _passes(n, prune)
    if prune <= f:
        return 0
    s = 1 << (c - f)
    return s + (s // 2 if prune > f + 1 else 0)


def tree_scratch(trees, device) -> torch.Tensor | None:
    """One scratch buffer for the pruned builds of `trees`, (leaf count,
    prune depth) pairs: the trees of a prove share it.  None when none of
    them needs one."""
    rows = max((scratch_rows(n, prune) for n, prune in trees), default=0)
    if not rows:
        return None
    return torch.empty((rows, 8), dtype=torch.int32, device=device)


def level_offsets(n: int) -> list[tuple[int, int]]:
    """(row offset, node count) of each level of a size-n tree buffer
    (rs_merkle shape: level l + 1 holds ceil(size_l / 2) nodes)."""
    out, off, size = [], 0, n
    while True:
        out.append((off, size))
        if size == 1:
            return out
        off += size
        size = (size + 1) // 2


def _level_launches(size: int) -> tuple[int, int]:
    """(K4 level launches, tail launches) of :func:`hash_levels` from a
    level of `size` nodes."""
    nodes = 0
    while size > 1:
        if _tail_builds(size):
            return nodes, 1
        nodes += 1
        size = (size + 1) // 2
    return nodes, 0


def tree_launches(n: int, prune: int = 0) -> dict:
    """The kernel launches :func:`build_tree` makes for a tree of n
    leaves with `prune` unstored levels: {"leaves": K3 alone (an odd
    tree), "subtree": K3's subtree form, "nodes": K4 one level a launch,
    "tail": K4's tail}."""
    if n & (n - 1):
        nodes, tail = _level_launches(n)
        return {"leaves": 1, "subtree": 0, "nodes": nodes, "tail": tail}
    if _tail_builds(n):
        return {"leaves": 0, "subtree": 0, "nodes": 0, "tail": 1}
    c, _, f = _passes(n, prune)
    passes = n >> c
    nodes, tail = _level_launches(n >> max(f, prune))
    return {"leaves": 0, "subtree": passes,
            "nodes": nodes + passes * max(0, prune - f), "tail": tail}


def _kernels(batch: bool):
    """(subtree, nodes, tail) wrappers of a single tree or a tree batch."""
    if batch:
        return sha_subtree_batch, sha_nodes_batch, sha_tail_batch
    return sha_subtree, sha_nodes, sha_tail


def _rows(t: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """Rows a..b of a (rows, 8) buffer, or of each tree of a (B, rows, 8)
    batch."""
    return t[..., a:b, :]


def build_tree(values: torch.Tensor, out: torch.Tensor | None = None, *,
               rows: bool = False, wide: bool = False, prune: int = 0,
               scratch: torch.Tensor | None = None, batch: bool = False):
    """The stored digest levels of the tree over `values` into `out` (a
    contiguous (rows, 8) int32 buffer of :func:`tree_rows` rows, allocated
    when None); n, the last axis, at least 1.  One value a leaf ((n,)
    u32, or (2, n) limb planes with `wide`), or with `rows` the row
    messages of C columns ((C, n), or (C, 2, n) with `wide`).  A level of
    odd size promotes its last node unhashed.  With `prune` (a
    power-of-two tree only) the first `prune` levels are not stored;
    those that the subtree kernel does not fuse go through `scratch` (a
    (rows, 8) int32 buffer of at least :func:`scratch_rows` rows,
    allocated when needed and None).  With `batch`, B unpruned
    power-of-two trees along the leading axis of `values` into a (B,
    rows, 8) `out`, each kernel launched once for all of them.  Returns
    the buffer."""
    n = int(values.shape[-1])
    if prune and (n & (n - 1) or (1 << prune) > n):
        raise ValueError(f"prune={prune} needs a power-of-two leaf count "
                         f">= 2^prune, got {n}")
    if n < 1:
        raise ValueError("a Merkle tree needs at least one leaf")
    if batch and (prune or n & (n - 1)):
        raise ValueError("a tree batch is of unpruned power-of-two trees")
    m = n >> prune
    if out is None:
        lead = (int(values.shape[0]),) if batch else ()
        out = torch.empty(lead + (tree_rows(m), 8), dtype=torch.int32,
                          device=values.device)
    if n & (n - 1):  # K3 alone, then one level a launch
        leaves = sha_row_leaves if rows else sha_leaves
        leaves(values, out=out[:n], wide=wide)
        return hash_levels(out, n)
    subtree, nodes, tail = _kernels(batch)
    if _tail_builds(n):
        return tail(values, out, leaves=True, rows=rows, wide=wide,
                    store_from=prune)
    k = n.bit_length() - 1
    c, s, f = _passes(n, prune)
    if prune > f:
        regions = _scratch_regions(n, prune, scratch, values.device)
    for q in range(n >> c):
        part = values[..., q << c:(q + 1) << c]
        if prune <= f:
            subtree(part, out, rows=rows, wide=wide, span_log=s, levels=f,
                    store_from=prune, tree_log=k, block0=q << (c - s))
            continue
        level = subtree(part, regions[0], rows=rows, wide=wide, span_log=s,
                        levels=f, store_from=f, tree_log=c)[:1 << (c - f)]
        for lv in range(f + 1, prune + 1):
            size = 1 << (c - lv)
            dst = (out[q * size:(q + 1) * size] if lv == prune
                   else regions[(lv - f) % 2][:size])
            nodes(level, out=dst)
            level = dst
    return hash_levels(out, m, max(f, prune) - prune, batch=batch)


def _scratch_regions(n: int, prune: int, scratch, device) -> tuple:
    """The scratch's two regions (a pass's top fused level, then half as
    many rows) for a pruned build of n leaves."""
    need = scratch_rows(n, prune)
    if scratch is None:
        scratch = tree_scratch([(n, prune)], device)
    elif (scratch.dtype != torch.int32 or scratch.dim() != 2
          or scratch.shape[0] < need or scratch.shape[1] != 8
          or scratch.device != device):
        raise ValueError(f"a pruned build of {n} leaves needs a ({need}, 8) "
                         f"int32 scratch on {device}, got "
                         f"{tuple(scratch.shape)} {scratch.dtype} on "
                         f"{scratch.device}")
    c, _, f = _passes(n, prune)
    s = 1 << (c - f)
    return scratch[:s], scratch[s:s + s // 2]


def hash_levels(out: torch.Tensor, m: int, first: int = 0, *,
                batch: bool = False) -> torch.Tensor:
    """Every level above level `first` of a tree buffer whose first `m`
    rows hold the tree's first level (:func:`level_offsets` layout), from
    level `first` already written: one K4 launch a level, the promoted
    node of an odd level copied after its pairs, until a level of a
    power-of-two size of at most 2^TAIL_LOG nodes, whose levels up to the
    root the tail hashes in one launch.  `batch`: a (B, rows, 8) buffer
    of B trees.  Returns `out`."""
    _, nodes, tail = _kernels(batch)
    offs = level_offsets(m)
    for j in range(first, len(offs) - 1):
        (off_c, size_c), (off_p, _) = offs[j], offs[j + 1]
        if _tail_builds(size_c):
            tail(_rows(out, off_c, off_c + size_c),
                 _rows(out, off_p, off_p + size_c - 1))
            break
        half = size_c // 2
        nodes(_rows(out, off_c, off_c + 2 * half),
              out=_rows(out, off_p, off_p + half))
        if size_c % 2:  # the odd node goes up unhashed
            out[..., off_p + half, :] = out[..., off_c + size_c - 1, :]
    return out


def tree_rows(n: int) -> int:
    """Digest rows of the buffer of a tree of n leaves (2n - 1 for a
    power of two)."""
    off, size = level_offsets(n)[-1]
    return off + size


class MerkleTree:
    """Commitment over a vector of canonical field values (int32 storage:
    (n,), or with `wide` the (2, n) limb planes of Goldilocks values).

    ``MerkleTree(values)`` hashes on the values' device; ``root()``
    returns lowercase hex like the reference.  With ``prune`` the first
    `prune` levels are not stored (:func:`build_tree`), and the host
    authentication paths refuse: a pruned tree's paths come from the
    device query phase."""

    def __init__(self, values: torch.Tensor, out: torch.Tensor | None = None,
                 *, wide: bool = False, prune: int = 0,
                 scratch: torch.Tensor | None = None):
        if (values.dim() != 1 + wide or values.shape[-1] == 0
                or (wide and values.shape[0] != 2)):
            raise ValueError(f"MerkleTree needs a non-empty "
                             f"{'(2, n)' if wide else '1-D'} tensor, got "
                             f"shape {tuple(values.shape)}")
        self._build(values, out, False, wide, prune, scratch)

    def _build(self, values, out, rows: bool, wide: bool, prune: int,
               scratch) -> None:
        self.num_leaves = int(values.shape[-1])
        self.prune = int(prune)
        self.buffer = build_tree(values, out, rows=rows, wide=wide,
                                 prune=self.prune, scratch=scratch)
        self.offsets = level_offsets(self.num_leaves >> self.prune)

    @classmethod
    def from_columns(cls, cols: torch.Tensor,
                     out: torch.Tensor | None = None, *,
                     wide: bool = False, prune: int = 0,
                     scratch: torch.Tensor | None = None) -> "MerkleTree":
        """Commit a multi-column codeword: cols (C, n), or (C, 2, n) with
        `wide`, C = 1..6; leaf i = SHA-256 of row i's values, 8 big-endian
        bytes each (the row message a query opens, so the verifier hashes
        it as the leaf preimage).  The same buffer as a one-column tree."""
        if (cols.dim() != 2 + wide or not 1 <= cols.shape[0] <= 6
                or cols.shape[-1] == 0 or (wide and cols.shape[1] != 2)):
            raise ValueError(f"from_columns needs a (C, {'2, ' * wide}n) "
                             f"tensor, C = 1..6")
        tree = cls.__new__(cls)
        tree._build(cols, out, True, wide, prune, scratch)
        return tree

    @property
    def levels(self) -> list[torch.Tensor]:
        """Per stored level (m, 8) views, level `prune` first, root
        last."""
        return [self.buffer[o:o + m] for o, m in self.offsets]

    @property
    def root_digest(self) -> torch.Tensor:
        """(8,) int32 root words, still on the device."""
        return self.buffer[-1]

    @property
    def entries(self) -> list[torch.Tensor]:
        """The buffers K5's query form reads for this tree (its one
        buffer; a ``DistMerkleTree`` has one a subtree)."""
        return [self.buffer]

    def level_size(self, level_i: int) -> int:
        """Nodes of stored level `level_i` (0 the first stored level)."""
        return self.offsets[level_i][1]

    def root_bytes(self) -> bytes:
        """The root's 32 bytes (only they cross to the host)."""
        return digest_to_bytes(self.buffer[-1])

    def root(self) -> str:
        """Lowercase hex root (merkle/mod.rs:24-26)."""
        return self.root_bytes().hex()

    def path_rows(self, index: int) -> list[int]:
        """Buffer rows of the sibling digests of leaf `index`, leaf level
        upward, skipping the levels where its node is promoted (an
        unpruned tree only)."""
        if self.prune:
            raise RuntimeError(
                "pruned tree: its first levels are not stored, so its "
                "authentication paths come from the device query phase's "
                "subtree recompute (channel/device_query.py), not from "
                "host gathers")
        if not 0 <= index < self.num_leaves:
            raise IndexError(f"leaf index {index} out of range")
        rows = []
        for l, (off, size) in enumerate(self.offsets[:-1]):
            j = index >> l
            if not (j == size - 1 and size % 2):
                rows.append(off + (j ^ 1))
        return rows

    def get_authentication_path(self, index: int) -> bytes:
        """Concatenated sibling digests, leaf level upward."""
        rows = torch.tensor(self.path_rows(index), dtype=torch.int64,
                            device=self.buffer.device)
        sibs = self.buffer.index_select(0, rows).cpu().tolist()
        return b"".join(digest_to_bytes(s) for s in sibs)

    @staticmethod
    def validate(root_hex: str, proof: bytes, index: int, leaf_bytes: bytes,
                 num_leaves: int) -> bool:
        """Host-side auth-path check (hashlib); `leaf_bytes` is the leaf's
        preimage, hashed here like tree construction does: the raw 8-byte
        BE field value, or a row message of 8C bytes."""
        if index < 0 or index >= num_leaves or num_leaves <= 0:
            return False
        if len(proof) % 32:
            return False
        sibs = [proof[i:i + 32] for i in range(0, len(proof), 32)]
        cur = hashlib.sha256(leaf_bytes).digest()
        idx, size = index, num_leaves
        while size > 1:
            if not (idx == size - 1 and size % 2 == 1):  # else promoted
                if not sibs:
                    return False
                sib = sibs.pop(0)
                pair = cur + sib if idx % 2 == 0 else sib + cur
                cur = hashlib.sha256(pair).digest()
            idx //= 2
            size = (size + 1) // 2
        return not sibs and cur.hex() == root_hex.lower()


def merkle_root_host_rows(cols) -> str:
    """Host oracle of the multi-column tree: leaf i = SHA-256 of row i's
    values, 8 big-endian bytes each (hashlib)."""
    c, n = len(cols), len(cols[0])
    level = [hashlib.sha256(b"".join(int(cols[j][i]).to_bytes(8, "big")
                                     for j in range(c))).digest()
             for i in range(n)]
    while len(level) > 1:
        nxt = [hashlib.sha256(level[i] + level[i + 1]).digest()
               for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0].hex()


def merkle_root_host(values: list[int]) -> str:
    """Pure-host oracle tree (hashlib), rs_merkle semantics."""
    level = [hashlib.sha256(int(v).to_bytes(8, "big")).digest()
             for v in values]
    while len(level) > 1:
        nxt = [hashlib.sha256(level[i] + level[i + 1]).digest()
               for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0].hex()
