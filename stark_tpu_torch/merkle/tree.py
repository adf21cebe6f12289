"""Merkle commitment over field-element codewords (counterpart of
``stark_tpu/merkle/tree.py``; power-of-two trees of u32 values only).

Node semantics are the reference's rs_merkle wrapper:

* leaf hash = SHA-256(8-byte big-endian field value)   (merkle/mod.rs:14-16)
* node hash = SHA-256(left_digest || right_digest)
* root      = lowercase hex string                     (merkle/mod.rs:24-26)

Storage: one (2n-1, 8) int32 buffer of digest rows in natural node order,
level after level (leaves first, root last), at static offsets
(:func:`level_offsets`).  The children of parent j of a level are rows
2j and 2j+1 of the level below, so a node hash reads 64 contiguous bytes,
and the authentication path of leaf j is the rows
``offset_l + ((j >> l) ^ 1)``.  Digests do not depend on the storage
layout, so roots and paths equal the JAX package's.

On a CUDA tensor the leaves go through kernel K3 and every level above
them, down to the root, through K4 (``hash/cuda_sha.py``); on a CPU
tensor through their plain versions.
"""

from __future__ import annotations

import hashlib

import torch

from stark_tpu_torch.hash.cuda_sha import sha_leaves, sha_nodes


def level_offsets(n: int) -> list[tuple[int, int]]:
    """(row offset, node count) of each level of a size-n tree buffer."""
    out, off, size = [], 0, n
    while True:
        out.append((off, size))
        if size == 1:
            return out
        off += size
        size //= 2


def digest_bytes(words) -> bytes:
    """Digest words (int32 storage or ints) -> 32 big-endian bytes."""
    return b"".join((int(x) & 0xFFFFFFFF).to_bytes(4, "big") for x in words)


def build_tree(values: torch.Tensor, out: torch.Tensor | None = None):
    """All digest levels of the tree over `values` ((n,) int32, n a power
    of two) into `out` (a contiguous (2n-1, 8) int32 buffer, allocated
    when None).  Returns the buffer."""
    n = int(values.shape[0])
    if n < 1 or n & (n - 1):
        raise NotImplementedError(
            "the port builds power-of-two trees only; odd-size trees "
            "(rs_merkle promotion) wait for ROADMAP Queue 1 item 14")
    if out is None:
        out = torch.empty((2 * n - 1, 8), dtype=torch.int32,
                          device=values.device)
    offs = level_offsets(n)
    sha_leaves(values, out=out[:n])
    for (off_c, size_c), (off_p, size_p) in zip(offs, offs[1:]):
        sha_nodes(out[off_c:off_c + size_c], out=out[off_p:off_p + size_p])
    return out


class MerkleTree:
    """Commitment over a vector of canonical field values (int32 storage).

    ``MerkleTree(values)`` hashes on the values' device; ``root()``
    returns lowercase hex like the reference."""

    def __init__(self, values: torch.Tensor, out: torch.Tensor | None = None):
        if values.dim() != 1 or values.shape[0] == 0:
            raise ValueError("MerkleTree needs a non-empty 1-D vector")
        self.num_leaves = int(values.shape[0])
        self.buffer = build_tree(values, out)
        self.offsets = level_offsets(self.num_leaves)

    @property
    def levels(self) -> list[torch.Tensor]:
        """Per-level (m, 8) views, leaves first, root last."""
        return [self.buffer[o:o + m] for o, m in self.offsets]

    @property
    def root_digest(self) -> torch.Tensor:
        """(8,) int32 root words, still on the device."""
        return self.buffer[-1]

    def root(self) -> str:
        """Lowercase hex root (merkle/mod.rs:24-26)."""
        return digest_bytes(self.root_digest.cpu().tolist()).hex()

    def path_rows(self, index: int) -> list[int]:
        """Buffer rows of the sibling digests of leaf `index`, leaf level
        upward."""
        if not 0 <= index < self.num_leaves:
            raise IndexError(f"leaf index {index} out of range")
        return [off + ((index >> l) ^ 1)
                for l, (off, _) in enumerate(self.offsets[:-1])]

    def get_authentication_path(self, index: int) -> bytes:
        """Concatenated sibling digests, leaf level upward."""
        rows = torch.tensor(self.path_rows(index), dtype=torch.int64,
                            device=self.buffer.device)
        sibs = self.buffer.index_select(0, rows).cpu().tolist()
        return b"".join(digest_bytes(s) for s in sibs)

    @staticmethod
    def validate(root_hex: str, proof: bytes, index: int, leaf_bytes: bytes,
                 num_leaves: int) -> bool:
        """Host-side auth-path check (hashlib); `leaf_bytes` is the raw
        8-byte BE field value, hashed here like tree construction does."""
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
