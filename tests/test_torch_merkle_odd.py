"""Odd-size Merkle trees (rs_merkle promotion: a level's odd last node
goes up unhashed) in the port against the JAX package's MerkleTree and
the hashlib oracle ``merkle_root_host``: roots and every leaf's
authentication path byte-identical (exact), each path accepted by
``MerkleTree.validate`` and a flipped one refused; the row form (against
the JAX package's row oracle) and the 64-bit mode at odd sizes too."""

import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stark_tpu.merkle.tree import MerkleTree as JMerkleTree
from stark_tpu.merkle.tree import merkle_root_host as j_root_host
from stark_tpu.merkle.tree import merkle_root_host_rows as j_root_rows
from stark_tpu_torch.fields.fp import host_words
from stark_tpu_torch.interop import u32_to_tensor
from stark_tpu_torch.merkle.tree import (MerkleTree, level_offsets,
                                         merkle_root_host, tree_rows)

P = 3 * 2**30 + 1
SIZES = (1, 3, 5, 6, 7, 12, 13)


def _vals(n, seed, bound=P):
    rs = np.random.RandomState(seed)
    return rs.randint(0, bound, size=n, dtype=np.int64).astype(np.uint32)


@pytest.mark.parametrize("n", SIZES)
def test_odd_tree_roots_and_paths_equal_jax(n):
    v = _vals(n, 100 + n)
    tree = MerkleTree(u32_to_tensor(v, device="cpu"))
    jtree = JMerkleTree(jnp.asarray(v))
    ints = [int(x) for x in v]
    assert tree.root() == jtree.root() == merkle_root_host(ints)
    assert tree.root() == j_root_host(ints)
    assert tree.buffer.shape == (tree_rows(n), 8)
    assert [size for _, size in level_offsets(n)] == [
        int(lv.shape[0]) for lv in jtree.levels]
    for i in range(n):
        path = tree.get_authentication_path(i)
        assert path == jtree.get_authentication_path(i)
        leaf = int(v[i]).to_bytes(8, "big")
        assert MerkleTree.validate(tree.root(), path, i, leaf, n)
        if path:
            bad = bytearray(path)
            bad[0] ^= 1
            assert not MerkleTree.validate(tree.root(), bytes(bad), i,
                                           leaf, n)


@pytest.mark.parametrize("n", (5, 13))
def test_odd_row_tree_equals_jax_oracle(n):
    """K3's row form (three columns) at an odd leaf count: the JAX
    package's row-tree oracle's root, every path validated."""
    cols = np.stack([_vals(n, 200 + c) for c in range(3)])
    tree = MerkleTree.from_columns(u32_to_tensor(cols, device="cpu"))
    assert tree.root() == j_root_rows(cols.tolist())
    for i in range(n):
        row = b"".join(int(x).to_bytes(8, "big") for x in cols[:, i])
        assert MerkleTree.validate(tree.root(),
                                   tree.get_authentication_path(i), i, row,
                                   n)


@pytest.mark.parametrize("n", (3, 7))
def test_odd_wide_tree_matches_oracle(n):
    """K3's 64-bit mode at an odd leaf count: leaf = SHA-256 of the
    8-byte value, promotion as in the u32 mode."""
    rs = np.random.RandomState(n)
    vals = [int(x) for x in rs.randint(0, 2**63, size=n, dtype=np.int64)]
    planes = host_words(np.asarray(vals, dtype=np.uint64), 2)
    tree = MerkleTree(u32_to_tensor(planes, device="cpu"), wide=True)
    assert tree.root() == merkle_root_host(vals)
    for i in range(n):
        assert MerkleTree.validate(
            tree.root(), tree.get_authentication_path(i), i,
            vals[i].to_bytes(8, "big"), n)


def test_promoted_node_is_a_copy():
    """A 3-leaf tree: level 1 is (H(l0 || l1), l2), the root H of them."""
    v = _vals(3, 1)
    tree = MerkleTree(u32_to_tensor(v, device="cpu"))
    leaves = [hashlib.sha256(int(x).to_bytes(8, "big")).digest() for x in v]
    assert torch.equal(tree.levels[1][1], tree.levels[0][2])
    assert tree.path_rows(2) == [3]  # leaf 2 has no sibling at level 0
    top = hashlib.sha256(hashlib.sha256(leaves[0] + leaves[1]).digest()
                         + leaves[2]).hexdigest()
    assert tree.root() == top
