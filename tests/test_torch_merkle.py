"""The port's hashing and Merkle layer (plain versions of kernels K3/K4 on
CPU tensors) against hashlib and the JAX package, exact equality; the
JAX tree build runs its Pallas kernels in interpret mode."""

import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stark_tpu.hash.sha256_jax import sha256_pairs as j_pairs
from stark_tpu.hash.sha256_jax import sha256_row_leaves as j_row_leaves
from stark_tpu.hash.sha256_jax import sha256_u64_leaves as j_leaves
from stark_tpu.merkle.tree import MerkleTree as JMerkleTree
from stark_tpu_torch.hash.cuda_sha import (sha_leaves, sha_nodes,
                                           sha_row_leaves)
from stark_tpu_torch.hash.sha256 import (sha256_pairs, sha256_row_leaves,
                                         sha256_u64_leaves)
from stark_tpu_torch.interop import tensor_to_u32, u32_to_tensor
from stark_tpu_torch.merkle.tree import (MerkleTree, level_offsets,
                                         merkle_root_host)

P = 3 * 2**30 + 1


def _vals(n, seed, bound=P):
    rs = np.random.RandomState(seed)
    return rs.randint(0, bound, size=n, dtype=np.int64).astype(np.uint32)


def _bytes(row) -> bytes:
    return np.asarray(row, dtype=np.uint32).astype(">u4").tobytes()


def test_leaves_match_hashlib_and_jax():
    v = np.concatenate([np.array([0, 1, P - 1, 2**32 - 1], np.uint32),
                        _vals(60, 1)])
    got = tensor_to_u32(sha256_u64_leaves(u32_to_tensor(v, device="cpu")))
    for i, x in enumerate(v):
        # the 8-byte big-endian leaf preimage (merkle/mod.rs:14-16)
        assert _bytes(got[i]) == hashlib.sha256(
            int(x).to_bytes(8, "big")).digest()
    want = np.asarray(j_leaves(jnp.zeros(len(v), jnp.uint32), jnp.asarray(v)))
    np.testing.assert_array_equal(got, want)


def test_pairs_match_hashlib_and_jax():
    kids = _vals(64 * 8, 2, 2**32).reshape(64, 8)
    got = tensor_to_u32(sha256_pairs(u32_to_tensor(kids, device="cpu")))
    for j in range(32):
        assert _bytes(got[j]) == hashlib.sha256(
            _bytes(kids[2 * j]) + _bytes(kids[2 * j + 1])).digest()
    want = np.asarray(j_pairs(jnp.asarray(kids[0::2]),
                              jnp.asarray(kids[1::2])))
    np.testing.assert_array_equal(got, want)


def test_wrappers_write_into_out_views():
    v = u32_to_tensor(_vals(16, 3), device="cpu")
    buf = torch.zeros((31, 8), dtype=torch.int32)
    sha_leaves(v, out=buf[:16])
    sha_nodes(buf[:16], out=buf[16:24])
    assert torch.equal(buf[:16], sha256_u64_leaves(v))
    assert torch.equal(buf[16:24], sha256_pairs(buf[:16]))
    assert sha_leaves.plain is sha256_u64_leaves
    assert sha_nodes.plain is sha256_pairs


@pytest.mark.parametrize("log_n", [0, 1, 3, 8, 11])
def test_tree_root_and_paths_match_jax(log_n):
    n = 1 << log_n
    v = _vals(n, 10 + log_n)
    t = MerkleTree(u32_to_tensor(v, device="cpu"))
    jt = JMerkleTree(jnp.asarray(v))
    assert t.root() == jt.root() == merkle_root_host(v.tolist())
    assert t.levels[-1].shape == (1, 8)
    for i in sorted({0, n - 1, n // 3, n // 2}):
        path = t.get_authentication_path(i)
        assert path == jt.get_authentication_path(i)
        assert MerkleTree.validate(t.root(), path, i,
                                   int(v[i]).to_bytes(8, "big"), n)
        if n > 1:
            bad = bytearray(path)
            bad[5] ^= 1
            assert not MerkleTree.validate(t.root(), bytes(bad), i,
                                           int(v[i]).to_bytes(8, "big"), n)


def test_tree_matches_jax_pallas_build_interpret():
    """The port's natural-order tree vs the TPU kernels it replaces
    (build_tree_bitrev, bit-reversed plane layout, interpret mode) at
    2^8 leaves: same root and same paths."""
    from stark_tpu.hash.pallas_sha import build_tree_bitrev
    from stark_tpu.merkle.tree import bitrev_layouts

    n = 1 << 8
    v = _vals(n, 42)
    levels = build_tree_bitrev(jnp.asarray(v), interpret=True)
    jt = JMerkleTree(None, device_levels=levels, layouts=bitrev_layouts(n))
    t = MerkleTree(u32_to_tensor(v, device="cpu"))
    assert t.root() == jt.root()
    for i in (0, 77, 128, 255):
        assert t.get_authentication_path(i) == jt.get_authentication_path(i)


def test_storage_layout_is_natural_and_contiguous():
    n = 32
    v = u32_to_tensor(_vals(n, 5), device="cpu")
    t = MerkleTree(v)
    assert level_offsets(n) == [(0, 32), (32, 16), (48, 8), (56, 4),
                                (60, 2), (62, 1)]
    assert t.buffer.shape == (2 * n - 1, 8)
    # children of parent j are rows 2j, 2j+1 of the level below
    assert torch.equal(t.levels[1][3], sha256_pairs(t.levels[0][6:8])[0])
    assert t.path_rows(5) == [4, 32 + 3, 48 + 0, 56 + 1, 60 + 1]


def test_unported_tree_shapes_raise():
    """An odd-size tree now builds (rs_merkle promotion, as the JAX
    package; tests/test_torch_merkle_odd.py holds it against JAX); an
    empty tree and a pruned one of odd size still raise."""
    v = _vals(6, 1)
    t = MerkleTree(u32_to_tensor(v, device="cpu"))
    assert t.root() == merkle_root_host([int(x) for x in v])
    with pytest.raises(ValueError, match="non-empty"):
        MerkleTree(torch.empty(0, dtype=torch.int32))
    with pytest.raises(ValueError, match="power-of-two"):
        MerkleTree(u32_to_tensor(v, device="cpu"), prune=1)


def _row_msg(cols, i) -> bytes:
    """Row i of (C, n) columns as its leaf preimage: 8 BE bytes a value."""
    return b"".join(int(x).to_bytes(8, "big") for x in cols[:, i])


@pytest.mark.parametrize("c", range(1, 7))
def test_row_leaves_match_hashlib_and_jax(c):
    """K3's row form (plain version): SHA-256 of each row's 8C-byte
    message, equal to JAX's sha256_row_leaves; at C = 1 the one-column
    leaf."""
    cols = _vals((c, 40), 70 + c)
    cols[:, 0] = [0, P - 1, 1, 2**32 - 1, 5, 6][:c]
    t = u32_to_tensor(cols, device="cpu")
    got = tensor_to_u32(sha256_row_leaves(t))
    np.testing.assert_array_equal(got, np.asarray(j_row_leaves(
        jnp.asarray(cols))))
    for i in (0, 17, 39):
        assert _bytes(got[i]) == hashlib.sha256(_row_msg(cols, i)).digest()
    assert torch.equal(sha_row_leaves(t), sha256_row_leaves(t))
    if c == 1:
        assert torch.equal(sha256_row_leaves(t), sha256_u64_leaves(t[0]))


@pytest.mark.parametrize("c", range(1, 7))
@pytest.mark.parametrize("log_n", [0, 5])
def test_from_columns_root_and_paths_match_jax(c, log_n):
    n = 1 << log_n
    cols = _vals((c, n), 80 + 7 * c + log_n)
    t = MerkleTree.from_columns(u32_to_tensor(cols, device="cpu"))
    jt = JMerkleTree.from_columns(jnp.asarray(cols))
    assert t.root() == jt.root()
    assert t.buffer.shape == (2 * n - 1, 8)
    for i in sorted({0, n - 1, n // 3}):
        path = t.get_authentication_path(i)
        assert path == jt.get_authentication_path(i)
        assert MerkleTree.validate(t.root(), path, i, _row_msg(cols, i), n)
        bad = bytearray(_row_msg(cols, i))
        bad[-1] ^= 1
        assert not MerkleTree.validate(t.root(), path, i, bytes(bad), n)


def test_row_leaves_wrapper_writes_into_out_and_rejects_shapes():
    cols = u32_to_tensor(_vals((2, 16), 90), device="cpu")
    buf = torch.zeros((31, 8), dtype=torch.int32)
    sha_row_leaves(cols, out=buf[:16])
    assert torch.equal(buf[:16], sha256_row_leaves(cols))
    assert sha_row_leaves.plain is sha256_row_leaves
    for bad in (torch.zeros((7, 4), dtype=torch.int32),
                torch.zeros(4, dtype=torch.int32)):
        with pytest.raises(ValueError, match="C = 1..6"):
            sha_row_leaves(bad)
        with pytest.raises(ValueError, match="C = 1..6"):
            MerkleTree.from_columns(bad)
