"""The tree build's split into launches (``merkle/tree.py``: K3's subtree
form, K4 one level a launch, K4's tail) on the CPU, where each launch runs
its plain version over the same span and into the same rows as the
kernel, against the JAX package's tree, exact: the stored buffer, the
root and every authentication path.  The block span, its fused levels and
the tail are shrunk (a 2^3-leaf block, 2 fused levels, a 2^2-node tail)
so that trees of 2^0 to 2^12 leaves cross every boundary: the tail alone,
the subtree kernel then the tail, and K4 levels between them.

One JAX tree a form serves every size: the tree over the first 2^k (or
the b-th 2^k) of its values is its subtree, whose levels are slices of
its levels.  The launches each build makes are counted through the
wrappers and held against ``tree_launches``."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import stark_tpu_torch.merkle.tree as mt
from stark_tpu.merkle.tree import MerkleTree as JMerkleTree
from stark_tpu.merkle.tree import merkle_root_host_rows as j_root_rows
from stark_tpu_torch.dist import dist_merkle_tree, make_mesh
from stark_tpu_torch.hash import cuda_sha
from stark_tpu_torch.interop import tensor_to_u32, u32_to_tensor
from stark_tpu_torch.merkle.tree import MerkleTree, build_tree

P = 3 * 2**30 + 1
BIG = 12  # the one-column u32 reference tree: 2^12 leaves
FORM_LOG = 8  # the row-form and 64-bit reference trees: 2^8 leaves
WRAPPERS = {"leaves": ("sha_leaves", "sha_row_leaves"),
            "subtree": ("sha_subtree", "sha_subtree_batch"),
            "nodes": ("sha_nodes", "sha_nodes_batch"),
            "tail": ("sha_tail", "sha_tail_batch")}


@pytest.fixture(autouse=True)
def shrunk(monkeypatch):
    monkeypatch.setattr(mt, "SUBTREE_LOG", 3)
    monkeypatch.setattr(mt, "SUBTREE_LEVELS", 2)
    monkeypatch.setattr(mt, "TAIL_LOG", 2)


@pytest.fixture
def calls(monkeypatch):
    """Each kind of launch build_tree makes, counted at its wrapper."""
    got = dict.fromkeys(WRAPPERS, 0)
    for kind, names in WRAPPERS.items():
        for name in names:
            def counted(*a, _fn=getattr(mt, name), _kind=kind, **kw):
                got[_kind] += 1
                return _fn(*a, **kw)
            monkeypatch.setattr(mt, name, counted)
    return got


@functools.lru_cache(maxsize=None)
def _ref(form: str, n: int):
    """(values, the JAX tree's levels as uint32 arrays) of seeded values:
    "u32" (n,), "rows1" / "rows6" (C, n) columns, "wide" (2, n) limb
    planes.  One column's row messages are its values' leaf preimages,
    so "rows1" is the "u32" reference tree (of 2^BIG leaves, whose
    prefixes the tests take) over its values as a (1, n) column."""
    if form == "rows1":
        v, levels = _ref("u32", 1 << BIG)
        return v[None], levels
    rs = np.random.RandomState(n + len(form))
    if form == "wide":
        v = rs.randint(0, 2**32, size=(2, n), dtype=np.uint64)
    else:
        shape = (int(form[-1]), n) if form.startswith("rows") else (n,)
        v = rs.randint(0, P, size=shape, dtype=np.int64)
    v = v.astype(np.uint32)
    jt = (JMerkleTree.from_columns(jnp.asarray(v)) if form.startswith("rows")
          else JMerkleTree(jnp.asarray(v)))
    return v, [np.asarray(lv) for lv in jt.levels]


def _sub(levels, k: int, b: int = 0):
    """The levels of the subtree over leaves [b 2^k, (b + 1) 2^k)."""
    return [lv[b << (k - l):(b + 1) << (k - l)]
            for l, lv in enumerate(levels[:k + 1])]


def _build(form: str, v: np.ndarray, **kw) -> MerkleTree:
    t = u32_to_tensor(v, device="cpu")
    if form.startswith("rows"):
        return MerkleTree.from_columns(t, **kw)
    return MerkleTree(t, wide=form == "wide", **kw)


def _check_tree(tree: MerkleTree, levels, prune: int = 0) -> None:
    """The stored buffer equals the JAX levels from `prune` up; unpruned,
    every leaf's path equals the one the JAX levels give, and verifies."""
    np.testing.assert_array_equal(tensor_to_u32(tree.buffer),
                                  np.concatenate(levels[prune:]))
    root = levels[-1][0].astype(">u4").tobytes().hex()
    assert tree.root() == root
    if prune:
        return
    raw = [lv.astype(">u4").tobytes() for lv in levels[:-1]]
    for i in range(len(levels[0])):
        want, j = b"", i
        for lv in raw:
            if not (j == len(lv) // 32 - 1 and len(lv) // 32 % 2):
                want += lv[32 * (j ^ 1):32 * (j ^ 1) + 32]
            j //= 2
        assert tree.get_authentication_path(i) == want


@pytest.mark.parametrize("log_n", range(BIG + 1))
def test_power_of_two_trees_match_jax(calls, log_n):
    v, levels = _ref("u32", 1 << BIG)
    tree = _build("u32", v[:1 << log_n])
    _check_tree(tree, _sub(levels, log_n))
    assert calls == mt.tree_launches(1 << log_n)


@pytest.mark.parametrize("log_n,prune", [(2, 1), (2, 2), (4, 1), (4, 3),
                                         (6, 2), (6, 3), (9, 1), (9, 3)])
def test_pruned_trees_match_jax(calls, log_n, prune):
    """Pruned within the fused levels (prune <= 2: no scratch) and past
    them (3: the scratch and a K4 launch), and pruned trees the tail
    builds alone."""
    v, levels = _ref("u32", 1 << BIG)
    n = 1 << log_n
    tree = _build("u32", v[:n], prune=prune)
    _check_tree(tree, _sub(levels, log_n), prune)
    assert calls == mt.tree_launches(n, prune)
    assert (mt.scratch_rows(n, prune) > 0) == (prune == 3 and log_n > 2)


@pytest.mark.parametrize("chunk,prune", [(4, 1), (4, 2), (5, 1), (5, 3)])
def test_chunked_build_matches_jax(monkeypatch, calls, chunk, prune):
    """2^7 leaves in chunks of 2^chunk (CHUNK_MIN_LOG shrunk): each chunk
    writes its slice of the stored levels, or of the scratch."""
    monkeypatch.setattr(mt, "CHUNK_MIN_LOG", 1)
    monkeypatch.setattr(mt, "CHUNK_LOG", chunk)
    v, levels = _ref("u32", 1 << BIG)
    tree = _build("u32", v[:1 << 7], prune=prune)
    _check_tree(tree, _sub(levels, 7), prune)
    assert calls == mt.tree_launches(1 << 7, prune)
    assert calls["subtree"] == 1 << (7 - chunk)


@pytest.mark.parametrize("form", ["rows1", "rows6", "wide"])
@pytest.mark.parametrize("log_n,prune", [(2, 0), (8, 0), (8, 3)])
def test_row_form_and_64bit_trees_match_jax(calls, form, log_n, prune):
    v, levels = _ref(form, 1 << FORM_LOG)
    tree = _build(form, v[..., :1 << log_n], prune=prune)
    sub = _sub(levels, log_n)
    if prune:
        _check_tree(tree, sub, prune)
    else:
        np.testing.assert_array_equal(tensor_to_u32(tree.buffer),
                                      np.concatenate(sub))
        assert tree.root() == sub[-1][0].astype(">u4").tobytes().hex()
    assert calls == mt.tree_launches(1 << log_n, prune)


def test_odd_trees_match_jax(calls):
    """K3 alone, K4 a level with the odd node promoted, and the tail once
    a level's size is a power of two within it: 13 u32 leaves against
    the JAX tree, 13 rows of 6 columns against its row oracle."""
    v, levels = _ref("u32", 13)
    _check_tree(_build("u32", v), levels)
    assert calls == mt.tree_launches(13)
    assert calls["leaves"] == 1 and calls["tail"] == 1
    cols = _ref("rows6", 1 << FORM_LOG)[0][:, :13]
    tree = _build("rows6", cols)
    assert tree.root() == j_root_rows(cols.tolist())
    for i in range(13):
        msg = b"".join(int(x).to_bytes(8, "big") for x in cols[:, i])
        assert MerkleTree.validate(tree.root(),
                                   tree.get_authentication_path(i), i, msg,
                                   13)


@pytest.mark.parametrize("log_n", [2, 4, 7])
def test_batch_of_three_trees_matches_jax(calls, log_n):
    """Three trees in one build (the tree as grid y): tree b over the
    b-th 2^k values, equal to the b-th subtree of the JAX tree, each
    launch made once for the three."""
    v, levels = _ref("u32", 1 << BIG)
    n = 1 << log_n
    vals = u32_to_tensor(v[:3 * n].reshape(3, n), device="cpu")
    out = build_tree(vals, batch=True)
    for b in range(3):
        np.testing.assert_array_equal(tensor_to_u32(out[b]),
                                      np.concatenate(_sub(levels, log_n, b)))
    assert calls == mt.tree_launches(n)


def test_dist_two_shard_tree_matches_jax(calls):
    """A 2-shard DistMerkleTree: each 2^6-leaf subtree through the split,
    the top level of two roots through the tail."""
    v, levels = _ref("u32", 1 << BIG)
    mesh = make_mesh(devices=["cpu"] * 2)
    tree = dist_merkle_tree(u32_to_tensor(v[:1 << 7], device="cpu"), mesh)
    sub = _sub(levels, 7)
    for got, want in zip(tree.levels, sub):
        np.testing.assert_array_equal(tensor_to_u32(got), want)
    assert tree.root() == sub[-1][0].astype(">u4").tobytes().hex()
    one = mt.tree_launches(1 << 6)
    assert calls == {k: 2 * one[k] + (k == "tail") for k in one}
    whole = _build("u32", v[:1 << 7])
    for i in range(1 << 7):
        assert (tree.get_authentication_path(i)
                == whole.get_authentication_path(i))


def test_plain_versions_write_the_launch_rows():
    """sha_subtree's plain version writes a block range's levels at the
    whole tree's rows; sha_tail's from a digest level writes levels 1..t;
    neither device check is passed over for an unknown device."""
    v, levels = _ref("u32", 1 << BIG)
    full = np.concatenate(_sub(levels, 5))
    out = torch.zeros((63, 8), dtype=torch.int32)
    vals = u32_to_tensor(v[:32], device="cpu")
    for q in range(2):  # two launches of two 2^3-leaf blocks each
        cuda_sha.sha_subtree(vals[q * 16:(q + 1) * 16], out, span_log=3,
                             levels=2, tree_log=5, block0=2 * q)
    written = np.concatenate([np.arange(32), 32 + np.arange(16),
                              48 + np.arange(8)])
    np.testing.assert_array_equal(tensor_to_u32(out)[written],
                                  full[written])
    top = torch.zeros((7, 8), dtype=torch.int32)
    cuda_sha.sha_tail(u32_to_tensor(full[48:56], device="cpu"), top)
    np.testing.assert_array_equal(tensor_to_u32(top), full[56:])
    with pytest.raises(ValueError, match="no kernel or plain path"):
        cuda_sha.sha_subtree(vals.to("meta"), out.to("meta"), span_log=3,
                             levels=2, tree_log=5)
