"""Pruned Merkle storage and the chunked tree build of the port
(``stark_tpu_torch/merkle/tree.py``) and the query plan's recompute of
the unstored siblings (``channel/device_query.py``, the plain version of
K5's query form) against the JAX package, exact equality (digest words,
indices, values, chain states).  Small trees: 2^5 to 2^9 leaves, with the
keep-log and the chunk sizes shrunk as ``tests/test_pruned_tree.py``
shrinks them."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import stark_tpu.merkle.tree as jmt
import stark_tpu_torch.merkle.tree as tmt
from stark_tpu.channel import device_query as jdq
from stark_tpu_torch.channel.device_query import (DeviceQueryPlan,
                                                  query_chain,
                                                  query_chain_plain,
                                                  supported)
from stark_tpu_torch.fri.commit import layer_layout
from stark_tpu_torch.interop import tensor_to_u32
from stark_tpu_torch.merkle.tree import MerkleTree

P = 3 * 2**30 + 1


def _words(shape, seed, bound=2**32):
    rs = np.random.RandomState(seed)
    return rs.randint(0, bound, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _assert_levels(port: MerkleTree, jax_levels):
    assert len(port.levels) == len(jax_levels)
    for got, want in zip(port.levels, jax_levels):
        np.testing.assert_array_equal(tensor_to_u32(got), np.asarray(want))


@pytest.mark.parametrize("keep", [0, 3, 20])
@pytest.mark.parametrize("n", [1, 2, 8, 2**9, 2**20, 2**24, 2**28,
                               2**22 - 1, 3 * 2**20])
def test_prune_depth_for_matches_jax(monkeypatch, keep, n):
    monkeypatch.setattr(jmt, "PRUNE_KEEP_LOG", keep)
    monkeypatch.setattr(tmt, "PRUNE_KEEP_LOG", keep)
    assert tmt.prune_depth_for(n) == jmt.prune_depth_for(n)
    monkeypatch.setenv("STARK_TPU_NO_PRUNE", "1")
    monkeypatch.setenv("STARK_TPU_TORCH_NO_PRUNE", "1")
    assert tmt.prune_depth_for(n) == jmt.prune_depth_for(n) == 0


def test_prune_depth_for_default_and_its_switch(monkeypatch):
    """The JAX default keep-log; the port's switch is its own variable."""
    assert tmt.PRUNE_KEEP_LOG == 22
    assert tmt.prune_depth_for(2**26) == 4
    assert tmt.prune_depth_for(2**22) == 0
    monkeypatch.setenv("STARK_TPU_NO_PRUNE", "1")
    assert tmt.prune_depth_for(2**26) == 4
    monkeypatch.setenv("STARK_TPU_TORCH_NO_PRUNE", "1")
    assert tmt.prune_depth_for(2**26) == 0


# (leaf form, n): one u32 value a leaf, one 64-bit limb pair, and the row
# form at C = 2 and 3 in both widths
TREES = [("u32", 2**9), ("wide", 2**8), ("rows2", 2**7), ("rows3", 2**6),
         ("rows2-wide", 2**6), ("rows3-wide", 2**5)]


def _tree_case(form, n):
    """(port values, JAX values, wide, rows) of a seeded tree."""
    wide = form.endswith("wide")
    cols = int(form[4]) if form.startswith("rows") else None
    shape = ((cols,) if cols else ()) + ((2,) if wide else ()) + (n,)
    vals = _words(shape, 40 + n + 7 * (cols or 0), P)
    return _t(vals), jnp.asarray(vals), wide, cols is not None


def _port_tree(vals, wide, rows, **kw):
    if rows:
        return MerkleTree.from_columns(vals, wide=wide, **kw)
    return MerkleTree(vals, wide=wide, **kw)


@pytest.mark.parametrize("form,n", TREES)
def test_pruned_levels_match_jax(form, n):
    """MerkleTree(..., prune=) / from_columns(..., prune=) store exactly
    the JAX tree's stored levels, at every depth up to the root alone."""
    vals, jvals, wide, rows = _tree_case(form, n)
    log_n = n.bit_length() - 1
    for prune in (0, 1, 3, log_n):
        port = _port_tree(vals, wide, rows, prune=prune)
        jt = (jmt.MerkleTree.from_columns(jvals, prune=prune) if rows
              else jmt.MerkleTree(jvals, prune=prune))
        assert (port.prune, port.num_leaves) == (prune, n)
        assert port.num_leaves == jt.num_leaves
        assert tuple(port.buffer.shape) == (2 * (n >> prune) - 1, 8)
        _assert_levels(port, jt.levels)
        assert port.root() == jt.root()


@pytest.mark.parametrize("form", [form for form, _ in TREES])
def test_chunked_build_matches_jax(monkeypatch, form):
    """Every pruned tree of 2^6 leaves chunked (CHUNK_MIN_LOG shrunk) at
    two chunk sizes, one as small as 2^prune (a chunk is one plain K3 and
    `prune` plain K4 calls, each ~30 ms on a CPU, so the tree is small):
    the stored levels equal JAX's
    build_levels_chunked_fn (one column) or its pruned column build (the
    row form, which JAX builds in one shot)."""
    n = 2**6
    vals, jvals, wide, rows = _tree_case(form, n)
    log_n = n.bit_length() - 1
    monkeypatch.setattr(tmt, "CHUNK_MIN_LOG", 1)
    for prune in (1, 3):
        if rows:
            want = jax.jit(jmt.build_columns_fn(n, prune))(jvals)
        else:
            want = jax.jit(jmt.build_levels_chunked_fn(
                n, wide, prune, chunk_log=prune + 1))(jvals)
        for chunk in (prune, log_n - 1):
            monkeypatch.setattr(tmt, "CHUNK_LOG", chunk)
            assert tmt.chunk_log(n, prune) == max(chunk, prune)
            port = _port_tree(vals, wide, rows, prune=prune)
            _assert_levels(port, want)


def test_chunked_build_shares_a_scratch_and_routes_by_size(monkeypatch):
    """One scratch serves trees of several sizes; below CHUNK_MIN_LOG the
    leaf level is hashed in one pass, from it in CHUNK_LOG chunks, and
    the scratch (needed only where `prune` passes the subtree kernel's
    fused levels, here 1 above 2^3-leaf blocks, with a 2^2-node tail)
    holds one pass's top fused level and half as many again."""
    monkeypatch.setattr(tmt, "CHUNK_MIN_LOG", 8)
    monkeypatch.setattr(tmt, "CHUNK_LOG", 5)
    monkeypatch.setattr(tmt, "SUBTREE_LOG", 3)
    monkeypatch.setattr(tmt, "SUBTREE_LEVELS", 1)
    monkeypatch.setattr(tmt, "TAIL_LOG", 2)
    assert tmt.chunk_log(2**7, 3) == 7
    assert tmt.chunk_log(2**9, 3) == 5
    assert tmt.scratch_rows(2**9, 3) == 16 + 8
    assert tmt.scratch_rows(2**9, 2) == 16
    assert tmt.scratch_rows(2**9, 1) == 0
    assert tmt.scratch_rows(2**9, 0) == 0
    assert tmt.scratch_rows(2**2, 2) == 0  # the tail builds it
    trees = [(2**9, 3), (2**7, 2), (2**6, 0)]
    scratch = tmt.tree_scratch(trees, "cpu")
    assert tuple(scratch.shape) == (2**6, 8)
    assert tmt.tree_scratch([(2**9, 0), (2**9, 1)], "cpu") is None
    for n, prune in trees:
        vals = _t(_words(n, n, P))
        got = MerkleTree(vals, prune=prune, scratch=scratch)
        _assert_levels(got, jmt.MerkleTree(jnp.asarray(tensor_to_u32(vals)),
                                           prune=prune).levels)
    with pytest.raises(ValueError, match="scratch"):
        MerkleTree(_t(_words(2**9, 1, P)), prune=3, scratch=scratch[:20])


def test_pruned_tree_refuses_host_paths():
    pruned = MerkleTree(_t(_words(64, 3, P)), prune=2)
    for call in (pruned.path_rows, pruned.get_authentication_path):
        with pytest.raises(RuntimeError, match="pruned"):
            call(3)
    full = MerkleTree(_t(_words(64, 3, P)))
    assert len(full.get_authentication_path(3)) == 6 * 32


def test_prune_rejects_bad_shapes():
    with pytest.raises(ValueError, match="prune"):
        MerkleTree(_t(_words(2, 1, P)), prune=3)
    with pytest.raises(ValueError, match="prune"):
        MerkleTree(_t(_words(12, 1, P)), prune=1)
    with pytest.raises(ValueError, match="prune"):
        MerkleTree.from_columns(_t(_words((2, 4), 1, P)), prune=3)


# pruned query plans: (columns, elem_width, trace prune, FRI prunes), over
# a 2^6-point LDE with three trace offsets and FRI layers 64 .. 2 (layer
# prunes up to each whole tree, so a sibling may be the block's other
# half, j's own top bit)
PLANS = [(1, 1, 3, (3, 2, 1, 0, 0, 0)), (2, 1, 6, (6, 5, 4, 3, 2, 1)),
         (1, 2, 2, (1, 1, 1, 1, 1, 0)), (3, 2, 4, (3, 0, 2, 0, 1, 0))]


def _fri_buffers(layers, width, prunes):
    """The port's FRI buffers: every layer's values and its stored tree
    levels, concatenated at layer_layout's offsets."""
    layout, vt, dt = layer_layout([v.shape[-1] for v in layers], width,
                                  prunes)
    values = torch.empty(vt, dtype=torch.int32)
    digests = torch.empty((dt, 8), dtype=torch.int32)
    for v, (ln, vo, do), prune in zip(layers, layout, prunes):
        values[vo:vo + width * ln] = _t(v).reshape(-1)
        MerkleTree(_t(v), out=digests[do:do + 2 * (ln >> prune) - 1],
                   wide=width == 2, prune=prune)
    return values, digests


@pytest.mark.parametrize("cols,width,trace_prune,fri_prune", PLANS)
def test_pruned_query_plan_matches_jax(cols, width, trace_prune, fri_prune):
    """query_chain_plain on a pruned plan (the unstored siblings
    recomputed per query with the plain K3 / K4) against the JAX plan of
    the same prunes (its _subtree_sibs inside the scan): final state,
    idxs, every opened value and digest."""
    n, offsets, q_n = 64, (0, 4, 8), 5
    fri = tuple(n >> k for k in range(6))
    lanes = (width,) if width == 2 else ()
    f_evals = _words((cols,) + lanes + (n,), 90 + cols, P)
    layers = [_words(lanes + (ln,), 91 + k, P) for k, ln in enumerate(fri)]
    state = _words(8, 92)
    jf = jnp.asarray(f_evals if cols > 1 else f_evals[0])
    jt = (jmt.MerkleTree.from_columns(jf, prune=trace_prune) if cols > 1
          else jmt.MerkleTree(jf, prune=trace_prune))
    jlv = [jmt.MerkleTree(jnp.asarray(v), prune=pr).levels[:-1]
           for v, pr in zip(layers, fri_prune)]
    jplan = jdq.DeviceQueryPlan(n - max(offsets), q_n, offsets, n, fri,
                                elem_width=width, num_columns=cols,
                                trace_prune=trace_prune, fri_prune=fri_prune)
    want_final, (want_idx, outs) = jax.device_get(jax.jit(functools.partial(
        jplan._run, mode=0))(
        jnp.asarray(state), jf, tuple(jt.levels[:-1]),
        tuple(jnp.asarray(v) for v in layers), tuple(tuple(l) for l in jlv)))
    outs = [np.asarray(o) for o in outs]
    want_vals = np.concatenate([o.reshape(q_n, -1) for o in outs
                                if o.ndim < 3 or o.shape[-1] != 8], axis=1)
    want_digs = np.concatenate([o for o in outs
                                if o.ndim == 3 and o.shape[-1] == 8], axis=1)

    assert supported(n - max(offsets), n, fri, cols, width, trace_prune,
                     fri_prune)
    plan = DeviceQueryPlan(n - max(offsets), q_n, offsets, n, fri, cols,
                           width, trace_prune, fri_prune)
    f_t = _t(f_evals)
    tree = (MerkleTree.from_columns(f_t, wide=width == 2, prune=trace_prune)
            if cols > 1 else MerkleTree(f_t[0], wide=width == 2,
                                        prune=trace_prune))
    values, digests = _fri_buffers(layers, width, fri_prune)
    final, idxs, vals, digs = plan.run_device(_t(state), f_t, tree.buffer,
                                              values, digests)
    np.testing.assert_array_equal(tensor_to_u32(final), want_final)
    np.testing.assert_array_equal(idxs.numpy(), want_idx)
    np.testing.assert_array_equal(tensor_to_u32(vals), want_vals)
    np.testing.assert_array_equal(tensor_to_u32(digs), want_digs)
    # one recompute task a pruned path: the trace's at each offset, two a
    # pruned FRI layer; a task keeps levels 0 .. prune - 1 of its block
    tb = plan.pack("cpu")
    tasks = [(len(offsets), trace_prune)] + [(2, pr) for pr in fri_prune]
    assert int(tb.tasks.shape[0]) == sum(k for k, pr in tasks if pr)
    assert tb.subtree_rows == sum(k * ((2 << pr) - 2) for k, pr in tasks)
    assert tb.max_prune == max(trace_prune, *fri_prune)
    assert tb.sizes[1] == 2 * (n >> trace_prune) - 1
    assert query_chain.plain is query_chain_plain


def test_pruned_plan_rejects_depths_past_its_trees():
    assert not supported(60, 64, (64, 32), 1, 1, 7, (0, 0))
    assert not supported(60, 64, (64, 32), 1, 1, 0, (0, 6))
    assert not supported(60, 64, (64, 32), 1, 1, 0, (1,))
    with pytest.raises(ValueError, match="prune"):
        DeviceQueryPlan(60, 1, (0, 4), 64, (64, 32), 1, 1, 0, (0, 6))
