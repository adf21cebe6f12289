"""The port's mesh layer (``stark_tpu_torch/dist``) on logical CPU shards,
exact equality: the four-step NTT, INTT and coset evaluation against the
JAX package's ``dist_*`` on a mesh of virtual CPU devices and against
the port's single-device transforms (u32 and Goldilocks, the below-S^2
fallback, the sub-transforms' root); the sharded tree's roots and paths
against the JAX package's dist tree (one value, 64-bit limb pairs, row
leaves); K5's query form over sharded sources (its plain version)
against the unsharded plan on the same data at S = 1, 2, 4; and the
mesh's copy counter against ``dist.comm``'s model for whole proves.
The card's sharded query form is in ``test_torch_kernels.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stark_tpu.dist import dist_coset_evaluate as j_coset_evaluate
from stark_tpu.dist import dist_intt as j_dist_intt
from stark_tpu.dist import dist_merkle_tree as j_dist_merkle_tree
from stark_tpu.dist import dist_ntt as j_dist_ntt
from stark_tpu.dist import make_mesh as j_make_mesh
from stark_tpu_torch.channel.device_query import query_chain_plain
from stark_tpu_torch.config import ProverConfig
from stark_tpu_torch.dist import (dist_coset_evaluate, dist_intt,
                                  dist_merkle_tree, dist_ntt, make_mesh,
                                  sharded)
from stark_tpu_torch.dist.comm import (fri_fold_schedule, prove_collectives,
                                       sharded_layers, stats_bytes)
from stark_tpu_torch.dist.merkle import DistMerkleTree
from stark_tpu_torch.dist.ntt import _split
from stark_tpu_torch.fields.fp import Fp
from stark_tpu_torch.fri.commit import layer_layout
from stark_tpu_torch.interop import (limbs_to_tensor, tensor_to_limbs,
                                     tensor_to_u32, u32_to_tensor)
from stark_tpu_torch.merkle.tree import MerkleTree
from stark_tpu_torch.ntt.ntt import coset_evaluate, intt, ntt
from stark_tpu_torch.ntt.reference_ntt import root_of_unity
from stark_tpu_torch.stark import FibMulAIR, prove
from stark_tpu_torch.stark.air import FibonacciSquareAIR
from stark_tpu_torch.stark.prover import query_plan

P = 3 * 2**30 + 1
GL = 2**64 - 2**32 + 1


def _jmesh(s):
    return j_make_mesh(s, devices=jax.local_devices(backend="cpu")[:s])


def _mesh(s):
    return make_mesh(devices=["cpu"] * s)


def _u32(shape, seed, bound=P):
    rs = np.random.RandomState(seed)
    return rs.randint(0, bound, size=shape, dtype=np.int64).astype(np.uint32)


def _limbs(shape, seed):
    """(2,) + shape uint32 limb planes of seeded Goldilocks values."""
    rs = np.random.RandomState(seed)
    v = [int(x) % GL for x in rs.randint(0, 2**63, size=int(np.prod(shape)),
                                         dtype=np.int64)]
    hi = np.array([x >> 32 for x in v], np.uint32).reshape(shape)
    lo = np.array([x & 0xFFFFFFFF for x in v], np.uint32).reshape(shape)
    return np.stack([hi, lo])


def _field_case(p, shape, seed):
    """(numpy words for JAX, port tensor) of seeded values: (n,) u32, or
    (2, n) limb planes for Goldilocks."""
    if p == GL:
        a = _limbs(shape, seed)
        return a, limbs_to_tensor(a, device="cpu")
    a = _u32(shape, seed)
    return a, u32_to_tensor(a, device="cpu")


def _host(t, p):
    return tensor_to_limbs(t) if p == GL else tensor_to_u32(t)


@pytest.mark.parametrize("p,shards,log_n", [(P, 2, 8), (P, 4, 8), (P, 8, 8),
                                            (GL, 2, 6), (GL, 4, 6)])
def test_dist_ntt_matches_jax_and_single_device(p, shards, log_n):
    a, x = _field_case(p, (1 << log_n,), log_n + shards)
    got = dist_ntt(x, p, _mesh(shards))
    assert len(got.blocks) == shards
    got = got.join()
    assert torch.equal(got, ntt(x, p))
    want = np.asarray(j_dist_ntt(jnp.asarray(a), p, _jmesh(shards)))
    np.testing.assert_array_equal(_host(got, p), want)


@pytest.mark.parametrize("p", [P, GL])
def test_dist_intt_and_coset_evaluate_match(p):
    """The inverse (scaled by 1/n once: each sub-transform's own 1/len)
    and the coset LDE of two columns, as the prove runs it."""
    mesh, jmesh = _mesh(4), _jmesh(4)
    a, x = _field_case(p, (1 << 6,), 5)
    got = dist_intt(x, p, mesh).join()
    assert torch.equal(got, intt(x, p))
    np.testing.assert_array_equal(
        _host(got, p), np.asarray(j_dist_intt(jnp.asarray(a), p, jmesh)))
    a, c = _field_case(p, (1 << 4,), 6)
    got = dist_coset_evaluate(c, p, 1 << 6, 7, mesh).join()
    assert torch.equal(got, coset_evaluate(c, p, 1 << 6, 7))
    np.testing.assert_array_equal(
        _host(got, p),
        np.asarray(j_coset_evaluate(jnp.asarray(a), p, 1 << 6, 7, jmesh)))
    cols = torch.stack([c, c.flip(-1)])  # (2, n) / (2, 2, n): two columns
    assert torch.equal(dist_coset_evaluate(cols, p, 1 << 6, 7, mesh).join(),
                       coset_evaluate(cols, p, 1 << 6, 7))


def test_below_s_squared_runs_one_shard_and_reshards():
    """32 points on 8 shards (32 < 64): the single-device transform,
    re-sharded, as JAX's _effective_shards falls back."""
    a, x = _field_case(P, (32,), 9)
    mesh = _mesh(8)
    got = dist_ntt(x, P, mesh)
    assert len(got.blocks) == 8 and got.block_len == 4
    assert torch.equal(got.join(), ntt(x, P))
    np.testing.assert_array_equal(
        tensor_to_u32(got.join()),
        np.asarray(j_dist_ntt(jnp.asarray(a), P, _jmesh(8))))
    assert mesh.stats == {"scatter": [7, 7 * 4 * 4]}


@pytest.mark.parametrize("p", [P, GL])
@pytest.mark.parametrize("log_n,shards", [(26, 4), (28, 2), (8, 8)])
def test_sub_transform_roots_are_powers_of_the_root(p, log_n, shards):
    """The four-step needs the root w^(n/len) for a length-len
    sub-transform; the port's transforms use root_of_unity(p, len)."""
    n = 1 << log_n
    n1, n2 = _split(n, shards)
    assert n1 * n2 == n and n1 % shards == 0 and n2 % shards == 0
    w = root_of_unity(p, n)
    for length in (n1, n2):
        assert root_of_unity(p, length) == pow(w, n // length, p)


@pytest.mark.parametrize("kind", ["narrow", "wide", "columns"])
def test_dist_merkle_tree_matches_jax(kind):
    n, shards = 64, 4
    if kind == "wide":
        a = _limbs((n,), 11)
        values = limbs_to_tensor(a, device="cpu")
    else:
        a = _u32((2, n) if kind == "columns" else (n,), 11)
        values = u32_to_tensor(a, device="cpu")
    columns, wide = kind == "columns", kind == "wide"
    mesh = _mesh(shards)
    vs = sharded(mesh, values)
    mesh.reset_stats()
    tree = dist_merkle_tree(vs, mesh, columns=columns, wide=wide)
    assert isinstance(tree, DistMerkleTree)
    assert mesh.stats == {"merkle": [shards - 1, 32 * (shards - 1)]}
    jt = j_dist_merkle_tree(jnp.asarray(a), _jmesh(shards), columns=columns)
    single = (MerkleTree.from_columns(values) if columns
              else MerkleTree(values, wide=wide))
    assert tree.root() == jt.root() == single.root()
    for idx in (0, 5, 31, 32, 63):
        path = tree.get_authentication_path(idx)
        assert path == jt.get_authentication_path(idx)
        assert path == single.get_authentication_path(idx)
    for mine, whole in zip(tree.levels, single.levels):
        assert torch.equal(mine, whole)


def test_dist_merkle_tree_small_sizes_build_whole():
    """Fewer than 2 leaves a shard: the whole tree on the first shard
    (JAX falls back the same way)."""
    a = _u32((4,), 12)
    values = u32_to_tensor(a, device="cpu")
    tree = dist_merkle_tree(values, _mesh(4))
    assert isinstance(tree, MerkleTree)
    assert tree.root() == j_dist_merkle_tree(jnp.asarray(a),
                                             _jmesh(4)).root()


def _sources(cfg, air, p, shards, seed):
    """The four query sources of `cfg`'s plan over `shards` (lists of
    entries) and unsharded (one buffer each), from the same seeded LDE
    and FRI layers: the sharded ones laid out as a mesh prove lays them
    out (``dist.comm.sharded_layers``, dist trees)."""
    M, wide = cfg.eval_domain_size, p == GL
    cols = air.num_columns
    shape = ((cols,) if cols > 1 else ()) + ((2,) if wide else ()) + (M,)
    rs = np.random.RandomState(seed)
    lde = torch.from_numpy(rs.randint(-2**31, 2**31, size=shape,
                                      dtype=np.int64).astype(np.int32))
    lengths = [M >> k for k in range(air.num_folds(cfg) + 1)]
    layers = [torch.from_numpy(rs.randint(
        -2**31, 2**31, size=((2,) if wide else ()) + (ln,),
        dtype=np.int64).astype(np.int32)) for ln in lengths]

    trace_tree = MerkleTree.from_columns if cols > 1 else MerkleTree
    one = (lde.reshape(-1), trace_tree(lde, wide=wide).buffer,
           torch.cat([v.reshape(-1) for v in layers]),
           torch.cat([MerkleTree(v, wide=wide).buffer for v in layers]))
    mesh = _mesh(shards)
    ls = sharded(mesh, lde)
    ttree = dist_merkle_tree(ls, mesh, columns=cols > 1, wide=wide)
    fv, fd = [], []
    for v, sh in zip(layers, sharded_layers(M, shards, len(lengths) - 1)):
        vs = sharded(mesh, v) if sh else None
        fv += [b.reshape(-1) for b in vs.blocks] if sh else [v.reshape(-1)]
        fd += (dist_merkle_tree(vs, mesh, wide=wide) if sh
               else MerkleTree(v, wide=wide)).entries
    many = ([b.reshape(-1) for b in ls.blocks], ttree.entries, fv, fd)
    return one, many


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("p,air", [(P, FibonacciSquareAIR()),
                                   (GL, FibMulAIR())])
def test_sharded_query_form_plain_equals_unsharded(shards, p, air):
    """K5's query form (plain version) over the mesh plan's sharded
    sources gives the unsharded plan's outputs on the same data; the
    one-shard plan is the unsharded plan."""
    kw = {"modulus": GL, "generator": 7} if p == GL else {}
    cfg = ProverConfig(log2_trace=4, blowup=4, num_queries=3, **kw)
    one, many = _sources(cfg, air, p, shards, 30 + shards)
    base = query_plan(cfg, air, pruned=False).pack("cpu")
    tb = query_plan(cfg, air, shards=shards).pack("cpu")
    srcs = many if shards > 1 else one
    assert tb.shards == shards
    assert [len(e) for e in tb.entries] == [
        len(m) if isinstance(m, list) else 1 for m in srcs]
    chain = u32_to_tensor(_u32((8,), 40, 2**32), device="cpu")
    want = query_chain_plain(chain, *one, base)
    got = query_chain_plain(chain, *srcs, tb)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if shards == 1:
        assert torch.equal(tb.slots, base.slots)
        assert (tb.slots[:, -1] == 62).all()


def test_fri_fold_schedule():
    """Sharded folds while a layer spans 8 S; one tail gather; the
    layers a mesh stores sharded follow."""
    sched = fri_fold_schedule(1 << 10, 4, 8)
    ops = [st["op"] for st in sched]
    assert ops == ["fold_sharded"] * 6 + ["gather_tail"] + ["fold_local"] * 2
    assert sched[0]["wire_bytes"] == (1 << 9) * 4
    assert sched[6]["wire_bytes"] == 16 * 4 * 3 // 4
    assert sharded_layers(1 << 10, 4, 8) == (True,) * 7 + (False,) * 2
    assert sharded_layers(1 << 10, 1, 8) == (False,) * 9


@pytest.mark.parametrize("kw,air,shards", [
    (dict(log2_trace=4, blowup=4, num_queries=2), FibonacciSquareAIR(), 4),
    # blowup 8 on 2 shards: a sharded fold makes the last layer, which is
    # gathered for the final send; FibMul-GL: two columns of 8 bytes
    (dict(log2_trace=4, blowup=8, num_queries=2, modulus=GL, generator=7),
     FibMulAIR(), 2)])
def test_copy_counter_matches_model(kw, air, shards):
    cfg = ProverConfig(**kw)
    mesh = _mesh(shards)
    prove(cfg, air=air, mesh=mesh)
    model = stats_bytes(prove_collectives(
        cfg.log2_trace, cfg.blowup, shards, air.num_folds(cfg),
        max(air.shifts) * cfg.blowup, air.num_columns,
        4 * Fp.get(cfg.modulus).width))
    assert {k: b for k, (_, b) in mesh.stats.items()} == model


def test_layer_layout_of_the_unsharded_plan():
    """The unsharded plan's FRI entries are the one concatenated buffer
    of ``fri.commit.layer_layout``."""
    cfg = ProverConfig(log2_trace=4, blowup=4, num_queries=2)
    tb = query_plan(cfg, pruned=False).pack("cpu")
    lengths = [cfg.eval_domain_size >> k for k in range(5)]
    _, vt, dt = layer_layout(lengths)
    assert tb.entries[2:] == ((vt,), (dt,))
