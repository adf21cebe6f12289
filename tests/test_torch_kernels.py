"""Each hand-written CUDA kernel of the port against its plain torch
version on the card, exact equality, at small sizes (the full-size
comparison is chip_smoke.py's).  Marked ``cuda``: they skip without a
CUDA device.  The card's machine has no JAX, so run them there without
the suite's conftest (which imports JAX) and its xdist options:

    python -m pytest tests/test_torch_kernels.py -q --noconftest -o addopts=""
"""

import importlib
import json
import os

import numpy as np
import pytest
import torch

P = 3 * 2**30 + 1
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no CPU mode")
    return torch.device("cuda:0")


def _u32(shape, bound, seed, dev):
    rs = np.random.RandomState(seed)
    v = rs.randint(0, bound, size=shape, dtype=np.int64).astype(np.uint32)
    return torch.from_numpy(v.view(np.int32)).to(dev)


def _ntt_case(route, dev, p, log_n, inverse):
    """One launch through `route` against both plain versions (the
    kernels' own passes and the Stockham dataflow)."""
    from stark_tpu_torch.ntt.cuda_ntt import ntt_passes_plain, ntt_plain

    x = _u32(1 << log_n, p, log_n, dev)
    before = route.launches
    got = route(x, p, inverse)
    torch.cuda.synchronize()
    assert route.launches == before + 1
    assert torch.equal(got, ntt_passes_plain(x, p, inverse))
    assert torch.equal(got, ntt_plain(x, p, inverse))


# the K1 route at the default limits: n = 2 (a one-word pass 2), 2^12 and
# 2^13 (pass 1 at 2^6 and 2^7 rows), 2^15, 2^22 (the route's top)
@pytest.mark.parametrize("p", [P, 97])
@pytest.mark.parametrize("log_n", [1, 2, 3, 5, 9, 12, 13, 15, 22])
@pytest.mark.parametrize("inverse", [False, True])
def test_k1_ntt_matches_plain(dev, p, log_n, inverse):
    from stark_tpu_torch.ntt.cuda_ntt import ntt_k1

    if p == 97 and log_n > 5:
        pytest.skip("GF(97) has roots of unity up to order 32 only")
    _ntt_case(ntt_k1, dev, p, log_n, inverse)


# the K2 route: 2^23 and 2^24 (n1 = ceil half, 8 columns), 2^25 (the first
# split set by the 2^15-word row), 2^27 (the last with 8 columns); with a
# shrunk block budget (2^block_log words) the narrow column groups of
# n > 2^27 (2^14, 2^16 at 2^8 words) and GF(97) at 2^5 (2^3 words)
@pytest.mark.parametrize("p,log_n,block_log",
                         [(P, 23, 15), (P, 24, 15), (P, 25, 15), (P, 27, 15),
                          (P, 13, 8), (P, 14, 8), (P, 16, 8), (97, 5, 3)])
@pytest.mark.parametrize("inverse", [False, True])
def test_k2_ntt_matches_plain(dev, monkeypatch, p, log_n, block_log,
                              inverse):
    from stark_tpu_torch.ntt import cuda_ntt

    monkeypatch.setattr(cuda_ntt, "BLOCK_LOG", block_log)
    _ntt_case(cuda_ntt.ntt_k2, dev, p, log_n, inverse)


# the batched form: C columns as the grid's y dimension, on both routes
# and across the narrow column groups (shrunk block budget)
@pytest.mark.parametrize("route,log_n,block_log",
                         [("K1", 1, 15), ("K1", 12, 15), ("K1", 22, 15),
                          ("K2", 23, 15), ("K2", 13, 8), ("K2", 16, 8)])
@pytest.mark.parametrize("cols", [2, 3])
@pytest.mark.parametrize("inverse", [False, True])
def test_batched_ntt_matches_plain(dev, monkeypatch, route, log_n, block_log,
                                   cols, inverse):
    from stark_tpu_torch.ntt import cuda_ntt

    monkeypatch.setattr(cuda_ntt, "BLOCK_LOG", block_log)
    fn = cuda_ntt.ntt_k1 if route == "K1" else cuda_ntt.ntt_k2
    x = _u32((cols, 1 << log_n), P, log_n + cols, dev)
    before = (fn.launches, fn.column_launches)
    got = fn(x, P, inverse)
    torch.cuda.synchronize()
    assert (fn.launches, fn.column_launches) == (before[0] + 1,
                                                 before[1] + 1)
    assert torch.equal(got, cuda_ntt.ntt_passes_plain(x, P, inverse))
    for c in range(cols):
        assert torch.equal(got[c], cuda_ntt.ntt_plain(x[c], P, inverse))


GL = 2**64 - 2**32 + 1


def _gl(shape, seed, dev):
    """Seeded canonical Goldilocks values as int32 limb planes ((2, n) or
    (C, 2, n)), p - 1, 2^32 - 1 and 2^32 first in each column."""
    from stark_tpu_torch.fields.fp import host_words

    rs = np.random.RandomState(seed)
    v = rs.randint(0, 2**32, size=shape + (2,), dtype=np.int64).astype(
        np.uint64)
    v = ((v[..., 0] << np.uint64(32)) | v[..., 1]) % np.uint64(GL)
    edge = np.asarray([GL - 1, 2**32 - 1, 2**32], dtype=np.uint64)
    k = min(3, shape[-1])
    v[..., :k] = edge[:k]
    return torch.from_numpy(host_words(v, 2).view(np.int32)).to(dev)


def _ntt64_case(dev, shape, inverse, seed):
    """One launch of the 64-bit kernels against ``ntt_limbs`` on the
    card, the wrapper's counters moved by one."""
    from stark_tpu_torch.ntt.cuda_ntt64 import ntt64
    from stark_tpu_torch.ntt.ntt import ntt_limbs

    x = _gl(shape, seed, dev)
    before = (ntt64.launches, ntt64.column_launches)
    got = ntt64(x, GL, inverse)
    torch.cuda.synchronize()
    assert (ntt64.launches, ntt64.column_launches) == (
        before[0] + 1, before[1] + (len(shape) == 2))
    assert torch.equal(got, ntt_limbs(x, GL, inverse))


@pytest.mark.parametrize("log_n", range(1, 25))
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt64_matches_limbs(dev, log_n, inverse):
    _ntt64_case(dev, (1 << log_n,), inverse, log_n + 30 * inverse)


# the prove's shapes (FibMul-GL at 2^21 rows, blowup 8), three columns,
# the narrow column groups above 2^25 and, with the block budget shrunk
# to 2^8 values, at small sizes
@pytest.mark.parametrize("shape,inverse,block_log",
                         [((2, 1 << 21), True, 14), ((2, 1 << 24), False, 14),
                          ((3, 1 << 12), False, 14), ((3, 1 << 12), True, 14),
                          ((1 << 26,), False, 14), ((1 << 27,), True, 14),
                          ((3, 1 << 13), False, 8), ((1 << 14,), True, 8),
                          ((2, 1 << 16), False, 8)])
def test_ntt64_columns_and_splits_match_limbs(dev, monkeypatch, shape,
                                              inverse, block_log):
    from stark_tpu_torch.ntt import cuda_ntt64

    monkeypatch.setattr(cuda_ntt64, "BLOCK_LOG", block_log)
    _ntt64_case(dev, shape, inverse, len(shape) + block_log)


def test_ntt64_reads_planes_a_stride_apart(dev):
    """A slice along the last axis (planes 2n words apart) is read in
    place."""
    from stark_tpu_torch.ntt.cuda_ntt64 import ntt64

    big = _gl((2, 1 << 13), 5, dev)
    x = big[..., : 1 << 12]
    assert not x.is_contiguous()
    assert torch.equal(ntt64(x, GL), ntt64(x.contiguous(), GL))


@pytest.mark.parametrize("shards,cols", [(2, None), (4, 2)])
def test_ntt64_four_step_rows_match_single_device(dev, shards, cols):
    """The mesh's four-step over Goldilocks on logical shards of the one
    card: its row transforms are (rows, 2, len) batches of the 64-bit
    kernels, and the coset LDE and the INTT equal the single-device
    ones."""
    from stark_tpu_torch.dist import (dist_coset_evaluate, dist_intt,
                                      make_mesh)
    from stark_tpu_torch.ntt.ntt import coset_evaluate, intt

    mesh = make_mesh(devices=[dev] * shards)
    c = _gl((1 << 12,) if cols is None else (cols, 1 << 12), shards, dev)
    assert torch.equal(dist_coset_evaluate(c, GL, 1 << 15, 7, mesh).join(),
                       coset_evaluate(c, GL, 1 << 15, 7))
    x = _gl((1 << 14,), shards + 1, dev)
    assert torch.equal(dist_intt(x, GL, mesh).join(), intt(x, GL))


def test_goldilocks_prove_launches_ntt64_twice(dev, monkeypatch):
    """A FibMul-GL prove at 2^12 rows: the batched trace INTT and the
    batched coset NTT are one launch each of the 64-bit kernels, no torch-op
    NTT runs and K1/K2 do not move; the proof verifies."""
    from stark_tpu_torch.config import ProverConfig
    from stark_tpu_torch.ntt.cuda_ntt import ntt_k1, ntt_k2
    from stark_tpu_torch.ntt.cuda_ntt64 import ntt64
    from stark_tpu_torch.stark import FibMulAIR, prove, verify

    def refused(*args, **kwargs):
        raise AssertionError("ntt_limbs called on the card")

    tn = importlib.import_module("stark_tpu_torch.ntt.ntt")
    monkeypatch.setattr(tn, "ntt_limbs", refused)
    cfg = ProverConfig(log2_trace=12, blowup=8, num_queries=8,
                       modulus=GL, generator=7)
    air = FibMulAIR(a0=1, b0=2718281)
    prove(cfg, air=air, device=dev)  # builds the context and the kernels
    before = (ntt64.launches, ntt64.column_launches, ntt_k1.launches,
              ntt_k2.launches)
    pr = prove(cfg, air=air, device=dev)
    after = (ntt64.launches, ntt64.column_launches, ntt_k1.launches,
             ntt_k2.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (2, 2, 0, 0)
    assert verify(pr)


@pytest.mark.parametrize("cols", range(1, 7))
@pytest.mark.parametrize("n", [1, 255, 4096])
def test_k3_row_form_matches_plain(dev, cols, n):
    from stark_tpu_torch.hash.cuda_sha import sha_row_leaves
    from stark_tpu_torch.hash.sha256 import sha256_row_leaves

    v = _u32((cols, n), P, 10 * cols + n, dev)
    assert torch.equal(sha_row_leaves(v), sha256_row_leaves(v))


@pytest.mark.parametrize("n", [1, 2, 255, 4096])
def test_k3_k4_match_plain(dev, n):
    from stark_tpu_torch.hash.cuda_sha import sha_leaves, sha_nodes
    from stark_tpu_torch.hash.sha256 import sha256_pairs, sha256_u64_leaves

    v = _u32(n, P, n, dev)
    assert torch.equal(sha_leaves(v), sha256_u64_leaves(v))
    kids = _u32((2 * n, 8), 2**32, n + 1, dev)
    assert torch.equal(sha_nodes(kids), sha256_pairs(kids))


@pytest.mark.parametrize("n", [1, 2, 255, 4096])
def test_k3_wide_matches_plain(dev, n):
    """K3's 64-bit mode, one column: (2, n) Goldilocks limb planes (any
    words: the kernel hashes hi || lo whatever the values), counted in
    wide_launches only."""
    from stark_tpu_torch.hash.cuda_sha import sha_leaves
    from stark_tpu_torch.hash.sha256 import sha256_u64_leaves

    v = _u32((2, n), 2**32, 3 * n, dev)
    before = (sha_leaves.launches, sha_leaves.wide_launches)
    got = sha_leaves(v, wide=True)
    torch.cuda.synchronize()
    assert (sha_leaves.launches, sha_leaves.wide_launches) == (
        before[0], before[1] + 1)
    assert torch.equal(got, sha256_u64_leaves(v, wide=True))


@pytest.mark.parametrize("cols", range(1, 7))
@pytest.mark.parametrize("n", [1, 255, 4096])
def test_k3_wide_row_form_matches_plain(dev, cols, n):
    from stark_tpu_torch.hash.cuda_sha import sha_row_leaves
    from stark_tpu_torch.hash.sha256 import sha256_row_leaves

    v = _u32((cols, 2, n), 2**32, 20 * cols + n, dev)
    before = sha_row_leaves.wide_launches
    got = sha_row_leaves(v, wide=True)
    torch.cuda.synchronize()
    assert sha_row_leaves.wide_launches == before + 1
    assert torch.equal(got, sha256_row_leaves(v, wide=True))


# the subtree kernel (K3 with the node levels above the leaves): every form
# at the tree build's block (2^10 leaves, 5 levels), a small block, the
# levels stored from 0 (unpruned), from 3 and from the top, a launch that
# starts at block 3 of a larger tree
@pytest.mark.parametrize("form", ["u32", "rows1", "rows6", "wide",
                                  "wide_rows6"])
@pytest.mark.parametrize("span_log,levels,store_from,block0",
                         [(10, 5, 0, 0), (10, 5, 3, 3), (10, 5, 5, 0),
                          (3, 3, 1, 2), (12, 7, 0, 0)])
def test_subtree_kernel_matches_plain(dev, form, span_log, levels,
                                      store_from, block0):
    from stark_tpu_torch.hash.cuda_sha import level_row, sha_subtree

    rows, wide = "rows" in form, form.startswith("wide")
    c = int(form[-1]) if rows else 1
    n = 4 << span_log
    shape = ((c,) if rows else ()) + ((2,) if wide else ()) + (n,)
    vals = _u32(shape, 2**32 if wide else P, n + c, dev)
    tree_log = span_log + 4 + (block0 > 0)
    size = level_row(tree_log, store_from, tree_log, 1)
    out = torch.zeros((size, 8), dtype=torch.int32, device=dev)
    kw = dict(rows=rows, wide=wide, span_log=span_log, levels=levels,
              store_from=store_from, tree_log=tree_log, block0=block0)
    name = "row_" * rows + "wide_" * wide + "launches"
    before = getattr(sha_subtree, name)
    sha_subtree(vals, out, **kw)
    torch.cuda.synchronize()
    assert getattr(sha_subtree, name) == before + 1
    want = sha_subtree.plain(vals, torch.zeros_like(out), **kw)
    assert torch.equal(out, want)


@pytest.mark.parametrize("log_n", range(11))
def test_tail_kernel_matches_plain(dev, log_n):
    """The tail from the leaves (the whole tree in one launch, stored from
    0 and from 2) and from a level of digest rows, one block."""
    from stark_tpu_torch.hash.cuda_sha import sha_tail

    n = 1 << log_n
    vals = _u32(n, P, 70 + log_n, dev)
    for store_from in sorted({0, min(2, log_n)}):
        rows = 2 * (n >> store_from) - 1
        out = torch.zeros((rows, 8), dtype=torch.int32, device=dev)
        before = sha_tail.launches
        sha_tail(vals, out, leaves=True, store_from=store_from)
        torch.cuda.synchronize()
        assert sha_tail.launches == before + 1
        want = sha_tail.plain(vals, torch.zeros_like(out), leaves=True,
                              store_from=store_from)
        assert torch.equal(out, want)
    if n > 1:
        kids = _u32((n, 8), 2**32, 80 + log_n, dev)
        out = sha_tail(kids, torch.zeros((n - 1, 8), dtype=torch.int32,
                                         device=dev))
        want = sha_tail.plain(kids, torch.zeros_like(out))
        assert torch.equal(out, want)


@pytest.mark.parametrize("prune", range(7))
def test_tree_build_matches_plain(dev, prune):
    """build_tree on the card (the subtree kernel, K4, the tail) against
    the same build on the CPU (their plain versions) at 2^17 leaves,
    every prune depth up to one past the fused levels."""
    from stark_tpu_torch.merkle.tree import build_tree

    vals = _u32(1 << 17, P, 90 + prune, dev)
    got = build_tree(vals, prune=prune)
    assert torch.equal(got.cpu(), build_tree(vals.cpu(), prune=prune))


def test_wide_tree_matches_plain(dev):
    from stark_tpu_torch.merkle.tree import MerkleTree

    v = _u32((2, 1 << 10), 2**32, 8, dev)
    plain = MerkleTree(v.cpu(), wide=True).buffer.to(dev)
    assert torch.equal(MerkleTree(v, wide=True).buffer, plain)


def test_tree_matches_plain(dev):
    from stark_tpu_torch.merkle.tree import MerkleTree

    v = _u32(1 << 10, P, 7, dev)
    plain = MerkleTree(v.cpu()).buffer.to(dev)
    assert torch.equal(MerkleTree(v).buffer, plain)


def test_k5_chain_matches_plain(dev):
    from stark_tpu_torch.hash.cuda_chain import (FIRST_HEX, FIRST_ROW,
                                                 sha_chain, sha_chain_plain)

    flags = [[FIRST_ROW, 0], [0, 1], [FIRST_HEX, 0], [0, 0], [0, 1],
             [0, 0], [FIRST_HEX, 1], [FIRST_ROW, 1]]
    fl = torch.tensor(flags, dtype=torch.int32, device=dev)
    stream = _u32((len(flags), 16), 2**32, 3, dev)
    chain = _u32(8, 2**32, 4, dev)
    assert torch.equal(sha_chain(stream, fl, chain),
                       sha_chain_plain(stream, fl, chain))


def test_k5_chain_long_stream_matches_plain(dev):
    """A stream longer than one staged chunk (5,000 blocks: ten 512-row
    chunks through the two buffers), its flags mixing FIRST_HEX,
    FIRST_ROW, plain and last rows."""
    from stark_tpu_torch.hash.cuda_chain import (FIRST_HEX, FIRST_ROW,
                                                 sha_chain, sha_chain_plain)

    n = 5000
    rs = np.random.RandomState(11)
    first = rs.choice([0, 0, 0, 0, FIRST_HEX, FIRST_ROW], size=n)
    last = rs.randint(0, 2, size=n)
    fl = torch.from_numpy(np.stack([first, last], 1).astype(np.int32)).to(dev)
    stream = _u32((n, 16), 2**32, 12, dev)
    chain = _u32(8, 2**32, 13, dev)
    before = sha_chain.launches
    got = sha_chain(stream, fl, chain)
    torch.cuda.synchronize()
    assert sha_chain.launches == before + 1
    assert torch.equal(got, sha_chain_plain(stream, fl, chain))


@pytest.mark.parametrize("log2_trace", [6, 11])
def test_k5_query_form_matches_plain(dev, log2_trace):
    """K5's query form (all queries in one launch) against its plain
    version on the prover's plan, seeded buffers: final chain, idxs,
    vals and digs."""
    from stark_tpu_torch.channel.device_query import (query_chain,
                                                      query_chain_plain)
    from stark_tpu_torch.config import ProverConfig
    from stark_tpu_torch.stark.prover import query_plan

    plan = query_plan(ProverConfig(log2_trace=log2_trace, blowup=8,
                                   num_queries=4))
    tb = plan.pack(dev)
    n_f, n_td, n_fv, n_fd = tb.sizes
    args = (_u32(8, 2**32, 20, dev), _u32(n_f, P, 21, dev),
            _u32((n_td, 8), 2**32, 22, dev), _u32(n_fv, P, 23, dev),
            _u32((n_fd, 8), 2**32, 24, dev))
    before = query_chain.launches
    got = query_chain(*args, tb)
    torch.cuda.synchronize()
    assert query_chain.launches == before + 1
    for g, w in zip(got, query_chain_plain(*args, tb)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("cols", [2, 4, 6])
def test_k5_query_form_row_messages_match_plain(dev, cols):
    """The query form on a plan of C-column row openings (C >= 4 spills a
    full hex block before the padded tail)."""
    from stark_tpu_torch.channel.device_query import (DeviceQueryPlan,
                                                      query_chain,
                                                      query_chain_plain)

    plan = DeviceQueryPlan(28, 4, (0, 4), 32, (32, 16, 8, 4, 2), cols)
    tb = plan.pack(dev)
    n_f, n_td, n_fv, n_fd = tb.sizes
    args = (_u32(8, 2**32, 30, dev), _u32(n_f, P, 31, dev),
            _u32((n_td, 8), 2**32, 32, dev), _u32(n_fv, P, 33, dev),
            _u32((n_fd, 8), 2**32, 34, dev))
    for g, w in zip(query_chain(*args, tb), query_chain_plain(*args, tb)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("cols", [1, 2, 6])
def test_k5_query_form_goldilocks_plan_matches_plain(dev, cols):
    """The query form on a Goldilocks plan: two value slots a value (hi
    and lo planes), the same kernel."""
    from stark_tpu_torch.channel.device_query import (DeviceQueryPlan,
                                                      query_chain,
                                                      query_chain_plain)

    plan = DeviceQueryPlan(28, 4, (0, 4), 32, (32, 16, 8, 4, 2, 1), cols,
                           elem_width=2)
    tb = plan.pack(dev)
    n_f, n_td, n_fv, n_fd = tb.sizes
    args = (_u32(8, 2**32, 40, dev), _u32(n_f, 2**32, 41, dev),
            _u32((n_td, 8), 2**32, 42, dev), _u32(n_fv, 2**32, 43, dev),
            _u32((n_fd, 8), 2**32, 44, dev))
    for g, w in zip(query_chain(*args, tb), query_chain_plain(*args, tb)):
        assert torch.equal(g, w)


def test_golden_vectors_on_card(dev):
    from stark_tpu_torch.config import ProverConfig
    from stark_tpu_torch.stark import StarkProof, prove

    path = os.path.join(os.path.dirname(__file__), "vectors",
                        "golden_proofs.json")
    with open(path) as fh:
        vec = json.load(fh)
    # no device: prove() runs on the card by default
    got = prove(ProverConfig(modulus=97, generator=5, log2_trace=2, blowup=4,
                             num_queries=2), a1=3)
    assert got.proof == StarkProof.deserialize(
        json.dumps(vec["fib_gf97_2e2"]).encode()).proof


@pytest.mark.parametrize("name", ["mimc3_2e5", "fibmul_2e5",
                                  "fibmul_gl_2e5"])
def test_golden_mimc_fibmul_on_card(dev, name):
    from stark_tpu_torch.config import ProverConfig
    from stark_tpu_torch.stark import FibMulAIR, MimcAIR, StarkProof, prove

    path = os.path.join(os.path.dirname(__file__), "vectors",
                        "golden_proofs.json")
    with open(path) as fh:
        vec = json.load(fh)
    air = (MimcAIR(x0=271828, k=777) if name == "mimc3_2e5"
           else FibMulAIR(a0=1, b0=2718281))
    field = (dict(modulus=2**64 - 2**32 + 1, generator=7)
             if name == "fibmul_gl_2e5" else {})
    got = prove(ProverConfig(log2_trace=5, blowup=4, num_queries=3, **field),
                air=air)
    assert got.serialize() == StarkProof.deserialize(
        json.dumps(vec[name]).encode()).serialize()


@pytest.mark.parametrize("shape,wide", [((1 << 12,), False),
                                        ((2, 1 << 12), True),
                                        ((3, 1 << 12), False),
                                        ((2, 2, 1 << 12), True)])
def test_k3_reads_a_chunk_in_place(dev, shape, wide):
    """K3 on a slice along the last axis (one chunk of a pruned build):
    its planes a fixed stride apart, read in place."""
    from stark_tpu_torch.hash.cuda_sha import sha_leaves, sha_row_leaves
    from stark_tpu_torch.hash.sha256 import sha256_row_leaves

    v = _u32(shape, 2**32 if wide else P, len(shape) + wide, dev)
    chunk = v[..., 1024:3072]
    rows = len(shape) == 2 + wide
    fn = sha_row_leaves if rows else sha_leaves
    want = sha256_row_leaves(chunk if rows else chunk[None], wide)
    assert torch.equal(fn(chunk, wide=wide), want)


@pytest.mark.parametrize("form", ["u32", "rows2", "wide"])
def test_chunked_build_matches_unchunked(dev, monkeypatch, form):
    """The chunked pruned build (chunks of 2^7 leaves) against the
    one-pass pruned build and the plain full tree, on the card."""
    from stark_tpu_torch.merkle import tree as mt

    n, prune = 1 << 10, 3
    shape = {"u32": (n,), "rows2": (2, n), "wide": (2, n)}[form]
    v = _u32(shape, 2**32 if form == "wide" else P, 50, dev)
    wide, rows = form == "wide", form == "rows2"
    build = mt.MerkleTree.from_columns if rows else mt.MerkleTree
    one_pass = build(v, wide=wide, prune=prune).buffer
    monkeypatch.setattr(mt, "CHUNK_MIN_LOG", 8)
    monkeypatch.setattr(mt, "CHUNK_LOG", 7)
    chunked = build(v, wide=wide, prune=prune).buffer
    full = build(v.cpu(), wide=wide).buffer
    assert torch.equal(chunked, one_pass)
    assert torch.equal(chunked.cpu(), full[2 * n - 2 * (n >> prune):])


# pruned plans (columns, width, trace prune, FRI prunes) over a 2^6-point
# LDE, as tests/test_torch_pruned_tree.py's
@pytest.mark.parametrize("cols,width,trace_prune,fri_prune",
                         [(1, 1, 3, (3, 2, 1, 0, 0, 0)),
                          (2, 1, 6, (6, 5, 4, 3, 2, 1)),
                          (3, 2, 4, (3, 0, 2, 0, 1, 0))])
def test_k5_query_form_pruned_plan_matches_plain(dev, cols, width,
                                                 trace_prune, fri_prune):
    """The query form with the in-launch recompute of pruned siblings
    against its plain version (plain K3 / K4 per query), seeded buffers:
    one launch, all four outputs equal."""
    from stark_tpu_torch.channel.device_query import (DeviceQueryPlan,
                                                      query_chain,
                                                      query_chain_plain)

    plan = DeviceQueryPlan(56, 6, (0, 4, 8), 64, (64, 32, 16, 8, 4, 2),
                           cols, width, trace_prune, fri_prune)
    tb = plan.pack(dev)
    n_f, n_td, n_fv, n_fd = tb.sizes
    args = (_u32(8, 2**32, 60, dev), _u32(n_f, 2**32, 61, dev),
            _u32((n_td, 8), 2**32, 62, dev), _u32(n_fv, 2**32, 63, dev),
            _u32((n_fd, 8), 2**32, 64, dev))
    before = query_chain.launches
    got = query_chain(*args, tb)
    torch.cuda.synchronize()
    assert query_chain.launches == before + 1
    for g, w in zip(got, query_chain_plain(*args, tb)):
        assert torch.equal(g, w)


def test_pruned_prove_on_the_card_equals_unpruned(dev, monkeypatch):
    """A fib-sq prove at 2^8 rows with every tree above 2^4 leaves pruned
    and chunked equals the unpruned prove."""
    from stark_tpu_torch.config import ProverConfig
    from stark_tpu_torch.merkle import tree as mt
    from stark_tpu_torch.stark import prove

    cfg = ProverConfig(log2_trace=8, blowup=4, num_queries=4)
    full = prove(cfg, device=dev).proof
    monkeypatch.setattr(mt, "PRUNE_KEEP_LOG", 4)
    monkeypatch.setattr(mt, "CHUNK_MIN_LOG", 9)
    monkeypatch.setattr(mt, "CHUNK_LOG", 7)
    assert prove(cfg, device=dev).proof == full


# -- the batched forms (stark/batch.py): one launch for B proofs -----------

@pytest.mark.parametrize("rows,wide", [(False, False), (True, False),
                                       (False, True)])
def test_tree_batch_matches_plain_loop(dev, rows, wide):
    """K3 / K4's tree batch (the tree as grid y) into a (B, 2n - 1, 8)
    buffer against the plain version tree by tree, and against B single
    launches."""
    from stark_tpu_torch.hash.cuda_sha import (sha_nodes_batch,
                                               sha_subtree_batch,
                                               sha_tail_batch)
    from stark_tpu_torch.merkle.tree import build_tree
    from stark_tpu_torch.stark.batch import _batched_tree

    b, n = 5, 1 << 16
    shape = (b, 3, n) if rows else (b, 2, n) if wide else (b, n)
    vals = _u32(shape, 2**32 if wide else P, 40, dev)
    out = torch.empty((b, 2 * n - 1, 8), dtype=torch.int32, device=dev)

    def counts():
        return (sha_subtree_batch.launches + sha_subtree_batch.wide_launches,
                sha_nodes_batch.launches, sha_tail_batch.launches)

    before = counts()
    _batched_tree(vals, out, rows=rows, wide=wide)
    torch.cuda.synchronize()
    # 2^16 leaves: the subtree kernel to level 5, K4 to 2^10, the tail
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + 1)
    plain = torch.empty_like(out).cpu()
    _batched_tree(vals.cpu(), plain, rows=rows, wide=wide)
    assert torch.equal(out.cpu(), plain)
    for k in range(b):
        assert torch.equal(out[k], build_tree(vals[k], rows=rows, wide=wide))


def test_k5_chain_batch_matches_plain_loop(dev):
    """K5's chain form on 16 mixed-flag streams in one launch, one block
    a chain, own flags or shared ones, against the plain version and B
    single launches."""
    from stark_tpu_torch.hash.cuda_chain import (FIRST_HEX, FIRST_ROW,
                                                 sha_chain, sha_chain_batch,
                                                 sha_chain_plain)

    b, r = 16, 700
    rs = np.random.RandomState(41)
    first = rs.choice([0, 0, 0, FIRST_HEX, FIRST_ROW], size=(b, r))
    last = rs.randint(0, 2, size=(b, r))
    fl = torch.from_numpy(np.stack([first, last], -1).astype(np.int32)).to(
        dev)
    stream = _u32((b, r, 16), 2**32, 42, dev)
    chain = _u32((b, 8), 2**32, 43, dev)
    before = sha_chain_batch.launches
    for flags in (fl, fl[0]):
        got = sha_chain_batch(stream, flags.contiguous(), chain)
        for k in range(b):
            fk = flags if flags.dim() == 2 else flags[k]
            assert torch.equal(got[k], sha_chain_plain(stream[k], fk,
                                                       chain[k]))
            assert torch.equal(got[k], sha_chain(stream[k], fk, chain[k]))
    assert sha_chain_batch.launches == before + 2


def test_k5_query_batch_matches_plain_loop(dev):
    """K5's query form for 16 proofs of one plan in one launch against the
    plain version proof by proof and 16 single launches."""
    from stark_tpu_torch.channel.device_query import (query_chain,
                                                      query_chain_batch,
                                                      query_chain_plain)
    from stark_tpu_torch.config import ProverConfig
    from stark_tpu_torch.stark.prover import query_plan

    b = 16
    tb = query_plan(ProverConfig(log2_trace=8, blowup=4, num_queries=4),
                    pruned=False).pack(dev)
    n_f, n_td, n_fv, n_fd = tb.sizes
    args = (_u32((b, 8), 2**32, 50, dev), _u32((b, n_f), P, 51, dev),
            _u32((b, n_td, 8), 2**32, 52, dev), _u32((b, n_fv), P, 53, dev),
            _u32((b, n_fd, 8), 2**32, 54, dev))
    before = query_chain_batch.launches
    got = query_chain_batch(*args, tb)
    torch.cuda.synchronize()
    assert query_chain_batch.launches == before + 1
    for k in range(b):
        one = [a[k] for a in args]
        for g, w, s in zip(got, query_chain_plain(*one, tb),
                           query_chain(*one, tb)):
            assert torch.equal(g[k], w) and torch.equal(g[k], s)


def test_prove_batch_on_card_equals_proves(dev):
    """A batch of three fib-sq statements on the card equals three
    proves."""
    from stark_tpu_torch.config import ProverConfig
    from stark_tpu_torch.stark import FibonacciSquareAIR, prove, prove_batch

    cfg = ProverConfig(log2_trace=8, blowup=4, num_queries=4)
    airs = [FibonacciSquareAIR(a1=a) for a in (3, 4, 5)]
    got = prove_batch(cfg, airs, device=dev)
    assert [g.proof for g in got] == [prove(cfg, air=a, device=dev).proof
                                      for a in airs]


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("modulus", [P, 2**64 - 2**32 + 1])
def test_k5_sharded_query_form_matches_plain(dev, shards, modulus):
    """K5's query form over a mesh plan's sharded sources (one entry a
    block, a subtree, a tree's top levels, a tail layer) against its
    plain version, seeded entries; one launch, counted as sharded."""
    from stark_tpu_torch.channel.device_query import (query_chain,
                                                      query_chain_plain)
    from stark_tpu_torch.config import ProverConfig
    from stark_tpu_torch.stark import FibMulAIR
    from stark_tpu_torch.stark.prover import query_plan

    kw = {} if modulus == P else {"modulus": modulus, "generator": 7}
    cfg = ProverConfig(log2_trace=8, blowup=4, num_queries=4, **kw)
    tb = query_plan(cfg, FibMulAIR(), shards=shards).pack(dev)
    srcs = [[_u32((size, 8) if k % 2 else (size,), 2**32, 60 + k + e, dev)
             for e, size in enumerate(sizes)]
            for k, sizes in enumerate(tb.entries)]
    chain = _u32(8, 2**32, 59, dev)
    before = (query_chain.launches, query_chain.sharded_launches)
    got = query_chain(chain, *srcs, tb)
    torch.cuda.synchronize()
    assert (query_chain.launches, query_chain.sharded_launches) == (
        before[0] + 1, before[1] + 1)
    for g, w in zip(got, query_chain_plain(chain, *srcs, tb)):
        assert torch.equal(g, w)


def test_mesh_prove_on_card_equals_single_device(dev):
    """fib-sq and FibMul on 4 logical shards of the card: the
    single-device transcripts, on the single-fetch mesh path."""
    from stark_tpu_torch.config import ProverConfig
    from stark_tpu_torch.dist import make_mesh
    from stark_tpu_torch.stark import FibMulAIR, prove
    from stark_tpu_torch.stark import prover as tprover

    cfg = ProverConfig(log2_trace=8, blowup=4, num_queries=4)
    mesh = make_mesh(devices=[dev] * 4)
    for air in (None, FibMulAIR()):
        got = prove(cfg, air=air, mesh=mesh)
        assert tprover.LAST_PROVE_PATH == "single-fetch-mesh"
        assert got.proof == prove(cfg, air=air, device=dev).proof


@pytest.mark.parametrize("shards,modulus", [(2, P), (4, P),
                                            (4, 2**64 - 2**32 + 1)])
def test_k5_cut_query_form_matches_plain(dev, shards, modulus):
    """K5's query form cut at the query boundary (a process mesh's, here
    in one process: nothing to sum) against its plain version and the
    one-launch form on the same seeded sharded sources: Q + 1 launches;
    then with the sources of every other shard absent (None, address 0),
    whose slot words must read as zeros."""
    from stark_tpu_torch.channel.device_query import (query_chain,
                                                      query_chain_cut,
                                                      query_chain_cut_plain)
    from stark_tpu_torch.config import ProverConfig
    from stark_tpu_torch.stark import FibMulAIR
    from stark_tpu_torch.stark.prover import query_plan

    kw = {} if modulus == P else {"modulus": modulus, "generator": 7}
    cfg = ProverConfig(log2_trace=8, blowup=4, num_queries=4, **kw)
    tb = query_plan(cfg, FibMulAIR(), shards=shards).pack(dev)
    srcs = [[_u32((size, 8) if k % 2 else (size,), 2**32, 70 + k + e, dev)
             for e, size in enumerate(sizes)]
            for k, sizes in enumerate(tb.entries)]
    chain = _u32(8, 2**32, 69, dev)
    before = query_chain_cut.launches
    got = query_chain_cut(chain, *srcs, tb)
    torch.cuda.synchronize()
    assert query_chain_cut.launches == before + tb.num_queries + 1
    for g, w, o in zip(got, query_chain_cut_plain(chain, *srcs, tb),
                       query_chain(chain, *srcs, tb)):
        assert torch.equal(g, w) and torch.equal(g, o)
    half = [[t if e % 2 else None for e, t in enumerate(src)]
            for src in srcs]
    got = query_chain_cut(chain, *half, tb)
    torch.cuda.synchronize()
    for g, w in zip(got, query_chain_cut_plain(chain, *half, tb)):
        assert torch.equal(g, w)


# lde on the card: the INTT and the coset NTT through K1 (n <= 2^22) and
# K2 (above; here above 2^9, with a 2^7-word block budget), one wrapper
# launch each, against the same lde on the CPU (the kernels' plain
# versions)
@pytest.mark.parametrize("log_n,blowup,k2_from", [(6, 4, None),
                                                  (10, 8, None), (8, 4, 9)])
def test_lde_on_card_matches_plain(dev, monkeypatch, log_n, blowup, k2_from):
    from stark_tpu_torch.ntt import cuda_ntt, lde

    if k2_from:
        monkeypatch.setattr(cuda_ntt, "MAX_LOG_N", k2_from)
        monkeypatch.setattr(cuda_ntt, "BLOCK_LOG", 7)
    x = _u32(1 << log_n, P, log_n, dev)
    k1, k2 = cuda_ntt.ntt_k1.launches, cuda_ntt.ntt_k2.launches
    got = lde(x, P, blowup, 3)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), lde(x.cpu(), P, blowup, 3))
    assert cuda_ntt.ntt_k1.launches - k1 == 2 - bool(k2_from)
    assert cuda_ntt.ntt_k2.launches - k2 == bool(k2_from)


@pytest.mark.parametrize("p", [P, 2**64 - 2**32 + 1])
def test_coset_fri_on_card_matches_cpu(dev, p):
    from stark_tpu_torch.fri import CosetFri
    from stark_tpu_torch.ntt.reference_ntt import root_of_unity

    w = root_of_unity(p, 1 << 12)
    on_card, on_cpu = (CosetFri(p, 3, w, 1 << 12, device=d)
                       for d in (dev, "cpu"))
    dom = on_card.generate_coset_domain()
    want = on_cpu.generate_coset_domain()
    assert torch.equal(dom.cpu(), want)
    assert torch.equal(on_card.next_coset_domain(dom).cpu(),
                       on_cpu.next_coset_domain(want))
    assert torch.equal(on_card.next_coset_domain_full(dom).cpu(),
                       on_cpu.next_coset_domain_full(want))


def test_debug_checks_on_card(dev, monkeypatch):
    """Under STARK_TPU_TORCH_DEBUG the card's prove gives the golden
    transcript, and a trace holding p raises at the trace boundary."""
    from stark_tpu_torch.config import ProverConfig
    from stark_tpu_torch.stark import FibonacciSquareAIR, prove
    from stark_tpu_torch.utils.debug import assert_canonical

    cfg = ProverConfig(log2_trace=6, blowup=4, num_queries=2)
    want = prove(cfg, device="cpu").proof
    monkeypatch.setenv("STARK_TPU_TORCH_DEBUG", "1")
    assert prove(cfg, device=dev).proof == want
    bad = FibonacciSquareAIR().build_trace(cfg, device=dev)
    bad[5] = torch.tensor(P - (1 << 32), dtype=torch.int32)  # p's bits
    with pytest.raises(AssertionError, match="trace: non-canonical"):
        prove(cfg, trace=bad, strict=False, device=dev)
    with pytest.raises(AssertionError, match="flat index 5"):
        assert_canonical(bad, P)


def test_mega_prove_on_card_captures_once(dev):
    """The single-dispatch prove on the card: the first prove of a
    configuration captures its graph, the next statement replays it (no
    second capture) with its own publics refilled, and a continued
    channel takes its own program; every transcript equals the CPU's
    single-fetch prove."""
    from stark_tpu_torch.channel.channel import Channel
    from stark_tpu_torch.config import ProverConfig
    from stark_tpu_torch.stark import FibonacciSquareAIR, prove
    from stark_tpu_torch.stark import prover as tprover

    cfg = ProverConfig(log2_trace=7, blowup=4, num_queries=4)
    ctx = tprover.get_air_context(FibonacciSquareAIR(), cfg, dev)
    ctx.__dict__.pop("_mega_fns", None)
    stats = dict(tprover.MEGA_STATS)
    for a1 in (3, 5, 3):
        got = prove(cfg, a1=a1, device=dev)
        assert tprover.LAST_PROVE_PATH == "mega"
        assert got.proof == prove(cfg, a1=a1, device="cpu").proof
    assert tprover.MEGA_STATS["captures"] == stats["captures"] + 1
    assert tprover.MEGA_STATS["replays"] == stats["replays"] + 3
    (prog,) = ctx._mega_fns.values()
    assert prog.pool_bytes > 0 and prog.graph is not None

    def channel():
        ch = Channel(cfg.modulus)
        ch.send(b"an earlier statement")
        return ch

    got = prove(cfg, channel=channel(), device=dev)
    assert got.proof == prove(cfg, channel=channel(), device="cpu").proof
    assert len(ctx._mega_fns) == 2


@pytest.mark.parametrize("name", ["mimc3_2e5", "fibmul_2e5",
                                  "fibmul_gl_2e5"])
def test_mega_golden_on_card(dev, monkeypatch, name):
    """The golden vectors through the captured graph (Goldilocks under
    its opt-in), each proved twice: capture, then replay."""
    from stark_tpu_torch.config import ProverConfig
    from stark_tpu_torch.stark import FibMulAIR, MimcAIR, StarkProof, prove
    from stark_tpu_torch.stark import prover as tprover

    monkeypatch.setenv("STARK_TPU_TORCH_WIDE_MEGA", "1")
    path = os.path.join(os.path.dirname(__file__), "vectors",
                        "golden_proofs.json")
    with open(path) as fh:
        vec = json.load(fh)[name]
    want = StarkProof.deserialize(json.dumps(vec).encode()).proof
    air = (MimcAIR(x0=271828, k=777) if name == "mimc3_2e5"
           else FibMulAIR(a0=1, b0=2718281))
    field = (dict(modulus=2**64 - 2**32 + 1, generator=7)
             if name == "fibmul_gl_2e5" else {})
    cfg = ProverConfig(log2_trace=5, blowup=4, num_queries=3, **field)
    for _ in range(2):
        assert prove(cfg, air=air, device=dev).proof == want
        assert tprover.LAST_PROVE_PATH == "mega"
