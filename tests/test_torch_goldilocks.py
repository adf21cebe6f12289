"""The port's Goldilocks field (p = 2^64 - 2^32 + 1, limb planes) module
by module against the JAX package on the same seeded inputs, exact
equality: the field ops, the NTT (and the 64-bit kernels' plain
version), K3's 64-bit mode (plain version, held
against the JAX Pallas kernel in interpret mode), the width-2 draw, the
FRI fold and commit, and the query plan's replay."""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stark_tpu.channel import device_channel as jdc
from stark_tpu.channel import device_query as jdq
from stark_tpu.channel.channel import Channel as JChannel
from stark_tpu.channel.device_channel import DeviceFS as JDeviceFS
from stark_tpu.fields.fp64 import Fp64Goldilocks as JFp64
from stark_tpu.fri import commit as jfc
from stark_tpu.hash.sha256_jax import sha256_row_leaves as j_row_leaves
from stark_tpu.merkle.tree import MerkleTree as JMerkleTree
from stark_tpu.ntt.fourstep import FOURSTEP_MIN
from stark_tpu.ntt.ntt import coset_evaluate as j_coset_evaluate
from stark_tpu.ntt.ntt import get_plan
from stark_tpu_torch.channel import device_channel as tdc
from stark_tpu_torch.channel.channel import Channel
from stark_tpu_torch.channel.device_channel import DeviceFS
from stark_tpu_torch.channel.device_query import DeviceQueryPlan, supported
from stark_tpu_torch.fields.fp import Fp, host_values, host_words
from stark_tpu_torch.fields.fp64 import GOLDILOCKS, Fp64Goldilocks
from stark_tpu_torch.fri import commit as tfc
from stark_tpu_torch.hash.cuda_sha import sha_leaves, sha_row_leaves
from stark_tpu_torch.hash.sha256 import sha256_row_leaves, sha256_u64_leaves
from stark_tpu_torch.interop import (hex_to_state, limbs_to_tensor,
                                     tensor_to_limbs, u32_to_tensor)
from stark_tpu_torch.merkle.tree import MerkleTree, merkle_root_host
from stark_tpu_torch.ntt import cuda_ntt64
from stark_tpu_torch.ntt.cuda_ntt64 import ntt64, ntt64_passes_plain
from stark_tpu_torch.ntt.ntt import coset_evaluate, intt, ntt

tn = importlib.import_module("stark_tpu_torch.ntt.ntt")
P = GOLDILOCKS
F = Fp.get(P)
JF = JFp64(P)
EDGE = [0, 1, 2, P - 1, P - 2, 2**32 - 1, 2**32, 2**32 + 1, 2**63,
        2**63 - 1, P - 2**32, 2**31]


def _ints(n, seed):
    """n seeded canonical field values (Python ints)."""
    rs = np.random.RandomState(seed)
    hi = rs.randint(0, 2**32, size=n, dtype=np.uint64)
    lo = rs.randint(0, 2**32, size=n, dtype=np.uint64)
    return [int(v) % P for v in (hi << np.uint64(32)) | lo]


def _limbs(values):
    """Python ints (any shape) -> numpy uint32 storage, the limb planes
    right before the last axis (the JAX (2, n) / (C, 2, n) layout)."""
    return host_words(np.asarray(values, dtype=np.uint64), 2)


def _words(shape, seed):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def _pairs(seed, n=2000):
    """(a, b) operand lists: every pair of edge values, then seeded ones."""
    a = [x for x in EDGE for _ in EDGE] + _ints(n, seed)
    b = [y for _ in EDGE for y in EDGE] + _ints(n, seed + 1)
    return a, b


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_field_ops_match_jax(op):
    """add / sub / mul on int32 storage planes, against the JAX context's
    jitted op and Python ints, edge values included."""
    a, b = _pairs(len(op))
    ta, tb = (limbs_to_tensor(_limbs(v), device="cpu") for v in (a, b))
    got = tensor_to_limbs(getattr(F, op)(ta, tb))
    want = np.asarray(getattr(JF, f"jit_{op}")(jnp.asarray(_limbs(a)),
                                               jnp.asarray(_limbs(b))))
    np.testing.assert_array_equal(got, want)
    ref = {"add": lambda x, y: (x + y) % P, "sub": lambda x, y: (x - y) % P,
           "mul": lambda x, y: x * y % P}[op]
    assert F.to_ints(got) == [ref(x, y) for x, y in zip(a, b)]


def test_neg_and_broadcast_constants():
    a = EDGE + _ints(100, 3)
    t = limbs_to_tensor(_limbs(a), device="cpu")
    assert F.to_ints(F.neg(t)) == [(-x) % P for x in a]
    # a (2, 1) constant and a (2,) pair broadcast plane by plane
    c = 2**40 + 12345
    want = [x * c % P for x in a]
    assert F.to_ints(F.mul(t, F.const(c))) == want
    assert F.to_ints(F.mul(F.const(c)[:, 0], t)) == want


def test_inverse_and_pow_match_jax():
    a = EDGE + _ints(60, 4)
    t = limbs_to_tensor(_limbs(a), device="cpu")
    ja = jnp.asarray(_limbs(a))
    np.testing.assert_array_equal(tensor_to_limbs(F.inv_rolled(t)),
                                  np.asarray(jax.jit(JF.inv_rolled)(ja)))
    assert F.to_ints(F.inv_rolled(t)) == [pow(x, P - 2, P) for x in a]
    for e in (0, 1, 2, 7, 2**20, P - 1):
        np.testing.assert_array_equal(
            tensor_to_limbs(F.pow_static(t, e)),
            np.asarray(JF.jit_pow_static(ja, e)))


@pytest.mark.parametrize("count", [1, 2, 33, 1027])
def test_powers_and_coset_domain_match_jax(count, monkeypatch):
    """The device powers (an outer product of two host tables, in chunks
    of POWERS_CHUNK entries) and the coset domain against JAX."""
    from stark_tpu_torch.fields import fp64

    monkeypatch.setattr(fp64, "POWERS_CHUNK", 64)
    w = pow(7, (P - 1) // 2**12, P)
    np.testing.assert_array_equal(
        tensor_to_limbs(F.powers(w, count, "cpu")),
        np.asarray(JF.jit_powers(w, count)))
    np.testing.assert_array_equal(
        tensor_to_limbs(F.coset_domain(7, w, count, "cpu")),
        np.asarray(JF.jit_coset_domain(7, w, count)))


def test_host_words_round_trip_and_interop_views():
    vals = np.asarray(_ints(24, 5), dtype=np.uint64).reshape(3, 8)
    words = host_words(vals, 2)
    assert words.shape == (3, 2, 8) and words.dtype == np.uint32
    np.testing.assert_array_equal(host_values(words, 2), vals)
    np.testing.assert_array_equal(host_values(host_words(vals, 1), 1),
                                  vals & np.uint64(0xFFFFFFFF))
    t = limbs_to_tensor(words, device="cpu")
    assert t.dtype == torch.int32 and t.shape == (3, 2, 8)
    np.testing.assert_array_equal(tensor_to_limbs(t), words)
    with pytest.raises(ValueError, match="limb planes"):
        limbs_to_tensor(words[:, 0], device="cpu")


# a Stockham size and the JAX package's four-step threshold (2^14)
@pytest.mark.parametrize("log_n", [6, FOURSTEP_MIN.bit_length() - 1])
@pytest.mark.parametrize("cols", [None, 2])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_matches_jax_plan(log_n, cols, inverse):
    """The torch-op Goldilocks NTT / INTT of one column (2, n) or of
    (2, 2, n) columns against JAX ``get_plan(P, n)`` (its Stockham plan,
    or the XLA four-step from 2^14)."""
    n = 1 << log_n
    shape = (n,) if cols is None else (cols, n)
    x = _limbs(np.asarray(_ints(int(np.prod(shape)), log_n + 7 * inverse),
                          dtype=object).reshape(shape))
    got = (intt if inverse else ntt)(limbs_to_tensor(x, device="cpu"), P)
    plan = get_plan(P, n, inverse)
    # the JAX plans take the limb plane leading: (2, C, n) for columns
    want = np.asarray(plan(jnp.asarray(x if cols is None
                                       else np.moveaxis(x, 1, 0))))
    if cols is not None:
        want = np.moveaxis(want, 0, 1)
    np.testing.assert_array_equal(tensor_to_limbs(got), want)


@pytest.mark.parametrize("cols", [None, 2])
def test_coset_evaluate_matches_jax(cols):
    n, big_n = 32, 128
    shape = (n,) if cols is None else (cols, n)
    c = _limbs(np.asarray(_ints(int(np.prod(shape)), 11),
                          dtype=object).reshape(shape))
    got = coset_evaluate(limbs_to_tensor(c, device="cpu"), P, big_n, 7)
    want = np.asarray(j_coset_evaluate(jnp.asarray(c), P, big_n, 7))
    np.testing.assert_array_equal(tensor_to_limbs(got), want)


def _ntt64_input(shape, seed):
    """Seeded limb planes of `shape` values (n last), every edge value
    (p - 1, 2^32 - 1, 2^32, ... in either limb) first in each column."""
    vals = np.asarray(_ints(int(np.prod(shape)), seed),
                      dtype=object).reshape(shape)
    k = min(len(EDGE), shape[-1])
    vals[..., :k] = EDGE[:k]
    return limbs_to_tensor(_limbs(vals), device="cpu")


@pytest.mark.parametrize("log_n", range(1, 13))
@pytest.mark.parametrize("cols", [1, 2, 3])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt64_plain_matches_limbs(log_n, cols, inverse):
    """The 64-bit kernels' plain version (their split, index maps and
    tables) against the torch-op Stockham ``ntt_limbs``: (2, n) for one
    column, (C, 2, n) for C."""
    shape = (1 << log_n,) if cols == 1 else (cols, 1 << log_n)
    x = _ntt64_input(shape, 3 * log_n + cols + 50 * inverse)
    assert torch.equal(ntt64_passes_plain(x, P, inverse),
                       tn.ntt_limbs(x, P, inverse))


# (BLOCK_LOG, log n, the split): pass 1's column group narrowed to 4, 2
# and 1 columns, a one-row pass 1 (n1 = 1) and a one-column group
@pytest.mark.parametrize("block_log,log_n,want",
                         [(6, 10, (4, 6, 2)), (6, 11, (5, 6, 1)),
                          (6, 12, (6, 6, 0)), (3, 1, (0, 1, 1)),
                          (3, 6, (3, 3, 0)), (4, 8, (4, 4, 0))])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt64_plain_matches_limbs_at_every_split(monkeypatch, block_log,
                                                  log_n, want, inverse):
    monkeypatch.setattr(cuda_ntt64, "BLOCK_LOG", block_log)
    assert cuda_ntt64.split(log_n) == want
    x = _ntt64_input((3, 1 << log_n), log_n + 90 * inverse)
    assert torch.equal(ntt64_passes_plain(x, P, inverse),
                       tn.ntt_limbs(x, P, inverse))


# the shapes of the two tests above, so the JAX programs are compiled once
@pytest.mark.parametrize("cols", [None, 2])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt64_plain_matches_jax_plan(cols, inverse):
    """The plain version against JAX ``get_plan``, and a coset evaluation
    through it against ``coset_evaluate``, edge values included."""
    n = 64
    x = _ntt64_input((n,) if cols is None else (cols, n), 8 + inverse)
    want = get_plan(P, n, inverse)(jnp.asarray(
        np.moveaxis(tensor_to_limbs(x), -2, 0)))
    got = ntt64_passes_plain(x, P, inverse)
    np.testing.assert_array_equal(tensor_to_limbs(got),
                                  np.moveaxis(np.asarray(want), 0, -2))
    c = _ntt64_input((32,) if cols is None else (cols, 32), 7)
    got = ntt64_passes_plain(tn.scale_pad(c, P, 128, 7), P)
    np.testing.assert_array_equal(
        tensor_to_limbs(got),
        np.asarray(j_coset_evaluate(jnp.asarray(tensor_to_limbs(c)), P, 128,
                                    7)))


def test_ntt64_split_and_refusals():
    """Two passes up to 2^28, 8-column groups up to 2^25 and no pass over
    2^14 values; the wrapper takes only Goldilocks limb planes on a CUDA
    tensor, and counts no launch for one it refuses."""
    for log_n in range(29):
        log1, log2, cols_log = cuda_ntt64.split(log_n)
        assert log1 + log2 == log_n
        assert log1 + cols_log <= cuda_ntt64.BLOCK_LOG >= log2
        assert cols_log == min(3, log2) or log_n > 25
    assert cuda_ntt64.split(21) == (11, 10, 3)
    assert cuda_ntt64.split(24) == (11, 13, 3)
    with pytest.raises(ValueError, match="n <= 2"):
        cuda_ntt64.Ntt64Plan(1 << 29, False, "cpu")
    x = _ntt64_input((16,), 1)
    with pytest.raises(ValueError, match="2\\^64 - 2\\^32 \\+ 1"):
        ntt64(x, 3 * 2**30 + 1)
    with pytest.raises(ValueError, match="limb planes"):
        ntt64(x[0], P)
    before = (ntt64.launches, ntt64.column_launches)
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match="take a CUDA tensor"):
            ntt64(torch.zeros(2, 8, dtype=torch.int32, device=dev), P)
    assert (ntt64.launches, ntt64.column_launches) == before
    assert ntt64.plain is ntt64_passes_plain


def test_transform_routes_by_width_and_device(monkeypatch):
    """A width-2 CPU tensor takes ``ntt_limbs`` (the 64-bit kernels only
    on a CUDA one); a u32 tensor K1 up to 2^MAX_LOG_N, K2 above, as
    before."""
    from stark_tpu_torch.ntt import cuda_ntt

    calls = []

    def spy(name, fn):
        def wrapped(x, p, inverse=False):
            calls.append((name, int(x.shape[-1]), inverse))
            return fn(x, p, inverse)
        return wrapped

    for name in ("ntt_limbs", "ntt64", "ntt_k1", "ntt_k2"):
        monkeypatch.setattr(tn, name, spy(name, getattr(tn, name)))
    monkeypatch.setattr(cuda_ntt, "MAX_LOG_N", 4)
    x = _ntt64_input((2, 32), 3)
    assert torch.equal(tn.intt(tn.ntt(x, P), P), x)
    u = u32_to_tensor(np.arange(32, dtype=np.uint32), device="cpu")
    q = 3 * 2**30 + 1
    tn.ntt(u, q)
    tn.intt(u[:16], q)
    assert calls == [("ntt_limbs", 32, False), ("ntt_limbs", 32, True),
                     ("ntt_k2", 32, False), ("ntt_k1", 16, True)]


def test_wide_leaves_match_jax_pallas_interpret_and_host_oracle():
    """K3's 64-bit mode, plain version: the tree over (2, n) limb planes
    against the TPU kernel it replaces (build_tree_bitrev in interpret
    mode, wide) and the hashlib oracle: same root and paths."""
    from stark_tpu.hash.pallas_sha import build_tree_bitrev
    from stark_tpu.merkle.tree import bitrev_layouts

    n = 1 << 8
    vals = _ints(n, 12)
    x = _limbs(vals)
    levels = build_tree_bitrev(jnp.asarray(x), interpret=True)
    jt = JMerkleTree(None, device_levels=levels, layouts=bitrev_layouts(n))
    t = MerkleTree(limbs_to_tensor(x, device="cpu"), wide=True)
    assert t.root() == jt.root() == merkle_root_host(vals)
    for i in (0, 77, 128, 255):
        assert t.get_authentication_path(i) == jt.get_authentication_path(i)
        assert MerkleTree.validate(t.root(), t.get_authentication_path(i), i,
                                   vals[i].to_bytes(8, "big"), n)


@pytest.mark.parametrize("c", range(1, 7))
def test_wide_row_leaves_match_jax(c):
    """The row form over (C, 2, n) limb planes against JAX
    ``sha256_row_leaves(cols, wide=True)``; C = 1 equals the one-column
    leaves."""
    cols = _words((c, 2, 40), 20 + c)
    t = u32_to_tensor(cols, device="cpu")
    got = sha256_row_leaves(t, wide=True)
    want = np.asarray(j_row_leaves(jnp.asarray(cols), wide=True))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert torch.equal(sha_row_leaves(t, wide=True), got)
    if c == 1:
        assert torch.equal(sha256_u64_leaves(t[0], wide=True), got)


def test_width_is_explicit_never_read_from_the_shape():
    """A (2, n) tensor is two u32 columns or one Goldilocks column: the
    tree entries hash it as the caller says, and refuse a mismatch."""
    v = u32_to_tensor(_words((2, 16), 30), device="cpu")
    rows = MerkleTree.from_columns(v)  # two u32 columns: 0 || a || 0 || b
    wide = MerkleTree(v, wide=True)  # one Goldilocks column: hi || lo
    assert rows.root() != wide.root()
    with pytest.raises(ValueError, match="1-D"):
        MerkleTree(v)
    with pytest.raises(ValueError, match=r"\(2, n\)"):
        MerkleTree(v[0], wide=True)
    with pytest.raises(ValueError, match="wide leaves"):
        sha_leaves(v[0], wide=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_width2_draw_matches_jax(seed):
    """int(state_hex, 16) mod p as a (2,) pair against JAX
    ``draw_field_element(state, P)``, and the state advance."""
    state = _words(8, 40 + seed)
    if seed == 2:
        state[:] = 0xFFFFFFFF  # the largest 256-bit state
    v, s2 = tdc.draw_field_element(u32_to_tensor(state, device="cpu"), P)
    jv, js2 = jdc.draw_field_element(jnp.asarray(state), P)
    np.testing.assert_array_equal(tensor_to_limbs(v[:, None])[:, 0],
                                  np.asarray(jv))
    assert F.to_ints(v) == [int(bytes(state.astype(">u4")).hex(), 16) % P]
    np.testing.assert_array_equal(s2.numpy().view(np.uint32),
                                  np.asarray(js2))


def test_device_fs_replays_width2_draws():
    """DeviceFS over the Goldilocks field: its (2,) draws replay into the
    host channel (8-byte values), equal to the JAX DeviceFS's."""
    ch, jch = Channel(P), JChannel(P)
    for c in (ch, jch):
        c.send(b"statement")
    fs, jfs = DeviceFS(P, ch.state, device="cpu"), JDeviceFS(P, jch.state)
    root = _words(8, 50)
    fs.absorb_root(u32_to_tensor(root, device="cpu"))
    jfs.absorb_root(jnp.asarray(root))
    draws = [fs.draw() for _ in range(3)]
    jdraws = [jfs.draw() for _ in range(3)]
    for d, jd in zip(draws, jdraws):
        assert F.to_ints(d) == JF.to_ints(np.asarray(jd))
    fs.replay_fetched(ch, [t.reshape(-1).numpy() for t in fs.payloads()])
    jfs.finalize(jch)
    assert ch.proof == jch.proof and ch.state == jch.state


@pytest.mark.parametrize("m", [2, 64])
def test_fold_and_inverse_domain_match_jax(m):
    ev = _limbs(_ints(m, 60 + m))
    beta = _ints(1, 61)[0]
    jinv = np.asarray(jfc._inv_domain(P, m, 7))
    tinv = tfc._inv_domain(P, m, 7, "cpu")
    np.testing.assert_array_equal(tensor_to_limbs(tinv), jinv)
    want = np.asarray(jfc._fold_fn(P, m)(jnp.asarray(ev),
                                         JF.const(beta), jnp.asarray(jinv)))
    got = tfc._fold_fn(P, m)(limbs_to_tensor(ev, device="cpu"),
                             F.const(beta)[:, 0], tinv)
    np.testing.assert_array_equal(tensor_to_limbs(got), want)


def test_fri_commit_matches_jax():
    """The deferred commit over a Goldilocks codeword: same layers (hi
    plane then lo plane of each in the values buffer), roots and
    transcript after the host replay."""
    n, num_folds, offset = 64, 3, 7
    coeffs = _limbs(_ints(8, 70))
    ev = np.asarray(j_coset_evaluate(jnp.asarray(coeffs), P, n, offset))
    jch, ch = JChannel(P), Channel(P)
    jfs = JDeviceFS(P, jch.state)
    jfri = jfc.fri_commit(jnp.asarray(ev), P, offset, jch,
                          num_folds=num_folds, fs=jfs, defer=True)
    jfs.finalize(jch)
    jfc.finish_deferred(P, np.asarray(jfri.fri_layers[-1]), jch)

    fs = DeviceFS(P, ch.state, device="cpu")
    fri = tfc.fri_commit(limbs_to_tensor(ev, device="cpu"), P, offset, ch,
                         num_folds=num_folds, fs=fs, defer=True)
    for got, want in zip(fri.fri_layers, jfri.fri_layers):
        np.testing.assert_array_equal(tensor_to_limbs(got), np.asarray(want))
    assert [t.root() for t in fri.fri_merkles] == [
        t.root() for t in jfri.fri_merkles]
    fs.replay_fetched(ch, [t.reshape(-1).numpy() for t in fs.payloads()])
    fri.final_value = tfc.finish_deferred(
        P, fri.fri_layers[-1].reshape(-1).numpy(), ch)
    assert ch.proof == jch.proof and ch.state == jch.state
    for layer, (ln, voff, _) in zip(fri.fri_layers, fri.layout):
        assert layer.shape == (2, ln)
        assert layer.data_ptr() == fri.values[voff:].data_ptr()


def test_finish_deferred_reads_both_words():
    ch = Channel(P)
    v = P - 5
    words = np.array([v >> 32, v >> 32, v & 0xFFFFFFFF, v & 0xFFFFFFFF],
                     dtype=np.uint32)
    assert tfc.finish_deferred(P, words, ch) == v
    assert ch.proof == [v.to_bytes(8, "big")]
    with pytest.raises(ValueError, match="constant"):
        tfc.finish_deferred(P, np.array([0, 1, 2, 2], np.uint32), Channel(P))


def _fri_buffers(layers):
    """Port FRI buffers (values, digests) for Goldilocks layers (2, ln)."""
    layout, vt, dt = tfc.layer_layout([v.shape[-1] for v in layers], 2)
    values = torch.empty(vt, dtype=torch.int32)
    digests = torch.empty((dt, 8), dtype=torch.int32)
    for v, (ln, vo, do) in zip(layers, layout):
        values[vo:vo + 2 * ln] = limbs_to_tensor(v, device="cpu").reshape(-1)
        MerkleTree(limbs_to_tensor(v, device="cpu"),
                   out=digests[do:do + 2 * ln - 1], wide=True)
    return values, digests


@pytest.mark.parametrize("c", [1, 2])
def test_query_plan_replay_matches_jax(c):
    """The query plan with elem_width 2 (two value slots a value, the hi
    word at 4c, the lo at 4c + 2 of a row message): the host replay's
    transcript equals the JAX DeviceQueryPlan's with elem_width=2."""
    n, offsets, fri = 32, (0, 4), (32, 16, 8, 4, 2, 1)
    f_evals = _limbs(np.asarray(_ints(c * n, 80 + c),
                                dtype=object).reshape(c, n))
    layers = [_limbs(_ints(ln, 90 + i)) for i, ln in enumerate(fri)]
    jf = jnp.asarray(f_evals if c > 1 else f_evals[0])
    jplan = jdq.DeviceQueryPlan(n - max(offsets), 3, offsets, n, fri,
                                elem_width=2, num_columns=c)
    jch, ch = JChannel(P), Channel(P)
    for ch_ in (jch, ch):
        ch_.send(b"statement")
    jt = JMerkleTree.from_columns(jf) if c > 1 else JMerkleTree(jf)
    jplan.run(jch, jf, jt.levels[:-1], [jnp.asarray(v) for v in layers],
              [JMerkleTree(jnp.asarray(v)).levels[:-1] for v in layers])

    plan = DeviceQueryPlan(jplan.rng, 3, offsets, n, fri, c, elem_width=2)
    f_t = limbs_to_tensor(f_evals if c > 1 else f_evals[0], device="cpu")
    tree = (MerkleTree.from_columns(f_t, wide=True) if c > 1
            else MerkleTree(f_t, wide=True))
    values, digests = _fri_buffers(layers)
    out = plan.run_device(hex_to_state(ch.state, device="cpu"), f_t,
                          tree.buffer, values, digests)
    plan.replay(ch, *(t.numpy() for t in out))
    assert ch.proof == jch.proof and ch.state == jch.state
    # a trace opening is one message of C 8-byte values (both words)
    assert len(ch.proof[2]) == 8 * c
    tb = plan.pack("cpu")
    assert tb.num_values == 2 * (c * len(offsets) + 2 * len(fri) + 1)
    assert tb.sizes[0] == 2 * c * n


def test_query_plan_width_is_checked():
    assert supported(100, 16, (16, 8), 2, 2)
    assert not supported(100, 16, (16, 8), 2, 3)
    with pytest.raises(ValueError, match="elem_width"):
        DeviceQueryPlan(10, 1, (0,), 16, (16,), 1, elem_width=4)


def test_fp64_context_refuses_other_moduli():
    assert Fp64Goldilocks().width == 2 and Fp.get(97).width == 1
    with pytest.raises(ValueError, match="2\\^64 - 2\\^32 \\+ 1"):
        Fp64Goldilocks(97)
    assert functools.reduce(lambda a, b: a * b % P, [7] * 5) == F.to_ints(
        F.pow_static(F.const(7), 5))[0]
