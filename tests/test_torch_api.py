"""The rest of the JAX package's public API in the port, held against the
JAX package on the same seeded inputs, exact equality: ``lde`` (both
fields, both NTT routes), ``CosetFri``, the field helpers, the debug
checks and their wiring into the prove, the regression gate, the proof's
compressed size, the host tree and digest helpers, the ``AIR`` base
class and the traces it builds, ``profile_trace``, the native host hash
and every subpackage import.  On the CPU every kernel wrapper runs its
plain version."""

import hashlib
import importlib
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stark_tpu.config import ProverConfig as JConfig
from stark_tpu.ntt import lde as j_lde
from stark_tpu.ntt.reference_ntt import ntt_host as j_ntt_host
from stark_tpu_torch import native
from stark_tpu_torch.config import ProverConfig
from stark_tpu_torch.fields import Fp
from stark_tpu_torch.interop import tensor_to_u32, u32_to_tensor
from stark_tpu_torch.ntt import cuda_ntt, lde
from stark_tpu_torch.ntt.reference_ntt import root_of_unity

# the module (the package exports the function ntt under its name, as
# the JAX package's does)
tn = importlib.import_module("stark_tpu_torch.ntt.ntt")

P = 3 * 2**30 + 1
GL = 2**64 - 2**32 + 1
OFFSET = 3


def _vals(p, shape, seed):
    """Seeded canonical values as numpy uint64."""
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 2**62, size=shape, dtype=np.int64).astype(
        np.uint64) % np.uint64(p))


def _words(vals, p):
    """Values -> the storage words both packages hold (uint32; limb
    planes (..., 2, n) for Goldilocks)."""
    if p < 1 << 32:
        return vals.astype(np.uint32)
    return np.stack([(vals >> np.uint64(32)).astype(np.uint32),
                     (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)],
                    axis=-2)


CFG5 = dict(log2_trace=5, blowup=4, num_queries=3)


@pytest.fixture(scope="module")
def proof5():
    """The port's fib-sq proof at 2^5 rows, made once for the file."""
    from stark_tpu_torch.stark import prove

    return prove(ProverConfig(**CFG5), device="cpu")


# -- every subpackage import the JAX package offers, in the port's form --

IMPORTS = [
    "from {pkg}.fri import fri_commit, decommit_fri, verify_fri, FRIProof, "
    "CosetFri, decommit_fri_layers, FRIVerificationError",
    "from {pkg}.ntt import ntt, intt, lde, coset_evaluate, "
    "coset_interpolate, ntt_host, ntt_available, root_of_unity, naive_dft",
    "from {pkg}.merkle import MerkleTree, merkle_root_host",
    "from {pkg}.merkle.tree import merkle_root_host_rows",
    "from {pkg}.channel import Channel, VerifierChannel, ChannelError",
    "from {pkg}.utils import setup_logging, get_logger, profile_trace, "
    "MetricsCollector, compare, save_baseline, assert_canonical, "
    "check_canonical, maybe_assert_canonical",
    "from {pkg}.hash import sha256_u64_leaves, sha256_pairs, digest_to_bytes",
    "from {pkg}.stark import AIR, fibonacci_square_trace, trace_polynomial, "
    "StarkProof, prove, verify, FibonacciSquareAIR, AirSpec",
    "from {pkg}.stark.trace import upload_trace, host_or_device_trace",
    "from {pkg}.poly import Polynomial, poly, gen_polynomial_from_roots, "
    "gen_lagrange_polynomials, interpolate_lagrange",
    "from {pkg}.native import sha256, merkle_validate, merkle_build_host, "
    "channel_absorb, get_lib, host_trace",
    "from {pkg}.fields import FieldElement, fe, Fp",
    "from {pkg}.dist import make_mesh, dist_ntt, multihost_prove",
]


@pytest.mark.parametrize("stmt", IMPORTS, ids=range(len(IMPORTS)))
def test_import_works_in_both_packages(stmt):
    exec(stmt.format(pkg="stark_tpu"), {})
    exec(stmt.format(pkg="stark_tpu_torch"), {})


# the JAX subpackages' __all__ names that are XLA mechanisms (ROADMAP item
# 17; tests/test_torch_api_parity.py holds the whole list)
_NOT_PORTED = {"jit_leaves", "jit_pairs", "NTTPlan", "get_plan"}


@pytest.mark.parametrize("sub", ["channel", "dist", "fields", "fri", "hash",
                                 "merkle", "ntt", "poly", "stark", "utils"])
def test_subpackage_exports_every_jax_name(sub):
    jmod = importlib.import_module(f"stark_tpu.{sub}")
    tmod = importlib.import_module(f"stark_tpu_torch.{sub}")
    missing = [n for n in jmod.__all__
               if n not in _NOT_PORTED and not hasattr(tmod, n)]
    assert not missing
    assert set(jmod.__all__) - _NOT_PORTED <= set(tmod.__all__)


# -- lde (stark_tpu/ntt/ntt.py:280; tests/test_ntt.py:80-100) -------------

def _lde_host(vals, p, blowup, offset):
    """The JAX package's host reference NTT composed as its lde is:
    INTT_n, coefficient i times offset^i, zero pad, NTT_{blowup n}."""
    n = vals.shape[-1]
    coeffs = j_ntt_host(vals, p, inverse=True).astype(np.uint64)
    scale = np.array([pow(offset, i, p) for i in range(n)], dtype=np.uint64)
    padded = np.zeros(blowup * n, dtype=np.uint64)
    padded[:n] = coeffs * scale % np.uint64(p)
    return j_ntt_host(padded, p)


@pytest.mark.parametrize("log_n", [4, 5, 6, 7, 8])
@pytest.mark.parametrize("blowup", [2, 4, 8])
def test_lde_matches_jax_host_reference(log_n, blowup):
    vals = _vals(P, 1 << log_n, seed=log_n * 10 + blowup)
    got = lde(u32_to_tensor(_words(vals, P), device="cpu"), P, blowup,
              OFFSET)
    np.testing.assert_array_equal(tensor_to_u32(got),
                                  _lde_host(vals, P, blowup, OFFSET))


@pytest.mark.parametrize("p,log_n,blowup", [(P, 4, 4), (P, 8, 2),
                                            (GL, 4, 2)])
def test_lde_matches_jax_lde(p, log_n, blowup):
    """Against the JAX package's lde itself (its XLA plans; limb planes
    for Goldilocks, which the port transforms in torch ops)."""
    words = _words(_vals(p, 1 << log_n, seed=log_n), p)
    want = np.asarray(j_lde(jnp.asarray(words), p, blowup, OFFSET))
    got = lde(u32_to_tensor(words, device="cpu"), p, blowup, OFFSET)
    np.testing.assert_array_equal(tensor_to_u32(got), want)


@pytest.mark.parametrize("log_n,blowup", [(4, 2), (4, 8), (5, 4)])
def test_lde_goldilocks_matches_jax_polynomial(log_n, blowup):
    """Goldilocks: the JAX package's host Polynomial (Lagrange
    interpolation on the subgroup, Horner on the coset) as the oracle."""
    from stark_tpu.poly import Polynomial as JPolynomial

    n = 1 << log_n
    vals = _vals(GL, n, seed=n + blowup)
    got = lde(u32_to_tensor(_words(vals, GL), device="cpu"), GL, blowup,
              OFFSET)
    w, wb = root_of_unity(GL, n), root_of_unity(GL, n * blowup)
    f = JPolynomial.interpolate([pow(w, i, GL) for i in range(n)],
                                vals.tolist(), GL)
    want = [f.evaluate(OFFSET * pow(wb, i, GL) % GL).value
            for i in range(n * blowup)]
    assert Fp.get(GL).to_ints(got) == want


def test_lde_columns_transform_each_column():
    vals = _vals(P, (3, 1 << 6), seed=11)
    got = tensor_to_u32(lde(u32_to_tensor(_words(vals, P), device="cpu"),
                            P, 4, OFFSET))
    for c in range(3):
        np.testing.assert_array_equal(got[c],
                                      _lde_host(vals[c], P, 4, OFFSET))


def test_lde_takes_the_k2_route_above_its_split(monkeypatch):
    """With the K1 route cut at 2^9 (and a 2^7-word block budget) the
    lde of 2^8 values at blowup 8 runs its INTT on K1 and its 2^11-point
    NTT on K2, both wrappers' plain versions here."""
    monkeypatch.setattr(cuda_ntt, "MAX_LOG_N", 9)
    monkeypatch.setattr(cuda_ntt, "BLOCK_LOG", 7)
    calls = []

    def spy(name, fn):
        def wrapped(x, p, inverse):
            calls.append((name, int(x.shape[-1]), inverse))
            return fn(x, p, inverse)
        return wrapped

    monkeypatch.setattr(tn, "ntt_k1", spy("K1", cuda_ntt.ntt_k1))
    monkeypatch.setattr(tn, "ntt_k2", spy("K2", cuda_ntt.ntt_k2))
    vals = _vals(P, 1 << 8, seed=8)
    got = lde(u32_to_tensor(_words(vals, P), device="cpu"), P, 8, OFFSET)
    np.testing.assert_array_equal(tensor_to_u32(got),
                                  _lde_host(vals, P, 8, OFFSET))
    assert calls == [("K1", 1 << 8, True), ("K2", 1 << 11, False)]


def test_lde_agrees_with_polynomial_eval():
    """tests/test_ntt.py's oracle: the interpolant on the subgroup,
    evaluated on the big coset; at offset 1 every blowup-th value is the
    input."""
    from stark_tpu_torch.poly import Polynomial

    p, n, blowup, offset = 97, 8, 4, 5
    vals = _vals(p, n, seed=7)
    out = tensor_to_u32(lde(u32_to_tensor(_words(vals, p), device="cpu"),
                            p, blowup, offset)).tolist()
    w = root_of_unity(p, n)
    f = Polynomial.interpolate([pow(w, i, p) for i in range(n)],
                               vals.tolist(), p)
    wb = root_of_unity(p, n * blowup)
    assert out == [f.evaluate(offset * pow(wb, i, p) % p).value
                   for i in range(n * blowup)]
    one = tensor_to_u32(lde(u32_to_tensor(_words(vals, p), device="cpu"),
                            p, blowup, 1))
    np.testing.assert_array_equal(one[::blowup], vals)


# -- CosetFri (tests/test_fri.py:174-200) --------------------------------

@pytest.mark.parametrize("p", [97, P, GL])
def test_coset_fri_matches_jax(p):
    from stark_tpu.fri import CosetFri as JCosetFri
    from stark_tpu_torch.fri import CosetFri

    w = root_of_unity(p, 16)
    cf = CosetFri(p, 3, w, 16, device="cpu")
    dom = cf.generate_coset_domain()
    want = [3 * pow(w, i, p) % p for i in range(16)]
    assert Fp.get(p).to_ints(dom.movedim(-2, 0) if p == GL else dom) == want
    if p == GL:
        return
    jdom = JCosetFri(p, 3, w, 16).generate_coset_domain()
    np.testing.assert_array_equal(tensor_to_u32(dom), np.asarray(jdom))
    nxt = cf.next_coset_domain(dom)
    assert tensor_to_u32(nxt).tolist() == [v * v % p for v in want[:8]]
    full = cf.next_coset_domain_full(dom)
    assert full.shape[0] == 16
    np.testing.assert_array_equal(tensor_to_u32(full), np.asarray(
        JCosetFri(p, 3, w, 16).next_coset_domain_full(jdom)))


def test_coset_fri_defaults_to_the_card():
    from stark_tpu_torch.fri import CosetFri

    assert CosetFri(P, 3, 5, 16).device == torch.device("cuda")


# -- the field helpers -----------------------------------------------------

def _u32(x):
    return np.asarray(x).astype(np.uint64)


def _t(vals):
    return u32_to_tensor(vals.astype(np.uint32), device="cpu")


def test_fp_helpers_match_jax():
    """Each helper against JAX's, jitted (its eager dispatch is slow); the
    inverse against JAX's inv_rolled, whose values are inv's."""
    from stark_tpu.fields.fp import Fp as JFp

    f, jf = Fp.get(P), JFp.get(P)
    a = _vals(P, 16, 1)
    e = _vals(2**32, 16, 3)
    ja, je = jnp.asarray(a.astype(np.uint32)), jnp.asarray(e.astype(
        np.uint32))
    ta = _t(a)
    pairs = {
        "inv": (f.inv(ta), jax.jit(jf.inv_rolled)(ja)),
        "pow": (f.pow(ta, _t(e)), jax.jit(jf.pow)(ja, je)),
        "sqr": (f.sqr(ta), jf.sqr(ja)),
        "double": (f.double(ta), jf.double(ja)),
        "mont_sqr": (f.mont_sqr(ta), jf.mont_sqr(ja)),
        "sum": (f.sum(ta), jax.jit(jf.sum)(ja)),
        "sum axis 1": (f.sum(ta.reshape(4, 4), axis=1), jax.jit(
            jf.sum, static_argnums=1)(ja.reshape(4, 4), 1)),
        "geometric_table": (f.geometric_table(ta[:5], 13), jax.jit(
            jf.geometric_table, static_argnums=1)(ja[:5], 13)),
        "const_mont": (f.const_mont(12345), jf.const_mont(12345)),
        "ones_mont": (f.ones_mont(4), jf.ones_mont(4)),
    }
    for name, (got, want) in pairs.items():
        np.testing.assert_array_equal(_u32(got), _u32(want), err_msg=name)
    for mont in (False, True):
        np.testing.assert_array_equal(
            f.host_geometric_table(a[:5], 13, mont),
            jf.host_geometric_table(a[:5], 13, mont))
    assert f.one_mont == jf.one_mont
    assert f.to_ints(ta) == jf.to_ints(np.asarray(ja))
    assert f.two_adic_root(1 << 10, 5) == jf.two_adic_root(1 << 10, 5)
    with pytest.raises(ValueError):
        f.two_adic_root(7, 5)
    assert f.inv(torch.zeros(1, dtype=torch.int32)).item() == 0


def test_goldilocks_helpers_match_jax():
    from stark_tpu.fields.fp64 import Fp64Goldilocks as JGl
    from stark_tpu_torch.fields import Fp64Goldilocks

    f, jf = Fp.get(GL), JGl(GL)
    wa, wb = _words(_vals(GL, 8, 4), GL), _words(_vals(GL, 8, 5), GL)
    ja, jb = jnp.asarray(wa), jnp.asarray(wb)
    ta, tb = u32_to_tensor(wa, device="cpu"), u32_to_tensor(wb, device="cpu")
    edge = np.array([[0xFFFFFFFF, 0xFFFFFFFF, 0], [5, 0, 7]], dtype=np.uint32)
    pairs = {
        "inv": (f.inv(ta), jax.jit(jf.inv_rolled)(ja)),
        "double": (f.double(ta), jax.jit(jf.double)(ja)),
        "mont_mul": (f.mont_mul(ta, tb), jax.jit(jf.mont_mul)(ja, jb)),
        "mont_sqr": (f.mont_sqr(ta), jax.jit(jf.mont_sqr)(ja)),
        "sum": (f.sum(ta), jax.jit(jf.sum)(ja)),
        "sum axis 2": (f.sum(ta.reshape(2, 2, 4), axis=2), jax.jit(
            jf.sum, static_argnums=1)(ja.reshape(2, 2, 4), 2)),
        "geometric_table": (f.geometric_table(ta[:, :3], 9), jax.jit(
            jf.geometric_table, static_argnums=1)(ja[:, :3], 9)),
        "const_mont": (f.const_mont(2**63 + 5).reshape(-1),
                       jf.const_mont(2**63 + 5)),
        "ones_mont": (f.ones_mont(3), jf.ones_mont(3)),
        "canon": (f.canon(u32_to_tensor(edge, device="cpu")),
                  jf.canon(jnp.asarray(edge))),
    }
    for name, (got, want) in pairs.items():
        np.testing.assert_array_equal(_u32(got) & 0xFFFFFFFF, _u32(want),
                                      err_msg=name)
    np.testing.assert_array_equal(f.host_geometric_table(wa[:, :3], 9),
                                  jf.host_geometric_table(wa[:, :3], 9))
    assert isinstance(Fp64Goldilocks.get(GL), Fp64Goldilocks)
    assert f.one_mont == jf.one_mont
    assert f.two_adic_root(1 << 32, 7) == jf.two_adic_root(1 << 32, 7)
    with pytest.raises(ValueError, match="limb plane"):
        f.sum(ta, axis=0)


# -- the debug checks (tests/test_utils_cli.py:157-226) --------------------

def _storage(vals):
    return torch.from_numpy(np.asarray(vals, dtype=np.uint32).view(np.int32))


class TestDebugChecks:
    def test_assert_canonical(self):
        from stark_tpu_torch.utils.debug import assert_canonical

        assert_canonical(_storage([0, 1, 96]), 97)
        with pytest.raises(AssertionError, match="non-canonical"):
            assert_canonical(_storage([0, 97]), 97)
        # the unsigned word of int32 storage above 2^31
        assert_canonical(_storage([0, P - 1]), P)
        with pytest.raises(AssertionError,
                           match=r"value 4294967295 >= modulus .* index 2"):
            assert_canonical((_storage([1]), _storage([0, 5, 2**32 - 1])), P)

    def test_maybe_assert_respects_env(self, monkeypatch):
        from stark_tpu_torch.utils.debug import maybe_assert_canonical

        bad = _storage([99])
        monkeypatch.delenv("STARK_TPU_TORCH_DEBUG", raising=False)
        maybe_assert_canonical(bad, 97)  # no-op
        maybe_assert_canonical(object(), 97)  # not even read
        monkeypatch.setenv("STARK_TPU_TORCH_DEBUG", "1")
        with pytest.raises(AssertionError):
            maybe_assert_canonical(bad, 97)

    def test_limb_pair_canonical(self):
        from stark_tpu_torch.utils.debug import assert_canonical

        good = _storage([[0, 1], [5, 0xFFFFFFFF]])
        assert_canonical(good, GL)  # hi / lo planes, both < p
        assert_canonical(good[None].expand(3, 2, 2), GL)  # (C, 2, n)
        bad = _storage([[0xFFFFFFFF], [0xFFFFFFFF]])
        with pytest.raises(AssertionError, match="non-canonical"):
            assert_canonical(bad, GL)  # == 2^64 - 1 >= p
        with pytest.raises(AssertionError, match="limb pair"):
            assert_canonical(_storage([1, 2, 3]), GL)

    def test_prove_catches_planted_noncanonical(self, monkeypatch):
        """A prove under STARK_TPU_TORCH_DEBUG=1 rejects a trace holding
        the value p at the trace phase boundary; with the flag unset the
        same call proves (strict=False: the corrupted trace fails FRI's
        constant check later), as the JAX package's does."""
        from stark_tpu_torch.stark import FibonacciSquareAIR, prove

        cfg = ProverConfig(log2_trace=6, blowup=4, num_queries=2)
        bad = FibonacciSquareAIR(a1=3141592).build_trace(cfg, device="cpu")
        bad[5] = _storage([cfg.modulus])[0]
        monkeypatch.delenv("STARK_TPU_TORCH_DEBUG", raising=False)
        assert prove(cfg, trace=bad, strict=False, device="cpu").proof
        monkeypatch.setenv("STARK_TPU_TORCH_DEBUG", "1")
        with pytest.raises(AssertionError, match="trace: non-canonical"):
            prove(cfg, trace=bad, strict=False, device="cpu")

    def test_check_canonical_queues_an_assertion(self):
        from stark_tpu_torch.utils.debug import check_canonical

        x = _storage([1, 2, 3])
        assert check_canonical(x, 97) is x
        with pytest.raises(RuntimeError, match="non-canonical"):
            check_canonical(_storage([1, 200]), 97)


@pytest.mark.parametrize("path", ["single-fetch", "per-phase"])
def test_debug_prove_equals_the_plain_prove(monkeypatch, proof5, path):
    """The checks read, never write: under the flag both prove paths give
    the transcript the prove gives without it."""
    from stark_tpu_torch.stark import prove
    from stark_tpu_torch.stark import prover

    if path == "per-phase":
        monkeypatch.setenv("STARK_TPU_TORCH_PHASE_SYNC", "1")
    monkeypatch.setenv("STARK_TPU_TORCH_DEBUG", "1")
    assert prove(ProverConfig(**CFG5), device="cpu").proof == proof5.proof
    assert prover.LAST_PROVE_PATH == path


# -- the regression gate, compressed size, host trees and digests ---------

def test_regression_compare_matches_jax(tmp_path):
    from stark_tpu.utils import regression as jreg
    from stark_tpu_torch.utils import compare, save_baseline

    base = {"prove_ms": 100.0, "leaves_per_s": 1e6, "n": 3, "name": "x",
            "zero": 0}
    cur = {"prove_ms": 125.0, "leaves_per_s": 1.2e6, "n": 3, "name": "y",
           "zero": 1, "new": 5}
    save_baseline(base, str(tmp_path / "t" / "base.json"))
    jreg.save_baseline(base, str(tmp_path / "j" / "base.json"))
    assert (tmp_path / "t" / "base.json").read_text() == \
        (tmp_path / "j" / "base.json").read_text()
    got = compare(cur, str(tmp_path / "t" / "base.json"))
    assert got == jreg.compare(cur, str(tmp_path / "j" / "base.json"))
    assert {r["metric"]: r["verdict"] for r in got} == {
        "prove_ms": "regressed", "leaves_per_s": "improved",
        "n": "unchanged"}
    assert compare(cur, str(tmp_path / "missing.json")) == []


def test_compressed_size_bytes_matches_jax(proof5):
    from stark_tpu.stark.prover import StarkProof as JProof

    jp = JProof(proof=proof5.proof, a0=proof5.a0, a_last=proof5.a_last,
                config=JConfig(**CFG5))
    assert proof5.compressed_size_bytes() == jp.compressed_size_bytes()
    assert proof5.compressed_size_bytes() < proof5.size_bytes()


@pytest.mark.parametrize("c,n", [(1, 8), (2, 13), (3, 32)])
def test_merkle_root_host_rows_matches_jax(c, n):
    from stark_tpu.merkle.tree import merkle_root_host_rows as j_rows
    from stark_tpu_torch.merkle import MerkleTree
    from stark_tpu_torch.merkle.tree import merkle_root_host_rows

    cols = _vals(P, (c, n), seed=c * 100 + n)
    want = j_rows(cols.tolist())
    assert merkle_root_host_rows(cols.tolist()) == want
    assert MerkleTree.from_columns(_t(cols)).root() == want


def test_tree_host_helpers():
    from stark_tpu.merkle import merkle_root_host as j_root
    from stark_tpu_torch.merkle import MerkleTree

    vals = _vals(P, 13, seed=13)
    tree = MerkleTree(_t(vals))
    assert tree.root_bytes() == bytes.fromhex(j_root(vals.tolist()))
    assert [tree.level_size(i) for i in range(5)] == [13, 7, 4, 2, 1]
    assert tree.root_bytes().hex() == tree.root()


def test_digest_helpers_match_jax():
    from stark_tpu.hash import sha256_jax as jsha
    from stark_tpu_torch.hash import sha256 as tsha

    words = _vals(2**32, (5, 8), seed=5).astype(np.uint32)
    t = u32_to_tensor(words, device="cpu")
    assert tsha.digest_to_bytes(t[0]) == jsha.digest_to_bytes(words[0])
    assert tsha.digests_to_numpy_bytes(t) == jsha.digests_to_numpy_bytes(
        words)
    msg = _vals(2**32, (16, 4), seed=6).astype(np.uint32)
    got = tsha.sha256_bytes_single_block(
        [u32_to_tensor(m, device="cpu") for m in msg], (4,))
    want = jsha.sha256_bytes_single_block([jnp.asarray(m) for m in msg],
                                          (4,))
    np.testing.assert_array_equal(tensor_to_u32(got), np.asarray(want))


def test_collective_volume_as_dict_matches_jax():
    from stark_tpu.dist import comm as jcomm
    from stark_tpu_torch.dist import comm as tcomm

    assert [v.as_dict() for v in tcomm.ntt_collectives(1 << 12, 4)] == [
        v.as_dict() for v in jcomm.ntt_collectives(1 << 12, 4)]


def test_device_query_get_plan_is_built_once():
    from stark_tpu_torch.channel import device_query as dq
    from stark_tpu_torch.stark.prover import query_plan

    cfg = ProverConfig(log2_trace=5, blowup=4, num_queries=3)
    plan = query_plan(cfg)
    assert query_plan(cfg) is plan
    assert dq.get_plan(plan.rng, 3, plan.offsets, plan.trace_len,
                       plan.fri_lengths, 1, 1, 0,
                       (0,) * len(plan.fri_lengths), 1) is plan


# -- the AIR base class and the traces it builds ---------------------------

def _airs(pkg):
    stark = importlib.import_module(f"{pkg}.stark")
    fam = importlib.import_module(f"{pkg}.stark.families")
    return {"fib": stark.FibonacciSquareAIR(a1=5), "mimc": stark.MimcAIR(),
            "fibmul": stark.FibMulAIR(b0=9), "tribmul": fam.build_air(
                "tribmul", 2)}


# the three hand-written AIRs in both fields, one AirSpec family
@pytest.mark.parametrize("name,modulus", [
    (n, p) for n in ("fib", "mimc", "fibmul") for p in (P, GL)]
    + [("tribmul", P)])
def test_publics_of_build_trace_match_jax(name, modulus):
    from stark_tpu_torch.stark import AIR

    kw = dict(log2_trace=5, blowup=4, num_queries=3)
    if modulus == GL:
        kw.update(modulus=GL, generator=7)
    air, jair = _airs("stark_tpu_torch")[name], _airs("stark_tpu")[name]
    assert isinstance(air, AIR)
    trace = air.build_trace(ProverConfig(**kw), device="cpu")
    jtrace = jair.build_trace(JConfig(**kw))
    np.testing.assert_array_equal(tensor_to_u32(trace), np.asarray(jtrace))
    assert air.publics(trace) == jair.publics(jtrace)
    assert air.publics(trace) == air.publics_from_host(
        ProverConfig(**kw), air.host_trace(ProverConfig(**kw)))


def test_an_air_subclass_proves_through_the_base_interface(proof5):
    """A subclass of AIR that delegates the statement to the Fibonacci-
    square AIR proves the same transcript; the base's own methods
    raise."""
    from stark_tpu_torch.stark import AIR, FibonacciSquareAIR, prove

    class Delegate(AIR):
        name, shifts, num_alphas = "fibonacci-square", (0, 1, 2), 3
        inner = FibonacciSquareAIR()

        def host_trace(self, cfg):
            return self.inner.host_trace(cfg)

        def host_publics(self, trace_host, width):
            return self.inner.host_publics(trace_host, width)

        def num_folds(self, cfg):
            return self.inner.num_folds(cfg)

        def context(self, cfg, device, block=None):
            return self.inner.context(cfg, device, block)

    cfg = ProverConfig(**CFG5)
    assert prove(cfg, air=Delegate(), device="cpu").proof == proof5.proof
    for method, args in (("host_trace", (cfg,)), ("num_folds", (cfg,)),
                         ("witness_params", ()),
                         ("host_publics", (None, 1))):
        with pytest.raises(NotImplementedError):
            getattr(AIR(), method)(*args)


def test_traces_match_jax():
    from stark_tpu.stark import trace as jtrace
    from stark_tpu_torch.stark import trace as ttrace

    got = ttrace.fibonacci_square_trace(P, 1023, device="cpu")
    want = jtrace.fibonacci_square_trace(P, 1023)
    np.testing.assert_array_equal(tensor_to_u32(got), np.asarray(want))
    assert int(tensor_to_u32(got)[-1]) == 2338775057  # STARK-101's a_1022
    host = _vals(GL, (2, 9), seed=9)
    t, j = ttrace.upload_trace(host, GL, device="cpu"), jtrace.upload_trace(
        host, GL)
    np.testing.assert_array_equal(tensor_to_u32(t), np.asarray(j))
    never = ttrace.host_or_device_trace(
        "mimc", P, 3, 7, 16, device_fallback=lambda: 1 / 0, device="cpu")
    np.testing.assert_array_equal(tensor_to_u32(never), np.asarray(
        jtrace.host_or_device_trace("mimc", P, 3, 7, 16, lambda: 1 / 0)))


# -- profile_trace -----------------------------------------------------------

def test_profile_trace_writes_a_chrome_trace(tmp_path):
    from stark_tpu_torch.utils import profile_trace

    with profile_trace(str(tmp_path / "trace")) as path:
        lde(_t(_vals(P, 64, 1)), P, 4, OFFSET)
    assert os.path.dirname(path) == str(tmp_path / "trace")
    with open(path) as fh:
        assert json.load(fh)["traceEvents"]


# -- the native host hash (tests/test_native.py) ----------------------------

@pytest.mark.parametrize("n", [0, 1, 55, 56, 63, 64, 65, 127, 128, 1000])
def test_native_sha256_matches_hashlib(n):
    msg = (bytes(range(256)) * (n // 256 + 1))[:n]
    assert native.sha256(msg) == hashlib.sha256(msg).digest()


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 33, 256])
def test_native_merkle_build_matches_oracles(n):
    from stark_tpu.merkle import merkle_root_host as j_root
    from stark_tpu_torch.merkle import MerkleTree

    vals = (np.arange(n, dtype=np.uint64) * 2654435761) % (1 << 32)
    digs = native.merkle_build_host(vals)
    assert digs[-1].hex() == j_root(vals.tolist())
    tree = MerkleTree(_t(vals))
    assert b"".join(digs) == tree.buffer.numpy().astype(">u4").tobytes()


def test_native_validate_agrees_with_the_tree():
    from stark_tpu_torch.merkle import MerkleTree

    vals = np.arange(1, 66, dtype=np.uint64)
    tree = MerkleTree(_t(vals))
    root = tree.root()
    for idx in [0, 17, 63, 64]:
        path = tree.get_authentication_path(idx)
        leaf = int(vals[idx]).to_bytes(8, "big")
        assert native.merkle_validate(root, path, idx, leaf, 65)
        assert MerkleTree.validate(root, path, idx, leaf, 65)
        assert not native.merkle_validate(root, path, idx,
                                          (999).to_bytes(8, "big"), 65)
        assert not native.merkle_validate(root, path[:-32], idx, leaf, 65)
    assert not native.merkle_validate("zz" * 32, b"", 0, b"\0" * 8, 1)
    assert not native.merkle_validate(root, b"", 65, b"\0" * 8, 65)


def test_native_channel_absorb_matches_hashlib():
    from stark_tpu_torch.channel.channel import Channel

    s, ch = "", Channel(P)
    for msg in [b"", b"\x00", b"abc", bytes(range(256))]:
        s_new = native.channel_absorb(s, msg)
        assert s_new == hashlib.sha256((s + msg.hex()).encode()).hexdigest()
        ch.send(msg)
        assert ch.state == s_new
        s = s_new


def test_native_host_trace_dispatches_by_kind():
    for kind, fn in (("fib", native.fib_trace), ("mimc", native.mimc_trace),
                     ("fibmul", native.fibmul_trace)):
        np.testing.assert_array_equal(native.host_trace(kind, P, 2, 3, 16),
                                      fn(P, 2, 3, 16))
    assert native.get_lib() is native.get_lib()
