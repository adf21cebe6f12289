"""The port's MiMC³ and two-column FibMul statements (stark_tpu_torch
stark/air.py, the prove on CPU tensors through the kernels' plain
versions) against the JAX package: compositions, verifier values,
publics, golden vectors and whole transcripts, exact equality; each
package's verifier on the other's proofs."""

import json
import os

import numpy as np
import pytest

import jax.numpy as jnp

from stark_tpu.config import ProverConfig as JProverConfig
from stark_tpu.stark import StarkProof as JStarkProof
from stark_tpu.stark import prove as jprove
from stark_tpu.stark import verify as jverify
from stark_tpu.stark.air import FibMulAIR as JFibMulAIR
from stark_tpu.stark.air import FibonacciSquareAIR as JFibonacciSquareAIR
from stark_tpu.stark.air import MimcAIR as JMimcAIR
from stark_tpu_torch.config import ProverConfig
from stark_tpu_torch.interop import air_from, tensor_to_u32, u32_to_tensor
from stark_tpu_torch.stark import (FibMulAIR, MimcAIR, StarkProof,
                                   StarkVerificationError, prove, verify)
from stark_tpu_torch.stark import prover as tprover
from stark_tpu_torch.stark.air import air_from_name

P = 3 * 2**30 + 1
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VEC = os.path.join(ROOT, "tests", "vectors", "golden_proofs.json")
GOLDEN_CFG = dict(log2_trace=5, blowup=4, num_queries=3)
# the AIRs of the two golden vectors, in both packages
GOLDEN = {"mimc3_2e5": (MimcAIR(x0=271828, k=777),
                        JMimcAIR(x0=271828, k=777)),
          "fibmul_2e5": (FibMulAIR(a0=1, b0=2718281),
                         JFibMulAIR(a0=1, b0=2718281)),
          "fibmul_gl_2e5": (FibMulAIR(a0=1, b0=2718281),
                            JFibMulAIR(a0=1, b0=2718281))}
# the golden vectors over another field than the default one
GOLDEN_FIELD = {"fibmul_gl_2e5": dict(modulus=2**64 - 2**32 + 1,
                                      generator=7)}
VERIFIED = sorted(GOLDEN)
# 2^11 rows, blowup 8 (LDE 2^14): one AIR of each family, other witnesses
CFG_2E11 = dict(log2_trace=11, blowup=8, num_queries=8)
AIRS_2E11 = {"mimc3": (MimcAIR(x0=12345, k=99), JMimcAIR(x0=12345, k=99)),
             "fibmul": (FibMulAIR(a0=3, b0=7), JFibMulAIR(a0=3, b0=7))}


@pytest.fixture(scope="module")
def vectors():
    with open(VEC) as fh:
        return json.load(fh)


def _blob(vectors, name) -> bytes:
    return json.dumps(vectors[name]).encode()


@pytest.fixture(scope="module", params=sorted(AIRS_2E11))
def proofs_2e11(request):
    """(port proof, JAX proof) of the same 2^11-row statement."""
    air, jair = AIRS_2E11[request.param]
    port = prove(ProverConfig(**CFG_2E11), air=air, device="cpu")
    ref = jprove(JProverConfig(**CFG_2E11), air=jair)
    return port, ref


def _tampered(pr: StarkProof, k: int) -> StarkProof:
    bad = StarkProof.deserialize(pr.serialize())
    msg = bytearray(bad.proof[k])
    msg[-1] ^= 1
    bad.proof[k] = bytes(msg)
    return bad


@pytest.mark.parametrize("name", VERIFIED)
def test_publics_follow_the_jax_rule(vectors, name):
    """a0 / a_last carry the first two publics; the names are input /
    output for every AIR but Fibonacci-square, the rest extra_publics."""
    port = StarkProof.deserialize(_blob(vectors, name))
    ref = JStarkProof.deserialize(_blob(vectors, name))
    assert port.publics == ref.publics
    assert set(port.publics) >= {"input", "output"}
    assert "a0" not in port.publics


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_vectors_byte_identical(vectors, name):
    pr = prove(ProverConfig(**GOLDEN_CFG, **GOLDEN_FIELD.get(name, {})),
               air=GOLDEN[name][0], device="cpu")
    assert tprover.LAST_PROVE_PATH == "single-fetch"
    assert pr.serialize() == StarkProof.deserialize(
        _blob(vectors, name)).serialize()


@pytest.mark.parametrize("name", VERIFIED)
def test_port_verifier_on_golden_proofs(vectors, name):
    pr = StarkProof.deserialize(_blob(vectors, name))
    assert verify(pr)
    for k in (1, len(pr.proof) // 3, len(pr.proof) // 2):
        with pytest.raises(StarkVerificationError):
            verify(_tampered(pr, k))
    with pytest.raises(StarkVerificationError, match="publics"):
        verify(pr, expected_publics={**pr.publics, "output": 0})


def test_prove_2e11_equals_jax(proofs_2e11):
    port, ref = proofs_2e11
    assert port.proof == ref.proof
    assert port.publics == ref.publics
    assert port.serialize() == ref.serialize()


def test_jax_verifier_accepts_port_proof(proofs_2e11):
    port, _ = proofs_2e11
    assert jverify(JStarkProof.deserialize(port.serialize()))
    with pytest.raises(Exception):
        jverify(JStarkProof.deserialize(
            _tampered(port, len(port.proof) // 2).serialize()))


def test_port_verifier_accepts_jax_proof(proofs_2e11):
    _, ref = proofs_2e11
    pr = StarkProof.deserialize(ref.serialize())
    assert verify(pr, expected_config=ProverConfig(**CFG_2E11))
    with pytest.raises(StarkVerificationError):
        verify(_tampered(pr, len(pr.proof) // 2))


def _seeded(shape, seed):
    rs = np.random.RandomState(seed)
    return rs.randint(0, P, size=shape, dtype=np.int64).astype(np.uint32)


@pytest.mark.parametrize("family", sorted(AIRS_2E11))
@pytest.mark.parametrize("log2_trace,blowup", [(5, 4), (6, 8)])
def test_compose_matches_jax(family, log2_trace, blowup):
    """The composition on a seeded LDE (C, M) with seeded alphas and
    publics, against the JAX context's composer."""
    air, jair = AIRS_2E11[family]
    cfg = ProverConfig(log2_trace=log2_trace, blowup=blowup)
    jcfg = JProverConfig(log2_trace=log2_trace, blowup=blowup)
    c, M = air.num_columns, cfg.eval_domain_size
    lde = _seeded((c, M) if c > 1 else (M,), 10 + log2_trace)
    alphas = [int(a) for a in _seeded(air.num_alphas, 20 + blowup)]
    pubs = dict(zip(("input", "output"), (int(v) for v in _seeded(2, 30))))
    pubs.update({"k": air.k} if family == "mimc3" else {"b0": 4242})
    ctx = tprover.get_air_context(air, cfg, "cpu")
    got = ctx.compose(u32_to_tensor(lde, device="cpu"), alphas, pubs)
    want = np.asarray(jair.context(jcfg).compose(jnp.asarray(lde), alphas,
                                                 pubs))
    np.testing.assert_array_equal(tensor_to_u32(got), want)


@pytest.mark.parametrize("family", sorted(AIRS_2E11))
def test_cp_at_matches_jax(family):
    air, jair = AIRS_2E11[family]
    cfg = ProverConfig(log2_trace=6, blowup=4)
    jctx = jair.context(JProverConfig(log2_trace=6, blowup=4))
    rs = np.random.RandomState(40)
    pubs = {"input": 5, "output": 77,
            **({"k": air.k} if family == "mimc3" else {"b0": 13})}
    for _ in range(5):
        x, *v = (int(t) for t in rs.randint(0, P, size=5, dtype=np.int64))
        opened = (v[:2] if family == "mimc3"
                  else [tuple(v[:2]), tuple(v[2:])])
        alphas = [int(a) for a in rs.randint(0, P, size=air.num_alphas,
                                             dtype=np.int64)]
        assert (air.cp_at(cfg, x, opened, alphas, pubs)
                == jctx.cp_at(x, opened, alphas, pubs))


def test_air_shapes_and_validation():
    cfg = ProverConfig(log2_trace=6, blowup=4)
    assert MimcAIR().num_folds(cfg) == 7 and FibMulAIR().num_folds(cfg) == 6
    assert (MimcAIR.num_columns, FibMulAIR.num_columns) == (1, 2)
    with pytest.raises(ValueError, match="blowup >= 4"):
        prove(ProverConfig(log2_trace=5, blowup=2), air=MimcAIR(),
              device="cpu")
    # one query plan per (configuration, offsets, folds, columns)
    plans = {tprover.query_plan(cfg, a) for a in (None, MimcAIR(),
                                                  FibMulAIR())}
    assert len(plans) == 3
    assert tprover.query_plan(cfg, FibMulAIR(b0=5)).num_columns == 2


@pytest.mark.parametrize("jair", [JFibonacciSquareAIR(a1=11, a0=2),
                                  JMimcAIR(x0=5, k=9),
                                  JFibMulAIR(a0=4, b0=6)])
def test_air_from_carries_the_statement(jair):
    air = air_from(jair)
    assert air.name == jair.name
    assert air.witness_params() == jair.witness_params()


def test_air_from_name_reads_the_publics():
    m = air_from_name("mimc3", {"input": 8, "output": 1, "k": 3})
    assert (m.x0, m.k) == (8, 3)
    f = air_from_name("fibmul", {"input": 2, "output": 1, "b0": 9})
    assert (f.a0, f.b0) == (2, 9)
    with pytest.raises(ValueError, match="unknown AIR"):
        air_from_name("no-such-air", {})


def test_airspec_families_wait_for_item_11():
    """The declarative families are ported (ROADMAP item 11): the port
    ships the JAX package's families, and a JAX family spec maps to the
    port's spec of the same statement."""
    from stark_tpu.stark.families import FAMILIES

    from stark_tpu_torch.stark.families import FAMILIES as PORT_FAMILIES

    assert set(PORT_FAMILIES) == set(FAMILIES)
    spec = FAMILIES["tribmul"][0]
    air = air_from(spec)
    assert (air.name, air.num_columns) == ("tribmul", 3)
    assert air.witness_params() == spec.witness_params()
