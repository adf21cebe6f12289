"""Whole Goldilocks proves (p = 2^64 - 2^32 + 1): the port's prove on CPU
tensors (the kernels' plain versions, the torch-op NTT) against the JAX
package's prove byte for byte, each package's verifier on the other's
proof, and the compositions against the JAX contexts.  The FibMul
statement is held by the golden vector fibmul_gl_2e5
(tests/test_torch_air.py); here the Fibonacci-square and MiMC³ ones, at
2^5 rows, one JAX prove each (a module-scoped fixture)."""

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
from stark_tpu_torch.fields.fp import host_words
from stark_tpu_torch.interop import limbs_to_tensor, tensor_to_limbs
from stark_tpu_torch.stark import (FibMulAIR, FibonacciSquareAIR, MimcAIR,
                                   StarkProof, StarkVerificationError, prove,
                                   verify)
from stark_tpu_torch.stark import prover as tprover

P = 2**64 - 2**32 + 1
FIELD = dict(modulus=P, generator=7)
CFG = dict(log2_trace=5, blowup=4, num_queries=3, **FIELD)
AIRS = {"fib-sq-GL": (FibonacciSquareAIR(a1=3141592),
                      JFibonacciSquareAIR(a1=3141592)),
        "mimc3-GL": (MimcAIR(x0=271828, k=777), JMimcAIR(x0=271828, k=777))}


@pytest.fixture(scope="module", params=sorted(AIRS))
def proofs(request):
    """(port proof, JAX proof) of the same 2^5-row Goldilocks statement."""
    air, jair = AIRS[request.param]
    port = prove(ProverConfig(**CFG), air=air, device="cpu")
    ref = jprove(JProverConfig(**CFG), air=jair)
    return port, ref


def _tampered(blob: bytes, k: int) -> StarkProof:
    bad = StarkProof.deserialize(blob)
    msg = bytearray(bad.proof[k])
    msg[-1] ^= 1
    bad.proof[k] = bytes(msg)
    return bad


def test_prove_equals_jax(proofs):
    port, ref = proofs
    assert tprover.LAST_PROVE_PATH == "single-fetch"
    assert port.proof == ref.proof
    assert port.publics == ref.publics
    assert port.serialize() == ref.serialize()


def test_jax_verifier_accepts_port_proof(proofs):
    port, _ = proofs
    assert jverify(JStarkProof.deserialize(port.serialize()))
    with pytest.raises(Exception):
        jverify(JStarkProof.deserialize(
            _tampered(port.serialize(), len(port.proof) // 2).serialize()))


def test_port_verifier_accepts_jax_proof(proofs):
    _, ref = proofs
    blob = ref.serialize()
    assert verify(StarkProof.deserialize(blob),
                  expected_config=ProverConfig(**CFG))
    for k in (1, len(ref.proof) // 3, len(ref.proof) // 2):
        with pytest.raises(StarkVerificationError):
            verify(_tampered(blob, k))


def _seeded(n, seed):
    rs = np.random.RandomState(seed)
    hi = rs.randint(0, 2**32, size=n, dtype=np.uint64)
    lo = rs.randint(0, 2**32, size=n, dtype=np.uint64)
    return [int(v) % P for v in (hi << np.uint64(32)) | lo]


@pytest.mark.parametrize("family", ["fib-sq", "mimc3", "fibmul"])
def test_compose_matches_jax(family):
    """The composition on a seeded Goldilocks LDE ((2, M), or (2, 2, M)
    for FibMul's two columns), seeded alphas and publics, against the JAX
    context's composer: the context's domain, Fermat inverses and
    zerofier included."""
    air, jair = {"fib-sq": (FibonacciSquareAIR(), JFibonacciSquareAIR()),
                 "mimc3": (MimcAIR(k=99), JMimcAIR(k=99)),
                 "fibmul": (FibMulAIR(), JFibMulAIR())}[family]
    cfg = ProverConfig(log2_trace=5, blowup=4, **FIELD)
    jcfg = JProverConfig(log2_trace=5, blowup=4, **FIELD)
    c, M = air.num_columns, cfg.eval_domain_size
    vals = np.asarray(_seeded(c * M, 7), dtype=np.uint64)
    lde = host_words(vals.reshape(c, M) if c > 1 else vals, 2)
    alphas = _seeded(air.num_alphas, 8)
    names = (("a0", "a_last") if family == "fib-sq"
             else ("input", "output"))
    pubs = dict(zip(names, _seeded(2, 9)))
    pubs.update({"k": 99} if family == "mimc3" else
                {"b0": 4242} if family == "fibmul" else {})
    ctx = tprover.get_air_context(air, cfg, "cpu")
    got = ctx.compose(limbs_to_tensor(lde, device="cpu"), alphas, pubs)
    want = np.asarray(jair.context(jcfg).compose(jnp.asarray(lde), alphas,
                                                 pubs))
    np.testing.assert_array_equal(tensor_to_limbs(got), want)


def test_host_trace_and_publics_keep_64_bit_values():
    """The native trace in limb planes ((2, T), (2, 2, T) for FibMul) and
    publics read as whole 64-bit values."""
    cfg = ProverConfig(**CFG)
    t = cfg.trace_length
    fib = FibonacciSquareAIR(a1=3141592)
    trace = fib.host_trace(cfg)
    assert trace.shape == (2, t) and trace.dtype == np.uint32
    pubs = fib.publics_from_host(cfg, trace)
    assert pubs["a_last"] == (int(trace[0, -1]) << 32 | int(trace[1, -1]))
    assert pubs["a_last"] >= 2**32  # a value the u32 cast would truncate
    fm = FibMulAIR(a0=1, b0=2718281)
    trace = fm.host_trace(cfg)
    assert trace.shape == (2, 2, t)
    assert fm.publics_from_host(cfg, trace) == {
        "input": 1, "output": 4104638859923115312, "b0": 2718281}
    plan = tprover.query_plan(cfg, fm)
    assert (plan.elem_width, plan.num_columns) == (2, 2)
    assert plan is not tprover.query_plan(ProverConfig(log2_trace=5,
                                                       blowup=4,
                                                       num_queries=3), fm)
