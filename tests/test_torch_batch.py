"""Batch proving in the port (``prove_batch``; plain kernel versions on
the CPU, each batched kernel proof by proof): every proof of a batch is
byte-identical (exact) to the sequential prove of its statement.  One
case against the JAX package's ``prove_batch`` itself (fib-sq, u32,
B = 3, 2^5 rows); MiMC, FibMul, tribmul and the Goldilocks fib-sq and
MiMC batches against the JAX package's sequential ``prove`` of each
statement (a module-scoped fixture a family), statement 0 being the one
a golden vector (``tests/vectors``, the JAX package's bytes),
tests/test_torch_air_builder.py or test_torch_prove_gl.py holds; the
JAX package's rejections (empty, mixed families, mixed keys, wide
multi-column)."""

import json
import os

import pytest

from stark_tpu.config import ProverConfig as JProverConfig
from stark_tpu.stark import FibMulAIR as JFibMul
from stark_tpu.stark import FibonacciSquareAIR as JFib
from stark_tpu.stark import MimcAIR as JMimc
from stark_tpu.stark import prove as jprove
from stark_tpu.stark import prove_batch as jprove_batch
from stark_tpu.stark.families import FAMILIES as JFAMILIES
from stark_tpu_torch.config import ProverConfig
from stark_tpu_torch.interop import airs_from
from stark_tpu_torch.stark import (FibMulAIR, FibonacciSquareAIR, MimcAIR,
                                   StarkProof, prove_batch, verify)

KW = dict(log2_trace=5, blowup=4, num_queries=3)
GL_KW = dict(KW, modulus=2**64 - 2**32 + 1, generator=7)
CFG = ProverConfig(**KW)
GL_CFG = ProverConfig(**GL_KW)
# family -> (config, the JAX package's statements of one batch)
BATCHES = {
    "mimc": (KW, [JMimc(x0=x, k=777) for x in (271828, 42)]),
    "fibmul": (KW, [JFibMul(a0=1, b0=b) for b in (2718281, 5)]),
    "tribmul": (KW, [JFAMILIES["tribmul"][0](b0=b) for b in (2, 9)]),
    "fib-sq-GL": (GL_KW, [JFib(a1=a) for a in (3141592, 4)]),
    "mimc-GL": (GL_KW, [JMimc(x0=x, k=777) for x in (271828, 2**40 + 5)]),
}
VEC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vectors",
                   "golden_proofs.json")


def _golden(name):
    with open(VEC) as fh:
        return StarkProof.deserialize(json.dumps(json.load(fh)[name])
                                      .encode())


def test_fib_batch_equals_jax_prove_batch():
    jairs = [JFib(a1=a) for a in (3141592, 7, 123456789)]
    want = jprove_batch(JProverConfig(**KW), jairs)
    got = prove_batch(CFG, airs_from(jairs), device="cpu")
    assert [g.serialize() for g in got] == [w.serialize() for w in want]
    assert all(verify(g) for g in got)


@pytest.mark.parametrize("family,golden", [("mimc", "mimc3_2e5"),
                                           ("fibmul", "fibmul_2e5")])
def test_batch_statement_zero_is_the_golden_vector(family, golden):
    ref = _golden(golden)
    if family == "mimc":
        airs = [MimcAIR(x0=x, k=777) for x in (ref.a0, 42)]
    else:
        airs = [FibMulAIR(a0=1, b0=b) for b in (ref.extra_publics["b0"], 5)]
    got = prove_batch(CFG, airs, device="cpu")
    assert got[0].proof == ref.proof
    assert all(verify(g) for g in got)


@pytest.fixture(scope="module", params=sorted(BATCHES))
def jax_sequential(request):
    """(config, the JAX statements, the JAX package's sequential proof of
    each)."""
    kw, jairs = BATCHES[request.param]
    return kw, jairs, [jprove(JProverConfig(**kw), air=a) for a in jairs]


def test_batch_equals_sequential_proves(jax_sequential):
    """Each proof of the port's batch equals the JAX package's sequential
    prove of its statement (the wide fold, the batched draws and, for
    FibMul and tribmul, the row-form tree batch)."""
    kw, jairs, want = jax_sequential
    got = prove_batch(ProverConfig(**kw), airs_from(jairs), device="cpu")
    assert [g.serialize() for g in got] == [w.serialize() for w in want]


def test_batch_rejections():
    assert prove_batch(CFG, [], device="cpu") == []
    with pytest.raises(ValueError, match="one family"):
        prove_batch(CFG, [FibonacciSquareAIR(), MimcAIR()], device="cpu")
    with pytest.raises(ValueError, match="one family"):
        prove_batch(CFG, [MimcAIR(k=1), MimcAIR(k=2)], device="cpu")
    with pytest.raises(ValueError, match="single-column"):
        prove_batch(GL_CFG, [FibMulAIR(), FibMulAIR(b0=3)], device="cpu")


def test_batch_and_resume_run_on_the_card_by_default():
    """prove_batch and prove_resumable without a device target CUDA; the
    CPU runs only when the caller asks for it."""
    import inspect

    import torch

    from stark_tpu_torch.stark import prove_resumable

    assert inspect.signature(prove_batch).parameters["device"].default == (
        "cuda")
    # None: the card, or the mesh's first device when a mesh is given
    assert inspect.signature(prove_resumable).parameters[
        "device"].default is None
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            prove_batch(CFG, [FibonacciSquareAIR()])
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            prove_resumable(CFG)
