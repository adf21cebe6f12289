"""Whole Goldilocks proves (p = 2^64 - 2^32 + 1) through pruned Merkle
storage: as ``test_torch_pruned_prove.py`` for fib-sq-GL and FibMul-GL at
2^5 rows (64-bit leaves, two query slots a value, the recompute hashing
limb pairs), byte-identical to the JAX package's pruned and chunked
proves and to the port's unpruned prove."""

import pytest

import stark_tpu.merkle.tree as jmt
import stark_tpu_torch.merkle.tree as tmt
from stark_tpu.config import ProverConfig as JProverConfig
from stark_tpu.stark import prove as jprove
from stark_tpu.stark.air import FibMulAIR as JFibMulAIR
from stark_tpu_torch.config import ProverConfig
from stark_tpu_torch.stark import FibMulAIR, prove, verify
from stark_tpu_torch.stark import prover as tprover

CFG = dict(log2_trace=5, blowup=4, num_queries=3,
           modulus=2**64 - 2**32 + 1, generator=7)
STATEMENTS = {"fib-sq-GL": (lambda: None, lambda: None),
              "FibMul-GL": (lambda: FibMulAIR(a0=1, b0=2718281),
                            lambda: JFibMulAIR(a0=1, b0=2718281))}
# (keep-log, CHUNK_MIN_LOG), as in test_torch_pruned_prove.py
SETTINGS = {"full": (99, 27), "pruned": (3, 27), "chunked": (3, 6)}


@pytest.fixture(scope="module", params=sorted(STATEMENTS))
def proves(request):
    """{setting: (port proof, JAX proof or None, port plan)}."""
    air, jair = (make() for make in STATEMENTS[request.param])
    out = {}
    for name, (keep, chunk_min) in SETTINGS.items():
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tmt, "PRUNE_KEEP_LOG", keep)
            mp.setattr(tmt, "CHUNK_MIN_LOG", chunk_min)
            mp.setattr(tmt, "CHUNK_LOG", 5)
            mp.setattr(jmt, "PRUNE_KEEP_LOG", keep)
            mp.setattr(jmt, "_CHUNK_MIN_LOG", chunk_min)
            plan = tprover.query_plan(ProverConfig(**CFG), air)
            port = prove(ProverConfig(**CFG), air=air, device="cpu")
            ref = (jprove(JProverConfig(**CFG), air=jair)
                   if name != "full" else None)
        out[name] = (port, ref, plan)
    return out


@pytest.mark.parametrize("setting", ["pruned", "chunked"])
def test_pruned_prove_equals_jax(proves, setting):
    port, ref, plan = proves[setting]
    assert port.serialize() == ref.serialize()
    assert plan.elem_width == 2 and plan.trace_prune == 4


@pytest.mark.parametrize("setting", ["pruned", "chunked"])
def test_pruned_prove_equals_unpruned(proves, setting):
    port = proves[setting][0]
    assert port.proof == proves["full"][0].proof
    assert verify(port)
