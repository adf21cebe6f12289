"""Whole proves through pruned Merkle storage, u32 statements: the port's
prove on CPU tensors with ``PRUNE_KEEP_LOG`` = 3 (every tree of more than
2^3 leaves drops levels, and the query phase recomputes their siblings),
and again with every pruned tree built in chunks, byte-identical to the
JAX package's proves under the same settings and to the port's unpruned
prove.  Fibonacci-square, MiMC³, FibMul and tribmul at 2^5 rows (LDE
2^7: the trace tree prunes 4 levels, the FRI trees 4, 3, 2, 1, then
none), one JAX prove of each setting per statement (a module-scoped
fixture).  The
Goldilocks statements are in ``test_torch_pruned_prove_gl.py``, so the
two files' JAX compiles run on two workers."""

import pytest

import stark_tpu.merkle.tree as jmt
import stark_tpu_torch.merkle.tree as tmt
from stark_tpu.config import ProverConfig as JProverConfig
from stark_tpu.stark import prove as jprove
from stark_tpu.stark.air import FibMulAIR as JFibMulAIR
from stark_tpu.stark.air import MimcAIR as JMimcAIR
from stark_tpu.stark.families import FAMILIES as JFAMILIES
from stark_tpu_torch.config import ProverConfig
from stark_tpu_torch.stark import FibMulAIR, MimcAIR, prove, verify
from stark_tpu_torch.stark import prover as tprover
from stark_tpu_torch.stark.families import FAMILIES

CFG = dict(log2_trace=5, blowup=4, num_queries=3)
STATEMENTS = {
    "fib-sq": (lambda: None, lambda: None),
    "mimc3": (lambda: MimcAIR(x0=271828, k=777),
              lambda: JMimcAIR(x0=271828, k=777)),
    "fibmul": (lambda: FibMulAIR(a0=1, b0=2718281),
               lambda: JFibMulAIR(a0=1, b0=2718281)),
    "tribmul": (FAMILIES["tribmul"][0], JFAMILIES["tribmul"][0]),
}
# (keep-log, CHUNK_MIN_LOG): unpruned; pruned; pruned with every tree of
# 2^6 leaves or more chunked (the port in chunks of 2^5 leaves)
SETTINGS = {"full": (99, 27), "pruned": (3, 27), "chunked": (3, 6)}


def transcripts(cfg, air, jair):
    """{setting: (port proof, JAX proof or None, port plan)} of one
    statement; the JAX package proves the pruned and chunked settings."""
    out = {}
    for name, (keep, chunk_min) in SETTINGS.items():
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tmt, "PRUNE_KEEP_LOG", keep)
            mp.setattr(tmt, "CHUNK_MIN_LOG", chunk_min)
            mp.setattr(tmt, "CHUNK_LOG", 5)
            mp.setattr(jmt, "PRUNE_KEEP_LOG", keep)
            mp.setattr(jmt, "_CHUNK_MIN_LOG", chunk_min)
            plan = tprover.query_plan(ProverConfig(**cfg), air)
            port = prove(ProverConfig(**cfg), air=air, device="cpu")
            ref = (jprove(JProverConfig(**cfg), air=jair)
                   if name != "full" else None)
        out[name] = (port, ref, plan)
    return out


@pytest.fixture(scope="module", params=sorted(STATEMENTS))
def proves(request):
    air, jair = (make() for make in STATEMENTS[request.param])
    return transcripts(CFG, air, jair)


@pytest.mark.parametrize("setting", ["pruned", "chunked"])
def test_pruned_prove_equals_jax(proves, setting):
    port, ref, _ = proves[setting]
    assert port.serialize() == ref.serialize()


@pytest.mark.parametrize("setting", ["pruned", "chunked"])
def test_pruned_prove_equals_unpruned(proves, setting):
    port, _, plan = proves[setting]
    full, _, full_plan = proves["full"]
    assert port.proof == full.proof
    assert verify(port)
    # the settings reached the prove: its plan pruned every tree above
    # 2^3 leaves, the unpruned one none
    assert plan.trace_prune == 4
    assert plan.fri_prune == tuple(max(0, ln.bit_length() - 4)
                                   for ln in plan.fri_lengths)
    assert full_plan.trace_prune == 0 and not any(full_plan.fri_prune)


def test_query_plan_keys_on_prune_depths(monkeypatch):
    """The prover's plan cache (shared by the daemon's proves) gives a
    plan per prune depths: the keep-log and the switch that turns pruning
    off each select their own."""
    cfg = ProverConfig(log2_trace=6, blowup=4, num_queries=2)
    default = tprover.query_plan(cfg)
    assert default.trace_prune == 0
    monkeypatch.setattr(tmt, "PRUNE_KEEP_LOG", 4)
    pruned = tprover.query_plan(cfg)
    assert (pruned.trace_prune, pruned.fri_prune[:6]) == (
        4, (4, 3, 2, 1, 0, 0))
    assert tprover.query_plan(cfg) is pruned
    monkeypatch.setenv("STARK_TPU_TORCH_NO_PRUNE", "1")
    assert tprover.query_plan(cfg) is default
