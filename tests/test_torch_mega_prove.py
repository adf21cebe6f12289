"""The port's single-dispatch ("mega") prove (stark_tpu_torch.stark.prover
``_prove_mega``, the counterpart of the JAX package's): everything after
the LDE as one program over static buffers, which the card captures as
one CUDA graph and the CPU runs eagerly when STARK_TPU_TORCH_FORCE_MEGA
asks for it.  Its transcripts must be the golden vectors' (the JAX
package's bytes) and the single-fetch path's, two statements through one
cached program must each give their own proof, and the gate must answer
as the JAX package's ``_use_mega``.  The graph itself (capture, replay,
refill) is held on the card by the ``cuda``-marked tests of
``test_torch_kernels.py``."""

import json
import os

import pytest

from stark_tpu_torch.channel.channel import Channel
from stark_tpu_torch.config import ProverConfig
from stark_tpu_torch.stark import FibMulAIR, MimcAIR, StarkProof, prove
from stark_tpu_torch.stark import prover as tprover
from stark_tpu_torch.utils import metrics as tmetrics
from stark_tpu_torch.utils.metrics import MetricsCollector

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VEC = os.path.join(ROOT, "tests", "vectors", "golden_proofs.json")
_GL = dict(modulus=2**64 - 2**32 + 1, generator=7)
GOLDEN = {
    "fib_gf97_2e2": (dict(modulus=97, generator=5, log2_trace=2, blowup=4,
                          num_queries=2), dict(a1=3)),
    "fib_stark101_2e6": (dict(log2_trace=6, blowup=8, num_queries=4),
                         dict(a1=3141592)),
    "mimc3_2e5": (dict(log2_trace=5, blowup=4, num_queries=3),
                  dict(air=MimcAIR(x0=271828, k=777))),
    "fibmul_2e5": (dict(log2_trace=5, blowup=4, num_queries=3),
                   dict(air=FibMulAIR(a0=1, b0=2718281))),
    "fibmul_gl_2e5": (dict(log2_trace=5, blowup=4, num_queries=3, **_GL),
                      dict(air=FibMulAIR(a0=1, b0=2718281))),
}
# M = 32 points: the smallest fib-sq prove the size gate's 16 turns away
SMALL = dict(log2_trace=3, blowup=4, num_queries=2)
ENV = ("STARK_TPU_TORCH_FORCE_MEGA", "STARK_TPU_TORCH_NO_MEGA",
       "STARK_TPU_TORCH_MEGA_MAX", "STARK_TPU_TORCH_WIDE_MEGA")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def vectors():
    with open(VEC) as fh:
        return json.load(fh)


def _single(cfg, **kw):
    pr = prove(cfg, device="cpu", **kw)
    assert tprover.LAST_PROVE_PATH == "single-fetch"
    return pr


def _mega(cfg, monkeypatch, **kw):
    monkeypatch.setenv("STARK_TPU_TORCH_FORCE_MEGA", "1")
    try:
        pr = prove(cfg, device="cpu", **kw)
    finally:
        monkeypatch.delenv("STARK_TPU_TORCH_FORCE_MEGA")
    assert tprover.LAST_PROVE_PATH == "mega"
    return pr


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_vectors_through_mega(vectors, name, monkeypatch):
    """The golden vectors byte-identical through the mega path (Goldilocks
    with its opt-in set), and equal to the single-fetch proofs."""
    kw, args = GOLDEN[name]
    cfg = ProverConfig(**kw)
    if "modulus" in kw and kw["modulus"] == _GL["modulus"]:
        monkeypatch.setenv("STARK_TPU_TORCH_WIDE_MEGA", "1")
    got = _mega(cfg, monkeypatch, **args)
    want = StarkProof.deserialize(json.dumps(vectors[name]).encode())
    assert got.proof == want.proof
    assert got.publics == want.publics
    assert got.proof == _single(cfg, **args).proof


def test_two_statements_one_program(monkeypatch):
    """Two statements of one configuration share the AIR context, so the
    second prove runs the first's cached program: each proof must still
    be its own statement's (the publics are refilled, not baked in)."""
    cfg = ProverConfig(**SMALL)
    ctx = tprover.get_air_context(tprover.FibonacciSquareAIR(), cfg, "cpu")
    ctx.__dict__.pop("_mega_fns", None)
    eager = tprover.MEGA_STATS["eager"]
    proofs = {a1: _mega(cfg, monkeypatch, a1=a1) for a1 in (3, 5)}
    assert len(ctx._mega_fns) == 1
    assert tprover.MEGA_STATS["eager"] == eager + 2
    assert proofs[3].a_last != proofs[5].a_last
    for a1, pr in proofs.items():
        assert pr.proof == _single(cfg, a1=a1).proof


def test_continued_channel(monkeypatch):
    """A channel that has absorbed before the prove (`initial` false: its
    own program, over the refilled state) gives the single-fetch bytes."""
    cfg = ProverConfig(**SMALL)

    def channel():
        ch = Channel(cfg.modulus)
        ch.send(b"an earlier statement")
        return ch

    got = _mega(cfg, monkeypatch, channel=channel())
    assert got.proof == _single(cfg, channel=channel()).proof
    ctx = tprover.get_air_context(tprover.FibonacciSquareAIR(), cfg, "cpu")
    assert {key[1] for key in ctx._mega_fns} >= {False}


def test_log_template_is_the_jax_formula(monkeypatch):
    """The Fiat-Shamir log template, kinds in the JAX package's order
    (stark_tpu/stark/prover.py:491-493), is the log the region keeps."""
    alphas, folds = 3, 3
    jax_kinds = (["mark:trace-commit", "root"] + ["draw"] * alphas
                 + ["mark:composition", "mark:fri-commit", "root"]
                 + ["draw", "root"] * folds)
    assert tprover.mega_log_kinds(alphas, folds) == jax_kinds
    cfg = ProverConfig(**SMALL)
    _mega(cfg, monkeypatch)
    ctx = tprover.get_air_context(tprover.FibonacciSquareAIR(), cfg, "cpu")
    (prog,) = [p for key, p in ctx._mega_fns.items() if key[1]]
    assert prog.fs.kinds() == jax_kinds == prog.setup["log_kinds"]


class _OnCard:
    """Stands in for an LDE on a CUDA device (the gate reads is_cuda)."""

    is_cuda = True


class _OnCpu:
    is_cuda = False


# (environment, mesh, precise, values, width, the JAX gate's answer) at
# M = 2^13
GATE_CASES = {
    "card": ({}, None, False, _OnCard(), 1, True),
    "cpu": ({}, None, False, _OnCpu(), 1, False),
    "cpu forced": ({"FORCE_MEGA": "1"}, None, False, _OnCpu(), 1, True),
    "mesh": ({"FORCE_MEGA": "1"}, object(), False, _OnCard(), 1, False),
    "precise metrics": ({"FORCE_MEGA": "1"}, None, True, _OnCard(), 1,
                        False),
    "no mega": ({"NO_MEGA": "1", "FORCE_MEGA": "1"}, None, False, _OnCard(),
                1, False),
    "size": ({"MEGA_MAX": "16", "FORCE_MEGA": "1"}, None, False, _OnCard(),
             1, False),
    "size raised": ({"MEGA_MAX": str(1 << 22)}, None, False, _OnCard(), 1,
                    True),
    "wide": ({}, None, False, _OnCard(), 2, False),
    "wide opted in": ({"WIDE_MEGA": "1"}, None, False, _OnCard(), 2, True),
    "wide forced": ({"FORCE_MEGA": "1"}, None, False, _OnCpu(), 2, True),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_answers(case, monkeypatch):
    env, mesh, precise, values, width, want = GATE_CASES[case]
    for name, value in env.items():
        monkeypatch.setenv(f"STARK_TPU_TORCH_{name}", value)
    assert tprover._use_mega(1 << 13, mesh, precise, values, width) is want
    if "MEGA_MAX" not in env:  # the JAX default limit: 2^20 points
        assert tprover._use_mega(1 << 20, mesh, precise, values,
                                 width) is want
        assert tprover._use_mega((1 << 20) + 1, mesh, precise, values,
                                 width) is False


def test_gates_in_prove(monkeypatch):
    """prove() consults the gate in its single-fetch branch: the CPU stays
    single-fetch unless forced, and a forced prove still leaves the mega
    path for the size limit, precise metrics, NO_MEGA and a mesh."""
    from stark_tpu_torch.dist import make_mesh

    cfg = ProverConfig(**SMALL)
    want = _single(cfg).proof
    monkeypatch.setenv("STARK_TPU_TORCH_FORCE_MEGA", "1")
    monkeypatch.setenv("STARK_TPU_TORCH_MEGA_MAX", "16")
    assert _single(cfg).proof == want
    monkeypatch.delenv("STARK_TPU_TORCH_MEGA_MAX")
    assert _single(cfg, metrics=MetricsCollector()).proof == want
    monkeypatch.setenv("STARK_TPU_TORCH_NO_MEGA", "1")
    assert _single(cfg).proof == want
    monkeypatch.delenv("STARK_TPU_TORCH_NO_MEGA")
    pr = prove(cfg, mesh=make_mesh(devices=["cpu"] * 2))
    assert tprover.LAST_PROVE_PATH == "single-fetch-mesh"
    assert pr.proof == want


def test_phases_recorded(monkeypatch):
    """A mega prove records its two phases in utils.metrics.GLOBAL (no
    collector passed: a precise one turns mega off)."""
    _mega(ProverConfig(**SMALL), monkeypatch)
    names = [ph.name for ph in tmetrics.GLOBAL.phases]
    assert names == ["trace-lde", "prove-device", "fetch-replay"]


def test_threads_share_one_program(monkeypatch):
    """Threads proving three statements in turn through one cached
    program (more threads than cores, up to 12, and a short switch
    interval): the program's lock keeps each proof its own
    statement's."""
    import sys
    import threading

    cfg = ProverConfig(**GOLDEN["fib_gf97_2e2"][0])
    want = {a1: _single(cfg, a1=a1).proof for a1 in (3, 4, 5)}
    count = min(len(os.sched_getaffinity(0)) + 1, 12)
    a1s = [3 + k % 3 for k in range(count)]
    monkeypatch.setenv("STARK_TPU_TORCH_FORCE_MEGA", "1")
    got = [None] * count

    def work(k):
        got[k] = prove(cfg, a1=a1s[k], device="cpu").proof

    threads = [threading.Thread(target=work, args=(k,))
               for k in range(count)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert got == [want[a1] for a1 in a1s]
