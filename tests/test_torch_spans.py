"""The prove's spans (``stark_tpu_torch/utils/metrics.py``) on the CPU.

Under an explicit collector a prove records its phases as top-level
spans and the spans below them (``host-trace``, ``intt``, ``coset-ntt``;
each fold's ``fri-draw``, ``fold`` and ``layer-tree``; ``host-replay``)
with their parents and one prove identifier; under ``torch.profiler``
each is a ``span:<name>`` range with the same nesting; with neither, no
span below a phase records.  None of this changes the proof: each mode
gives the golden vector's bytes (the JAX package's).  ``GLOBAL``, the
collector of proves without one, stays bounded."""

import json
import os
import sys
import threading

import pytest
import torch

from stark_tpu_torch.config import ProverConfig
from stark_tpu_torch.stark import FibMulAIR, StarkProof, prove
from stark_tpu_torch.stark import prover as tprover
from stark_tpu_torch.utils import metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VEC = os.path.join(ROOT, "tests", "vectors", "golden_proofs.json")
GOLDEN = "fibmul_2e5"
CFG = ProverConfig(log2_trace=5, blowup=4, num_queries=3)
PHASES = ["trace-lde", "trace-commit", "composition", "fri-commit",
          "queries"]


def _prove(mx=None):
    return prove(CFG, air=FibMulAIR(a0=1, b0=2718281), device="cpu",
                 metrics=mx)


def _children(folds: int) -> dict:
    """Each phase's spans below it, in order, for a prove of `folds`
    folds."""
    return {"trace-lde": ["host-trace", "intt", "coset-ntt"],
            "trace-commit": [], "composition": [],
            "fri-commit": ["layer-tree"]
            + ["fri-draw", "fold", "layer-tree"] * folds,
            "queries": ["host-replay"]}


def _profiled_ranges(fn):
    """Run `fn` under a CPU torch.profiler: its result and the
    (name, start, end) of every range named ``span:`` or ``phase:``, in
    start order (read from the raw events: building the profile's
    FunctionEvents of a CPU prove's ~4e5 torch ops takes ~20 s)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith(("span:", "phase:"))]
    return out, sorted(ranges, key=lambda r: (r[1], -r[2]))


def _nesting(ranges) -> list:
    """(name, the name of the innermost range enclosing it or None) for
    each range, names without their ``span:`` prefix."""
    out = []
    for i, (name, s, e) in enumerate(ranges):
        parents = [r for r in ranges[:i] if r[1] <= s and e <= r[2]]
        parent = max(parents, key=lambda r: r[1])[0] if parents else None
        out.append((name.removeprefix("span:"),
                    parent and parent.removeprefix("span:")))
    return out


@pytest.fixture(scope="module")
def golden():
    with open(VEC) as fh:
        return StarkProof.deserialize(
            json.dumps(json.load(fh)[GOLDEN]).encode())


@pytest.fixture(scope="module")
def collected():
    """Two proves into one explicit collector."""
    mx = metrics.MetricsCollector()
    proofs = [_prove(mx), _prove(mx)]
    return mx, proofs


@pytest.fixture(scope="module")
def profiled():
    return _profiled_ranges(_prove)


@pytest.fixture(scope="module")
def plain():
    """A prove with neither a collector nor a profiler, with every span
    that opened past the no-op check."""
    opened = []
    real = metrics._open_span
    metrics._open_span = lambda scope, name: (opened.append(name),
                                              real(scope, name))[1]
    try:
        pr = _prove()
    finally:
        metrics._open_span = real
    return pr, opened, [p.name for p in metrics.GLOBAL.phases]


def test_collector_records_nested_spans(collected):
    mx, _ = collected
    assert [p.name for p in mx.phases] == PHASES * 2
    folds = mx.phases[3].extra["folds"]
    assert folds > 0
    proves = sorted({s.prove for s in mx.spans})
    assert len(proves) == 2
    for prove_id in proves:
        idx = [i for i, s in enumerate(mx.spans) if s.prove == prove_id]
        top = [i for i in idx if mx.spans[i].parent is None]
        assert [mx.spans[i].name for i in top] == PHASES
        for i in top:
            kids = [mx.spans[j] for j in idx if mx.spans[j].parent == i]
            assert [k.name for k in kids] == \
                _children(folds)[mx.spans[i].name]
        for i in idx:
            s = mx.spans[i]
            assert s.start_s <= s.end_s
            if s.parent is not None:
                up = mx.spans[s.parent]
                assert up.prove == prove_id
                assert up.start_s <= s.start_s and s.end_s <= up.end_s


def test_profiler_sees_span_ranges(profiled, collected):
    _, ranges = profiled
    mx, _ = collected
    folds = mx.phases[3].extra["folds"]
    assert not [r for r in ranges if r[0].startswith("phase:")]
    nest = _nesting(ranges)
    assert [n for n, up in nest if up is None] == PHASES
    for phase, kids in _children(folds).items():
        assert [n for n, up in nest if up == phase] == kids
    assert len(nest) == len(mx.spans) // 2


def test_mega_prove_replay_span(monkeypatch):
    """The mega path's host replay is a span under its ``fetch-replay``
    phase (the mega path never runs under an explicit collector)."""
    monkeypatch.setenv("STARK_TPU_TORCH_FORCE_MEGA", "1")
    cfg = ProverConfig(log2_trace=3, blowup=4, num_queries=2)
    _, ranges = _profiled_ranges(lambda: prove(cfg, device="cpu"))
    assert tprover.LAST_PROVE_PATH == "mega"
    nest = _nesting(ranges)
    assert [n for n, up in nest if up is None] == [
        "trace-lde", "prove-device", "fetch-replay"]
    assert ("host-replay", "fetch-replay") in nest


def test_no_span_without_collector_or_profiler(plain):
    _, opened, global_phases = plain
    assert opened == []
    # the phases went to GLOBAL, which keeps no spans
    assert global_phases == PHASES
    assert metrics.GLOBAL.spans == []
    assert metrics.span("fold") is metrics.span("intt")


@pytest.mark.parametrize("mode", ["collected", "profiled", "plain"])
def test_proof_bytes_unchanged(mode, request, golden):
    got = request.getfixturevalue(mode)
    pr = got[1][0] if mode == "collected" else got[0]
    assert pr.proof == golden.proof
    assert pr.a_last == golden.a_last


def test_global_keeps_one_prove_and_totals():
    """50 proves' phases through a bounded collector: its phases are the
    last prove's, its totals count every prove."""
    assert isinstance(metrics.GLOBAL, metrics.PhaseTotals)
    c = metrics.PhaseTotals()
    for _ in range(50):
        c.begin_prove()
        for name in PHASES:
            with c.phase(name):
                pass
    assert [p.name for p in c.phases] == PHASES
    assert {n: t["count"] for n, t in c.totals.items()} == dict.fromkeys(
        PHASES, 50)
    assert all(t["max_s"] <= t["total_s"] for t in c.totals.values())
    d = c.to_dict()
    assert [p["name"] for p in d["phases"]] == PHASES
    assert d["totals"]["queries"]["count"] == 50
    assert c.spans == []


def test_global_totals_under_threads():
    """Threads adding phases to one bounded collector, more threads than
    cores and a short switch interval: no count is lost."""
    c = metrics.PhaseTotals()
    threads, each = 2 * (os.cpu_count() or 4), 300

    def work():
        for _ in range(each):
            with c.phase("fold"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert c.totals["fold"]["count"] == threads * each


def test_threads_keep_their_own_spans():
    """A thread's spans record into its own prove's collector only: a
    span opened at the same time in another thread, outside any prove,
    records nowhere."""
    mx = metrics.MetricsCollector()
    inside, outside = threading.Barrier(2), threading.Barrier(2)

    def prover():
        with metrics.proving(mx), metrics.span("fold"):
            inside.wait(timeout=30)
            outside.wait(timeout=30)

    def other():
        inside.wait(timeout=30)
        with metrics.span("intt"):
            outside.wait(timeout=30)

    ts = [threading.Thread(target=prover), threading.Thread(target=other)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert [s.name for s in mx.spans] == ["fold"]
    assert mx.spans[0].parent is None
