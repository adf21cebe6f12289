"""The port's per-phase prove (a phase-accurate channel, or
STARK_TPU_TORCH_HOST_QUERIES / STARK_TPU_TORCH_PHASE_SYNC; plain kernel
versions on the CPU) against the JAX package's proves of the same
statements, byte for byte (exact, through SHA-256 of the transcript):
fib-sq, FibMul and FibMul over Goldilocks through their golden vectors
(``tests/vectors``, which the JAX package reproduces byte for byte,
tests/test_golden_vectors.py), and the tribmul family against the JAX
package's prove of the same statement at 2^5 rows.  A 7-column AirSpec,
which no single-fetch plan takes, goes down the per-phase path in both
packages and is refused there alike."""

import hashlib
import json
import os

import pytest

from stark_tpu.config import ProverConfig as JProverConfig
from stark_tpu.stark import prove as jprove
from stark_tpu.stark import prover as jprover
from stark_tpu.stark.air_builder import AirSpec as JAirSpec
from stark_tpu.stark.air_builder import Boundary as JBoundary
from stark_tpu.stark.families import FAMILIES as JFAMILIES
from stark_tpu_torch.channel.channel import Channel
from stark_tpu_torch.config import ProverConfig
from stark_tpu_torch.interop import air_from
from stark_tpu_torch.stark import FibMulAIR, StarkProof, prove, verify
from stark_tpu_torch.stark import prover as tprover
from stark_tpu_torch.stark.families import FAMILIES
from stark_tpu_torch.utils.metrics import MetricsCollector

VEC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vectors",
                   "golden_proofs.json")
# statement -> golden vector name, or None for tribmul
STATEMENTS = {"fib-sq": "fib_stark101_2e6", "fibmul": "fibmul_2e5",
              "fibmul-GL": "fibmul_gl_2e5", "tribmul": None}
TRIBMUL = dict(log2_trace=5, blowup=4, num_queries=3)


def _digest(proof) -> str:
    return hashlib.sha256(b"".join(proof.proof)).hexdigest()


class PhaseAccurate(Channel):
    phase_accurate = True


@pytest.fixture(scope="module", params=sorted(STATEMENTS))
def statement(request):
    """(port config, port AIR, the JAX package's transcript digest)."""
    golden = STATEMENTS[request.param]
    if golden is None:
        ref = jprove(JProverConfig(**TRIBMUL), air=JFAMILIES["tribmul"][0]())
        return (ProverConfig(**TRIBMUL), FAMILIES["tribmul"][0](),
                _digest(ref))
    with open(VEC) as fh:
        ref = StarkProof.deserialize(json.dumps(json.load(fh)[golden])
                                     .encode())
    air = (FibMulAIR(a0=ref.a0, b0=ref.extra_publics["b0"])
           if ref.air_name == "fibmul" else None)
    return ref.config, air, _digest(ref)


def test_phase_accurate_channel_equals_jax(statement):
    """A phase-accurate channel: the per-phase path with the device
    query plan; its phase marks where the JAX per-phase prove sets
    them."""
    cfg, air, ref = statement
    ch = PhaseAccurate(cfg.modulus)
    mx = MetricsCollector()
    got = prove(cfg, air=air, device="cpu", channel=ch, metrics=mx)
    assert tprover.LAST_PROVE_PATH == "per-phase"
    assert _digest(got) == ref
    assert [label for label, _ in ch.phases] == [
        "trace-commit", "composition", "fri-commit", "queries"]
    assert [ph.name for ph in mx.phases] == [
        "trace-lde", "trace-commit", "composition", "fri-commit", "queries"]
    assert verify(got)


def test_host_queries_equal_jax(statement, monkeypatch):
    """STARK_TPU_TORCH_HOST_QUERIES: the per-phase path with one
    BatchGather a query."""
    cfg, air, ref = statement
    monkeypatch.setenv("STARK_TPU_TORCH_HOST_QUERIES", "1")
    got = prove(cfg, air=air, device="cpu")
    assert tprover.LAST_PROVE_PATH == "per-phase"
    assert _digest(got) == ref


def test_phase_sync_and_trace_argument(monkeypatch):
    """STARK_TPU_TORCH_PHASE_SYNC takes the per-phase path too; a caller's
    trace (numpy words or a tensor) proves as the AIR's own; a plain
    channel with a prior message keeps the single-fetch path and
    continues from its state, as the per-phase path does."""
    from stark_tpu_torch.fields.fp import upload_u32
    from stark_tpu_torch.stark import FibonacciSquareAIR

    cfg = ProverConfig(**TRIBMUL)
    want = prove(cfg, device="cpu")
    monkeypatch.setenv("STARK_TPU_TORCH_PHASE_SYNC", "1")
    host = FibonacciSquareAIR().host_trace(cfg)
    got = prove(cfg, device="cpu", trace=host)
    assert tprover.LAST_PROVE_PATH == "per-phase"
    assert got.proof == want.proof and verify(got)
    assert prove(cfg, device="cpu",
                 trace=upload_u32(host, "cpu")).proof == want.proof
    monkeypatch.delenv("STARK_TPU_TORCH_PHASE_SYNC")
    chans = [Channel(cfg.modulus), PhaseAccurate(cfg.modulus)]
    for ch in chans:
        ch.send(b"an earlier message")
    a = prove(cfg, device="cpu", channel=chans[0])
    assert tprover.LAST_PROVE_PATH == "single-fetch"
    assert prove(cfg, device="cpu", channel=chans[1]).proof == a.proof


def _rot7(spec_cls, boundary_cls):
    c = 7
    return spec_cls(
        name="rot7", columns=c,
        init=(tuple((f"c{i}", i + 1) for i in range(c)),),
        step=lambda f, rows, P: tuple(
            rows[0][i + 1] for i in range(c - 1)) + (
            f.add(f.mul(rows[0][0], rows[0][1]), rows[0][c - 1]),),
        boundaries=(boundary_cls(column=0, row=0, public="input"),
                    boundary_cls(column=c - 1, row=-1, public="output")),
        register=False)


def test_seven_column_spec_takes_the_per_phase_path_as_jax():
    """No device query plan takes 7 columns, so both packages prove a
    7-column AirSpec on the per-phase path, where the row-leaf
    commitment (one SHA block: at most 6 values) refuses it with a
    ValueError in both (the JAX package's behaviour, kept)."""
    cfg_kw = dict(log2_trace=4, blowup=4, num_queries=2)
    with pytest.raises(ValueError, match="1..6"):
        jprove(JProverConfig(**cfg_kw),
               air=_rot7(JAirSpec, JBoundary)(c1=5))
    assert jprover.LAST_PROVE_PATH == "per-phase"
    air = air_from(_rot7(JAirSpec, JBoundary)(c1=5))
    with pytest.raises(ValueError, match="1..6"):
        prove(ProverConfig(**cfg_kw), air=air, device="cpu")
    assert tprover.LAST_PROVE_PATH == "per-phase"
