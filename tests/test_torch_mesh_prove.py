"""The port's sharded prove (``prove(..., mesh=...)``) on CPU meshes of 1,
2 and 4 logical shards, byte for byte against the JAX package's proves
of the same statements: Fibonacci-square, MiMC³, FibMul,
Fibonacci-square over Goldilocks and the ``tribmul`` family, each
against the JAX single-device prove and the JAX mesh prove on as many
virtual devices (their transcript digests, ``tests/vectors/
mesh_digests.json``, which ``scripts/jax_mesh_digests.py`` makes with
the JAX package: a JAX prove costs ~15-25 s of XLA compile here, too
much to run one a case).  Then the per-phase mesh path (a
phase-accurate channel, the BatchGather loop), ``prove_resumable(mesh=)``
stopped after a phase and resumed on another mesh, and the CLI's
``prove --cpu --mesh 2``."""

import hashlib
import json
import os
import subprocess
import sys

import pytest

from stark_tpu_torch.channel.channel import Channel
from stark_tpu_torch.config import ProverConfig
from stark_tpu_torch.dist import make_mesh
from stark_tpu_torch.stark import (FibMulAIR, MimcAIR, ProverCheckpoint,
                                   StarkProof, prove, prove_resumable,
                                   verify)
from stark_tpu_torch.stark import prover as tprover
from stark_tpu_torch.stark.air import FibonacciSquareAIR
from stark_tpu_torch.stark.families import FAMILIES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GL = dict(modulus=2**64 - 2**32 + 1, generator=7)
KW = dict(log2_trace=4, blowup=4, num_queries=2)
STATEMENTS = {
    "fib-sq": ({}, lambda: FibonacciSquareAIR(a1=3141592)),
    "mimc3": ({}, lambda: MimcAIR(x0=271828, k=777)),
    "fibmul": ({}, lambda: FibMulAIR(a0=1, b0=2718281)),
    "fib-sq-GL": (GL, lambda: FibonacciSquareAIR(a1=3141592)),
    "tribmul": ({}, lambda: FAMILIES["tribmul"][0]()),
}


@pytest.fixture(scope="module")
def vectors():
    with open(os.path.join(ROOT, "tests", "vectors",
                           "mesh_digests.json")) as fh:
        vec = json.load(fh)
    assert vec["config"] == KW
    return vec["statements"]


def _digest(pr) -> str:
    return hashlib.sha256(b"".join(pr.proof)).hexdigest()


def _mesh(s):
    return make_mesh(devices=["cpu"] * s)


def _case(name):
    field, air = STATEMENTS[name]
    return ProverConfig(**KW, **field), air()


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_mesh_prove_equals_jax_proves(vectors, name, shards):
    cfg, air = _case(name)
    pr = prove(cfg, air=air, mesh=_mesh(shards))
    assert tprover.LAST_PROVE_PATH == "single-fetch-mesh"
    want = vectors[name]
    assert _digest(pr) == want["single"] == want["mesh"][str(shards)]
    assert pr.publics == want["publics"]
    assert verify(pr)


@pytest.mark.parametrize("name", ["fib-sq", "fib-sq-GL"])
def test_per_phase_mesh_paths(vectors, monkeypatch, name):
    """A phase-accurate channel keeps the mesh prove on the per-phase
    path (the sharded query form from the host state); the host-queries
    switch takes the BatchGather loop over the shards (Goldilocks: rows
    of limb planes)."""
    cfg, air = _case(name)
    if name == "fib-sq":
        ch = Channel(cfg.modulus)
        ch.phase_accurate = True
        pr = prove(cfg, air=air, mesh=_mesh(2), channel=ch)
        assert tprover.LAST_PROVE_PATH == "per-phase-mesh"
        assert _digest(pr) == vectors[name]["single"]
    monkeypatch.setenv("STARK_TPU_TORCH_HOST_QUERIES", "1")
    pr = prove(cfg, air=air, mesh=_mesh(2))
    assert tprover.LAST_PROVE_PATH == "per-phase-mesh"
    assert _digest(pr) == vectors[name]["single"]


def test_prove_resumable_on_a_mesh(vectors):
    """Stopped after the composition on 2 shards, serialized, resumed on
    4: the JAX transcript."""
    cfg, air = _case("fibmul")
    ckpt = prove_resumable(cfg, air=air, stop_after="composition",
                           mesh=_mesh(2))
    assert isinstance(ckpt, ProverCheckpoint) and ckpt.phase == "composition"
    resumed = prove_resumable(
        cfg, resume=ProverCheckpoint.deserialize(ckpt.serialize()),
        mesh=_mesh(4))
    assert tprover.LAST_PROVE_PATH == "per-phase-mesh"
    assert _digest(resumed) == vectors["fibmul"]["single"]


def test_mesh_must_start_on_the_prove_device():
    with pytest.raises(ValueError, match="first device"):
        prove(ProverConfig(**KW), device="cuda:1", mesh=_mesh(2))
    with pytest.raises(ValueError, match="power-of-two"):
        _mesh(3)


def test_cli_mesh_round_trip(vectors, tmp_path):
    """``prove --cpu --mesh 2`` writes the JAX transcript, which
    verifies."""
    res = subprocess.run(
        [sys.executable, "-m", "stark_tpu_torch", "prove", "--cpu", "--mesh",
         "2", "--log2-trace", "4", "--blowup", "4", "--num-queries", "2",
         "-o", "mesh.json"], cwd=tmp_path, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=ROOT), timeout=600)
    assert res.returncode == 0, res.stderr
    assert "2-shard mesh" in res.stderr
    pr = StarkProof.deserialize((tmp_path / "mesh.json").read_bytes())
    assert _digest(pr) == vectors["fib-sq"]["single"]
    assert verify(pr)
