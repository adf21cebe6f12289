"""Checkpoint / resume in the port (plain kernel versions on the CPU),
after tests/test_checkpoint.py's cases: stop at every phase boundary,
serialize, resume, and require the proof byte-identical (exact) to an
uninterrupted prove; a corrupted checkpoint, another config and another
witness are refused; every family class resumes (MiMC, FibMul, a
declarative spec, Goldilocks).  Across packages: the port's checkpoint
serializes to the JAX package's bytes, and a checkpoint written by
either package resumes in the other to the same proof bytes."""

import pytest

from stark_tpu.config import ProverConfig as JProverConfig
from stark_tpu.stark.checkpoint import ProverCheckpoint as JProverCheckpoint
from stark_tpu.stark.checkpoint import prove_resumable as jprove_resumable
from stark_tpu_torch.config import ProverConfig
from stark_tpu_torch.interop import checkpoint_from
from stark_tpu_torch.stark import (FibMulAIR, MimcAIR, ProverCheckpoint,
                                   StarkProof, prove, prove_resumable,
                                   verify)
from stark_tpu_torch.stark import prover as tprover
from stark_tpu_torch.stark.checkpoint import ResumeMismatch
from stark_tpu_torch.stark.families import MIMC5

KW = dict(log2_trace=5, blowup=4, num_queries=3)
CFG = ProverConfig(**KW)
GL = dict(modulus=2**64 - 2**32 + 1, generator=7)


@pytest.fixture(scope="module")
def full_proof():
    return prove(CFG, device="cpu")


@pytest.mark.parametrize("phase", ["trace-commit", "composition",
                                   "fri-commit"])
def test_crash_and_resume_is_byte_identical(phase, full_proof):
    ckpt = prove_resumable(CFG, stop_after=phase, device="cpu")
    assert isinstance(ckpt, ProverCheckpoint)
    assert ckpt.phase == phase
    assert 0 < len(ckpt.proof) < len(full_proof.proof)
    restored = ProverCheckpoint.deserialize(ckpt.serialize())
    resumed = prove_resumable(CFG, resume=restored, device="cpu")
    assert tprover.LAST_PROVE_PATH == "per-phase"
    assert resumed.proof == full_proof.proof
    assert verify(resumed)


def test_stop_after_queries_and_no_stop_equal_plain_prove(full_proof):
    """`queries` is the last phase: no boundary follows it, so the prove
    completes (as in the JAX package)."""
    for stop in ("queries", None):
        got = prove_resumable(CFG, stop_after=stop, device="cpu")
        assert isinstance(got, StarkProof)
        assert got.proof == full_proof.proof


def test_corrupted_checkpoint_detected():
    ckpt = prove_resumable(CFG, stop_after="fri-commit", device="cpu")
    for i in (0, 2, len(ckpt.proof) - 1):
        bad = ProverCheckpoint.deserialize(ckpt.serialize())
        m = bytearray(bad.proof[i])
        m[-1] ^= 1
        bad.proof[i] = bytes(m)
        with pytest.raises(ResumeMismatch):
            prove_resumable(CFG, resume=bad, device="cpu")


def test_checkpoint_config_and_witness_mismatch_rejected():
    ckpt = prove_resumable(CFG, stop_after="trace-commit", device="cpu")
    with pytest.raises(ValueError, match="config"):
        prove_resumable(ProverConfig(**dict(KW, num_queries=4)),
                        resume=ckpt, device="cpu")
    with pytest.raises(ValueError, match="statement/witness"):
        prove_resumable(CFG, a1=999, resume=ckpt, device="cpu")
    mimc = prove_resumable(CFG, air=MimcAIR(x0=1), stop_after="fri-commit",
                           device="cpu")
    with pytest.raises(ValueError, match="statement/witness"):
        prove_resumable(CFG, air=MimcAIR(x0=2), resume=mimc, device="cpu")
    with pytest.raises(ValueError, match="air="):
        prove_resumable(CFG, a1=5, resume=mimc, device="cpu")


@pytest.mark.parametrize("family", ["mimc", "fibmul", "spec", "goldilocks"])
def test_every_family_resumes(family):
    """One stop + resume per family class; resume omits air=, so the
    checkpoint rebuilds its own AIR."""
    cfg, air = {
        "mimc": (CFG, MimcAIR(x0=424242)),
        "fibmul": (CFG, FibMulAIR(b0=777777)),
        "spec": (ProverConfig(**dict(KW, blowup=8)), MIMC5(x0=161803)),
        "goldilocks": (ProverConfig(**KW, **GL), None),
    }[family]
    full = prove(cfg, air=air, device="cpu")
    ckpt = prove_resumable(cfg, air=air, stop_after="fri-commit",
                           device="cpu")
    restored = ProverCheckpoint.deserialize(ckpt.serialize())
    resumed = prove_resumable(cfg, resume=restored, device="cpu")
    assert resumed.proof == full.proof
    assert verify(resumed)


@pytest.fixture(scope="module")
def jax_checkpoint():
    return jprove_resumable(JProverConfig(**KW), stop_after="composition")


def test_checkpoints_serialize_to_the_jax_bytes(jax_checkpoint):
    port = prove_resumable(CFG, stop_after="composition", device="cpu")
    assert port.serialize() == jax_checkpoint.serialize()
    assert checkpoint_from(jax_checkpoint) == port


def test_checkpoints_resume_across_packages(jax_checkpoint, full_proof):
    """A JAX checkpoint resumes in the port, a port checkpoint in the JAX
    package: both give the proof of the uninterrupted prove, which is
    the JAX package's (tests/test_torch_prove.py)."""
    resumed = prove_resumable(CFG, resume=checkpoint_from(jax_checkpoint),
                              device="cpu")
    assert resumed.proof == full_proof.proof
    port = prove_resumable(CFG, stop_after="fri-commit", device="cpu")
    jresumed = jprove_resumable(
        JProverConfig(**KW),
        resume=JProverCheckpoint.deserialize(port.serialize()))
    assert jresumed.proof == full_proof.proof
