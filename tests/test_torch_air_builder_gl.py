"""The declarative families over the Goldilocks field (p = 2^64 - 2^32 + 1,
limb planes): each family's proof equals the JAX package's prove byte
for byte (one JAX prove a family, a module-scoped fixture; a separate
file from the u32 families so that the test workers share the JAX
compile time), each package's verifier accepts the other's proof, and a
tampered proof is rejected.  A custom periodic spec checks the
composer's tiled limb-plane column against a host recurrence."""

import copy

import pytest

from stark_tpu.config import ProverConfig as JProverConfig
from stark_tpu.stark import StarkProof as JStarkProof
from stark_tpu.stark import prove as jprove
from stark_tpu.stark import verify as jverify
from stark_tpu.stark.families import FAMILIES as JFAMILIES
from stark_tpu_torch.config import ProverConfig
from stark_tpu_torch.stark import (AirSpec, Boundary, StarkProof,
                                   StarkVerificationError, prove, verify)
from stark_tpu_torch.stark.families import FAMILIES

P = 2**64 - 2**32 + 1
FIELD = dict(modulus=P, generator=7)
BLOWUP = {"tribmul": 4, "mimc5": 8, "mimc5rc": 8}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """(port proof, JAX proof) of the family's statement, witness 271828."""
    name = request.param
    kw = dict(log2_trace=5, blowup=BLOWUP[name], num_queries=3, **FIELD)
    secret = {FAMILIES[name][1]: 271828}
    port = prove(ProverConfig(**kw), air=FAMILIES[name][0](**secret),
                 device="cpu")
    ref = jprove(JProverConfig(**kw), air=JFAMILIES[name][0](**secret))
    return port, ref


def test_family_proof_equals_jax(family):
    port, ref = family
    assert port.serialize() == ref.serialize()
    assert port.serialize(compress=True) == ref.serialize(compress=True)


def test_family_proofs_verify_across_packages(family):
    port, ref = family
    assert verify(StarkProof.deserialize(ref.serialize(compress=True)))
    assert jverify(JStarkProof.deserialize(port.serialize(compress=True)))


def test_family_tamper_rejected(family):
    port, _ = family
    for i in (0, 2, len(port.proof) - 1):
        bad = copy.deepcopy(port)
        msg = bytearray(bad.proof[i])
        msg[0] ^= 1
        bad.proof[i] = bytes(msg)
        with pytest.raises(StarkVerificationError):
            verify(bad)


def test_goldilocks_periodic_spec():
    """A 64-bit round-constant schedule (values above 2^63): the proof
    verifies and its output equals the host recurrence."""
    rc = (11, 2**63 + 5, 3, 2**40)
    spec = AirSpec(
        name="mimc5rc-goldi", columns=1, init=((("x0", 987654321),),),
        step=lambda f, rows, P: (
            (lambda t: f.mul(f.mul(f.mul(f.mul(t, t), t), t), t))(
                f.add(rows[0][0], P["rc"])),
        ),
        boundaries=(Boundary(0, 0, "input"), Boundary(0, -1, "output")),
        periodic={"rc": rc}, register=False)
    cfg = ProverConfig(log2_trace=5, blowup=8, num_queries=4, **FIELD)
    proof = prove(cfg, air=spec(), device="cpu")
    assert verify(proof, air=spec)
    x = 987654321
    for t in range(cfg.trace_length - 1):
        x = pow((x + rc[t % 4]) % P, 5, P)
    assert proof.publics["output"] == x
