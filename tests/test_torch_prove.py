"""The port's whole prove (stark_tpu_torch.stark.prove, plain kernel
versions on the CPU) against the golden vectors and the JAX package's
prove, byte for byte; the port's verifier against both packages' proofs."""

import importlib
import inspect
import json
import os
import subprocess
import sys

import pytest
import torch

from stark_tpu.config import ProverConfig as JProverConfig
from stark_tpu.stark import StarkProof as JStarkProof
from stark_tpu.stark import prove as jprove
from stark_tpu.stark import verify as jverify
from stark_tpu_torch.channel.compress import CompressionError
from stark_tpu_torch.config import ProverConfig
from stark_tpu_torch.interop import config_fields, config_from
from stark_tpu_torch.ntt import cuda_ntt
from stark_tpu_torch.stark import (FibMulAIR, StarkProof,
                                   StarkVerificationError, prove, verify)
from stark_tpu_torch.stark import prover as tprover

# the module (the package exports the function ntt under its name, as
# the JAX package's does)
tn = importlib.import_module("stark_tpu_torch.ntt.ntt")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VEC = os.path.join(ROOT, "tests", "vectors", "golden_proofs.json")

GOLDEN = {
    "fib_gf97_2e2": (dict(modulus=97, generator=5, log2_trace=2, blowup=4,
                          num_queries=2), 3),
    "fib_stark101_2e6": (dict(log2_trace=6, blowup=8, num_queries=4),
                         3141592),
}
# M = 2^14: the JAX package's LDE takes its four-step plan at this size
CFG_2E11 = dict(log2_trace=11, blowup=8, num_queries=8)


@pytest.fixture(scope="module")
def vectors():
    with open(VEC) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def proofs_2e11():
    """(port proof, JAX proof) of the same 2^11-row statement."""
    port = prove(ProverConfig(**CFG_2E11), device="cpu")
    ref = jprove(JProverConfig(**CFG_2E11))
    return port, ref


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_vectors_byte_identical(vectors, name):
    kw, a1 = GOLDEN[name]
    pr = prove(ProverConfig(**kw), a1=a1, device="cpu")
    assert tprover.LAST_PROVE_PATH == "single-fetch"
    stored = StarkProof.deserialize(json.dumps(vectors[name]).encode())
    assert pr.proof == stored.proof
    assert (pr.a0, pr.a_last) == (stored.a0, stored.a_last)


def test_prove_2e11_equals_jax(proofs_2e11):
    port, ref = proofs_2e11
    assert port.proof == ref.proof
    assert port.publics == ref.publics
    assert port.serialize() == ref.serialize()


def test_prove_2e11_through_k2_route_equals_jax(proofs_2e11, monkeypatch):
    """With the K2 route forced above 2^9 and a 2^7-word block budget, the
    trace INTT (2^11) and the LDE (2^14, one column a pass-1 group) take
    the K2 route through the kernels' plain version, and the transcript
    still equals the JAX prove's."""
    _, ref = proofs_2e11
    monkeypatch.setattr(cuda_ntt, "MAX_LOG_N", 9)
    monkeypatch.setattr(cuda_ntt, "BLOCK_LOG", 7)
    sizes = []

    def k2(x, p, inverse):
        sizes.append((int(x.shape[0]), inverse))
        return cuda_ntt.ntt_k2(x, p, inverse)

    monkeypatch.setattr(tn, "ntt_k2", k2)
    port = prove(ProverConfig(**CFG_2E11), device="cpu")
    assert sizes == [(1 << 11, True), (1 << 14, False)]
    assert port.serialize() == ref.serialize()


def test_jax_verifier_accepts_port_proof(proofs_2e11):
    port, _ = proofs_2e11
    assert jverify(JStarkProof.deserialize(port.serialize()))


def test_port_verifier_accepts_jax_proof(proofs_2e11):
    _, ref = proofs_2e11
    pr = StarkProof.deserialize(ref.serialize())
    assert verify(pr, expected_config=ProverConfig(**CFG_2E11))


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_port_verifier_on_golden_proofs(vectors, name):
    blob = json.dumps(vectors[name]).encode()
    assert verify(StarkProof.deserialize(blob))
    bad = StarkProof.deserialize(blob)
    k = len(bad.proof) // 2
    msg = bytearray(bad.proof[k])
    msg[-1] ^= 1
    bad.proof[k] = bytes(msg)
    with pytest.raises(StarkVerificationError):
        verify(bad)
    pinned = StarkProof.deserialize(blob)
    with pytest.raises(StarkVerificationError, match="publics"):
        verify(pinned, expected_publics={"a0": 1, "a_last": 0})


def test_serialize_round_trip_and_config_interop(vectors):
    blob = json.dumps(vectors["fib_stark101_2e6"]).encode()
    pr = StarkProof.deserialize(blob)
    assert StarkProof.deserialize(pr.serialize()) == pr
    jcfg = JProverConfig(**GOLDEN["fib_stark101_2e6"][0])
    assert config_from(jcfg) == pr.config
    assert JProverConfig(**config_fields(pr.config)) == jcfg


def test_unported_paths_raise():
    # the config's mesh_shape is not read (as in the JAX package): a
    # sharded prove takes a mesh, and gives the same transcript
    from stark_tpu_torch.dist import make_mesh

    cfg = ProverConfig(log2_trace=4, mesh_shape=(2,))
    single = prove(cfg, device="cpu")
    assert tprover.LAST_PROVE_PATH == "single-fetch"
    assert prove(cfg, mesh=make_mesh(devices=["cpu"] * 2)).proof == (
        single.proof)
    assert tprover.LAST_PROVE_PATH == "single-fetch-mesh"
    # above 2^32 only the Goldilocks prime has a path (as in JAX): the
    # 2-adic prime 18 * 2^32 + 1 is refused
    with pytest.raises(ValueError, match="Goldilocks"):
        prove(ProverConfig(modulus=18 * 2**32 + 1, generator=7,
                           log2_trace=4), device="cpu")
    # the compressed container and the AirSpec families are ported: a
    # malformed container and an empty family proof are rejected, not
    # refused as unported
    header = b'{"config": {}}'
    with pytest.raises(CompressionError, match="bad magic"):
        StarkProof.deserialize(b"STP1" + bytes([len(header)]) + header
                               + b"TC0")
    tribmul = StarkProof(proof=[], a0=1, a_last=2, air_name="tribmul",
                         config=ProverConfig(log2_trace=5, blowup=4))
    with pytest.raises(StarkVerificationError):
        verify(tribmul)


def test_prove_runs_on_the_card_by_default():
    """prove(cfg) without a device targets CUDA; the CPU runs only when
    the caller asks for it.  (The default is None: the card, or a mesh's
    first device when a mesh is given.)"""
    assert inspect.signature(prove).parameters["device"].default is None
    if not torch.cuda.is_available():
        # here the default reaches the trace upload and fails there
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            prove(ProverConfig(log2_trace=4, blowup=4, num_queries=2))


def test_port_imports_no_jax():
    """Importing every module of the port leaves jax and stark_tpu out of
    sys.modules (the card's machine has no JAX)."""
    code = (
        "import sys, pkgutil, importlib, stark_tpu_torch\n"
        "for m in pkgutil.walk_packages(stark_tpu_torch.__path__,"
        " 'stark_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in"
        " ('jax', 'jaxlib', 'stark_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
