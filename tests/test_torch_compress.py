"""The port's proof container (stark_tpu_torch/channel/compress.py and
StarkProof.serialize(compress=True)) against the JAX package's: the same
bytes on seeded fuzz transcripts and on a proof, an exact round trip,
and the same rejections of a malformed blob."""

import numpy as np
import pytest

from stark_tpu.channel import compress as jcompress
from stark_tpu.stark import StarkProof as JStarkProof
from stark_tpu_torch.channel import compress
from stark_tpu_torch.config import ProverConfig
from stark_tpu_torch.stark import StarkProof, prove, verify


def fuzz_messages(seed: int) -> list[bytes]:
    """A transcript-like mix: hex roots, digest vectors sharing nodes,
    8-byte values, exact repeats, odd literals and edge lengths."""
    rs = np.random.RandomState(seed)
    nodes = [rs.bytes(32) for _ in range(12)]
    msgs = []
    for _ in range(rs.randint(20, 80)):
        kind = rs.randint(6)
        if kind == 0:
            msgs.append(rs.bytes(32).hex().encode())
        elif kind == 1:
            msgs.append(b"".join(nodes[i] for i in
                                 rs.randint(0, len(nodes), rs.randint(1, 6))))
        elif kind == 2:
            msgs.append(rs.bytes(8))
        elif kind == 3 and msgs:
            msgs.append(msgs[rs.randint(len(msgs))])
        elif kind == 4:
            msgs.append(rs.bytes(rs.randint(0, 70)))
        else:
            msgs.append(rs.choice([b"", b"a", b"0f", b"0F", b"abc"]))
    return msgs


@pytest.mark.parametrize("seed", range(6))
def test_container_equals_jax_on_fuzz(seed):
    msgs = fuzz_messages(seed)
    blob = compress.compress_messages(msgs)
    assert blob == jcompress.compress_messages(msgs)
    assert compress.decompress_messages(blob) == msgs
    assert compress.compressed_size(msgs) == len(blob)


@pytest.fixture(scope="module")
def proof():
    return prove(ProverConfig(log2_trace=6, blowup=4, num_queries=8),
                 device="cpu")


def test_proof_container_equals_jax(proof):
    blob = proof.serialize(compress=True)
    ref = JStarkProof.deserialize(proof.serialize())
    assert blob == ref.serialize(compress=True)
    assert blob[:4] == b"STP1"
    assert len(blob) < len(proof.serialize())
    assert compress.compressed_size(proof.proof) == ref.compressed_size_bytes()
    again = StarkProof.deserialize(blob)
    assert again == proof
    assert verify(again)
    assert JStarkProof.deserialize(blob).proof == proof.proof


def test_malformed_blobs_rejected_as_jax_does(proof):
    blob = compress.compress_messages(proof.proof)
    cases = {"bad magic": b"TC2" + blob[3:],
             "truncated": blob[:len(blob) // 2],
             "trailing bytes": blob + b"\x00",
             "empty": b""}
    for what, bad in cases.items():
        with pytest.raises(compress.CompressionError) as mine:
            compress.decompress_messages(bad)
        with pytest.raises(jcompress.CompressionError) as ref:
            jcompress.decompress_messages(bad)
        assert str(mine.value) == str(ref.value), what
    header = proof.serialize(compress=True)
    with pytest.raises(compress.CompressionError, match="trailing"):
        StarkProof.deserialize(header + b"\x01")
