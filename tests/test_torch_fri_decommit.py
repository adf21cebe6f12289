"""The port's standalone FRI commit and query phase (``fri_commit`` on a
host channel + ``decommit_fri``) against the JAX package's on the same
seeded codewords, exact equality of the transcripts (bytes), in the u32
field and over Goldilocks; the per-query BatchGather loop
(``STARK_TPU_TORCH_HOST_QUERIES``) against the device query plan (one
launch of K5's query form, its plain version here); ``verify_fri``
accepts the transcript and rejects a flipped byte."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stark_tpu.channel.channel import Channel as JChannel
from stark_tpu.fri import commit as jfc
from stark_tpu.ntt.ntt import coset_evaluate as j_coset_evaluate
from stark_tpu_torch.channel.channel import Channel, ChannelError
from stark_tpu_torch.channel.device_query import query_chain
from stark_tpu_torch.fields.fp import host_words
from stark_tpu_torch.fri import commit as tfc
from stark_tpu_torch.fri.verify import FRIVerificationError, verify_fri
from stark_tpu_torch.interop import u32_to_tensor
from stark_tpu_torch.utils.gather import BatchGather, fetch_packed

P = 3 * 2**30 + 1
GL = 2**64 - 2**32 + 1
QUERIES = 3
# (field, codeword points, degree bound, coset offset): 2^8 points at
# blowup 8 in the u32 field; the Goldilocks codeword at the size whose
# JAX FRI programs tests/test_torch_goldilocks.py already compiles
CASES = {"u32": (P, 256, 32, 5), "goldilocks": (GL, 64, 8, 7)}


def _codeword(p, n, deg, offset, seed):
    """A seeded polynomial of degree < deg on the coset, as JAX storage
    words ((n,) u32 or (2, n) limb planes)."""
    rs = np.random.RandomState(seed)
    if p == P:
        c = rs.randint(0, p, size=deg, dtype=np.int64).astype(np.uint32)
    else:
        hi = rs.randint(0, 2**32, size=deg, dtype=np.uint64)
        lo = rs.randint(0, 2**32, size=deg, dtype=np.uint64)
        c = host_words(((hi << np.uint64(32)) | lo) % np.uint64(p), 2)
    return np.asarray(j_coset_evaluate(jnp.asarray(c), p, n, offset))


def _port_transcript(p, ev, offset, num_folds, host_loop, monkeypatch):
    if host_loop:
        monkeypatch.setenv("STARK_TPU_TORCH_HOST_QUERIES", "1")
    ch = Channel(p)
    fri = tfc.fri_commit(u32_to_tensor(ev, device="cpu"), p, offset, ch,
                         num_folds=num_folds)
    before = query_chain.launches
    tfc.decommit_fri(QUERIES, ev.shape[-1] - 1, fri.fri_layers,
                     fri.fri_merkles, ch)
    # on the CPU neither route launches the kernel
    assert query_chain.launches == before
    return ch, fri


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """(p, codeword, offset, folds, the JAX transcript)."""
    p, n, deg, offset = CASES[request.param]
    ev = _codeword(p, n, deg, offset, seed=n + deg)
    num_folds = (deg.bit_length() - 1)
    jch = JChannel(p)
    jfri = jfc.fri_commit(jnp.asarray(ev), p, offset, jch,
                          num_folds=num_folds)
    jfc.decommit_fri(QUERIES, n - 1, jfri.fri_layers, jfri.fri_merkles, jch)
    return p, ev, offset, num_folds, jch


@pytest.mark.parametrize("host_loop", [False, True],
                         ids=["device-plan", "batch-gather"])
def test_fri_transcript_equals_jax(case, host_loop, monkeypatch):
    """Both query routes give the JAX package's transcript, phase marks
    included, and the same final constant."""
    p, ev, offset, num_folds, jch = case
    ch, fri = _port_transcript(p, ev, offset, num_folds, host_loop,
                               monkeypatch)
    assert ch.proof == jch.proof
    assert ch.phases == jch.phases
    assert ch.state == jch.state
    assert fri.final_value == int.from_bytes(jch.proof[num_folds * 2 + 1],
                                             "big")
    # not deferred: every tree stored whole
    assert all(t.prune == 0 for t in fri.fri_merkles)


def test_fri_transcript_verifies_and_tamper_rejected(case):
    """The JAX transcript, which the port's equals (above)."""
    p, ev, offset, num_folds, jch = case
    ch = jch
    n = ev.shape[-1]
    assert verify_fri(ch.proof, p, n, offset, num_folds, QUERIES, n - 1)
    for i in (0, num_folds * 2 + 1, len(ch.proof) - 1):
        bad = list(ch.proof)
        msg = bytearray(bad[i])
        msg[-1] ^= 1
        bad[i] = bytes(msg)
        with pytest.raises((FRIVerificationError, ChannelError)):
            verify_fri(bad, p, n, offset, num_folds, QUERIES, n - 1)


def test_fri_commit_defaults_and_defer_rule():
    """num_folds defaults to log2(n) - 3 and defer needs the caller's
    DeviceFS, as in the JAX package; the final constant is checked
    unless strict is off."""
    ev = _codeword(P, 64, 8, 5, seed=1)
    fri = tfc.fri_commit(u32_to_tensor(ev, device="cpu"), P, 5, Channel(P))
    assert len(fri.fri_layers) == 4 and fri.fri_layers[-1].shape == (8,)
    with pytest.raises(ValueError, match="DeviceFS"):
        tfc.fri_commit(u32_to_tensor(ev, device="cpu"), P, 5, Channel(P),
                       defer=True)
    noisy = u32_to_tensor(np.arange(64, dtype=np.uint32) ** 3 % P,
                          device="cpu")
    with pytest.raises(ValueError, match="constant"):
        tfc.fri_commit(noisy, P, 5, Channel(P), num_folds=2)
    doomed = tfc.fri_commit(noisy, P, 5, Channel(P), num_folds=2,
                            strict=False)
    assert doomed.final_value == int(doomed.fri_layers[-1][0]) & 0xFFFFFFFF


def test_batch_gather_rows_and_one_fetch():
    """BatchGather: values, limb pairs (the (n, 2) open_layout view) and
    digest rows of several tensors in one fetch; fetch_packed keeps
    shapes and the low 32 bits."""
    vals = torch.arange(10, dtype=torch.int32) * 7
    pairs = torch.arange(20, dtype=torch.int32).view(2, 10)
    digs = torch.arange(40, dtype=torch.int32).view(5, 8)
    bg = BatchGather((vals, tfc.open_layout(pairs), digs))
    hs = [bg.want(0, 3), bg.want(1, 4), bg.want(2, 2), bg.want(0, 9)]
    bg.run()
    assert bg.scalar(hs[0]) == 21 and bg.scalar(hs[3]) == 63
    assert bg.value_u64(hs[1]) == 4 << 32 | 14
    assert bg.digest(hs[2]) == np.arange(16, 24).astype(">u4").tobytes()
    with pytest.raises(ValueError):
        bg.scalar(hs[2])
    a, b = fetch_packed([torch.tensor([2**32 + 5, -1]), digs])
    assert a.tolist() == [5, -1] and b.shape == (5, 8)
