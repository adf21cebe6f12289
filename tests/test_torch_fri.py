"""The port's FRI commit (fold, inverse domain, per-layer trees and
Fiat-Shamir) and FRI verifier against the JAX package on the same seeded
inputs, exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stark_tpu.channel.channel import Channel as JChannel
from stark_tpu.channel.device_channel import DeviceFS as JDeviceFS
from stark_tpu.fri import commit as jfc
from stark_tpu.ntt.ntt import coset_evaluate as j_coset_evaluate
from stark_tpu_torch.channel.channel import Channel, VerifierChannel
from stark_tpu_torch.channel.device_channel import DeviceFS
from stark_tpu_torch.fields.fp import store
from stark_tpu_torch.fri import commit as tfc
from stark_tpu_torch.fri.verify import (FRIVerificationError, replay_commit,
                                        verify_query_layers)
from stark_tpu_torch.interop import tensor_to_u32, u32_to_tensor

P = 3 * 2**30 + 1


def _low_degree(n, deg, offset, seed, p=P):
    rs = np.random.RandomState(seed)
    c = np.zeros(deg, dtype=np.uint32)
    c[:] = rs.randint(0, p, size=deg, dtype=np.int64)
    return np.asarray(j_coset_evaluate(jnp.asarray(c), p, n, offset))


@pytest.mark.parametrize("p,m,offset", [(P, 64, 5), (97, 16, 5)])
def test_fold_and_inverse_domain_match_jax(p, m, offset):
    rs = np.random.RandomState(m)
    ev = rs.randint(0, p, size=m, dtype=np.int64).astype(np.uint32)
    beta = int(rs.randint(0, p))
    jinv = np.asarray(jfc._inv_domain(p, m, offset))
    tinv = tfc._inv_domain(p, m, offset, "cpu")
    np.testing.assert_array_equal(tensor_to_u32(tinv), jinv)
    want = np.asarray(jfc._fold_fn(p, m)(jnp.asarray(ev), jnp.uint32(beta),
                                         jnp.asarray(jinv)))
    got = store(tfc._fold_fn(p, m)(u32_to_tensor(ev, device="cpu"),
                                   torch.tensor(beta), tinv))
    np.testing.assert_array_equal(tensor_to_u32(got), want)


@pytest.mark.parametrize("fresh", [True, False])
def test_fri_commit_matches_jax(fresh):
    """Deferred commit through a device FS: same layers, roots and
    challenges, and the same transcript after the host replay."""
    n, num_folds, offset = 256, 5, 5
    ev = _low_degree(n, 8, offset, seed=3)

    jch = JChannel(P)
    ch = Channel(P)
    if not fresh:
        jch.send(b"prior")
        ch.send(b"prior")
    jfs = JDeviceFS(P, jch.state)
    jfri = jfc.fri_commit(jnp.asarray(ev), P, offset, jch,
                          num_folds=num_folds, fs=jfs, defer=True)
    jfs.finalize(jch)
    jfc.finish_deferred(P, np.asarray(jfri.fri_layers[-1]), jch)

    fs = DeviceFS(P, ch.state, device="cpu")
    fri = tfc.fri_commit(u32_to_tensor(ev, device="cpu"), P, offset, ch,
                         num_folds=num_folds, fs=fs, defer=True)
    for got, want in zip(fri.fri_layers, jfri.fri_layers):
        np.testing.assert_array_equal(tensor_to_u32(got), np.asarray(want))
    assert [t.root() for t in fri.fri_merkles] == [
        t.root() for t in jfri.fri_merkles]
    assert fri.offsets == jfri.offsets
    fs.replay_fetched(ch, [t.reshape(-1).numpy() for t in fs.payloads()])
    fri.final_value = tfc.finish_deferred(
        P, tensor_to_u32(fri.fri_layers[-1]), ch)
    assert ch.proof == jch.proof and ch.state == jch.state
    # the layers are views into one values buffer at the static layout
    for layer, (ln, voff, _) in zip(fri.fri_layers, fri.layout):
        assert layer.data_ptr() == fri.values[voff:].data_ptr()
        assert layer.shape == (ln,)


def test_finish_deferred_strict_check():
    with pytest.raises(ValueError, match="constant"):
        tfc.finish_deferred(P, np.array([1, 2], np.uint32), Channel(P))
    ch = Channel(P)
    assert tfc.finish_deferred(P, np.array([7, 7], np.uint32), ch) == 7
    assert ch.proof == [(7).to_bytes(8, "big")]


def test_fri_verify_accepts_replayed_layers_and_rejects_tampering():
    """The copied FRI verifier walks a commit plus one hand-built query."""
    n, num_folds, offset = 64, 3, 5
    ev = _low_degree(n, 8, offset, seed=9)
    ch = Channel(P)
    fs = DeviceFS(P, ch.state, device="cpu")
    fri = tfc.fri_commit(u32_to_tensor(ev, device="cpu"), P, offset, ch,
                         num_folds=num_folds, fs=fs, defer=True)
    fs.replay_fetched(ch, [t.reshape(-1).numpy() for t in fs.payloads()])
    tfc.finish_deferred(P, tensor_to_u32(fri.fri_layers[-1]), ch)
    idx = ch.receive_random_int(0, n - 1, True)
    for layer, tree in zip(fri.fri_layers, fri.fri_merkles):
        ln = layer.shape[0]
        for j in (idx % ln, (idx % ln + ln // 2) % ln):
            ch.send((int(layer[j]) & 0xFFFFFFFF).to_bytes(8, "big"))
            ch.send(tree.get_authentication_path(j))

    def walk(proof):
        vc = VerifierChannel(P, proof)
        roots, betas, final = replay_commit(vc, num_folds)
        i0 = vc.receive_random_int(0, n - 1, True)
        verify_query_layers(vc, i0, roots, betas, final, P, n, offset)

    walk(ch.proof)
    bad = list(ch.proof)
    bad[-4] = (int.from_bytes(bad[-4], "big") ^ 1).to_bytes(8, "big")
    with pytest.raises(FRIVerificationError):
        walk(bad)
