"""The port's Fiat-Shamir layer — the chain (plain version of kernel K5),
the device channel, DeviceFS and the device query plan — against the JAX
package on the same seeded inputs, exact equality.  The JAX chain runs
its Pallas kernel in interpret mode."""

import functools
import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stark_tpu.channel import device_channel as jdc
from stark_tpu.channel import device_query as jdq
from stark_tpu.channel.channel import Channel as JChannel
from stark_tpu.merkle.tree import MerkleTree as JMerkleTree
from stark_tpu_torch.channel import device_channel as tdc
from stark_tpu_torch.channel.channel import Channel, ChannelError
from stark_tpu_torch.channel.device_query import DeviceQueryPlan, supported
from stark_tpu_torch.fri.commit import layer_layout
from stark_tpu_torch.hash.cuda_chain import (FIRST_HEX, FIRST_ROW, sha_chain,
                                             sha_chain_plain)
from stark_tpu_torch.interop import (hex_to_state, state_to_hex,
                                     tensor_to_u32, u32_to_tensor)
from stark_tpu_torch.merkle.tree import MerkleTree

P = 3 * 2**30 + 1


def _words(n, seed, bound=2**32):
    rs = np.random.RandomState(seed)
    return rs.randint(0, bound, size=n, dtype=np.uint64).astype(np.uint32)


def _stream(seed, sizes=(1, 3, 2, 4, 1)):
    first, last = [], []
    for blocks in sizes:
        first += [1] + [0] * (blocks - 1)
        last += [0] * (blocks - 1) + [1]
    rows = _words(16 * len(first), seed).reshape(-1, 16)
    flags = np.stack([first, last], axis=1).astype(np.uint32)
    return rows, flags, _words(8, seed + 1)


def test_chain_matches_jax_scan_and_pallas_interpret():
    """K5's plain version vs the XLA _block_step scan and the TPU kernel it
    replaces (pallas_chain.sha_chain, interpret mode)."""
    from stark_tpu.hash.pallas_chain import sha_chain as j_sha_chain

    rows, flags, chain0 = _stream(42)
    (_, want), _ = jax.lax.scan(
        jdq._block_step, (jnp.zeros(8, jnp.uint32), jnp.asarray(chain0)),
        (jnp.asarray(rows), jnp.asarray(flags[:, 0] != 0),
         jnp.asarray(flags[:, 1] != 0)))
    got = sha_chain(u32_to_tensor(rows), u32_to_tensor(flags),
                    u32_to_tensor(chain0))
    np.testing.assert_array_equal(tensor_to_u32(got), np.asarray(want))
    pallas = j_sha_chain(jnp.asarray(rows), jnp.asarray(flags),
                         jnp.asarray(chain0), interpret=True)
    np.testing.assert_array_equal(tensor_to_u32(got), np.asarray(pallas))
    assert sha_chain.plain is sha_chain_plain


def test_chain_first_row_flag_hashes_the_row_itself():
    """The port's extra flag value: reset to H0 and keep the row — a
    two-block message hashed from scratch equals hashlib."""
    msg = bytes(range(64))
    pad = np.zeros(16, np.uint32)
    pad[0], pad[15] = 0x80000000, 512
    rows = np.stack([np.frombuffer(msg, ">u4").astype(np.uint32), pad])
    flags = np.array([[FIRST_ROW, 0], [0, 1]], np.uint32)
    out = sha_chain(u32_to_tensor(rows), u32_to_tensor(flags),
                    u32_to_tensor(_words(8, 5)))
    assert state_to_hex(out) == hashlib.sha256(msg).hexdigest()
    # FIRST_HEX hashes the chain's own hex instead: the channel's advance
    state = hashlib.sha256(b"seed").hexdigest()
    flags = np.array([[FIRST_HEX, 0], [0, 1]], np.uint32)
    out = sha_chain(u32_to_tensor(rows), u32_to_tensor(flags),
                    hex_to_state(state))
    assert state_to_hex(out) == hashlib.sha256(state.encode()).hexdigest()


def test_ascii_hex_words_match_jax():
    d = _words(24, 3).reshape(3, 8)
    want = np.asarray(jdc.ascii_hex_words(jnp.asarray(d)))
    got = tdc.ascii_hex_words(u32_to_tensor(d)).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_channel_ops_match_jax(seed):
    d, s = _words(8, seed), _words(8, seed + 10)
    jd, js = jnp.asarray(d), jnp.asarray(s)
    td, ts = u32_to_tensor(d), u32_to_tensor(s)
    pairs = [
        (tdc.absorb_digest(None, td), jdc.absorb_digest(None, jd)),
        (tdc.absorb_digest(ts, td), jdc.absorb_digest(js, jd)),
        (tdc.advance(ts), jdc.advance(js)),
        (tdc.absorb_value(ts, torch.tensor(0), torch.tensor(int(d[0]) % P)),
         jdc.absorb_value(js, jnp.uint32(0), jnp.uint32(int(d[0]) % P))),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(tensor_to_u32(got), np.asarray(want))
    for p in (P, 97):
        assert int(tdc.mod_state(ts, p)) == int(np.asarray(
            jdc.state_mod(js, p)))
    # even and odd draw ranges of the query phase
    for rng in (100, 2**22 - 8, 4093):
        want = jdq._mod_state(js, jnp.asarray(jdq._mod_weights(rng)), rng)
        assert int(tdc.mod_state(ts, rng)) == int(np.asarray(want))


def _fs_script(fs, digests):
    fs.mark("trace-commit")
    fs.absorb_root(digests[0])
    draws = [fs.draw() for _ in range(3)]
    fs.mark("fri-commit")
    fs.absorb_root(digests[1])
    draws.append(fs.draw())
    return draws


def test_device_fs_replay_matches_jax():
    digests = [_words(8, 20), _words(8, 21)]
    jch = JChannel(P)
    jfs = jdc.DeviceFS(P, jch.state)
    _fs_script(jfs, [jnp.asarray(d) for d in digests])
    jfs.finalize(jch)

    ch = Channel(P)
    fs = tdc.DeviceFS(P, ch.state, device="cpu")
    draws = _fs_script(fs, [u32_to_tensor(d) for d in digests])
    fetched = [t.reshape(-1).numpy() for t in fs.payloads()]
    fs.replay_fetched(ch, fetched)
    assert ch.proof == jch.proof
    assert ch.state == jch.state == state_to_hex(fs.state)
    assert ch.phases == jch.phases
    assert [int(d) for d in draws] == [
        int.from_bytes(m, "big") for m in ch.proof if len(m) == 8]


def test_device_fs_rejects_a_diverged_draw():
    ch = Channel(P)
    fs = tdc.DeviceFS(P, ch.state, device="cpu")
    fs.absorb_root(u32_to_tensor(_words(8, 1)))
    fs.draw()
    fetched = [t.reshape(-1).numpy().copy() for t in fs.payloads()]
    fetched[1][0] += 1
    with pytest.raises(RuntimeError, match="diverged"):
        fs.replay_fetched(ch, fetched)
    with pytest.raises(ValueError):
        tdc.DeviceFS(P, "", device="cpu").draw()


def test_channel_copy_matches_reference():
    jch, ch = JChannel(P), Channel(P)
    for ch_ in (jch, ch):
        ch_.send(b"abc")
        ch_.receive_random_field_element()
        ch_.receive_random_int(0, 1000, True)
        ch_.send(bytes(range(20)))
    assert ch.proof == jch.proof and ch.state == jch.state
    with pytest.raises(ChannelError):
        Channel(P).receive_random_int(0, 10)


def _fri_buffers(layers):
    """Port FRI buffers (values, digests) for a list of numpy layers."""
    layout, vt, dt = layer_layout([len(v) for v in layers])
    values = torch.empty(vt, dtype=torch.int32)
    digests = torch.empty((dt, 8), dtype=torch.int32)
    for v, (ln, vo, do) in zip(layers, layout):
        values[vo:vo + ln] = u32_to_tensor(v)
        MerkleTree(u32_to_tensor(v), out=digests[do:do + 2 * ln - 1])
    return values, digests


def _jax_outs(outs):
    vals = np.stack([np.asarray(o) for o in outs if o.ndim == 1], axis=1)
    digs = np.concatenate([np.asarray(o) for o in outs if o.ndim == 3],
                          axis=1)
    return vals, digs


@pytest.mark.parametrize("fri_lengths,mode", [((16,), 2),
                                              ((16, 8, 4, 2, 1), 0)])
def test_query_plan_matches_jax(fri_lengths, mode):
    """DeviceQueryPlan vs the JAX plan's _run — mode 2 is the Pallas
    chain in interpret mode; the ladder ending in a length-1 layer
    exercises the len==1 quirk."""
    f_evals = _words(16, 21, P)
    layers = [f_evals[:ln] if i == 0 else _words(ln, 30 + i, P)
              for i, ln in enumerate(fri_lengths)]
    state = _words(8, 22)
    # draw range 15 = trace length - largest offset, as in the prover
    jplan = jdq.get_plan(15, 3, (0, 1), 16, fri_lengths)
    jt = JMerkleTree(jnp.asarray(f_evals))
    jlv = [JMerkleTree(jnp.asarray(v)).levels[:-1] for v in layers]
    want = jax.device_get(jax.jit(functools.partial(jplan._run, mode=mode))(
        jnp.asarray(state), jnp.asarray(f_evals), tuple(jt.levels[:-1]),
        tuple(jnp.asarray(v) for v in layers), tuple(tuple(l) for l in jlv)))
    jdq.get_plan.cache_clear()
    want_final, (want_idx, outs) = want
    want_vals, want_digs = _jax_outs(outs)

    plan = DeviceQueryPlan(15, 3, (0, 1), 16, fri_lengths)
    tree = MerkleTree(u32_to_tensor(f_evals))
    values, digests = _fri_buffers(layers)
    final, idxs, vals, digs = plan.run_device(
        u32_to_tensor(state), u32_to_tensor(f_evals), tree.buffer, values,
        digests)
    np.testing.assert_array_equal(tensor_to_u32(final), want_final)
    np.testing.assert_array_equal(idxs.numpy(), want_idx)
    np.testing.assert_array_equal(tensor_to_u32(vals), want_vals)
    np.testing.assert_array_equal(tensor_to_u32(digs), want_digs)


def test_query_replay_matches_jax_transcript():
    fri_lengths = (32, 16, 8)
    f_evals = _words(32, 50, P)
    layers = [f_evals] + [_words(ln, 51 + i, P)
                          for i, ln in enumerate(fri_lengths[1:])]
    jch, ch = JChannel(P), Channel(P)
    jch.send(b"statement")
    ch.send(b"statement")
    jplan = jdq.get_plan(28, 4, (0, 2, 4), 32, fri_lengths)
    jplan.run(jch, jnp.asarray(f_evals),
              JMerkleTree(jnp.asarray(f_evals)).levels[:-1],
              [jnp.asarray(v) for v in layers],
              [JMerkleTree(jnp.asarray(v)).levels[:-1] for v in layers])
    jdq.get_plan.cache_clear()

    plan = DeviceQueryPlan(28, 4, (0, 2, 4), 32, fri_lengths)
    values, digests = _fri_buffers(layers)
    final, idxs, vals, digs = plan.run_device(
        hex_to_state(ch.state), u32_to_tensor(f_evals),
        MerkleTree(u32_to_tensor(f_evals)).buffer, values, digests)
    plan.replay(ch, final.numpy(), idxs.numpy(), vals.numpy(), digs.numpy())
    assert ch.proof == jch.proof
    assert ch.state == jch.state
    bad = vals.numpy().copy()
    bad[0, 0] ^= 1
    fresh = Channel(P)
    fresh.send(b"statement")
    with pytest.raises(RuntimeError, match="diverged"):
        plan.replay(fresh, final.numpy(), idxs.numpy(), bad, digs.numpy())


def test_supported_mirrors_the_plan():
    assert supported(100, 16, (16, 8))
    assert not supported(100, 16, (12,))
    assert not supported(2**32, 16, (16,))
    with pytest.raises(ValueError, match="power-of-two"):
        DeviceQueryPlan(100, 1, (0,), 16, (12,))
    with pytest.raises(ValueError, match="draw range"):
        DeviceQueryPlan(2**32, 1, (0,), 16, (16,))
