"""Device-resident Fiat-Shamir state machine (counterpart of
``stark_tpu/channel/device_channel.py``).

The state is the (8,) int32 tensor of digest words whose lowercase hex IS
the host channel's state string.  Every operation hashes a message that
starts with that 64-char hex (or, for a fresh channel, with nothing), so
each one is a short flagged block stream run through kernel K5
(``hash/cuda_chain.py``): JAX runs each as a single-lane SHA, which in
eager torch would be thousands of tiny launches per compression.  The
block rows are built with torch ops on the state's device; nothing syncs
with the host until :meth:`DeviceFS.replay_fetched`.

Message layouts (all inputs are 32-byte digests or one field value):

* absorb, empty state:  128 bytes -> 2 blocks + pad block
* absorb, 64-char state: 192 bytes -> 3 blocks + pad block
* advance (draw):         64 bytes -> 1 block  + pad block
* absorb_value:           80 bytes -> 1 block  + value/pad block
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from stark_tpu_torch.fields.fp import Fp, lift, store
from stark_tpu_torch.hash.cuda_chain import (FIRST_HEX, FIRST_ROW, sha_chain,
                                             sha_chain_batch)
from stark_tpu_torch.utils.gather import fetch_packed


def state_words(state_hex: str, device) -> torch.Tensor:
    """The channel's 64-char hex state -> (8,) int32 words on `device`."""
    words = np.frombuffer(bytes.fromhex(state_hex), dtype=">u4")
    return torch.from_numpy(
        words.astype(np.uint32).view(np.int32).copy()).to(device)


def ascii_hex_words(d: torch.Tensor) -> torch.Tensor:
    """(..., k) 32-bit words -> (..., 2k) int64: the UTF-8 bytes of their
    lowercase hex string, packed big-endian 4 chars per word (what SHA
    consumes).  The one shared copy of this transcript-critical layout."""
    d = lift(d)
    shifts = torch.arange(28, -4, -4, device=d.device)
    nib = ((d[..., :, None] >> shifts) & 0xF).reshape(
        d.shape[:-1] + (d.shape[-1] * 8,))
    ch = torch.where(nib < 10, 0x30 + nib, 0x57 + nib)
    ch4 = ch.reshape(d.shape[:-1] + (d.shape[-1] * 2, 4))
    return (ch4[..., 0] << 24) | (ch4[..., 1] << 16) | (ch4[..., 2] << 8) \
        | ch4[..., 3]


def _double_hex_words(digest: torch.Tensor) -> torch.Tensor:
    """(8,) digest -> (32,) words: hex(utf8(hex(digest))) — the bytes
    send() hashes when the message is itself an ASCII hex root string."""
    return ascii_hex_words(ascii_hex_words(digest))


def pad_row(msg_bytes: int) -> np.ndarray:
    """The final SHA block of a message that ends on a block boundary:
    0x80, zeros, 64-bit bit length."""
    row = np.zeros(16, dtype=np.int64)
    row[0] = 0x80000000
    row[15] = msg_bytes * 8
    return row


# absorb_value's second block after the 4 hex words of the value:
# 0x80, zeros, the bit length of the 80-byte message
VALUE_TAIL = np.concatenate([pad_row(80)[:1], np.zeros(10, np.int64),
                             pad_row(80)[15:]])


@functools.lru_cache(maxsize=None)
def _consts(device: str) -> dict:
    """Per-device constant rows (int64) and (first, last) flags (int32)
    of the channel's block streams."""
    dev = torch.device(device)

    def rows(arr):
        return torch.from_numpy(np.asarray(arr, dtype=np.int64)).to(dev)

    def flags(pairs):
        return torch.tensor(pairs, dtype=torch.int32, device=dev)

    return {
        "zero_row": rows(np.zeros((1, 16))),
        "pad64": rows(pad_row(64)[None]),
        "pad128": rows(pad_row(128)[None]),
        "pad192": rows(pad_row(192)[None]),
        "value_tail": rows(VALUE_TAIL),
        # the first absorb of a fresh channel hashes its rows as they are:
        # no state prefix (stark_tpu/channel/device_channel.py:104-105)
        "f_initial": flags([[FIRST_ROW, 0], [0, 0], [0, 1]]),
        "f_absorb": flags([[FIRST_HEX, 0], [0, 0], [0, 0], [0, 1]]),
        "f_one": flags([[FIRST_HEX, 0], [0, 1]]),
    }


# Every chain operation takes one state, (8,), or a batch of B states,
# (B, 8) with the other operands' leading axis B (stark/batch.py): a
# batch's block streams are (B, rows, 16) and run as B chains in one
# launch of K5's chain form.

def _stream(rows: list, lead: tuple) -> torch.Tensor:
    """Block rows ((r, 16), or (*lead, r, 16)) -> one contiguous int32
    (*lead, R, 16) stream, the constant rows repeated for each chain."""
    return store(torch.cat([r.expand(lead + tuple(r.shape[-2:]))
                            for r in rows], dim=-2)).contiguous()


def _chain(stream, flags, chain):
    return (sha_chain if chain.dim() == 1 else sha_chain_batch)(
        stream, flags, chain)


def _run(rows: list, flags: str, chain: torch.Tensor) -> torch.Tensor:
    return _chain(_stream(rows, tuple(chain.shape[:-1])),
                  _consts(str(chain.device))[flags], chain)


def absorb_stream(digest: torch.Tensor, initial: bool):
    """(stream, flags) of send(hex_string_of(digest).encode()) for K5;
    `initial` for the first absorb of a fresh channel."""
    c = _consts(str(digest.device))
    lead = tuple(digest.shape[:-1])
    msg = _double_hex_words(digest).reshape(lead + (2, 16))
    if initial:
        # quirk reproduced: the first absorb has no 64-char state prefix,
        # so its blocks are the message itself (a distinct layout)
        rows, flags = [msg, c["pad128"]], c["f_initial"]
    else:
        rows, flags = [c["zero_row"], msg, c["pad192"]], c["f_absorb"]
    return _stream(rows, lead), flags


def absorb_digest(state, digest: torch.Tensor) -> torch.Tensor:
    """send(hex_string_of(digest).encode()) -> state' words.  `state` is
    an (8,) int32 tensor or None (the initial empty state); a batch of
    (B, 8) digests takes (B, 8) states."""
    stream, flags = absorb_stream(digest, state is None)
    if state is None:
        state = torch.zeros(digest.shape, dtype=torch.int32,
                            device=digest.device)
    return _chain(stream, flags, state)


def advance(state: torch.Tensor) -> torch.Tensor:
    """state' = sha256(utf8(state_hex)) (channel.rs:75-76)."""
    c = _consts(str(state.device))
    return _run([c["zero_row"], c["pad64"]], "f_one", state)


def absorb_value(state: torch.Tensor, hi, lo) -> torch.Tensor:
    """send(value.to_bytes(8, 'big')): the 80-byte message = 64-char state
    hex + 16 hex chars of the value (FRI's final-constant send); a batch
    of (B, 8) states takes (B,) words."""
    c = _consts(str(state.device))
    hv = ascii_hex_words(torch.stack([lift(hi), lift(lo)], dim=-1))
    tail = c["value_tail"].expand(hv.shape[:-1] + (12,))
    row = torch.cat([hv, tail], dim=-1)[..., None, :]
    return _run([c["zero_row"], row], "f_one", state)


@functools.lru_cache(maxsize=None)
def mod_weights(rng: int, device: str) -> torch.Tensor:
    """(8, 32) int64: weight of state word w, bit b is 2^((7-w)*32+b) mod
    rng (state words are big-endian: word 0 is most significant)."""
    return torch.tensor(
        [[pow(2, (7 - w) * 32 + b, rng) for b in range(32)] for w in range(8)],
        dtype=torch.int64, device=torch.device(device))


def mod_state(state: torch.Tensor, rng: int) -> torch.Tensor:
    """int(state_hex, 16) mod rng as an int64 0-dim tensor ((B,) for a
    batch of states; any rng below 2^32): the sum of at most 256 weights
    < 2^32 fits int64 exactly."""
    w = mod_weights(rng, str(state.device))
    bits = (lift(state)[..., None]
            >> torch.arange(32, device=state.device)) & 1
    return (bits * w).sum((-1, -2)) % rng


@functools.lru_cache(maxsize=None)
def _word_weights(p: int, device: str) -> torch.Tensor:
    """(2, 8) limb planes of 2^(32 (7 - w)) mod p, the weight of state
    word w (word 0 the most significant)."""
    return Fp.get(p).array([pow(2, 32 * (7 - w), p) for w in range(8)],
                           device=torch.device(device))


def state_mod(state: torch.Tensor, p: int) -> torch.Tensor:
    """int(state_hex, 16) mod p as a canonical field element, width-generic
    (the JAX ``state_mod``): an int64 0-dim tensor for p < 2^32, a (2,)
    (hi, lo) pair for the Goldilocks field ((B,) / (2, B) for a batch of
    (B, 8) states).  There the 8 words (each
    below p) times their weights mod p are summed by field adds, the
    value of JAX's Horner loop over the words."""
    f = Fp.get(p)
    if f.width == 1:
        return mod_state(state, p)
    words = lift(state)
    weights = _word_weights(p, str(state.device))
    acc = f.mul(torch.stack([torch.zeros_like(words), words]),
                weights.view((2,) + (1,) * (words.dim() - 1) + (8,)))
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = f.add(acc[..., :h], acc[..., h:])
    return acc[..., 0]


def draw_field_element(state: torch.Tensor, p: int):
    """(value, new_state) of receive_random_field_element.  Quirk
    reproduced: the channel draws (state + min) % range with min = 0 and
    range = p, i.e. int(state_hex, 16) mod p (channel.rs:69-72)."""
    return state_mod(state, p), advance(state)


class DeviceFS:
    """Device mirror of a host Channel from a given state onward.

    Commit phases call :meth:`absorb_root` with the root digest still on
    the device and :meth:`draw` for a device challenge scalar; the log of
    payloads is fetched once at the end and replayed into the host
    channel by :meth:`replay_fetched`, which checks every draw.  Fed
    (B, 8) root digests, a fresh one runs B chains at once, (B, 8)
    states and (B,) or (2, B) draws (``stark/batch.py``).  On a mesh
    (`mesh`, a ``dist.mesh.Mesh``) the state lives on its first shard:
    the chain is serial and tiny, and in one process its replication is
    nothing more than the one fetch.

    `state`: an (8,) int32 device tensor to start from instead of
    `state_hex` (which :func:`state_words` uploads): the single-dispatch
    prove's static state buffer, which its CUDA graph reads and never
    writes.  The log's payloads are the device tensors that the one fetch
    packs; :meth:`replay_fetched` reads only the log's kinds and the
    fetched values, so a log kept from an earlier run (the graph's, whose
    payload tensors each replay overwrites) replays a later fetch."""

    def __init__(self, p: int, state_hex: str = "", *, device=None,
                 mesh=None, state: torch.Tensor | None = None):
        if (device is None) == (mesh is None):
            raise ValueError("DeviceFS takes a device or a mesh")
        if state is not None and state_hex:
            raise ValueError("DeviceFS takes a state tensor or a hex state")
        self.p = p
        self.width = Fp.get(p).width
        self.device = mesh.first if mesh is not None else torch.device(device)
        self.state = state_words(state_hex, self.device) if state_hex \
            else state
        self.log: list[tuple[str, object]] = []

    def absorb_root(self, digest: torch.Tensor) -> None:
        """send(root_hex.encode()) — digest: (8,) int32 device tensor."""
        self.state = absorb_digest(self.state, digest)
        self.log.append(("root", digest))

    def draw(self) -> torch.Tensor:
        """receive_random_field_element as a device int64 scalar (a (2,)
        limb pair for the Goldilocks field)."""
        if self.state is None:
            raise ValueError("draw before any absorb (empty channel state)")
        v, self.state = draw_field_element(self.state, self.p)
        self.log.append(("draw", v))
        return v

    def mark(self, label: str) -> None:
        """Record a phase boundary (replayed as channel.mark_phase)."""
        self.log.append(("mark", label))

    def payloads(self) -> list[torch.Tensor]:
        """The device tensors the replay needs, in log order."""
        return [pl for kind, pl in self.log if kind != "mark"]

    def kinds(self) -> list[str]:
        """The log's shape: "root", "draw" or "mark:<phase>" an entry (the
        JAX package's ``log_kinds``)."""
        return [f"mark:{pl}" if kind == "mark" else kind
                for kind, pl in self.log]

    def replay_fetched(self, channel, fetched) -> None:
        """Replay the log into `channel` from fetched host values (one per
        non-mark entry, in order: 8 words for a root, one for a draw, or
        its (hi, lo) pair), asserting every device draw equals the host
        derivation."""
        it = iter(fetched)
        for kind, payload in self.log:
            if kind == "mark":
                channel.mark_phase(payload)
            elif kind == "root":
                words = np.asarray(next(it), dtype=np.int64) & 0xFFFFFFFF
                channel.send(words.astype(">u4").tobytes().hex().encode())
            else:
                el = channel.receive_random_field_element()
                words = np.asarray(next(it)).reshape(-1)[:self.width]
                dev_val = 0
                for w in words:
                    dev_val = dev_val << 32 | (int(w) & 0xFFFFFFFF)
                if el.value != dev_val:
                    raise RuntimeError(
                        "device Fiat-Shamir diverged from host transcript "
                        f"({dev_val} != {el.value})")

    def finalize(self, channel, extras=()) -> list:
        """Replay the log into `channel` (which must be at this FS's
        construction state) from one packed fetch of the payloads and
        the `extras` tensors; returns the fetched extras (numpy int32
        words of their shapes)."""
        payloads = self.payloads()
        fetched = fetch_packed(payloads + list(extras))
        self.replay_fetched(channel, fetched[:len(payloads)])
        return fetched[len(payloads):]
