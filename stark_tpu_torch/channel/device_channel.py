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

from stark_tpu_torch.fields.fp import lift, store
from stark_tpu_torch.hash.cuda_chain import FIRST_HEX, FIRST_ROW, sha_chain


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


def _run(rows: list, flags: str, chain: torch.Tensor) -> torch.Tensor:
    stream = store(torch.cat(rows, dim=0)).contiguous()
    return sha_chain(stream, _consts(str(chain.device))[flags], chain)


def absorb_stream(digest: torch.Tensor, initial: bool):
    """(stream, flags) of send(hex_string_of(digest).encode()) for K5;
    `initial` for the first absorb of a fresh channel."""
    c = _consts(str(digest.device))
    msg = _double_hex_words(digest).reshape(2, 16)
    if initial:
        # quirk reproduced: the first absorb has no 64-char state prefix,
        # so its blocks are the message itself (a distinct layout)
        rows, flags = [msg, c["pad128"]], c["f_initial"]
    else:
        rows, flags = [c["zero_row"], msg, c["pad192"]], c["f_absorb"]
    return store(torch.cat(rows, dim=0)).contiguous(), flags


def absorb_digest(state, digest: torch.Tensor) -> torch.Tensor:
    """send(hex_string_of(digest).encode()) -> state' words.  `state` is
    an (8,) int32 tensor or None (the initial empty state)."""
    stream, flags = absorb_stream(digest, state is None)
    if state is None:
        state = torch.zeros(8, dtype=torch.int32, device=digest.device)
    return sha_chain(stream, flags, state)


def advance(state: torch.Tensor) -> torch.Tensor:
    """state' = sha256(utf8(state_hex)) (channel.rs:75-76)."""
    c = _consts(str(state.device))
    return _run([c["zero_row"], c["pad64"]], "f_one", state)


def absorb_value(state: torch.Tensor, hi, lo) -> torch.Tensor:
    """send(value.to_bytes(8, 'big')): the 80-byte message = 64-char state
    hex + 16 hex chars of the value (FRI's final-constant send)."""
    c = _consts(str(state.device))
    hv = ascii_hex_words(torch.stack([lift(hi), lift(lo)]))
    row = torch.cat([hv, c["value_tail"]])[None]
    return _run([c["zero_row"], row], "f_one", state)


@functools.lru_cache(maxsize=None)
def mod_weights(rng: int, device: str) -> torch.Tensor:
    """(8, 32) int64: weight of state word w, bit b is 2^((7-w)*32+b) mod
    rng (state words are big-endian: word 0 is most significant)."""
    return torch.tensor(
        [[pow(2, (7 - w) * 32 + b, rng) for b in range(32)] for w in range(8)],
        dtype=torch.int64, device=torch.device(device))


def mod_state(state: torch.Tensor, rng: int) -> torch.Tensor:
    """int(state_hex, 16) mod rng as an int64 0-dim tensor (any rng below
    2^32): the sum of at most 256 weights < 2^32 fits int64 exactly."""
    w = mod_weights(rng, str(state.device))
    bits = (lift(state)[:, None] >> torch.arange(32, device=state.device)) & 1
    return (bits * w).sum() % rng


def draw_field_element(state: torch.Tensor, p: int):
    """(value, new_state) of receive_random_field_element.  Quirk
    reproduced: the channel draws (state + min) % range with min = 0 and
    range = p, i.e. int(state_hex, 16) mod p (channel.rs:69-72)."""
    return mod_state(state, p), advance(state)


class DeviceFS:
    """Device mirror of a host Channel from a given state onward.

    Commit phases call :meth:`absorb_root` with the root digest still on
    the device and :meth:`draw` for a device challenge scalar; the log of
    payloads is fetched once at the end and replayed into the host
    channel by :meth:`replay_fetched`, which checks every draw."""

    def __init__(self, p: int, state_hex: str = "", *, device):
        self.p = p
        self.device = torch.device(device)
        if state_hex:
            words = np.frombuffer(bytes.fromhex(state_hex), dtype=">u4")
            self.state = torch.from_numpy(
                words.astype(np.uint32).view(np.int32).copy()).to(self.device)
        else:
            self.state = None
        self.log: list[tuple[str, object]] = []

    def absorb_root(self, digest: torch.Tensor) -> None:
        """send(root_hex.encode()) — digest: (8,) int32 device tensor."""
        self.state = absorb_digest(self.state, digest)
        self.log.append(("root", digest))

    def draw(self) -> torch.Tensor:
        """receive_random_field_element as a device int64 scalar."""
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

    def replay_fetched(self, channel, fetched) -> None:
        """Replay the log into `channel` from fetched host values (one per
        non-mark entry, in order: 8 words for a root, one for a draw),
        asserting every device draw equals the host derivation."""
        it = iter(fetched)
        for kind, payload in self.log:
            if kind == "mark":
                channel.mark_phase(payload)
            elif kind == "root":
                words = np.asarray(next(it), dtype=np.int64) & 0xFFFFFFFF
                channel.send(words.astype(">u4").tobytes().hex().encode())
            else:
                el = channel.receive_random_field_element()
                dev_val = int(np.asarray(next(it)).reshape(-1)[0]) & 0xFFFFFFFF
                if el.value != dev_val:
                    raise RuntimeError(
                        "device Fiat-Shamir diverged from host transcript "
                        f"({dev_val} != {el.value})")
