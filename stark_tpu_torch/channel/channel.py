# Copied from stark_tpu/channel/channel.py (host-only), with its stark_tpu imports
# rewritten to the port: the port must not import stark_tpu, whose
# package init imports JAX.
"""Fiat-Shamir channel — byte-exact host replica of the reference's
``Channel`` (reference: src/channel/channel.rs:14-96).

The transcript is inherently sequential and tiny (O(rounds + queries)
hashes), so it stays on host; device work is phase-batched between channel
interactions (SURVEY §3.3).  Semantics replicated exactly, quirks included:

* ``state`` is a lowercase hex *string*, initially "" (channel.rs:28).
* ``send(msg)``: state = sha256_hex(utf8(state ++ hex(msg))) — the hash
  input is the UTF-8 bytes of the concatenated hex *strings*
  (channel.rs:35-44); raw msg bytes appended to both proof logs.
* ``receive_random_int(min,max)``: num = (state_int + min) % (max-min+1)
  — the reference's deviation from STARK-101 (min shifts instead of
  offsetting, channel.rs:69-72) — then state = sha256_hex(utf8(state)),
  i.e. a hash of the old hex string itself (channel.rs:75-76); returns the
  low 64 bits (first U256 limb, channel.rs:83).
* ``receive_random_field_element``: draws with show_in_proof=False, then
  pushes the 8-byte BE value into ``proof`` only (channel.rs:47-55).
* drawing before any ``send`` is an error (the reference panics on
  ``U256::from_str_radix("")``, channel.rs:64-65 — we raise ChannelError).

On top of the replica, the transcript doubles as a serializable,
phase-tagged, append-only log (SURVEY §5.4): serialize/deserialize plus
the resumable prover (not yet ported) give checkpoint/resume, and the
verifier walks it with a cursor — fixing the reference's
``proof.last()`` replay bug (fri_verify.rs:45,56,97,106).
"""

from __future__ import annotations

import hashlib
import json

from stark_tpu_torch.fields.element import FieldElement

_MASK64 = (1 << 64) - 1


class ChannelError(Exception):
    pass


def _sha256_hex(s: str) -> str:
    return hashlib.sha256(s.encode()).hexdigest()


def _absorb(state_hex: str, message: bytes) -> str:
    """state' = sha256_hex(utf8(state ++ hex(msg))) (hashlib only)."""
    return _sha256_hex(state_hex + message.hex())


class Channel:
    """Prover-side Fiat-Shamir transcript for GF(modulus)."""

    def __init__(self, modulus: int):
        self.modulus = modulus
        self.proof: list[bytes] = []
        self.compressed_proof: list[bytes] = []
        self.state: str = ""
        self.phases: list[tuple[str, int]] = []  # (label, proof index) marks

    # -- reference-exact core (channel.rs:35-84) --------------------------
    def send(self, message: bytes) -> None:
        self.state = _absorb(self.state, message)
        self.proof.append(bytes(message))
        self.compressed_proof.append(bytes(message))

    def receive_random_int(self, min_: int, max_: int, show_in_proof: bool = False) -> int:
        if self.state == "":
            raise ChannelError(
                "receive_* before any send: channel state is empty "
                "(the reference panics here, channel.rs:64-65)"
            )
        state_int = int(self.state, 16)
        rng = (max_ - min_) + 1
        if rng <= 0:
            raise ChannelError(f"empty range [{min_}, {max_}]")
        num = (state_int + min_) % rng
        self.state = _sha256_hex(self.state)
        num64 = num & _MASK64
        if show_in_proof:
            self.proof.append(num64.to_bytes(8, "big"))
        return num64

    def receive_random_field_element(self) -> FieldElement:
        num = self.receive_random_int(0, self.modulus - 1, False)
        self.proof.append(num.to_bytes(8, "big"))
        return FieldElement(num, self.modulus)

    def proof_size(self) -> int:
        return sum(len(m) for m in self.proof)

    def compressed_proof_size(self) -> int:
        return sum(len(m) for m in self.compressed_proof)

    # -- transcript log extensions (SURVEY §5.4) ---------------------------
    def mark_phase(self, label: str) -> None:
        self.phases.append((label, len(self.proof)))

    def serialize(self) -> bytes:
        return json.dumps(
            {
                "modulus": self.modulus,
                "proof": [m.hex() for m in self.proof],
                "phases": self.phases,
            }
        ).encode()

    @classmethod
    def deserialize(cls, data: bytes) -> "Channel":
        obj = json.loads(data.decode())
        ch = cls(obj["modulus"])
        ch.proof = [bytes.fromhex(m) for m in obj["proof"]]
        ch.phases = [tuple(p) for p in obj["phases"]]
        return ch


class VerifierChannel:
    """Replays a proof transcript with an explicit cursor, re-deriving the
    prover's challenges.  This is what the reference's verifier should have
    been (it re-read ``proof.last()`` forever, fri_verify.rs:45).

    The verifier mirrors every prover action: where the prover sent a
    message, call :meth:`read` (which absorbs it into the state hash);
    where the prover drew randomness, call the matching receive_*.
    """

    def __init__(self, modulus: int, proof: list[bytes]):
        self.modulus = modulus
        self.proof = list(proof)
        self.cursor = 0
        self.state = ""

    def _next(self) -> bytes:
        if self.cursor >= len(self.proof):
            raise ChannelError("transcript exhausted")
        m = self.proof[self.cursor]
        self.cursor += 1
        return m

    def read(self) -> bytes:
        """Consume a prover message, updating state exactly like send."""
        m = self._next()
        self.state = _absorb(self.state, m)
        return m

    def receive_random_int(self, min_: int, max_: int, show_in_proof: bool = False) -> int:
        if self.state == "":
            raise ChannelError("receive_* before any message")
        state_int = int(self.state, 16)
        rng = (max_ - min_) + 1
        if rng <= 0:
            # the verifier is the adversarial-input surface — guard like
            # the prover twin (channel.rs has no such guard; a rng <= 0
            # would be a bare ZeroDivisionError otherwise)
            raise ChannelError(f"empty range [{min_}, {max_}]")
        num = (state_int + min_) % rng
        self.state = _sha256_hex(self.state)
        num64 = num & _MASK64
        if show_in_proof:
            # prover pushed the drawn value; consume and cross-check it
            m = self._next()
            if m != num64.to_bytes(8, "big"):
                raise ChannelError("transcript mismatch on shown random int")
        return num64

    def receive_random_field_element(self) -> FieldElement:
        num = self.receive_random_int(0, self.modulus - 1, False)
        m = self._next()
        if m != num.to_bytes(8, "big"):
            raise ChannelError("transcript mismatch on field element draw")
        return FieldElement(num, self.modulus)
