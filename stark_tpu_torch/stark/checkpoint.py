"""Checkpoint / resume (counterpart of ``stark_tpu/stark/checkpoint.py``).

The transcript IS the serialized prover state: proving is deterministic,
so recovery is "replay the log, verify the prefix, continue".
:func:`prove_resumable` runs the prover with a :class:`ReplayChannel`:

* while the transcript cursor is inside the checkpointed prefix, every
  message the recomputed pipeline produces is asserted byte-equal to the
  log, so nondeterminism or corruption after a restart raises
  :class:`ResumeMismatch` at once;
* past the prefix it behaves exactly like a fresh Channel;
* ``stop_after`` stops the prove at a phase boundary and returns a
  serializable :class:`ProverCheckpoint`.

A checkpoint carries the statement's identity ``(config, air_name,
air_params)``, so every family resumes: the hand-written AIRs rebuild
from their constructor arguments, the declarative AirSpecs re-bind
through the registry, and the field is the config's modulus.  Its JSON
is byte-identical to the JAX package's, so a checkpoint written by
either package resumes in the other.  Device state (LDE, trees, folds)
is recomputed on resume, on the prove's device.
"""

from __future__ import annotations

import dataclasses
import json

from stark_tpu_torch.channel.channel import Channel
from stark_tpu_torch.config import ProverConfig

PHASES = ("trace-commit", "composition", "fri-commit", "queries")


class ProverInterrupted(Exception):
    """Raised by the ReplayChannel at `stop_after` to unwind the prover."""

    def __init__(self, checkpoint: "ProverCheckpoint"):
        super().__init__(checkpoint.phase)
        self.checkpoint = checkpoint


class ResumeMismatch(Exception):
    """The recomputed transcript diverged from the checkpointed prefix."""


@dataclasses.dataclass
class ProverCheckpoint:
    config: ProverConfig
    air_name: str
    air_params: dict
    phase: str
    proof: list[bytes]
    phases: list[tuple[str, int]]

    def serialize(self) -> bytes:
        c = self.config
        return json.dumps(
            {
                "config": {
                    "modulus": c.modulus, "generator": c.generator,
                    "log2_trace": c.log2_trace, "blowup": c.blowup,
                    "num_queries": c.num_queries,
                },
                "air": self.air_name,
                "air_params": self.air_params,
                "phase": self.phase,
                "proof": [m.hex() for m in self.proof],
                "phases": self.phases,
            }
        ).encode()

    @classmethod
    def deserialize(cls, data: bytes) -> "ProverCheckpoint":
        o = json.loads(data.decode())
        c = o["config"]
        return cls(
            config=ProverConfig(
                modulus=c["modulus"], generator=c["generator"],
                log2_trace=c["log2_trace"], blowup=c["blowup"],
                num_queries=c["num_queries"]),
            air_name=o["air"],
            air_params=o["air_params"],
            phase=o["phase"],
            proof=[bytes.fromhex(m) for m in o["proof"]],
            phases=[tuple(p) for p in o["phases"]],
        )


class ReplayChannel(Channel):
    """A channel that checks its sends against a checkpointed prefix and
    interrupts the prove at a phase boundary.

    `phase_accurate` keeps the prover on its per-phase path: the
    single-fetch path runs the whole prove on the device before any
    mark_phase, so a checkpoint taken there would save no device work."""

    phase_accurate = True

    def __init__(self, modulus: int, saved: list[bytes],
                 stop_after: str | None, cfg: ProverConfig, air_name: str,
                 air_params: dict):
        super().__init__(modulus)
        self._saved = list(saved)
        self._stop_after = stop_after
        self._cfg = cfg
        self._air_name = air_name
        self._air_params = air_params

    def _check(self, i: int, what: str) -> None:
        if i < len(self._saved) and self._saved[i] != self.proof[i]:
            raise ResumeMismatch(
                f"recomputed {what} {i} differs from the checkpoint "
                f"({self.proof[i][:16].hex()} != "
                f"{self._saved[i][:16].hex()})")

    def send(self, message: bytes) -> None:
        i = len(self.proof)
        super().send(message)
        self._check(i, "message")

    def receive_random_int(self, min_, max_, show_in_proof=False):
        i = len(self.proof)
        num = super().receive_random_int(min_, max_, show_in_proof)
        if show_in_proof:
            self._check(i, "random draw")
        return num

    def receive_random_field_element(self):
        i = len(self.proof)
        el = super().receive_random_field_element()
        self._check(i, "field draw")
        return el

    def mark_phase(self, label: str) -> None:
        # interrupt at the boundary AFTER the requested phase
        if (self._stop_after is not None and self.phases
                and self.phases[-1][0] == self._stop_after):
            raise ProverInterrupted(ProverCheckpoint(
                self._cfg, self._air_name, self._air_params,
                self._stop_after, [bytes(m) for m in self.proof],
                list(self.phases)))
        super().mark_phase(label)


def prove_resumable(cfg: ProverConfig, a1: int = 3141592,
                    resume: ProverCheckpoint | None = None,
                    stop_after: str | None = None, air=None,
                    device=None, mesh=None):
    """Prove with stop / resume support, any statement family, on
    `device` (the card unless the caller asks for the CPU), or sharded
    over `mesh` (a ``dist.mesh.Mesh``, as ``prove``: its per-phase mesh
    path, the device state recomputed sharded on resume).

    Returns a StarkProof, or a ProverCheckpoint when `stop_after` names a
    phase ('trace-commit', 'composition', 'fri-commit', 'queries').  With
    `resume`, the checkpointed transcript prefix is verified while the
    pipeline is recomputed, then proving continues.  `air` selects the
    statement as in ``prove``; on resume it may be omitted: the
    checkpoint names its AIR, which is rebuilt (a declarative spec must
    be registered, as importing its defining module does)."""
    from stark_tpu_torch.stark import prover as _prover
    from stark_tpu_torch.stark.air import FibonacciSquareAIR, rebuild_air

    if air is None:
        if resume is not None and resume.air_name != FibonacciSquareAIR.name:
            if a1 != 3141592:
                raise ValueError(
                    f"checkpoint is for {resume.air_name!r}; pass the "
                    "witness through air=, not a1=")
            air = rebuild_air(resume.air_name, resume.air_params)
        else:
            air = FibonacciSquareAIR(a1=a1)
    elif a1 != 3141592:
        raise ValueError("pass the witness through the AIR, not a1=")
    air_name, air_params = air.name, air.witness_params()
    if resume is not None:
        if resume.config != cfg:
            raise ValueError("checkpoint does not match config")
        if (resume.air_name, resume.air_params) != (air_name, air_params):
            raise ValueError("checkpoint does not match statement/witness")
        saved = resume.proof
    else:
        saved = []
    channel = ReplayChannel(cfg.modulus, saved, stop_after, cfg, air_name,
                            air_params)
    try:
        return _prover.prove(cfg, a1=a1, air=air, device=device,
                             channel=channel, mesh=mesh)
    except ProverInterrupted as e:
        return e.checkpoint
