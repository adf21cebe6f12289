# Copied from stark_tpu/utils/metrics.py (host-only): the port must not
# import stark_tpu, whose package init imports JAX.
"""Structured per-phase metrics.

Every prove records its phases' wall times and its counters (``proves``,
``proof_bytes``) in a collector; the prover daemon's ``stats`` op reads
:data:`GLOBAL`.  A multi-launch prove's phases are ``trace-lde``,
``trace-commit``, ``composition``, ``fri-commit`` and ``queries``; a
mega prove's (``stark/prover.py`` ``_prove_mega``, never under an
explicit collector, which asks for the synced split) ``trace-lde``,
``prove-device`` (refill and graph replay) and ``fetch-replay`` (the
one copy and the host transcript replay).
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field


@dataclass
class PhaseMetric:
    name: str
    wall_s: float = 0.0
    extra: dict = field(default_factory=dict)


@dataclass
class MetricsCollector:
    phases: list[PhaseMetric] = field(default_factory=list)
    counters: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str, **extra):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases.append(
                PhaseMetric(name, time.perf_counter() - t0, dict(extra))
            )

    def count(self, name: str, value=1):
        self.counters[name] = self.counters.get(name, 0) + value

    def to_dict(self) -> dict:
        return {
            "phases": [
                {"name": p.name, "wall_s": round(p.wall_s, 6), **p.extra}
                for p in self.phases
            ],
            "counters": dict(self.counters),
            "total_wall_s": round(sum(p.wall_s for p in self.phases), 6),
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict())


# process-global collector used by prove() when none is passed.  Phases
# recorded here do NOT synchronise the device (no overhead, so a phase's
# wall holds only what the host waited for, and queued device work falls
# in the next phase that waits); pass an explicit collector to
# prove(metrics=...) for an accurate split (each phase ends in
# torch.cuda.synchronize() on a CUDA device).
GLOBAL = MetricsCollector()
