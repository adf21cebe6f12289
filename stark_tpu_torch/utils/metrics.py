# Copied from stark_tpu/utils/metrics.py (host-only): the port must not
# import stark_tpu, whose package init imports JAX.
"""Structured per-phase metrics and the prove's spans.

Every prove records its phases' wall times and its counters (``proves``,
``proof_bytes``) in a collector; the prover daemon's ``stats`` op reads
:data:`GLOBAL`.  A multi-launch prove's phases are ``trace-lde``,
``trace-commit``, ``composition``, ``fri-commit`` and ``queries``; a
mega prove's (``stark/prover.py`` ``_prove_mega``, never under an
explicit collector, which asks for the synced split) ``trace-lde``,
``prove-device`` (refill and graph replay) and ``fetch-replay`` (the
one copy and the host transcript replay).

A span is a phase's generalisation: each phase is a prove's top-level
span, and :func:`span` opens one nested under whatever span is open.
The spans below the phases are ``host-trace`` (the AIR's host trace or
the given trace, with the publics), ``intt`` (the trace polynomial) and
``coset-ntt`` (the LDE) in ``trace-lde``; a ``fri-draw`` (the absorb of
the last layer's root and the draw of beta), a ``fold`` and a
``layer-tree`` for each fold in ``fri-commit``, with one more
``layer-tree`` for layer 0; ``host-replay`` (the host transcript replay
after the one fetch) in ``queries`` or a mega prove's ``fetch-replay``.
What the device does inside a span the host does not wait for: only a
phase of an explicit collector ends in a device synchronise.

A span records when it runs inside ``prove(metrics=...)`` with an
explicit collector: a :class:`Span` in that collector's ``spans``, with
its parent and the prove's identifier.  When a ``torch.profiler`` is
recording, every span, the phases included, is also a
``record_function`` range named ``span:<name>``, so the host range and
the kernels launched inside it share the profiler's clock (a
``utils.logging.profile_trace`` of a prove shows them beside the
kernels).  With neither, a span below a phase is a shared no-op context.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import threading
import time
from dataclasses import dataclass, field

import torch
from torch.autograd import profiler as _autograd_profiler


@dataclass
class PhaseMetric:
    name: str
    wall_s: float = 0.0
    extra: dict = field(default_factory=dict)


@dataclass
class Span:
    """One span of a prove on ``time.perf_counter()``: `parent` is the
    index in the collector's ``spans`` of the span it nests under (None
    for a phase), `prove` the identifier its prove's spans share."""
    name: str
    start_s: float
    end_s: float
    parent: int | None
    prove: int


@dataclass(frozen=True)
class _Scope:
    collector: MetricsCollector | None  # None: only a profiler sees spans
    prove: int
    parent: int | None


_SCOPE: contextvars.ContextVar = contextvars.ContextVar(
    "stark_tpu_torch_span_scope", default=None)
_PROVES = itertools.count(1)
_NOOP = contextlib.nullcontext()


def span(name: str):
    """A span named `name` under the open span (module docstring): a
    no-op outside an explicit collector's prove with no profiler
    recording."""
    scope = _SCOPE.get()
    if ((scope is None or scope.collector is None)
            and not _autograd_profiler._is_profiler_enabled):
        return _NOOP
    return _open_span(scope, name)


@contextlib.contextmanager
def _open_span(scope: _Scope | None, name: str):
    ranged = (torch.profiler.record_function(f"span:{name}")
              if _autograd_profiler._is_profiler_enabled else _NOOP)
    with ranged:
        if scope is None or scope.collector is None:
            yield
            return
        spans = scope.collector.spans
        s = Span(name, time.perf_counter(), float("nan"), scope.parent,
                 scope.prove)
        token = _SCOPE.set(_Scope(scope.collector, scope.prove, len(spans)))
        spans.append(s)
        try:
            yield
        finally:
            s.end_s = time.perf_counter()
            _SCOPE.reset(token)


@contextlib.contextmanager
def proving(metrics: MetricsCollector | None):
    """The scope of one prove: yields the collector its phases record
    into (`metrics`, or :data:`GLOBAL` when None), and makes `metrics`
    the collector of its spans under a fresh prove identifier."""
    mx = metrics if metrics is not None else GLOBAL
    mx.begin_prove()
    token = _SCOPE.set(_Scope(metrics, next(_PROVES), None))
    try:
        yield mx
    finally:
        _SCOPE.reset(token)


@dataclass
class MetricsCollector:
    phases: list[PhaseMetric] = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    spans: list[Span] = field(default_factory=list)

    def begin_prove(self) -> None:
        """Called as a prove starts; this collector keeps every prove's
        phases and spans."""

    @contextlib.contextmanager
    def phase(self, name: str, **extra):
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            self._add_phase(
                PhaseMetric(name, time.perf_counter() - t0, dict(extra)))

    def _add_phase(self, ph: PhaseMetric) -> None:
        self.phases.append(ph)

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


@dataclass
class PhaseTotals(MetricsCollector):
    """A collector bounded over any number of proves: `phases` holds the
    last prove's phases only, `totals` each phase name's ``count``,
    ``total_s`` and ``max_s`` over every prove."""
    totals: dict = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    def begin_prove(self) -> None:
        self.phases = []

    def _add_phase(self, ph: PhaseMetric) -> None:
        self.phases.append(ph)
        with self._lock:
            t = self.totals.setdefault(
                ph.name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
            t["count"] += 1
            t["total_s"] += ph.wall_s
            t["max_s"] = max(t["max_s"], ph.wall_s)

    def to_dict(self) -> dict:
        with self._lock:
            totals = {n: {"count": t["count"],
                          "total_s": round(t["total_s"], 6),
                          "max_s": round(t["max_s"], 6)}
                      for n, t in self.totals.items()}
        return {**super().to_dict(), "totals": totals}


# process-global collector used by prove() when none is passed.  Phases
# recorded here do NOT synchronise the device (no overhead, so a phase's
# wall holds only what the host waited for, and queued device work falls
# in the next phase that waits), and no span records here; pass an
# explicit collector to prove(metrics=...) for an accurate split (each
# phase ends in torch.cuda.synchronize() on a CUDA device) and the spans.
GLOBAL = PhaseTotals()
