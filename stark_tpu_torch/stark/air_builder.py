"""Declarative AIR builder (counterpart of ``stark_tpu/stark/air_builder.py``):
define a STARK statement once — columns, a step recurrence, boundary
conditions, optional explicit transition constraints — written against
an abstract field-ops handle ``f``, and run it under three adapters:

* the port's batched torch field (``Fp``, or ``Fp64Goldilocks`` on
  (hi, lo) limb planes) over the LDE, row shifts as rolls along the
  last axis — the composer;
* a scalar host field (:class:`ScalarField`, Python ints mod p) — the
  host trace loop and the verifier's ``cp_at`` mirror;
* a degree semiring (:class:`DegreeField`) — the composition degree,
  from which the FRI fold count and the minimum blowup follow.

Example — the two-column multiplicative Fibonacci (transcripts
byte-identical to the hand-written ``FibMulAIR``)::

    fibmul = AirSpec(
        name="fibmul-decl",
        columns=2,
        init=((("input", 1), ("b0", 2718281)),),   # one window row
        step=lambda f, rows, P: (rows[0][1], f.mul(rows[0][0], rows[0][1])),
        boundaries=(
            Boundary(column=0, row=0, public="input"),
            Boundary(column=1, row=0, public="b0"),
            Boundary(column=1, row=-1, public="output"),
        ),
    )
    proof = prove(cfg, air=fibmul())            # bind the default witness
    assert verify(proof)                        # the spec self-registers

When ``transitions`` is omitted it is derived from ``step``: one
constraint per column, ``rows[w][c] - step(rows[:w])[c]``.

The trace is a host loop over :class:`ScalarField` (the JAX package runs
the step in a device ``lax.scan``): exact, and Python, so it costs
seconds at 2^20 rows where the hand-written AIRs' C loops take ms.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from stark_tpu_torch.config import ProverConfig
from stark_tpu_torch.ntt.reference_ntt import root_of_unity
from stark_tpu_torch.stark.air import (AIR, _BaseContext, _host_ints,
                                      _host_trace)


# ---------------------------------------------------------------------------
# Field-ops adapters (the device adapter is fields.fp.Fp itself)
# ---------------------------------------------------------------------------
class ScalarField:
    """Host mod-p integers behind the same ops surface as ``Fp``."""

    __slots__ = ("p",)

    def __init__(self, p: int):
        self.p = p

    def const(self, v: int) -> int:
        return v % self.p

    def add(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.p

    def mul(self, a: int, b: int) -> int:
        return a * b % self.p

    def inv(self, a: int) -> int:
        if a % self.p == 0:
            raise ZeroDivisionError("inverse of zero")
        return pow(a, self.p - 2, self.p)


class DegreeField:
    """Degree semiring: values are polynomial degrees in units of the
    trace-interpolant degree (a trace cell = 1, a constant = 0); mul
    adds, add/sub take the max."""

    def const(self, v) -> int:
        return 0

    def add(self, a: int, b: int) -> int:
        return max(a, b)

    sub = add

    def mul(self, a: int, b: int) -> int:
        return a + b


# ---------------------------------------------------------------------------
# Spec dataclasses
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Boundary:
    """column value at trace row ``row`` (negative = from the end)
    equals the public input named ``public``."""

    column: int
    row: int
    public: str


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _horner(coeffs: list, x: int, p: int) -> int:
    """coeffs[0] + coeffs[1]·x + ... evaluated mod p (host ints)."""
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


def _periodic_coeffs(cycle, p: int) -> list:
    """The coefficients of K_hat, the interpolant of `cycle` over the
    size-L subgroup (a host inverse DFT)."""
    cyc = [v % p for v in cycle]
    L = len(cyc)
    hinv = pow(root_of_unity(p, L), p - 2, p)
    linv = pow(L, p - 2, p)
    return [linv * sum(cyc[i] * pow(hinv, i * m, p) for i in range(L)) % p
            for m in range(L)]


class AirSpec(AIR):
    """A declaratively-defined AIR, with the port's AIR interface
    (``host_trace``, ``host_publics``, ``context(cfg, device)``,
    ``cp_at``).

    Parameters
    ----------
    name:        registry key (proofs carry it; ``verify`` reconstructs
                 the spec through it — specs self-register on creation).
    columns:     number of trace columns C.
    init:        window of the first ``w`` trace rows, each row a tuple
                 of C entries; an entry is an int (fixed), or a
                 ``(witness_name, default)`` pair bindable per instance
                 via ``spec(witness_name=...)``.
    step:        ``step(f, rows, params) -> tuple[C]`` — row ``i+w``
                 from the window ``rows[0..w-1]``.  Drives the trace AND
                 (by default) the transition constraints.
    boundaries:  Boundary constraints; exactly one must bind the public
                 ``"input"`` and one ``"output"``.
    transitions: optional ``fn(f, rows, params) -> tuple`` of constraint
                 expressions over the shift window (``rows[k]`` = shift
                 ``shifts[k]``); default: derived from ``step``.
    shifts:      row shifts the constraints read; default ``(0..w)``.
    params:      public parameters (name -> default int), the ``P`` dict
                 of ``step``/``transitions``, carried in the publics.
    periodic:    name -> cycle of ints (power-of-two length L); the value
                 at base row i is ``cycle[i mod L]``.  Constraint-side it
                 is the interpolant K(x) = K_hat(x^(N/L)): ``blowup*L``
                 host-built points tiled over the domain, and a scalar
                 Horner in the verifier mirror.
    """

    def __init__(
        self,
        name: str,
        columns: int,
        init: Sequence[Sequence],
        step: Callable,
        boundaries: Sequence[Boundary],
        transitions: Callable | None = None,
        shifts: Sequence[int] | None = None,
        params: dict | None = None,
        periodic: dict | None = None,
        register: bool = True,
    ):
        self.name = name
        self.num_columns = int(columns)
        self.init = tuple(tuple(row) for row in init)
        self.step = step
        self.boundaries = tuple(boundaries)
        self.params_spec = dict(params or {})
        self.periodic = {
            k: tuple(int(v) for v in cyc) for k, cyc in (periodic or {}).items()
        }
        for k, cyc in self.periodic.items():
            L = len(cyc)
            if L < 1 or L & (L - 1):
                raise ValueError(
                    f"periodic {k!r}: cycle length must be a power of two, "
                    f"got {L}"
                )
        overlap = set(self.periodic) & set(self.params_spec)
        if overlap:
            raise ValueError(
                f"names bound as both param and periodic: {sorted(overlap)}"
            )
        self.window = len(self.init)
        if self.window < 1:
            raise ValueError("init must contain at least one window row")
        for row in self.init:
            if len(row) != self.num_columns:
                raise ValueError(
                    f"init rows must have {self.num_columns} entries"
                )
        self.shifts = (
            tuple(shifts) if shifts is not None
            else tuple(range(self.window + 1))
        )
        if self.shifts[0] != 0 or list(self.shifts) != sorted(set(self.shifts)):
            raise ValueError("shifts must be sorted, unique, starting at 0")
        if transitions is None:
            if self.shifts != tuple(range(self.window + 1)):
                raise ValueError(
                    "auto-derived transitions need shifts == (0..window)"
                )
            w = self.window

            def _auto(f, rows, P):
                nxt = _as_tuple(self.step(f, rows[:w], P))
                return tuple(
                    f.sub(rows[w][c], nxt[c]) for c in range(self.num_columns)
                )

            self.transitions = _auto
        else:
            self.transitions = lambda f, rows, P: _as_tuple(
                transitions(f, rows, P)
            )

        pubs = [b.public for b in self.boundaries]
        if len(set(pubs)) != len(pubs):
            raise ValueError("duplicate boundary public names")
        for required in ("input", "output"):
            if required not in pubs:
                raise ValueError(
                    f'boundaries must bind a public named "{required}"'
                )
        overlap = set(pubs) & (set(self.params_spec) | set(self.periodic))
        if overlap:
            raise ValueError(f"publics double-bound: {sorted(overlap)}")

        # degree inference (cfg-independent units): trace cell = 1; a
        # periodic interpolant has deg (L-1)·N/L <= N-2 for L <= N/2, so
        # one trace-unit is its exact ceiling
        df = DegreeField()
        deg_rows = tuple(
            tuple(1 for _ in range(self.num_columns)) for _ in self.shifts
        )
        deg_params = {k: 0 for k in self.params_spec}
        deg_params.update({k: 1 for k in self.periodic})
        self._trans_degrees = tuple(
            int(d) for d in self.transitions(df, deg_rows, deg_params)
        )
        if not self._trans_degrees:
            raise ValueError("at least one transition constraint required")
        self.num_alphas = len(self.boundaries) + len(self._trans_degrees)

        # instance witness/params (defaults; bind via spec(**overrides))
        self._witness = {}
        for row in self.init:
            for entry in row:
                if isinstance(entry, tuple):
                    wname, default = entry
                    self._witness[wname] = int(default)
        self._param_values = dict(self.params_spec)

        if register:
            _REGISTRY[name] = self

    # -- instance binding ---------------------------------------------------
    def __call__(self, **overrides) -> "AirSpec":
        """A bound copy with witness/param values overridden by name."""
        bound = copy.copy(self)
        bound._witness = dict(self._witness)
        bound._param_values = dict(self._param_values)
        for k, v in overrides.items():
            if k in bound._witness:
                bound._witness[k] = int(v)
            elif k in bound._param_values:
                bound._param_values[k] = int(v)
            else:
                raise ValueError(f"unknown witness/param {k!r}")
        return bound

    def witness_params(self) -> dict:
        return {"witness": dict(self._witness),
                "params": dict(self._param_values)}

    def _init_values(self) -> tuple:
        return tuple(
            tuple(
                self._witness[e[0]] if isinstance(e, tuple) else int(e)
                for e in row
            )
            for row in self.init
        )

    @property
    def context_key(self) -> tuple:
        """What a composer context depends on beyond (config, device): the
        spec's structure and its constraint functions (the same objects in
        every bound copy; the witness and the params are not in it)."""
        return (self.num_columns, self.shifts,
                tuple((b.column, b.row, b.public) for b in self.boundaries),
                tuple(sorted(self.params_spec)),
                tuple(sorted(self.periodic.items())),
                self.step, self.transitions)

    # -- AIR interface --------------------------------------------------
    def validate(self, cfg: ProverConfig) -> None:
        cfg.validate()
        folds = self.num_folds(cfg)
        if cfg.eval_domain_size >> folds < 2:
            need = 2 << folds >> cfg.log2_trace
            raise ValueError(
                f"{self.name}: composition degree needs blowup >= {need}"
            )
        T = cfg.trace_length
        for b in self.boundaries:
            r = b.row if b.row >= 0 else T + b.row
            if not 0 <= r < T:
                raise ValueError(f"boundary row {b.row} outside trace (T={T})")
        N = cfg.trace_domain_size
        for k, cyc in self.periodic.items():
            if len(cyc) > N // 2:
                raise ValueError(
                    f"periodic {k!r}: cycle length {len(cyc)} > N/2 = "
                    f"{N // 2} (the degree-1-unit ceiling needs L <= N/2)"
                )

    def num_folds(self, cfg: ProverConfig) -> int:
        T = cfg.trace_length
        w = max(self.shifts)
        # transition quotient degree: deg(expr) - deg(divisor), where the
        # divisor (x^N - 1) / prod(excluded) has degree T - w
        quot = max(u * (T - 1) - (T - w) for u in self._trans_degrees)
        quot = max(quot, T - 2)  # boundary quotients: (T-1) - 1
        return max(1, quot.bit_length())

    def host_trace(self, cfg: ProverConfig):
        """The trace as numpy storage words ((T,) or (C, T) u32; (2, T) or
        (C, 2, T) limb planes for Goldilocks), from a host loop of the
        step over Python ints: row t + w is the step of rows t..t+w-1
        with the periodic values of row t, as the JAX ``lax.scan``."""
        p, T, C = cfg.modulus, cfg.trace_length, self.num_columns
        f = ScalarField(p)
        P = {k: v % p for k, v in self._param_values.items()}
        cycles = [(k, [v % p for v in cyc])
                  for k, cyc in self.periodic.items()]
        window = tuple(tuple(v % p for v in row)
                       for row in self._init_values())
        step = self.step
        cols = [[] for _ in range(C)]
        for t in range(T):
            for c in range(C):
                cols[c].append(window[0][c])
            for k, cyc in cycles:
                P[k] = cyc[t % len(cyc)]
            window = window[1:] + (_as_tuple(step(f, window, P)),)
        values = np.array(cols if C > 1 else cols[0], dtype=np.uint64)
        return _host_trace(values, cfg)

    def host_publics(self, trace_host, width: int) -> dict:
        T = trace_host.shape[-1]
        by_name = {
            b.public: _host_ints(trace_host, b.row if b.row >= 0
                                 else T + b.row, width)[b.column]
            for b in self.boundaries
        }
        out = {"input": by_name.pop("input"), "output": by_name.pop("output")}
        out.update(by_name)
        out.update(self._param_values)
        return out

    def context(self, cfg: ProverConfig, device,
                block=None) -> "_SpecContext":
        return _SpecContext(cfg, self, device, block)

    def cp_at(self, cfg: ProverConfig, x: int, opened, alphas,
              publics: dict) -> int:
        """Host value of the composition polynomial at x from the opened
        rows (the verifier's side of the composer)."""
        p, N, T = cfg.modulus, cfg.trace_domain_size, cfg.trace_length
        f = ScalarField(p)
        g = root_of_unity(p, N)
        rows = tuple(
            (v,) if not isinstance(v, (tuple, list)) else tuple(v)
            for v in opened
        )
        terms = [
            (rows[0][b.column] - publics[b.public])
            * f.inv((x - pow(g, b.row if b.row >= 0 else T + b.row, p)) % p)
            % p
            for b in self.boundaries
        ]
        excl = 1
        for i in range(T - max(self.shifts), N):
            excl = excl * (x - pow(g, i, p)) % p
        tm = excl * f.inv((pow(x, N, p) - 1) % p) % p
        pdict = {k: publics[k] % p for k in self.params_spec}
        for name, cyc in self.periodic.items():
            pdict[name] = _horner(_periodic_coeffs(cyc, p),
                                  pow(x, N // len(cyc), p), p)
        terms += [e * tm % p for e in self.transitions(f, rows, pdict)]
        return sum(a * t % p for a, t in zip(alphas, terms)) % p


class _SpecContext(_BaseContext):
    """The composer of a spec: boundary and transition zerofier inverses
    and the periodic columns' evaluations on the LDE domain (device)."""

    def __init__(self, cfg: ProverConfig, spec: AirSpec, device,
                 block=None):
        super().__init__(cfg, device, block)
        p, g, N, T = cfg.modulus, self.g, self.N, cfg.trace_length
        self.spec = spec
        self.compose_publics = tuple(dict.fromkeys(
            [b.public for b in spec.boundaries] + sorted(spec.params_spec)))
        # one inverse table per boundary row (tribmul binds three publics
        # at row 0)
        rows = {b.row if b.row >= 0 else T + b.row for b in spec.boundaries}
        inv = {r: self.boundary_inv(pow(g, r, p)) for r in rows}
        self.binvs = tuple(inv[b.row if b.row >= 0 else T + b.row]
                           for b in spec.boundaries)
        w = max(spec.shifts)
        self.trans_mult = self.zerofier_inv_excluding(
            tuple(pow(g, i, p) for i in range(T - w, N)))
        # periodic columns: K(x) = K_hat(x^(N/L)).  Over the coset
        # {off·W^j} the argument x^(N/L) cycles with period blowup·L, so
        # K over the domain is blowup·L host-built points tiled
        # M/(blowup·L) times along the lanes (a block's lanes: the
        # points from start mod blowup·L on, tiled over its size)
        start, size = block or (0, self.M)
        self.periodic = {}
        for name, cyc in spec.periodic.items():
            coeffs = _periodic_coeffs(cyc, p)
            bl = cfg.blowup * len(cyc)
            wb = root_of_unity(p, bl)
            off = pow(cfg.offset, N // len(cyc), p)
            evals = [_horner(coeffs, off * pow(wb, j, p) % p, p)
                     for j in range(bl)]
            small = self.fp.array(evals, self.device)  # (bl,) or (2, bl)
            small = torch.roll(small, -(start % bl), -1)
            self.periodic[name] = small.tile((-(-size // bl),))[..., :size]

    def compose(self, lde: torch.Tensor, alphas, publics: dict):
        """The composition polynomial on the LDE domain (int32 storage).
        `lde`: (M,) or (C, M); (2, M) or (C, 2, M) limb planes for
        Goldilocks (a column is taken first, then rolled along its
        lanes)."""
        f = self.fp
        spec = self.spec
        blw = self.cfg.blowup
        al = [self._const(a) for a in alphas]
        cols = (tuple(self.column(lde, c) for c in range(spec.num_columns))
                if spec.num_columns > 1 else (lde,))
        rows = tuple(tuple(self.shift(col, s * blw) for col in cols)
                     for s in spec.shifts)
        terms = [
            f.mul(f.sub(rows[0][b.column], self._const(publics[b.public])),
                  bi)
            for b, bi in zip(spec.boundaries, self.binvs)
        ]
        pdict = {k: self._const(publics[k]) for k in spec.params_spec}
        pdict.update(self.periodic)
        terms += [f.mul(e, self.trans_mult)
                  for e in spec.transitions(f, rows, pdict)]
        acc = f.mul(al[0], terms[0])
        for a, t in zip(al[1:], terms[1:]):
            acc = f.add(acc, f.mul(a, t))
        return f.storage(acc)


# ---------------------------------------------------------------------------
# Registry (verify() reconstructs specs by proof.air_name through here)
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, AirSpec] = {}


def lookup_spec(name: str) -> AirSpec | None:
    return _REGISTRY.get(name)


def register_spec(spec: AirSpec) -> AirSpec:
    _REGISTRY[spec.name] = spec
    return spec
