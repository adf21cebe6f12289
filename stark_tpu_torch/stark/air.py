"""The hand-written AIRs and their per-config contexts (counterpart of
``stark_tpu/stark/air.py``):

* :class:`FibonacciSquareAIR` — STARK-101's a_{i+2} = a_{i+1}^2 + a_i^2
  (degree-2 transition, CP degree < N, log2(N) folds); publics a_0 and
  a_{T-1}.
* :class:`MimcAIR` — the MiMC cube chain x_{i+1} = (x_i + k)^3 (degree 3,
  CP degree < 2N: one more fold, blowup >= 4); publics input, output, k.
* :class:`FibMulAIR` — the two-column a_{i+1} = b_i, b_{i+1} = a_i * b_i
  (a (2, T) trace, row-leaf commitment, row openings); publics input,
  output, b0.

Each context holds the LDE coset domain and the boundary / zerofier
inverse tables on the device; the composition is pointwise torch ops on
them and on the LDE rolled by the blowup along its last axis, so it also
composes a batch of proofs at once (``stark/batch.py``: a leading batch
axis of lanes, the publics and alphas as tensors broadcast over it).  Every AIR
runs over a u32 field or the Goldilocks field: there a column is (2, M)
limb planes (a C-column LDE (C, 2, M)), constants are (2, 1) pairs and
the drawn alphas (2,) pairs, so the same code broadcasts plane by
plane.  The
declarative AirSpecs are ``air_builder.py`` and ``families.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from stark_tpu_torch import native
from stark_tpu_torch.config import ProverConfig
from stark_tpu_torch.fields.fp import Fp, host_values, host_words
from stark_tpu_torch.ntt.reference_ntt import root_of_unity


class _BaseContext:
    """Shared per-config tables: the LDE coset domain and its inverses.

    With `block` = (start, size) the tables cover only the LDE lanes
    start .. start + size - 1 (a shard's block of a mesh prove,
    ``dist/compose.py``), built directly, so S blocks cost one whole
    build; ``compose`` then takes that block followed by a halo of the
    lanes after it and reads row shifts as slices of it."""

    def __init__(self, cfg: ProverConfig, device, block=None):
        cfg.validate()
        p = cfg.modulus
        self.cfg = cfg
        self.fp = Fp.get(p)
        self.device = torch.device(device)
        self.N = cfg.trace_domain_size
        self.M = cfg.eval_domain_size
        self.g = root_of_unity(p, self.N)
        self.w = root_of_unity(p, self.M)
        self.block = block
        start, size = block or (0, self.M)
        self.domain = self.fp.coset_domain(
            cfg.offset * pow(self.w, start, p), self.w, size, self.device)

    def shift(self, lde: torch.Tensor, k: int) -> torch.Tensor:
        """The LDE at x * w^k for every lane x: rolled along the last axis
        over the whole domain, or lanes k .. k + size - 1 of a block with
        its halo."""
        if self.block is not None:
            return lde[..., k:k + self.block[1]]
        return lde if k == 0 else torch.roll(lde, -k, -1)

    def _const(self, value) -> torch.Tensor:
        """A broadcastable constant: 0-dim, or a (2, 1) pair (JAX ``_bc``);
        a tensor (a batch's publics, ``stark/batch.py``, or a view of
        :meth:`compose_args`) passes through."""
        if torch.is_tensor(value):
            return value
        return self.fp.const(value, self.device)

    # the publics ``compose`` reads, in the order of compose_args' buffer
    compose_publics: tuple = ()

    def compose_args(self, publics: dict) -> dict:
        """The publics ``compose`` reads (``compose_publics``) as device
        constants from one upload (JAX ``compose_args``): {name: a 0-dim
        tensor, or a (2, 1) pair}, which ``compose`` takes in place of
        the ints.  The single-dispatch prove keeps such a buffer static
        (:meth:`public_views`) and refills it before each replay, so a
        captured graph reads each statement's publics, not the first's."""
        return self.public_views(self.fp.array(
            [publics[k] for k in self.compose_publics], self.device))

    def public_views(self, values: torch.Tensor) -> dict:
        """{name: view} of a (K,) int64 buffer of the K compose publics,
        or of its (2, K) limb planes."""
        if self.fp.width == 2:
            return {k: values[:, i:i + 1]
                    for i, k in enumerate(self.compose_publics)}
        return {k: values[i] for i, k in enumerate(self.compose_publics)}

    def column(self, lde: torch.Tensor, c: int) -> torch.Tensor:
        """Column c of a C-column LDE: (C, M) u32 words, or (B, C, M) for a
        batch of B proofs (``stark/batch.py``); (C, 2, M) Goldilocks limb
        planes."""
        return lde[..., c, :, :] if self.fp.width == 2 else lde[..., c, :]

    def boundary_inv(self, point: int) -> torch.Tensor:
        """1 / (x - point) on the LDE domain (int32 storage)."""
        f = self.fp
        return f.storage(f.inv_rolled(f.sub(self.domain,
                                            self._const(point))))

    def zerofier_inv_excluding(self, excluded) -> torch.Tensor:
        """prod(x - e for e in excluded) / (x^N - 1) on the LDE domain."""
        f = self.fp
        xn = f.pow_static(self.domain, self.N)
        mult = f.inv_rolled(f.sub(xn, self._const(1)))
        for e in excluded:
            mult = f.mul(mult, f.sub(self.domain, self._const(e)))
        return f.storage(mult)


class _FibContext(_BaseContext):
    compose_publics = ("a0", "a_last")

    def __init__(self, cfg: ProverConfig, device, block=None):
        super().__init__(cfg, device, block)
        p, g, N = cfg.modulus, self.g, self.N
        self.inv_b0 = self.boundary_inv(1)
        self.inv_b1 = self.boundary_inv(pow(g, N - 2, p))
        self.trans_mult = self.zerofier_inv_excluding(
            (pow(g, N - 3, p), pow(g, N - 2, p), pow(g, N - 1, p)))

    def compose(self, lde: torch.Tensor, alphas, publics: dict):
        """The composition polynomial on the LDE domain (int32 storage).
        `alphas`: three device scalars (DeviceFS draws) or ints."""
        f = self.fp
        b = self.cfg.blowup
        al = [self._const(a) for a in alphas]
        f_x, f_gx, f_g2x = (self.shift(lde, k * b) for k in range(3))
        p0 = f.mul(f.sub(f_x, self._const(publics["a0"])), self.inv_b0)
        p1 = f.mul(f.sub(f_x, self._const(publics["a_last"])), self.inv_b1)
        num = f.sub(f.sub(f_g2x, f.mul(f_gx, f_gx)), f.mul(f_x, f_x))
        p2 = f.mul(num, self.trans_mult)
        return f.storage(f.add(f.add(f.mul(al[0], p0), f.mul(al[1], p1)),
                               f.mul(al[2], p2)))


def _host_trace(values, cfg: ProverConfig):
    """A native trace (numpy uint64 values) in the storage words of the
    configuration's field: (T,) or (C, T) u32, (2, T) or (C, 2, T) limb
    planes for Goldilocks."""
    return host_words(values, Fp.get(cfg.modulus).width)


def _host_ints(trace_host, index: int, width: int) -> list[int]:
    """Each column's value at trace position `index`, from the storage
    words of :func:`_host_trace` in a field of `width` limbs, as Python
    ints (only that position is converted: a whole 2^24-row trace would
    cost a copy of every word)."""
    i = index % trace_host.shape[-1]
    vals = host_values(trace_host[..., i:i + 1], width)
    return [int(v) for v in vals.reshape(-1)]


class AIR:
    """The interface the prover calls (counterpart of the JAX ``AIR`` base
    class).  A subclass is a light descriptor of one statement; its
    per-config tables live in its context.

    * ``host_trace(cfg)``: the trace as numpy storage words, from the host;
    * ``host_publics(trace_host, width)``: the public statement read off
      those words (a field of `width` u32 limbs);
    * ``num_folds(cfg)``: FRI folds until the composition's degree is 0;
    * ``context(cfg, device, block)``: the composition's tables on
      `device` (a block of lanes for a mesh shard), whose ``compose`` the
      prover calls, and ``cp_at`` its host mirror for the verifier;
    * ``witness_params()``: the JSON arguments that rebuild the instance
      (``rebuild_air``, checkpoint / resume)."""

    name: str = "abstract"
    shifts: tuple[int, ...] = (0,)
    num_alphas: int = 0
    num_columns: int = 1  # trace columns; > 1 commits rows (from_columns)

    def validate(self, cfg: ProverConfig) -> None:
        cfg.validate()

    def host_trace(self, cfg: ProverConfig):
        raise NotImplementedError

    def host_publics(self, trace_host, width: int) -> dict:
        raise NotImplementedError

    def num_folds(self, cfg: ProverConfig) -> int:
        raise NotImplementedError

    def context(self, cfg: ProverConfig, device, block=None):
        raise NotImplementedError

    def cp_at(self, cfg: ProverConfig, x: int, opened, alphas,
              publics: dict) -> int:
        raise NotImplementedError

    def witness_params(self) -> dict:
        raise NotImplementedError

    def publics_from_host(self, cfg: ProverConfig, trace_host) -> dict:
        """The public statement of the host trace of `cfg`."""
        return self.host_publics(trace_host, Fp.get(cfg.modulus).width)

    def build_trace(self, cfg: ProverConfig, device="cuda"):
        """The trace uploaded to `device` as storage words (``trace.py``
        ``upload_trace``, which records its endpoints)."""
        from stark_tpu_torch.stark.trace import upload_trace

        width = Fp.get(cfg.modulus).width
        return upload_trace(host_values(self.host_trace(cfg), width),
                            cfg.modulus, device)

    def publics(self, trace) -> dict:
        """The public statement of a trace of storage words (a tensor, as
        :meth:`build_trace` returns, or an array), read on the host; the
        field's width is the words' rank beyond the columns."""
        words = np.asarray(trace.cpu() if torch.is_tensor(trace) else trace)
        return self.host_publics(words,
                                 words.ndim - (self.num_columns > 1))


class FibonacciSquareAIR(AIR):
    """a_{i+2} = a_{i+1}^2 + a_i^2; publics a_0 and a_{T-1}."""

    name = "fibonacci-square"
    shifts = (0, 1, 2)
    num_alphas = 3
    num_columns = 1

    def __init__(self, a1: int = 3141592, a0: int = 1):
        self.a0 = a0
        self.a1 = a1

    def host_trace(self, cfg: ProverConfig):
        """The trace as numpy uint32 storage words, from the native host
        loop (host code whatever the prove's device)."""
        return _host_trace(native.fib_trace(cfg.modulus, self.a0, self.a1,
                                            cfg.trace_length), cfg)

    def host_publics(self, trace_host, width: int) -> dict:
        return {"a0": _host_ints(trace_host, 0, width)[0],
                "a_last": _host_ints(trace_host, -1, width)[0]}

    def witness_params(self) -> dict:
        return {"a1": self.a1, "a0": self.a0}

    def num_folds(self, cfg: ProverConfig) -> int:
        return cfg.log2_trace  # CP degree < N

    def context(self, cfg: ProverConfig, device, block=None) -> _FibContext:
        return _FibContext(cfg, device, block)

    def cp_at(self, cfg: ProverConfig, x: int, opened, alphas,
              publics: dict) -> int:
        """Host value of the composition polynomial at x from the openings
        f(x), f(gx), f(g^2 x) — the verifier's side of ``compose``."""
        p, N = cfg.modulus, cfg.trace_domain_size
        g = root_of_unity(p, N)
        fx, fgx, fg2x = opened
        a0, a_last = publics["a0"], publics["a_last"]
        p0 = (fx - a0) * pow((x - 1) % p, p - 2, p) % p
        p1 = (fx - a_last) * pow((x - pow(g, N - 2, p)) % p, p - 2, p) % p
        num = (fg2x - fgx * fgx - fx * fx) % p
        cubic = ((x - pow(g, N - 3, p)) * (x - pow(g, N - 2, p))
                 * (x - pow(g, N - 1, p))) % p
        zn_inv = pow((pow(x, N, p) - 1) % p, p - 2, p)
        p2 = num * cubic * zn_inv % p
        return (alphas[0] * p0 + alphas[1] * p1 + alphas[2] * p2) % p


def _inv(x: int, p: int) -> int:
    return pow(x % p, p - 2, p)


class _NextRowContext(_BaseContext):
    """The tables of an AIR whose transition reads rows i and i + 1
    (MiMC³, FibMul): boundaries at g^0 and g^(N-2), the transition at
    g^0..g^(T-2)."""

    def __init__(self, cfg: ProverConfig, device, block=None):
        super().__init__(cfg, device, block)
        p, g, N = cfg.modulus, self.g, self.N
        self.inv_b0 = self.boundary_inv(1)
        self.inv_b1 = self.boundary_inv(pow(g, N - 2, p))
        self.trans_mult = self.zerofier_inv_excluding(
            (pow(g, N - 2, p), pow(g, N - 1, p)))


class _MimcContext(_NextRowContext):
    compose_publics = ("input", "output")

    def __init__(self, cfg: ProverConfig, k: int, device, block=None):
        super().__init__(cfg, device, block)
        self.k = k  # the round key is part of the context's cache key
        self.k_const = self._const(k)

    def compose(self, lde: torch.Tensor, alphas, publics: dict):
        f = self.fp
        b = self.cfg.blowup
        al = [self._const(a) for a in alphas]
        f_x, f_gx = self.shift(lde, 0), self.shift(lde, b)
        p0 = f.mul(f.sub(f_x, self._const(publics["input"])), self.inv_b0)
        p1 = f.mul(f.sub(f_x, self._const(publics["output"])), self.inv_b1)
        t = f.add(f_x, self.k_const)
        num = f.sub(f_gx, f.mul(f.mul(t, t), t))
        p2 = f.mul(num, self.trans_mult)
        return f.storage(f.add(f.add(f.mul(al[0], p0), f.mul(al[1], p1)),
                               f.mul(al[2], p2)))


class MimcAIR(AIR):
    """x_{i+1} = (x_i + k)^3 over GF(p); publics x_0 (input), x_{T-1}
    (output) and the round key k."""

    name = "mimc3"
    shifts = (0, 1)
    num_alphas = 3
    num_columns = 1

    def __init__(self, x0: int = 271828, k: int = 777):
        self.x0 = x0
        self.k = k

    def validate(self, cfg: ProverConfig) -> None:
        cfg.validate()
        if cfg.blowup < 4:
            raise ValueError("MimcAIR needs blowup >= 4 (CP degree < 2N)")

    def host_trace(self, cfg: ProverConfig):
        return _host_trace(native.mimc_trace(cfg.modulus, self.x0, self.k,
                                             cfg.trace_length), cfg)

    def host_publics(self, trace_host, width: int) -> dict:
        return {"input": _host_ints(trace_host, 0, width)[0],
                "output": _host_ints(trace_host, -1, width)[0], "k": self.k}

    def witness_params(self) -> dict:
        return {"x0": self.x0, "k": self.k}

    def num_folds(self, cfg: ProverConfig) -> int:
        return cfg.log2_trace + 1  # CP degree < 2N

    def context(self, cfg: ProverConfig, device, block=None) -> _MimcContext:
        return _MimcContext(cfg, self.k, device, block)

    def cp_at(self, cfg: ProverConfig, x: int, opened, alphas,
              publics: dict) -> int:
        p, N = cfg.modulus, cfg.trace_domain_size
        g = root_of_unity(p, N)
        fx, fgx = opened
        p0 = (fx - publics["input"]) * _inv(x - 1, p) % p
        p1 = (fx - publics["output"]) * _inv(x - pow(g, N - 2, p), p) % p
        t = (fx + publics["k"]) % p
        num = (fgx - t * t % p * t) % p
        excl = (x - pow(g, N - 2, p)) * (x - pow(g, N - 1, p)) % p
        p2 = num * excl * _inv(pow(x, N, p) - 1, p) % p
        return (alphas[0] * p0 + alphas[1] * p1 + alphas[2] * p2) % p


class _FibMulContext(_NextRowContext):
    compose_publics = ("input", "b0", "output")

    def compose(self, lde: torch.Tensor, alphas, publics: dict):
        """`lde`: the (2, M) LDE of the columns a and b ((2, 2, M) limb
        planes for Goldilocks)."""
        f = self.fp
        b = self.cfg.blowup
        al = [self._const(a) for a in alphas]
        a_lde, b_lde = self.column(lde, 0), self.column(lde, 1)
        a_x, b_x = self.shift(a_lde, 0), self.shift(b_lde, 0)
        a_gx, b_gx = self.shift(a_lde, b), self.shift(b_lde, b)
        terms = (
            f.mul(f.sub(a_x, self._const(publics["input"])), self.inv_b0),
            f.mul(f.sub(b_x, self._const(publics["b0"])), self.inv_b0),
            f.mul(f.sub(b_x, self._const(publics["output"])), self.inv_b1),
            f.mul(f.sub(a_gx, b_x), self.trans_mult),
            f.mul(f.sub(b_gx, f.mul(a_x, b_x)), self.trans_mult))
        acc = f.mul(al[0], terms[0])
        for a, term in zip(al[1:], terms[1:]):
            acc = f.add(acc, f.mul(a, term))
        return f.storage(acc)


class FibMulAIR(AIR):
    """a_{i+1} = b_i, b_{i+1} = a_i * b_i over GF(p), a two-column trace;
    publics a_0 (input), b_{T-1} (output) and b_0."""

    name = "fibmul"
    shifts = (0, 1)
    num_alphas = 5
    num_columns = 2

    def __init__(self, a0: int = 1, b0: int = 2718281):
        self.a0 = a0
        self.b0 = b0

    def host_trace(self, cfg: ProverConfig):
        """The (2, T) trace, rows a and b, as numpy uint32 storage words
        ((2, 2, T) for Goldilocks)."""
        return _host_trace(native.fibmul_trace(cfg.modulus, self.a0, self.b0,
                                               cfg.trace_length), cfg)

    def host_publics(self, trace_host, width: int) -> dict:
        (a0, b0), (_, b_last) = (_host_ints(trace_host, i, width)
                                 for i in (0, -1))
        return {"input": a0, "output": b_last, "b0": b0}

    def witness_params(self) -> dict:
        return {"a0": self.a0, "b0": self.b0}

    def num_folds(self, cfg: ProverConfig) -> int:
        return cfg.log2_trace  # CP degree < N

    def context(self, cfg: ProverConfig, device,
                block=None) -> _FibMulContext:
        return _FibMulContext(cfg, device, block)

    def cp_at(self, cfg: ProverConfig, x: int, opened, alphas,
              publics: dict) -> int:
        p, N = cfg.modulus, cfg.trace_domain_size
        g = root_of_unity(p, N)
        (ax, bx), (agx, bgx) = opened
        inv_x1 = _inv(x - 1, p)
        terms = (
            (ax - publics["input"]) * inv_x1 % p,
            (bx - publics["b0"]) * inv_x1 % p,
            (bx - publics["output"]) * _inv(x - pow(g, N - 2, p), p) % p)
        quad = (x - pow(g, N - 2, p)) * (x - pow(g, N - 1, p)) % p
        tm = quad * _inv(pow(x, N, p) - 1, p) % p
        terms += ((agx - bx) * tm % p, (bgx - ax * bx) * tm % p)
        return sum(al * t % p for al, t in zip(alphas, terms)) % p


def air_from_name(name: str, publics: dict):
    """The verifier-side AIR a proof names, from its publics (as
    ``stark_tpu/stark/air.py:597-611``): a registered AirSpec first, then
    the hand-written AIRs."""
    import stark_tpu_torch.stark.families  # noqa: F401  (registers them)
    from stark_tpu_torch.stark.air_builder import lookup_spec

    spec = lookup_spec(name)
    if spec is not None:
        return spec
    if name == FibonacciSquareAIR.name:
        return FibonacciSquareAIR(a0=publics.get("a0", 1))
    if name == MimcAIR.name:
        return MimcAIR(x0=publics.get("input", 0), k=publics.get("k", 0))
    if name == FibMulAIR.name:
        return FibMulAIR(a0=publics.get("input", 1), b0=publics.get("b0", 1))
    raise ValueError(f"unknown AIR {name!r}")


def rebuild_air(name: str, params: dict):
    """The prover-side AIR of (name, witness_params()), the inverse that
    checkpoint resume uses (``stark_tpu/stark/air.py:74``): a
    hand-written AIR from its constructor arguments, a declarative
    AirSpec through the registry (the shipped families included) with
    its witness and param values re-bound."""
    import stark_tpu_torch.stark.families  # noqa: F401  (registers them)
    from stark_tpu_torch.stark.air_builder import lookup_spec

    legacy = {cls.name: cls for cls in (FibonacciSquareAIR, MimcAIR,
                                        FibMulAIR)}
    if name in legacy:
        return legacy[name](**params)
    spec = lookup_spec(name)
    if spec is None:
        raise ValueError(
            f"unknown AIR {name!r}: not a hand-written family and not in "
            "the spec registry (declarative specs must be registered "
            "before resume)")
    return spec(**params.get("witness", {}), **params.get("params", {}))
