"""The Fibonacci-square AIR (STARK-101) and its per-config context
(counterpart of ``stark_tpu/stark/air.py``).

a_{i+2} = a_{i+1}^2 + a_i^2 over GF(p); publics a_0 and a_{T-1}.  The
context holds the LDE coset domain and the boundary / zerofier inverse
tables on the device; the composition is pointwise torch ops on them.
Other statement families (MiMC, FibMul, declarative AirSpecs) wait for
ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

import numpy as np
import torch

from stark_tpu_torch import native
from stark_tpu_torch.config import ProverConfig
from stark_tpu_torch.fields.fp import Fp, store
from stark_tpu_torch.ntt.reference_ntt import root_of_unity


class _BaseContext:
    """Shared per-config tables: the LDE coset domain and its inverses."""

    def __init__(self, cfg: ProverConfig, device):
        cfg.validate()
        p = cfg.modulus
        self.cfg = cfg
        self.fp = Fp.get(p)
        self.device = torch.device(device)
        self.N = cfg.trace_domain_size
        self.M = cfg.eval_domain_size
        self.g = root_of_unity(p, self.N)
        self.w = root_of_unity(p, self.M)
        self.domain = self.fp.coset_domain(cfg.offset, self.w, self.M,
                                           self.device)

    def _const(self, value: int) -> torch.Tensor:
        return torch.tensor(int(value) % self.fp.p, device=self.device)

    def boundary_inv(self, point: int) -> torch.Tensor:
        """1 / (x - point) on the LDE domain (int32 storage)."""
        f = self.fp
        return store(f.inv_rolled(f.sub(self.domain, self._const(point))))

    def zerofier_inv_excluding(self, excluded) -> torch.Tensor:
        """prod(x - e for e in excluded) / (x^N - 1) on the LDE domain."""
        f = self.fp
        xn = f.pow_static(self.domain, self.N)
        mult = f.inv_rolled(f.sub(xn, self._const(1)))
        for e in excluded:
            mult = f.mul(mult, f.sub(self.domain, self._const(e)))
        return store(mult)


class _FibContext(_BaseContext):
    def __init__(self, cfg: ProverConfig, device):
        super().__init__(cfg, device)
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
        al = [a if torch.is_tensor(a) else self._const(a) for a in alphas]
        f_x = lde
        f_gx = torch.roll(lde, -b)
        f_g2x = torch.roll(lde, -2 * b)
        p0 = f.mul(f.sub(f_x, self._const(publics["a0"])), self.inv_b0)
        p1 = f.mul(f.sub(f_x, self._const(publics["a_last"])), self.inv_b1)
        num = f.sub(f.sub(f_g2x, f.mul(f_gx, f_gx)), f.mul(f_x, f_x))
        p2 = f.mul(num, self.trans_mult)
        return store(f.add(f.add(f.mul(al[0], p0), f.mul(al[1], p1)),
                           f.mul(al[2], p2)))


class FibonacciSquareAIR:
    """a_{i+2} = a_{i+1}^2 + a_i^2; publics a_0 and a_{T-1}."""

    name = "fibonacci-square"
    shifts = (0, 1, 2)
    num_alphas = 3
    num_columns = 1

    def __init__(self, a1: int = 3141592, a0: int = 1):
        self.a0 = a0
        self.a1 = a1

    def validate(self, cfg: ProverConfig) -> None:
        cfg.validate()

    def host_trace(self, cfg: ProverConfig):
        """The trace as numpy uint32, from the native host loop (host code
        whatever the prove's device)."""
        return native.fib_trace(cfg.modulus, self.a0, self.a1,
                                cfg.trace_length).astype(np.uint32)

    def publics_from_host(self, trace_host) -> dict:
        return {"a0": int(trace_host[0]), "a_last": int(trace_host[-1])}

    def num_folds(self, cfg: ProverConfig) -> int:
        return cfg.log2_trace  # CP degree < N

    def context(self, cfg: ProverConfig, device) -> _FibContext:
        return _FibContext(cfg, device)

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


def air_from_name(name: str):
    """The AIR a proof names; only the Fibonacci-square AIR is ported."""
    if name == "fibonacci-square":
        return FibonacciSquareAIR()
    raise NotImplementedError(
        f"AIR {name!r} is not ported yet (ROADMAP Queue 1 item 11)")
