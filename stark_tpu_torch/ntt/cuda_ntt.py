"""K1 wrapper: the two-step NTT/INTT kernel (``csrc/ntt.cu``; replaces
``stark_tpu/ntt/pallas_ntt.py`` ``_PallasNTT._step1_kernel`` and
``_step2_kernel``).

Same decomposition and twiddle conventions as the TPU plan: n = n1 * n2
with n1 = 2^ceil(log2(n)/2); step 1 runs a length-n1 DIT down each column
of x.reshape(n1, n2) (rows bit-reversed) and multiplies by
T[k1, j2] = w^(j2*k1); step 2 runs a length-n2 DIT down each column of
the transpose (rows bit-reversed), scales by n^-1 for the inverse and
leaves Montgomery form.  The row permutations and the transpose are
folded into the kernels' load addresses.

Every power-of-two n from 2 to 2^22 runs here; above 2^22 a sub-transform
no longer fits one block's shared memory and the three-step kernel K2
(ROADMAP Queue 2) is not ported yet.

:func:`ntt_two_step` is the wrapper: a CPU tensor runs :func:`ntt_plain`
(same signature), a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from stark_tpu_torch import _build
from stark_tpu_torch.fields.fp import Fp, lift, store, upload_u32
from stark_tpu_torch.ntt.reference_ntt import ntt_available, root_of_unity

MAX_LOG_N = 22


@functools.lru_cache(maxsize=None)
def _stage_twiddles(p: int, n: int, inverse: bool, device: str) -> tuple:
    """Per-stage Stockham twiddles [wl^0 .. wl^(l/2-1)] (mont, int64)."""
    f = Fp.get(p)
    w = root_of_unity(p, n)
    if inverse:
        w = pow(w, p - 2, p)
    out = []
    l = n
    while l > 1:
        wl = pow(w, n // l, p)
        out.append(torch.from_numpy(
            f.host_powers(wl, l // 2, mont=True).astype("int64")).to(device))
        l //= 2
    return tuple(out)


def ntt_plain(x: torch.Tensor, p: int, inverse: bool = False) -> torch.Tensor:
    """Plain version of K1: radix-2 Stockham autosort of an (n,) tensor,
    Montgomery domain inside, natural order in and out; int32 storage in
    and out."""
    if x.dim() != 1:
        raise ValueError(f"NTT input must be 1-D, got shape {tuple(x.shape)}")
    n = int(x.shape[0])
    if n & (n - 1) or n < 1:
        raise ValueError(f"NTT size must be a power of two, got {n}")
    if not ntt_available(p, n):
        raise ValueError(f"GF({p}) has no order-{n} subgroup")
    f = Fp.get(p)
    xm = f.to_mont(lift(x))
    l, m = n, 1
    for t in _stage_twiddles(p, n, inverse, str(x.device)):
        lh = l // 2
        v = xm.reshape(l, m)
        a, b = v[:lh], v[lh:]
        top = f.add(a, b)
        bot = f.mont_mul(t[:, None], f.sub(a, b))
        xm = torch.stack([top, bot], dim=1).reshape(n)
        l, m = lh, 2 * m
    if inverse:
        ninv_mont = pow(n, p - 2, p) * f.r % p
        xm = f.mont_mul(xm, torch.full_like(xm, ninv_mont))
    return store(f.from_mont(xm))


class CudaNTTPlan:
    """Device tables for one (p, n, direction) on one device."""

    def __init__(self, p: int, n: int, inverse: bool, device):
        if n & (n - 1) or n < 2:
            raise ValueError(f"K1 needs a power-of-two n >= 2, got {n}")
        if n > 1 << MAX_LOG_N:
            raise NotImplementedError(
                f"NTT of size {n} > 2^22 on CUDA needs the three-step kernel "
                "K2 (ROADMAP Queue 2), not ported yet")
        if not ntt_available(p, n):
            raise ValueError(f"GF({p}) has no order-{n} subgroup")
        self.p, self.n, self.inverse = p, n, inverse
        self.fp = f = Fp.get(p)
        log_n = n.bit_length() - 1
        self.log1 = (log_n + 1) // 2
        self.log2 = log_n - self.log1
        n1, n2 = 1 << self.log1, 1 << self.log2
        w = root_of_unity(p, n)
        if inverse:
            w = pow(w, p - 2, p)
        self.table = upload_u32(
            f.host_geometric_table(f.host_powers(w, n1), n2, mont=True)
            .reshape(-1), device)
        # sub-transform roots: step 1 w^n2 (order n1), step 2 w^n1 (order n2)
        self.tw1 = upload_u32(
            f.host_powers(pow(w, n2, p), max(n1 // 2, 1), mont=True), device)
        self.tw2 = upload_u32(
            f.host_powers(pow(w, n1, p), max(n2 // 2, 1), mont=True), device)
        self.scale = pow(n, p - 2, p) * f.r % p if inverse else 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        n, f = self.n, self.fp
        _build.require(x, "x", (n,))
        scratch = torch.empty(n, dtype=torch.int32, device=x.device)
        out = torch.empty(n, dtype=torch.int32, device=x.device)
        _build.check(_build.lib("ntt").stark_ntt_two_step(
            x.data_ptr(), self.table.data_ptr(), self.tw1.data_ptr(),
            self.tw2.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            self.log1, self.log2, f.p, f.ninv, f.r2, self.scale,
            _build.stream_ptr(x.device)), "K1 ntt_two_step")
        ntt_two_step.launches += 1
        return out


@functools.lru_cache(maxsize=None)
def get_cuda_plan(p: int, n: int, inverse: bool, device: str) -> CudaNTTPlan:
    return CudaNTTPlan(p, n, inverse, torch.device(device))


def ntt_two_step(x: torch.Tensor, p: int, inverse: bool = False):
    """NTT (or INTT) of an (n,) int32 tensor of canonical values, natural
    order in and out: K1 on a CUDA tensor, :func:`ntt_plain` on a CPU
    one."""
    if _build.plain_device(x):
        return ntt_plain(x, p, inverse)
    return get_cuda_plan(p, int(x.shape[0]), inverse, str(x.device))(x)


ntt_two_step.launches = 0
ntt_two_step.plain = ntt_plain
