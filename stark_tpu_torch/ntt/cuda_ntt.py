"""K1 and K2 wrappers: the two-step and three-step NTT/INTT kernels
(``csrc/ntt.cu``; K1 replaces ``stark_tpu/ntt/pallas_ntt.py``
``_PallasNTT._step1_kernel`` and ``_step2_kernel``, K2
``_ThreeStepNTT._k1_kernel`` and ``_k2a_kernel`` with the XLA coarse
stages after them).

Same decomposition and twiddle conventions as the TPU plan: n = n1 * n2
with n1 = 2^ceil(log2(n)/2); step 1 runs a length-n1 DIT down each column
of x.reshape(n1, n2) (rows bit-reversed) and multiplies by
T[k1, j2] = w^(j2*k1); step 2 runs a length-n2 DIT down each column of
the transpose (rows bit-reversed), scales by n^-1 for the inverse and
leaves Montgomery form.  The row permutations and the transpose are
folded into the kernels' load addresses.

K1 takes every power-of-two n from 2 to 2^MAX_LOG_N = 2^22.  Above that a
length-sqrt(n) sub-transform no longer fits one block's shared memory,
and K2 takes n up to 2^30: n = n1 * n2 with n1 = 2^ROWS_LOG rows; step 1
is K1's at n1 rows, then the length-n2 transform of each column runs its
stages l <= b = min(n1, n2) segment by segment in shared memory and its
log2(n2 / b) coarse stages one launch each (see ``csrc/ntt.cu``).

:func:`ntt_two_step` and :func:`ntt_three_step` are the wrappers: a CPU
tensor runs the plain version (:func:`ntt_plain`, the Stockham dataflow;
:func:`ntt_three_step_plain`, K2's own three steps with its own tables),
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from stark_tpu_torch import _build
from stark_tpu_torch.fields.fp import Fp, lift, store, upload_u32
from stark_tpu_torch.ntt.reference_ntt import ntt_available, root_of_unity

MAX_LOG_N = 22  # K1 up to 2^MAX_LOG_N, K2 above
MAX_LOG_N3 = 30  # K2's top size
ROWS_LOG = 11  # K2's default row split n1 = 2^ROWS_LOG


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
            raise ValueError(
                f"K1 covers n <= 2^{MAX_LOG_N}; an NTT of size {n} takes the "
                "three-step kernel K2 (ntt_three_step)")
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


def _bitrev(bits: int) -> np.ndarray:
    """The bit-reversal permutation of 2^bits indices (int64)."""
    idx = np.arange(1 << bits, dtype=np.int64)
    out = np.zeros_like(idx)
    for k in range(bits):
        out |= ((idx >> k) & 1) << (bits - 1 - k)
    return out


class CudaThreeStepPlan:
    """K2's tables for one (p, n, direction, row split) on one device:
    n = n1 * n2, n1 = 2^rows_log, b = min(n1, n2), a = n2 / b."""

    def __init__(self, p: int, n: int, inverse: bool, device,
                 rows_log: int = ROWS_LOG):
        if n & (n - 1) or n < 1:
            raise ValueError(f"K2 needs a power-of-two n, got {n}")
        if n > 1 << MAX_LOG_N3:
            raise ValueError(f"K2 covers n <= 2^{MAX_LOG_N3}, got {n}")
        if not 1 <= rows_log <= 12 or n < 1 << rows_log:
            raise ValueError(
                f"K2 needs 1 <= rows_log <= 12 (8 columns of 2^rows_log "
                f"words in shared memory) and n >= 2^rows_log; got "
                f"rows_log {rows_log}, n {n}")
        if not ntt_available(p, n):
            raise ValueError(f"GF({p}) has no order-{n} subgroup")
        self.p, self.n, self.inverse = p, n, inverse
        self.fp = f = Fp.get(p)
        self.log1 = rows_log
        self.log2 = n.bit_length() - 1 - rows_log
        self.log_b = min(self.log1, self.log2)
        self.log_a = self.log2 - self.log_b
        n1, n2, b = 1 << self.log1, 1 << self.log2, 1 << self.log_b
        w = root_of_unity(p, n)
        if inverse:
            w = pow(w, p - 2, p)
        w2 = pow(w, n1, p)  # order-n2 root
        self.table = upload_u32(
            f.host_geometric_table(f.host_powers(w, n1), n2, mont=True)
            .reshape(-1), device)
        # step 1: root w^n2 (order n1); block stages: length-b DIT of the
        # root w2^a; coarse stage l = 2b .. n2: l/2 powers of w2^(n2/l),
        # one after another (stage l at offset l/2 - b)
        self.tw1 = upload_u32(
            f.host_powers(pow(w, n2, p), max(n1 // 2, 1), mont=True), device)
        self.tw2a = upload_u32(
            f.host_powers(pow(w2, n2 // b, p), max(b // 2, 1), mont=True),
            device)
        segs = [f.host_powers(pow(w2, n2 // (2 * h), p), h, mont=True)
                for h in (b << k for k in range(self.log_a))]
        self.tw2b = upload_u32(
            np.concatenate(segs) if segs else np.zeros(0, np.uint32), device)
        self.scale = pow(n, p - 2, p) * f.r % p if inverse else 0
        # the plain version's gathers: step 1's bit-reversed rows, and row
        # r of segment i reading column bitrev_b(r) * a + bitrev_a(i) of C
        self.rev1 = torch.from_numpy(_bitrev(self.log1)).to(device)
        seg = (_bitrev(self.log_b)[None, :] << self.log_a) \
            + _bitrev(self.log_a)[:, None]
        self.seg_cols = torch.from_numpy(seg.reshape(-1)).to(device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        n, f = self.n, self.fp
        _build.require(x, "x", (n,))
        scratch = torch.empty(n, dtype=torch.int32, device=x.device)
        out = torch.empty(n, dtype=torch.int32, device=x.device)
        _build.check(_build.lib("ntt").stark_ntt_three_step(
            x.data_ptr(), self.table.data_ptr(), self.tw1.data_ptr(),
            self.tw2a.data_ptr(), self.tw2b.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), self.log1, self.log2, f.p, f.ninv, f.r2,
            self.scale, _build.stream_ptr(x.device)), "K2 ntt_three_step")
        ntt_three_step.launches += 1
        return out


@functools.lru_cache(maxsize=None)
def get_three_step_plan(p: int, n: int, inverse: bool, device: str,
                        rows_log: int) -> CudaThreeStepPlan:
    return CudaThreeStepPlan(p, n, inverse, torch.device(device), rows_log)


def _dit_stage(f: Fp, xm: torch.Tensor, tw: torch.Tensor, l: int):
    """One radix-2 DIT stage of block length l along axis -2 of
    (..., length, m) Montgomery values: the top and bottom halves of each
    l-row block, bottom * tw[j]."""
    *lead, length, m = xm.shape
    v = xm.reshape(*lead, length // l, l, m)
    top = v[..., :l // 2, :]
    bw = f.mont_mul(v[..., l // 2:, :], tw[:, None])
    return torch.cat([f.add(top, bw), f.sub(top, bw)], dim=-2).reshape(
        xm.shape)


def _dit(f: Fp, xm: torch.Tensor, tw: torch.Tensor, length: int):
    """Every DIT stage along axis -2 (input rows bit-reversed, output
    natural); tw[k] = mont(root^k) for k < length/2, stage l reading
    tw[j * length / l] (the kernels' ``dit_stages``)."""
    l = 2
    while l <= length:
        xm = _dit_stage(f, xm, tw[::length // l][:l // 2], l)
        l *= 2
    return xm


def ntt_three_step_plain(x: torch.Tensor, p: int, inverse: bool = False,
                         rows_log: int | None = None) -> torch.Tensor:
    """Plain version of K2 in torch ops: the kernels' three steps, index
    maps and tables (those of :class:`CudaThreeStepPlan` on x's device);
    int32 storage in and out, natural order."""
    if x.dim() != 1:
        raise ValueError(f"NTT input must be 1-D, got shape {tuple(x.shape)}")
    pl = get_three_step_plan(p, int(x.shape[0]), inverse, str(x.device),
                             ROWS_LOG if rows_log is None else rows_log)
    f = pl.fp
    n1, n2 = 1 << pl.log1, 1 << pl.log2
    a, b = 1 << pl.log_a, 1 << pl.log_b
    # step 1: DIT_n1 down the columns of the bit-reversed rows, * T
    xm = f.to_mont(lift(x)).reshape(n1, n2)[pl.rev1]
    xm = _dit(f, xm, lift(pl.tw1), n1)
    c = f.mont_mul(xm, lift(pl.table).reshape(n1, n2))
    # step 2a: segment i of column k1 gathers C[k1, bitrev_b(r)*a +
    # bitrev_a(i)]; the stages l <= b of each segment
    d = c[:, pl.seg_cols].T.reshape(a, b, n1)
    d = _dit(f, d, lift(pl.tw2a), b).reshape(n2, n1)
    # step 2b: the coarse stages l = 2b .. n2
    tw2b = lift(pl.tw2b)
    for k in range(pl.log_a):
        h = b << k
        d = _dit_stage(f, d, tw2b[h - b:2 * h - b], 2 * h)
    if inverse:
        d = f.mont_mul(d, torch.full_like(d, pl.scale))
    return store(f.from_mont(d)).reshape(-1)  # (n2, n1) is natural order


def ntt_three_step(x: torch.Tensor, p: int, inverse: bool = False,
                   rows_log: int | None = None):
    """NTT (or INTT) of an (n,) int32 tensor of canonical values, natural
    order in and out, n = 2^rows_log * n2 (rows_log defaults to
    ROWS_LOG): K2 on a CUDA tensor, :func:`ntt_three_step_plain` on a CPU
    one."""
    rows_log = ROWS_LOG if rows_log is None else rows_log
    if _build.plain_device(x):
        return ntt_three_step_plain(x, p, inverse, rows_log)
    return get_three_step_plan(p, int(x.shape[0]), inverse, str(x.device),
                               rows_log)(x)


ntt_three_step.launches = 0
ntt_three_step.plain = ntt_three_step_plain
