"""K1 and K2 wrappers: one two-pass NTT/INTT kernel family
(``csrc/ntt.cu``) for every power-of-two n from 2 to 2^30.  K1 replaces
``stark_tpu/ntt/pallas_ntt.py`` ``_PallasNTT._step1_kernel`` and
``_step2_kernel``, K2 ``_ThreeStepNTT._k1_kernel`` and ``_k2a_kernel``
with the XLA coarse stages after them; on the card both are the same two
kernels, and the two routes differ only in their launch counts.

Same algebra as the TPU plans: n = n1 * n2, j = j1*n2 + j2,
k = k1 + n1*k2.  Pass 1 runs a length-n1 transform down each column of
x.reshape(n1, n2) and multiplies by w^(j2*k1); pass 2 runs a length-n2
transform along each row k1 of that intermediate, scales by n^-1 for the
inverse and writes X[k1 + n1*k2], natural order.  Both passes are
decimation in frequency (natural input, bit-reversed output), so the
bit-reversal folds into the rows pass 1 writes and the positions pass 2
writes.  The data stay canonical: every twiddle is in Montgomery form,
and a Montgomery product of a canonical value and mont(t) is the
canonical product.

The split (:func:`split`): a block holds at most 2^BLOCK_LOG words of
one pass; pass 1 holds 2^COLS_LOG adjacent columns (32 bytes of each
row) while n1 <= 2^(BLOCK_LOG - COLS_LOG), and narrower groups above;
pass 2 holds one row.  So n <= 2^27 runs with 8-column groups and
n <= 2^30 in two passes.  The twiddle w^(j2*k1) comes from two tables of
about sqrt(n) words: w^e = w^(hi(e)*2^h) * w^(lo(e)).

:func:`ntt_k1` (n <= 2^MAX_LOG_N) and :func:`ntt_k2` (any n, the route
above it) are the wrappers, for an (n,) vector or the C columns of a
(C, n) tensor (a grid dimension of both passes, so a pass-1 column group
or a pass-2 cluster never crosses a column): a CPU tensor runs
:func:`ntt_passes_plain` (the kernels' own passes, index maps and
tables), a CUDA tensor launches the kernels or raises.
:func:`ntt_plain` (the Stockham dataflow) is the second oracle.  The
constants are read at call time, so the CPU tests shrink them to reach
every branch at small sizes.
"""

from __future__ import annotations

import functools

import torch

from stark_tpu_torch import _build
from stark_tpu_torch.fields.fp import Fp, lift, store, upload_u32
from stark_tpu_torch.ntt.reference_ntt import ntt_available, root_of_unity

MAX_LOG_N = 22  # the K1 route up to 2^22 (the TPU K1's range), K2 above
BLOCK_LOG = 15  # at most 2^15 words of a pass a block (128 KB): n <= 2^30
COLS_LOG = 3  # pass 1's column group: 8 words, one 32-byte sector a row


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


def _check_size(x: torch.Tensor, p: int, batched: bool = False) -> int:
    """The transform length n of x: (n,), or (C, n) columns when
    `batched`."""
    if x.dim() != 1 and not (batched and x.dim() == 2):
        raise ValueError(f"NTT input must be 1-D{' or (C, n)' * batched}, "
                         f"got shape {tuple(x.shape)}")
    n = int(x.shape[-1])
    if n & (n - 1) or n < 1:
        raise ValueError(f"NTT size must be a power of two, got {n}")
    if not ntt_available(p, n):
        raise ValueError(f"GF({p}) has no order-{n} subgroup")
    return n


def ntt_plain(x: torch.Tensor, p: int, inverse: bool = False) -> torch.Tensor:
    """Second oracle: radix-2 Stockham autosort of an (n,) tensor (the
    JAX ``NTTPlan``'s dataflow), Montgomery domain inside, natural order
    in and out; int32 storage in and out."""
    n = _check_size(x, p)
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


def split(log_n: int) -> tuple[int, int, int]:
    """(log n1, log n2, log of pass 1's column group) for n = 2^log_n."""
    log1 = max(min((log_n + 1) // 2, BLOCK_LOG - COLS_LOG),
               log_n - BLOCK_LOG)
    log2 = log_n - log1
    return log1, log2, min(COLS_LOG, log2, BLOCK_LOG - log1)


def _bitrev(bits: int, device) -> torch.Tensor:
    """The bit-reversal permutation of 2^bits indices (int64)."""
    idx = torch.arange(1 << bits, dtype=torch.int64, device=device)
    out = torch.zeros_like(idx)
    for k in range(bits):
        out |= ((idx >> k) & 1) << (bits - 1 - k)
    return out


class CudaNTTPlan:
    """Tables for one (p, n, direction) on one device, every one of at
    most 2^15 words: the two passes' mont twiddles [root^k, k < len/2],
    and the split table of w^(j2*k1)."""

    def __init__(self, p: int, n: int, inverse: bool, device):
        if n & (n - 1) or n < 1:
            raise ValueError(f"the NTT kernels need a power-of-two n, got "
                             f"{n}")
        log_n = n.bit_length() - 1
        if log_n > 2 * BLOCK_LOG:
            raise ValueError(f"the NTT kernels cover n <= 2^{2 * BLOCK_LOG}, "
                             f"got {n}")
        if not ntt_available(p, n):
            raise ValueError(f"GF({p}) has no order-{n} subgroup")
        self.p, self.n, self.inverse = p, n, inverse
        self.fp = f = Fp.get(p)
        self.log1, self.log2, self.cols_log = split(log_n)
        n1, n2 = 1 << self.log1, 1 << self.log2
        w = root_of_unity(p, n)
        if inverse:
            w = pow(w, p - 2, p)
        # pass roots: pass 1 w^n2 (order n1), pass 2 w^n1 (order n2)
        self.tw1 = upload_u32(
            f.host_powers(pow(w, n2, p), max(n1 // 2, 1), mont=True), device)
        self.tw2 = upload_u32(
            f.host_powers(pow(w, n1, p), max(n2 // 2, 1), mont=True), device)
        # w^e = hi[e >> h] * lo[e & (2^h - 1)], e = j2*k1 < n
        self.h = (log_n + 1) // 2
        self.lo = upload_u32(f.host_powers(w, 1 << self.h, mont=True), device)
        self.hi = upload_u32(f.host_powers(pow(w, 1 << self.h, p),
                                           n >> self.h, mont=True), device)
        self.scale = pow(n, p - 2, p) * f.r % p if inverse else 0
        self.pinv = pow(p, -1, 1 << 32)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """One launch of each pass for x of shape (n,) or (C, n): the C
        columns are a grid dimension of both passes."""
        f = self.fp
        cols = int(x.shape[0]) if x.dim() == 2 else 1
        _build.require(x, "x", tuple(x.shape[:-1]) + (self.n,))
        if not 1 <= cols <= 65535:
            raise ValueError(f"the NTT kernels take 1..65535 columns, got "
                             f"{cols}")
        scratch = torch.empty_like(x)
        out = torch.empty_like(x)
        _build.check(_build.lib("ntt").stark_ntt(
            x.data_ptr(), self.tw1.data_ptr(), self.tw2.data_ptr(),
            self.hi.data_ptr(), self.lo.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), self.log1, self.log2, self.cols_log, self.h,
            cols, f.p, self.pinv, self.scale, _build.stream_ptr(x.device)),
            "ntt passes")
        return out


@functools.lru_cache(maxsize=None)
def _cached_plan(p: int, n: int, inverse: bool, device: str,
                 limits: tuple) -> CudaNTTPlan:
    return CudaNTTPlan(p, n, inverse, torch.device(device))


def get_cuda_plan(p: int, n: int, inverse: bool, device: str) -> CudaNTTPlan:
    """The cached plan, keyed also by the split constants in force."""
    return _cached_plan(p, n, inverse, device, (BLOCK_LOG, COLS_LOG))


get_cuda_plan.cache_clear = _cached_plan.cache_clear


def _dif(f: Fp, v: torch.Tensor, tw: torch.Tensor, length: int):
    """Every radix-2 DIF stage along axis 0 of (length, m) canonical
    values: natural input, bit-reversed output.  The stage of block length
    l reads tw[j * length / l], j < l/2 (tw[k] = mont(root^k)), as the
    kernels' register rounds do."""
    l = length
    while l > 1:
        h = l // 2
        b = v.reshape(length // l, 2, h, -1)
        top, bot = b[:, 0], b[:, 1]
        t = tw[::length // l][:h, None]
        v = torch.stack([f.add(top, bot), f.mont_mul(f.sub(top, bot), t)],
                        dim=1).reshape(length, -1)
        l = h
    return v


def ntt_passes_plain(x: torch.Tensor, p: int,
                     inverse: bool = False) -> torch.Tensor:
    """Plain version of the kernels in torch ops: their split, index maps
    and tables (those of :class:`CudaNTTPlan` on x's device); int32
    storage in and out, natural order; x is (n,) or (C, n), each column
    transformed on its own."""
    n = _check_size(x, p, batched=True)
    cols = int(x.shape[0]) if x.dim() == 2 else 1
    pl = get_cuda_plan(p, n, inverse, str(x.device))
    f = pl.fp
    n1, n2 = 1 << pl.log1, 1 << pl.log2
    rev1 = _bitrev(pl.log1, x.device)
    # pass 1, down the (n1, C * n2) view of the columns side by side:
    # position q of column j2 holds k1 = bitrev(q); row k1 of the
    # intermediate is that row times w^(j2*k1)
    xs = lift(x).reshape(cols, n1, n2).permute(1, 0, 2).reshape(n1, -1)
    y = _dif(f, xs, lift(pl.tw1), n1).reshape(n1, cols, n2)
    e = rev1[:, None] * torch.arange(n2, device=x.device)[None, :]
    tw = f.mont_mul(lift(pl.hi)[e >> pl.h], lift(pl.lo)[e & ((1 << pl.h) - 1)])
    c = f.mont_mul(y, tw[:, None, :])[rev1]  # (k1, column, j2)
    # pass 2 along each row: position q of row k1 holds k2 = bitrev(q);
    # X[k1 + n1*k2]
    z = _dif(f, c.permute(2, 1, 0).reshape(n2, -1), lift(pl.tw2), n2)
    out = z[_bitrev(pl.log2, x.device)].reshape(n2, cols, n1)
    out = out.permute(1, 0, 2).reshape(x.shape)
    if inverse:
        out = f.mont_mul(out, torch.full_like(out, pl.scale))
    return store(out)


def _launch(wrapper, x: torch.Tensor, p: int,
            inverse: bool) -> torch.Tensor:
    out = get_cuda_plan(p, int(x.shape[-1]), inverse, str(x.device))(x)
    wrapper.launches += 1
    wrapper.column_launches += x.dim() == 2
    return out


def ntt_k1(x: torch.Tensor, p: int, inverse: bool = False) -> torch.Tensor:
    """The K1 route: NTT (or INTT) of an (n,) int32 tensor of canonical
    values, or of each column of a (C, n) one, n <= 2^MAX_LOG_N, natural
    order in and out; the kernels on a CUDA tensor (one launch of each
    pass whatever C), :func:`ntt_passes_plain` on a CPU one."""
    n = _check_size(x, p, batched=True)
    if n > 1 << MAX_LOG_N:
        raise ValueError(f"K1 covers n <= 2^{MAX_LOG_N}; an NTT of size {n} "
                         "takes the K2 route (ntt_k2)")
    if _build.plain_device(x):
        return ntt_passes_plain(x, p, inverse)
    return _launch(ntt_k1, x, p, inverse)


def ntt_k2(x: torch.Tensor, p: int, inverse: bool = False) -> torch.Tensor:
    """The K2 route (the sizes above 2^MAX_LOG_N, up to 2^30; any n is
    taken): as :func:`ntt_k1`."""
    _check_size(x, p, batched=True)
    if _build.plain_device(x):
        return ntt_passes_plain(x, p, inverse)
    return _launch(ntt_k2, x, p, inverse)


# launches: every call that launched the kernels; column_launches: those
# of them on a (C, n) input (the batched form)
for _w in (ntt_k1, ntt_k2):
    _w.launches = 0
    _w.column_launches = 0
    _w.plain = ntt_passes_plain
