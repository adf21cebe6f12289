"""The Goldilocks NTT wrapper: one two-pass NTT/INTT kernel family
(``csrc/ntt64.cu``, ``ntt64_pass1`` / ``ntt64_pass2``) over
p = 2^64 - 2^32 + 1 for every power-of-two n from 1 to 2^28, on int32
limb planes (2, n) or (C, 2, n), the high words' plane first.

It replaces no TPU kernel: the JAX package runs this width in XLA, and
the port's torch-op Stockham ``ntt.ntt_limbs`` stays the plain
reference.  The algebra is K1/K2's (``ntt/cuda_ntt.py``): n = n1 * n2,
pass 1 a length-n1 DIF transform down each column of x.reshape(n1, n2)
times w^(j2*k1), pass 2 a length-n2 DIF transform along each row, the
n^-1 of the inverse in pass 2, both bit-reversals folded into addresses.
The tiling differs, since a value is 8 bytes: a block holds at most
2^BLOCK_LOG values of a pass, pass 1 2^COLS_LOG adjacent columns (32
bytes of each limb plane a row) while n1 <= 2^(BLOCK_LOG - COLS_LOG),
narrower groups above (:func:`split`).  The twiddle w^(j2*k1) is
hi[e >> h] * lo[e & (2^h - 1)] from two tables of about sqrt(n) values.

:func:`ntt64` is the wrapper, for CUDA tensors only (one launch of each
pass whatever C, the column as grid y): ``ntt.py`` sends a CPU tensor
to ``ntt_limbs``.  :func:`ntt64_passes_plain` (``ntt64.plain``) is the
kernels' own split, index maps and tables in torch ops, which the tests
hold against ``ntt_limbs`` and the kernels.  BLOCK_LOG is read at call
time, so the tests shrink it to reach every split at small sizes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from stark_tpu_torch import _build
from stark_tpu_torch.fields.fp import MASK32, Fp, lift
from stark_tpu_torch.fields.fp64 import GOLDILOCKS
from stark_tpu_torch.ntt.cuda_ntt import _bitrev
from stark_tpu_torch.ntt.reference_ntt import ntt_available, root_of_unity

BLOCK_LOG = 14  # at most 2^14 values of a pass a block (128 KB): n <= 2^28
COLS_LOG = 3  # pass 1's column group: 8 values, one 32-byte sector a plane


def split(log_n: int) -> tuple[int, int, int]:
    """(log n1, log n2, log of pass 1's column group) for n = 2^log_n."""
    log1 = max(min((log_n + 1) // 2, BLOCK_LOG - COLS_LOG),
               log_n - BLOCK_LOG)
    log2 = log_n - log1
    return log1, log2, min(COLS_LOG, log2, BLOCK_LOG - log1)


def _check_size(x: torch.Tensor, p: int) -> int:
    """The transform length n of x: (2, n) limb planes, or (C, 2, n)."""
    if int(p) != GOLDILOCKS:
        raise ValueError(f"the 64-bit NTT kernels take p = 2^64 - 2^32 + 1, "
                         f"got {p}")
    if x.dim() not in (2, 3) or int(x.shape[-2]) != 2:
        raise ValueError(f"64-bit NTT input must be (2, n) or (C, 2, n) limb "
                         f"planes, got shape {tuple(x.shape)}")
    n = int(x.shape[-1])
    if n & (n - 1) or n < 1:
        raise ValueError(f"NTT size must be a power of two, got {n}")
    if not ntt_available(p, n):
        raise ValueError(f"GF({p}) has no order-{n} subgroup")
    return n


def _packed(f, base: int, count: int, device) -> torch.Tensor:
    """[base^0 .. base^(count-1)] as (count,) int64 holding the uint64
    values (the kernels' table layout)."""
    planes = f.host_powers(base, count).astype(np.uint64)
    v = (planes[0] << np.uint64(32)) | planes[1]
    return torch.from_numpy(v.view(np.int64)).to(device)


def _planes(t: torch.Tensor) -> torch.Tensor:
    """A packed table -> (2, count) int64 limb planes."""
    return torch.stack([(t >> 32) & MASK32, t & MASK32])


class Ntt64Plan:
    """Tables for one (n, direction) on one device, every one of at most
    2^14 values: the two passes' twiddles [root^k, k < len/2] and the
    split table of w^(j2*k1)."""

    def __init__(self, n: int, inverse: bool, device):
        p = GOLDILOCKS
        log_n = n.bit_length() - 1
        if n & (n - 1) or n < 1 or log_n > 2 * BLOCK_LOG:
            raise ValueError(f"the 64-bit NTT kernels cover power-of-two "
                             f"n <= 2^{2 * BLOCK_LOG}, got {n}")
        self.n, self.inverse = n, inverse
        self.fp = f = Fp.get(p)
        self.log1, self.log2, self.cols_log = split(log_n)
        n1, n2 = 1 << self.log1, 1 << self.log2
        w = root_of_unity(p, n)
        if inverse:
            w = pow(w, p - 2, p)
        # pass roots: pass 1 w^n2 (order n1), pass 2 w^n1 (order n2)
        self.tw1 = _packed(f, pow(w, n2, p), max(n1 // 2, 1), device)
        self.tw2 = _packed(f, pow(w, n1, p), max(n2 // 2, 1), device)
        # w^e = hi[e >> h] * lo[e & (2^h - 1)], e = j2*k1 < n
        self.h = (log_n + 1) // 2
        self.lo = _packed(f, w, 1 << self.h, device)
        self.hi = _packed(f, pow(w, 1 << self.h, p), n >> self.h, device)
        self.scale = pow(n, p - 2, p) if inverse else 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """One launch of each pass for x of shape (2, n) or (C, 2, n)."""
        cols = int(x.shape[0]) if x.dim() == 3 else 1
        ld = _build.require_planes(x, "x", tuple(x.shape[:-1]) + (self.n,))
        if not 1 <= cols <= 65535:
            raise ValueError(f"the 64-bit NTT kernels take 1..65535 columns, "
                             f"got {cols}")
        scratch = torch.empty((cols, self.n), dtype=torch.int64,
                              device=x.device)
        out = torch.empty(tuple(x.shape), dtype=torch.int32, device=x.device)
        _build.check(_build.lib("ntt64").stark_ntt64(
            x.data_ptr(), ld, self.tw1.data_ptr(), self.tw2.data_ptr(),
            self.hi.data_ptr(), self.lo.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), self.log1, self.log2, self.cols_log, self.h,
            cols, self.scale, _build.stream_ptr(x.device)), "ntt64 passes")
        return out


@functools.lru_cache(maxsize=None)
def _cached_plan(n: int, inverse: bool, device: str,
                 block_log: int) -> Ntt64Plan:
    return Ntt64Plan(n, inverse, torch.device(device))


def get_plan(n: int, inverse: bool, device: str) -> Ntt64Plan:
    """The cached plan, keyed also by the block budget in force."""
    return _cached_plan(n, inverse, device, BLOCK_LOG)


def _dif(f, v: torch.Tensor, tw: torch.Tensor, length: int) -> torch.Tensor:
    """Every radix-2 DIF stage along axis 1 of (2, length, m) limb planes:
    natural input, bit-reversed output.  The stage of block length l reads
    tw[:, j * length / l], j < l/2 (tw[:, k] = root^k), as the kernels'
    register rounds do."""
    l = length
    while l > 1:
        h = l // 2
        b = v.reshape(2, length // l, 2, h, -1)
        top, bot = b[:, :, 0], b[:, :, 1]
        t = tw[:, ::length // l][:, :h, None]
        v = torch.stack([f.add(top, bot), f.mul(f.sub(top, bot), t)],
                        dim=2).reshape(2, length, -1)
        l = h
    return v


def ntt64_passes_plain(x: torch.Tensor, p: int,
                       inverse: bool = False) -> torch.Tensor:
    """Plain version of the kernels in torch ops: their split, index maps
    and tables (those of :class:`Ntt64Plan` on x's device); int32 limb
    planes in and out, natural order; x is (2, n) or (C, 2, n), each
    column transformed on its own."""
    n = _check_size(x, p)
    cols = int(x.shape[0]) if x.dim() == 3 else 1
    pl = get_plan(n, inverse, str(x.device))
    f = pl.fp
    n1, n2 = 1 << pl.log1, 1 << pl.log2
    rev1 = _bitrev(pl.log1, x.device)
    # pass 1, down the (2, n1, C * n2) view of the columns side by side:
    # position q of column j2 holds k1 = bitrev(q); row k1 of the
    # intermediate is that row times w^(j2*k1)
    xs = lift(x).reshape(cols, 2, n1, n2).permute(1, 2, 0, 3)
    y = _dif(f, xs.reshape(2, n1, -1), _planes(pl.tw1), n1)
    e = rev1[:, None] * torch.arange(n2, device=x.device)[None, :]
    tw = f.mul(_planes(pl.hi)[:, e >> pl.h],
               _planes(pl.lo)[:, e & ((1 << pl.h) - 1)])
    c = f.mul(y.reshape(2, n1, cols, n2), tw[:, :, None, :])[:, rev1]
    # pass 2 along each row: position q of row k1 holds k2 = bitrev(q);
    # X[k1 + n1*k2]
    z = _dif(f, c.permute(0, 3, 2, 1).reshape(2, n2, -1), _planes(pl.tw2),
             n2)
    out = z[:, _bitrev(pl.log2, x.device)]
    if inverse:
        out = f.mul(out, f.const(pl.scale, x.device)[..., None])
    out = out.reshape(2, n2, cols, n1).permute(2, 0, 1, 3)
    return out.reshape(x.shape).to(torch.int32)


def ntt64(x: torch.Tensor, p: int, inverse: bool = False) -> torch.Tensor:
    """NTT (or INTT) of Goldilocks limb planes on a CUDA tensor, (2, n) or
    the C columns of (C, 2, n), canonical values, natural order in and
    out: one launch of each pass whatever C."""
    n = _check_size(x, p)
    if not x.is_cuda:
        raise ValueError(f"the 64-bit NTT kernels take a CUDA tensor, got "
                         f"one on {x.device} (ntt_limbs is the CPU route)")
    out = get_plan(n, inverse, str(x.device))(x)
    ntt64.launches += 1
    ntt64.column_launches += x.dim() == 3
    return out


# launches: every call that launched the kernels; column_launches: those
# of them on a (C, 2, n) input (the batched form)
ntt64.launches = 0
ntt64.column_launches = 0
ntt64.plain = ntt64_passes_plain
