"""Distributed NTT: the four-step algorithm over a mesh (counterpart of
``stark_tpu/dist/ntt.py``).

A size-n NTT with n = n1 * n2 decomposes (j = j1*n2 + j2, k = k2*n1 + k1,
w the order-n root):

    X[k2*n1 + k1] = NTT_n2_rows( w^(j2*k1) * NTT_n1_cols(A) )[k1, k2]^T

where A = x.reshape(n1, n2).  Shard i holds rows i*n1/S .. of A (its
contiguous block of x).  Each axis transform is local after a transpose,
and a transpose over the mesh is an all-to-all (block (i, j) of shard i
goes to shard j, :meth:`Mesh.exchange`) then a local transpose.  Three of
them give natural order in and out, so the result equals the
single-device transform bit for bit.

The local transforms are the port's own (``ntt/ntt.py``): a u32 field's
rows as one (rows, len) batch, K1/K2 on the card; Goldilocks rows as one
(rows, 2, len) batch, the 64-bit kernels on the card and ``ntt_limbs``
on the CPU.  Their roots are root_of_unity(p, len) =
g^((p-1)/len) = w^(n/len), the roots the four-step needs.  An inverse
sub-transform scales by 1/len, so the two scale the whole by
1/(n1 n2) = 1/n and nothing is scaled again.  The twiddle table
w^(j2*k1) is built once per (shard, device) from two tables of about
sqrt(n) powers and kept, n words over the mesh.

Domains below S^2 points do not split (S^2 | n); they run the
single-device transform on the first shard and are re-sharded.

On a process mesh each rank transforms and twiddles only the blocks it
holds, and each transpose is one all-to-all of the process group
(:meth:`Mesh.exchange`): a rank's pieces for another rank's shards go in
one message whatever the number of its shards.
"""

from __future__ import annotations

import functools

import torch

from stark_tpu_torch.dist.mesh import Mesh, Sharded, sharded
from stark_tpu_torch.fields.fp import Fp
from stark_tpu_torch.ntt.ntt import coset_evaluate, intt, ntt
from stark_tpu_torch.ntt.reference_ntt import ntt_available, root_of_unity


def _split(n: int, s: int) -> tuple[int, int]:
    """n = n1 * n2 with s | n1 and s | n2 (both layouts shard evenly), n1
    as square as possible."""
    log_n = n.bit_length() - 1
    log_s = s.bit_length() - 1
    if n % (s * s) and s > 1:
        raise ValueError(f"four-step NTT needs s^2 | n (n={n}, shards={s})")
    log_n1 = max(log_s, min(log_n - log_s, (log_n + 1) // 2))
    return 1 << log_n1, 1 << (log_n - log_n1)


def _effective_shards(n: int, s: int) -> int:
    """The full mesh when s^2 | n, else 1 (the single-device transform,
    re-sharded): for power-of-two n and s, s^2 | n iff n >= s^2."""
    return s if s <= 1 or n % (s * s) == 0 else 1


@functools.lru_cache(maxsize=None)
def _twiddle(p: int, n: int, s: int, inverse: bool, j: int,
             device: str) -> torch.Tensor:
    """Shard j's block of w^(j2*k1): rows j2 in [j n2/s, (j+1) n2/s),
    columns k1 < n1; (rows, n1) int32, or (2, rows, n1) limb planes.
    w^e = hi[e >> h] * lo[e mod 2^h] (e = j2*k1 < n)."""
    f = Fp.get(p)
    n1, n2 = _split(n, s)
    w = root_of_unity(p, n)
    if inverse:
        w = pow(w, p - 2, p)
    dev = torch.device(device)
    h = (n.bit_length()) // 2
    lo = f.powers(w, 1 << h, dev)
    hi = f.powers(pow(w, 1 << h, p), -(-n >> h), dev)
    rows = n2 // s
    j2 = torch.arange(j * rows, (j + 1) * rows, device=dev)
    e = j2[:, None] * torch.arange(n1, device=dev)[None, :]
    return f.mul(hi[..., e >> h], lo[..., e & ((1 << h) - 1)]).to(
        torch.int32)


def _all_to_all(mesh: Mesh, x: Sharded) -> Sharded:
    """Blocks (*lead, R, S*W) -> (*lead, W, S*R): block (i, j), columns
    j*W .. of shard i, goes to shard j, which stacks the S it receives
    along the rows and transposes its (S*R, W) matrix (one exchange: on
    a process mesh one all-to-all)."""
    s = mesh.size
    shape = tuple(x._any().shape)
    w = shape[-1] // s
    items = [(x.owners[i], x.owners[j],
              None if x.blocks[i] is None
              else x.blocks[i][..., j * w:(j + 1) * w], shape[:-1] + (w,))
             for j in range(s) for i in range(s)]
    got = mesh.exchange(items, "ntt")
    return x.map(lambda _, j: torch.cat(got[j * s:(j + 1) * s], dim=-2)
                 .transpose(-1, -2).contiguous())


def _rows_transform(x: torch.Tensor, p: int, inverse: bool) -> torch.Tensor:
    """The transform of every row of (*lead, R, len) along its last axis:
    one (rows, len) batch; Goldilocks limb planes (*cols, 2, R, len) as
    (rows, 2, len), copied so that each row's planes lie a fixed stride
    apart, as the 64-bit kernels read them."""
    length = int(x.shape[-1])
    fn = intt if inverse else ntt
    if Fp.get(p).width == 1:
        return fn(x.reshape(-1, length), p).reshape(x.shape)
    y = x.movedim(-3, -2)
    shape = y.shape
    y = fn(y.reshape(-1, 2, length).contiguous(), p).reshape(shape)
    return y.movedim(-2, -3).contiguous()


def _times_twiddle(x: torch.Tensor, tw: torch.Tensor, p: int):
    f = Fp.get(p)
    if f.width == 1:
        return f.storage(f.mul(x, tw))
    a = x.movedim(-3, 0)  # (2, *cols, R, len)
    t = tw.view((2,) + (1,) * (a.dim() - 3) + tuple(tw.shape[1:]))
    return f.mul(a, t).movedim(0, -3).to(torch.int32).contiguous()


def _transform(x, p: int, mesh: Mesh, inverse: bool) -> Sharded:
    n = int(x.shape[-1])
    if not ntt_available(p, n) or n & (n - 1):
        raise ValueError(f"GF({p}) has no order-{n} subgroup")
    s = _effective_shards(n, mesh.size)
    if s == 1:
        whole = x.join() if isinstance(x, Sharded) else x
        return sharded(mesh, (intt if inverse else ntt)(whole, p))
    xs = x if isinstance(x, Sharded) else sharded(mesh, x)
    n1, n2 = _split(n, s)
    lead = tuple(xs._any().shape[:-1])
    a = xs.map(lambda b, _: b.reshape(lead + (n1 // s, n2)))
    a = _all_to_all(mesh, a)  # (n2/s, n1): A's columns as rows
    a = a.map(lambda b, j: _times_twiddle(
        _rows_transform(b, p, inverse),
        _twiddle(p, n, s, inverse, j, str(b.device)), p))
    a = _all_to_all(mesh, a)  # (n1/s, n2)
    a = a.map(lambda b, _: _rows_transform(b, p, inverse))
    a = _all_to_all(mesh, a)  # (n2/s, n1): X.reshape(n2, n1), natural
    return a.map(lambda b, _: b.reshape(lead + (n // s,)))


def dist_ntt(x, p: int, mesh: Mesh) -> Sharded:
    """Forward NTT along the last axis of `x` (a tensor, split over the
    mesh, or a :class:`Sharded`), natural order: equal to the
    single-device ``ntt``.  Domains below mesh.size^2 points run that on
    the first shard and are re-sharded."""
    return _transform(x, p, mesh, False)


def dist_intt(x, p: int, mesh: Mesh) -> Sharded:
    """Inverse NTT (the 1/n scale included), as :func:`dist_ntt`."""
    return _transform(x, p, mesh, True)


def dist_coset_evaluate(coeffs: torch.Tensor, p: int, big_n: int,
                        offset: int, mesh: Mesh) -> Sharded:
    """``ntt.coset_evaluate`` over the mesh: the (…, n) coefficients on
    {offset * W^i : i < big_n}.  The scaled coefficients stay on their
    device; each shard's block of the zero-padded vector is built where
    it lives, from the coefficients in its range (on a process mesh every
    rank holds the coefficients whole and builds its own blocks)."""
    s = mesh.size
    if _effective_shards(big_n, s) == 1:
        return sharded(mesh, coset_evaluate(coeffs, p, big_n, offset))
    f = Fp.get(p)
    n = int(coeffs.shape[-1])
    scaled = f.storage(f.mul(f.arith(coeffs),
                             f.powers(int(offset) % p, n, coeffs.device)))
    k = big_n // s
    blocks = []
    for i, dev in enumerate(mesh.devices):
        if not mesh.owns(i):
            blocks.append(None)
            continue
        blk = torch.zeros(coeffs.shape[:-1] + (k,), dtype=torch.int32,
                          device=dev)
        lo, hi = i * k, min((i + 1) * k, n)
        if lo < hi:
            blk[..., :hi - lo] = mesh.take(scaled[..., lo:hi], i, "scatter")
        blocks.append(blk)
    return dist_ntt(Sharded(blocks, mesh), p, mesh)
