"""Batched SHA-256 in plain torch ops, one hash per lane (counterpart of
``stark_tpu/hash/sha256_jax.py``).

These are the plain versions of the tree kernels K3/K4
(``hash/cuda_sha.py``) and run on whatever device their inputs are on;
:func:`digest_to_bytes` and :func:`digests_to_numpy_bytes` turn digest
words into bytes on the host.
Lanes are int64 tensors holding 32-bit words (torch has no uint32
arithmetic on the CPU); every add is masked back to 32 bits.  Byte
semantics are standard FIPS 180-4, identical to hashlib.
"""

from __future__ import annotations

import numpy as np
import torch

from stark_tpu_torch.fields.fp import MASK32, lift

K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]

H0 = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]


def _sigma(x, r1: int, r2: int, r3: int, shift: bool = False):
    """rotr(x, r1) ^ rotr(x, r2) ^ (x >> r3 if `shift` else rotr(x, r3))
    of 32-bit words: x | x << 32 holds x twice, so its bits r..r + 31 are
    x rotated right by r (r <= 31; an int64 lane's top bits may wrap or
    sign-extend, and only bits below 63 are read)."""
    y = x | (x << 32)
    return ((y >> r1) ^ (y >> r2) ^ ((x if shift else y) >> r3)) & MASK32


def compress(state, w16):
    """One compression.  state: 8 lane tensors (int64 words) or ints;
    w16: 16 lane tensors or ints (broadcast against each other).
    Returns 8 int64 lane tensors, or 8 ints when every input is an int
    (the K5 host loop)."""
    w = list(w16)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        if i >= 16:
            s0 = _sigma(w[i - 15], 7, 18, 3, shift=True)
            s1 = _sigma(w[i - 2], 17, 19, 10, shift=True)
            w.append((w[i - 16] + s0 + w[i - 7] + s1) & MASK32)
        t1 = h + _sigma(e, 6, 11, 25) + (g ^ (e & (f ^ g))) + K[i] + w[i]
        t2 = _sigma(a, 2, 13, 22) + ((a & b) | (c & (a | b)))
        h, g, f, e = g, f, e, (d + t1) & MASK32
        d, c, b, a = c, b, a, (t1 + t2) & MASK32
    return [(s + n) & MASK32 for s, n in zip(state, (a, b, c, d, e, f, g, h))]


def sha256_u64_leaves(values: torch.Tensor, wide: bool = False):
    """SHA-256 of each value's 8-byte big-endian encoding, the reference's
    leaf hash Sha256::hash(value.to_be_bytes()): (n,) u32 words (high word
    0), or with `wide` the (2, n) (hi, lo) limb planes of Goldilocks
    values -> (n, 8) int32 digest rows."""
    if wide:
        if values.dim() != 2 or values.shape[0] != 2:
            raise ValueError(f"wide leaves take (2, n) limb planes, got "
                             f"shape {tuple(values.shape)}")
        return sha256_row_leaves(values[None], wide=True)
    return sha256_row_leaves(values[None])


def sha256_row_leaves(cols: torch.Tensor, wide: bool = False):
    """SHA-256 of multi-column row messages (``sha256_row_leaves`` of the
    JAX package): leaf i hashes col_0[i] || ... || col_{C-1}[i], each
    value as 8 big-endian bytes.  (C, n) u32 words (high words 0), or with
    `wide` (C, 2, n) Goldilocks limb planes (hi_0 || lo_0 || ...) ->
    (n, 8) int32 digest rows, C = 1..6 (one block: 8C + 9 <= 64 bytes);
    C = 1 equals :func:`sha256_u64_leaves`."""
    c = int(cols.shape[0])
    if (cols.dim() != 2 + wide or not 1 <= c <= 6
            or (wide and cols.shape[1] != 2)):
        raise ValueError(f"row leaves take a (C, {'2, ' * wide}n) tensor "
                         f"with C = 1..6, got shape {tuple(cols.shape)}")
    v = lift(cols)
    if wide:
        w = [v[k, j] for k in range(c) for j in (0, 1)]
    else:
        zero = torch.zeros_like(v[0])
        w = [x for k in range(c) for x in (zero, v[k])]
    w += [0x80000000] + [0] * (14 - 2 * c) + [64 * c]  # bit length of 8C
    out = compress([torch.full_like(v.reshape(-1, v.shape[-1])[0], h)
                    for h in H0], w)
    return torch.stack(out, dim=-1).to(torch.int32)


def sha256_pairs(children: torch.Tensor) -> torch.Tensor:
    """Parent digests of a (2m, 8) child level: row j = SHA-256(children[2j]
    || children[2j+1]) -> (m, 8) int32.  rs_merkle's parent node hash."""
    pairs = lift(children).reshape(-1, 16)
    w1 = [pairs[:, k] for k in range(16)]
    st = compress([torch.full_like(w1[0], h) for h in H0], w1)
    pad = [0x80000000] + [0] * 14 + [512]
    out = compress(st, pad)
    return torch.stack(out, dim=-1).to(torch.int32)


def sha256_bytes_single_block(words16, lanes_shape) -> torch.Tensor:
    """One compression from the initial state of pre-padded 16-word
    messages: 16 lane tensors of `lanes_shape` (int32 storage or int64
    words) or ints -> (lanes, 8) int32 digests."""
    w = [lift(x) if torch.is_tensor(x) else x for x in words16]
    dev = next((x.device for x in w if torch.is_tensor(x)), None)
    state = [torch.full(tuple(lanes_shape), h, dtype=torch.int64,
                        device=dev) for h in H0]
    return torch.stack(compress(state, w), dim=-1).to(torch.int32)


def _rows(words):
    if torch.is_tensor(words):
        words = words.cpu()
    return np.asarray(words).astype(np.int64) & MASK32


def digest_to_bytes(d) -> bytes:
    """One digest's 8 words (int32 storage or ints; a tensor, an array or
    a list) -> 32 big-endian bytes."""
    return b"".join(int(x).to_bytes(4, "big") for x in _rows(d))


def digests_to_numpy_bytes(level) -> list[bytes]:
    """An (m, 8) level of digest rows -> m digests of 32 bytes."""
    return [row.astype(">u4").tobytes() for row in _rows(level)]
