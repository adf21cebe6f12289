"""Batched SHA-256 in plain torch ops, one hash per lane (counterpart of
``stark_tpu/hash/sha256_jax.py``; u32 leaves only).

These are the plain versions of the tree kernels K3/K4
(``hash/cuda_sha.py``) and run on whatever device their inputs are on.
Lanes are int64 tensors holding 32-bit words (torch has no uint32
arithmetic on the CPU); every add is masked back to 32 bits.  Byte
semantics are standard FIPS 180-4, identical to hashlib.
"""

from __future__ import annotations

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


def _rotr(x, r: int):
    return ((x >> r) | (x << (32 - r))) & MASK32


def compress(state, w16):
    """One compression.  state: 8 lane tensors (int64 words) or ints;
    w16: 16 lane tensors or ints (broadcast against each other).
    Returns 8 int64 lane tensors, or 8 ints when every input is an int
    (the K5 host loop)."""
    w = list(w16)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        if i >= 16:
            x15, x2 = w[i - 15], w[i - 2]
            s0 = _rotr(x15, 7) ^ _rotr(x15, 18) ^ (x15 >> 3)
            s1 = _rotr(x2, 17) ^ _rotr(x2, 19) ^ (x2 >> 10)
            w.append((w[i - 16] + s0 + w[i - 7] + s1) & MASK32)
        t1 = h + (_rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)) + (
            (e & f) ^ ((e ^ MASK32) & g)) + K[i] + w[i]
        t2 = (_rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)) + (
            (a & b) ^ (a & c) ^ (b & c))
        h, g, f, e = g, f, e, (d + t1) & MASK32
        d, c, b, a = c, b, a, (t1 + t2) & MASK32
    return [(s + n) & MASK32 for s, n in zip(state, (a, b, c, d, e, f, g, h))]


def sha256_u64_leaves(values: torch.Tensor) -> torch.Tensor:
    """SHA-256 of each value's 8-byte big-endian encoding (high word 0, the
    u32 field): (n,) words -> (n, 8) int32 digest rows.  The reference's
    leaf hash Sha256::hash(value.to_be_bytes())."""
    lo = lift(values)
    zero = torch.zeros_like(lo)
    # 8-byte BE preimage: [0, value], then SHA padding for a 64-bit message
    w = [zero, lo, 0x80000000] + [0] * 12 + [64]
    out = compress([torch.full_like(lo, h) for h in H0], w)
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
