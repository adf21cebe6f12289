"""SHA-256 (FIPS 180-4) of many equal-length messages at once, on plain
torch int64 tensors, for the plain reference prover.

A message is a list of 32-bit big-endian words, each an int64 tensor of
lanes (one message a lane) or a Python int shared by every lane.  Words
that are Python ints (the padding, a zero high word) are computed on the
host, so their part of the schedule costs nothing on the device.  Every
32-bit word is held in [0, 2^32) of an int64; a rotation reads the
word doubled into 64 bits, and a mask follows each sum.
"""

from __future__ import annotations

import struct

import torch

M32 = 0xFFFFFFFF

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
IV = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F,
      0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]


def _rot3(x, r1, r2, r3):
    """rotr(x, r1) ^ rotr(x, r2) ^ rotr(x, r3) (r3 < 0: x >> -r3)."""
    y = x | (x << 32)
    last = x >> -r3 if r3 < 0 else y >> r3
    return ((y >> r1) ^ (y >> r2) ^ last) & M32


def compress(state, w):
    """One compression: `state` 8 words, `w` 16 message words (tensors or
    ints); returns the 8 new state words."""
    w = list(w)
    for t in range(16, 64):
        w.append((_rot3(w[t - 2], 17, 19, -10) + w[t - 7]
                  + _rot3(w[t - 15], 7, 18, -3) + w[t - 16]) & M32)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        t1 = h + _rot3(e, 6, 11, 25) + (g ^ (e & (f ^ g))) + (K[t] + w[t])
        t2 = _rot3(a, 2, 13, 22) + ((a & b) | (c & (a | b)))
        a, b, c, d, e, f, g, h = ((t1 + t2) & M32, a, b, c, (d + t1) & M32,
                                  e, f, g)
    return [(x + y) & M32 for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def sha256_words(words, nbytes: int):
    """SHA-256 of messages of `nbytes` bytes given as ceil(nbytes / 4)
    big-endian words (a whole number of words); returns 8 digest words.
    One block up to 55 bytes, else the message blocks and a padding
    block."""
    if nbytes % 4 or len(words) != nbytes // 4:
        raise ValueError("messages must be whole 32-bit words")
    msg = list(words) + [0x80000000]
    while len(msg) % 16 != 14:
        msg.append(0)
    msg += [0, 8 * nbytes]
    state = list(IV)
    for i in range(0, len(msg), 16):
        state = compress(state, msg[i:i + 16])
    return state


def hash_columns(cols, nbytes: int, chunk: int = 1 << 24) -> torch.Tensor:
    """SHA-256 of n messages of `nbytes` bytes, given as nbytes / 4 word
    columns: each an (n,) int64 tensor of 32-bit words, or a Python int
    shared by every message.  Runs in chunks of lanes; returns (n, 8)
    int32 digest words (the bits of each u32 word)."""
    n = max(int(c.shape[0]) for c in cols if torch.is_tensor(c))
    dev = next(c.device for c in cols if torch.is_tensor(c))
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    for s in range(0, n, chunk):
        words = [c[s:s + chunk] if torch.is_tensor(c) else c for c in cols]
        digest = torch.stack(sha256_words(words, nbytes), dim=1)
        out[s:s + chunk] = to_int32(digest)
    return out


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """u32 values held in an int64 tensor -> int32 with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def digest_bytes(words) -> bytes:
    """8 digest words (ints or an (8,) tensor) -> the 32-byte digest."""
    return struct.pack(">8I", *[int(v) & M32 for v in words])
