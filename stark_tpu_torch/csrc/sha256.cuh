// One SHA-256 compression (FIPS 180-4) on 32-bit registers, shared by the
// tree kernels (sha256_tree.cu) and the Fiat-Shamir chain (sha_chain.cu).
// Words are big-endian message words held as native uint32 values, the
// layout of the port's digest rows and block streams.
#pragma once

#include <cstdint>

namespace sha {

__device__ __constant__ uint32_t K[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu,
    0x59F111F1u, 0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u,
    0x243185BEu, 0x550C7DC3u, 0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u,
    0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u, 0x0FC19DC6u, 0x240CA1CCu,
    0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu, 0x983E5152u,
    0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu,
    0x53380D13u, 0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u,
    0xA2BFE8A1u, 0xA81A664Bu, 0xC24B8B70u, 0xC76C51A3u, 0xD192E819u,
    0xD6990624u, 0xF40E3585u, 0x106AA070u, 0x19A4C116u, 0x1E376C08u,
    0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au, 0x5B9CCA4Fu,
    0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int r) {
  return __funnelshift_r(x, x, r);
}

__device__ __forceinline__ void init(uint32_t st[8]) {
  st[0] = 0x6A09E667u; st[1] = 0xBB67AE85u; st[2] = 0x3C6EF372u;
  st[3] = 0xA54FF53Au; st[4] = 0x510E527Fu; st[5] = 0x9B05688Cu;
  st[6] = 0x1F83D9ABu; st[7] = 0x5BE0CD19u;
}

// st <- compress(st, w); w (16 words) is used as the rolling schedule.
__device__ __forceinline__ void compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i >= 16) {
      const uint32_t x15 = w[(i - 15) & 15], x2 = w[(i - 2) & 15];
      const uint32_t s0 = rotr(x15, 7) ^ rotr(x15, 18) ^ (x15 >> 3);
      const uint32_t s1 = rotr(x2, 17) ^ rotr(x2, 19) ^ (x2 >> 10);
      w[i & 15] += s0 + w[(i - 7) & 15] + s1;
    }
    const uint32_t t1 = h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) +
                        ((e & f) ^ (~e & g)) + K[i] + w[i & 15];
    const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) +
                        ((a & b) ^ (a & c) ^ (b & c));
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// st <- SHA-256 of a 64-byte message w (two digests, a Merkle node's
// children): the data block, then the constant padding block.
__device__ __forceinline__ void pair(uint32_t st[8], uint32_t w[16]) {
  init(st);
  compress(st, w);
  uint32_t pad[16] = {0x80000000u, 0u, 0u, 0u, 0u, 0u, 0u, 0u,
                      0u, 0u, 0u, 0u, 0u, 0u, 0u, 512u};
  compress(st, pad);
}

// W[i] + K[i] for the 64 rounds of one block (w: its 16 words, used as
// the rolling schedule), stored four words at a time to out[0..15]: the
// schedule of a block whose words are known ahead of the chain, computed
// off the chain's thread (K5's staging warps).
__device__ __forceinline__ void schedule_kw(uint32_t w[16], uint4* out) {
#pragma unroll
  for (int i = 0; i < 64; i += 4) {
    uint32_t kw[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = i + j;
      if (r >= 16) {
        const uint32_t x15 = w[(r - 15) & 15], x2 = w[(r - 2) & 15];
        const uint32_t s0 = rotr(x15, 7) ^ rotr(x15, 18) ^ (x15 >> 3);
        const uint32_t s1 = rotr(x2, 17) ^ rotr(x2, 19) ^ (x2 >> 10);
        w[r & 15] += s0 + w[(r - 7) & 15] + s1;
      }
      kw[j] = w[r & 15] + K[r];
    }
    out[i / 4] = make_uint4(kw[0], kw[1], kw[2], kw[3]);
  }
}

// st <- compress(st) from the precomputed kw[i] = W[i] + K[i]: rounds
// only.  d + h + kw is formed three rounds ahead of its use (d and h are
// a and e of three rounds before), so the new e is one 3-input add after
// Sigma1 and Ch: three dependent operations a round (shift, xor3, add3)
// where T1 then d + T1 takes four.
__device__ __forceinline__ void compress_kw(uint32_t st[8],
                                            const uint32_t kw[64]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const uint32_t hk = h + kw[i];
    const uint32_t dhk = d + hk;
    const uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t mj = (a & b) ^ (a & c) ^ (b & c);
    const uint32_t t1 = hk + s1 + ch;
    h = g; g = f; f = e; e = dhk + s1 + ch;
    d = c; c = b; b = a; a = t1 + s0 + mj;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

}  // namespace sha
