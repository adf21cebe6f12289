// Host SHA-256, Merkle tree build / validate and the channel's absorb,
// built with the host C++ compiler and loaded with ctypes
// (stark_tpu_torch/_build.py, stark_tpu_torch/native/__init__.py).
//
// Copied from stark_tpu/native/sha256_merkle.cpp (the SHA-256 context,
// stark_sha256, stark_merkle_build, stark_merkle_validate and
// stark_channel_absorb, :13-198): the port may not import stark_tpu,
// whose package init imports JAX.  Semantics: FIPS 180-4 SHA-256;
// rs_merkle tree shape (parent = H(left||right), odd node promoted
// unhashed), leaf = H(8-byte BE value).  No external dependencies.

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

constexpr uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

inline uint32_t rotr(uint32_t x, int r) { return (x >> r) | (x << (32 - r)); }

struct Sha256Ctx {
  uint32_t h[8];
  uint8_t buf[64];
  uint64_t total = 0;
  size_t fill = 0;

  Sha256Ctx() {
    static constexpr uint32_t H0[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                       0xa54ff53a, 0x510e527f, 0x9b05688c,
                                       0x1f83d9ab, 0x5be0cd19};
    std::memcpy(h, H0, sizeof(h));
  }

  void compress(const uint8_t* p) {
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
      w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
             (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
    for (int i = 16; i < 64; i++) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
    uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
      uint32_t e1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + e1 + ch + K[i] + w[i];
      uint32_t e0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = e0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const uint8_t* data, size_t len) {
    total += len;
    while (len) {
      size_t take = 64 - fill < len ? 64 - fill : len;
      std::memcpy(buf + fill, data, take);
      fill += take;
      data += take;
      len -= take;
      if (fill == 64) {
        compress(buf);
        fill = 0;
      }
    }
  }

  void final(uint8_t out[32]) {
    uint64_t bits = total * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t zero = 0;
    while (fill != 56) update(&zero, 1);
    uint8_t lenb[8];
    for (int i = 0; i < 8; i++) lenb[i] = uint8_t(bits >> (56 - 8 * i));
    update(lenb, 8);
    for (int i = 0; i < 8; i++) {
      out[4 * i] = uint8_t(h[i] >> 24);
      out[4 * i + 1] = uint8_t(h[i] >> 16);
      out[4 * i + 2] = uint8_t(h[i] >> 8);
      out[4 * i + 3] = uint8_t(h[i]);
    }
  }
};

void sha256_once(const uint8_t* data, size_t len, uint8_t out[32]) {
  Sha256Ctx c;
  c.update(data, len);
  c.final(out);
}

}  // namespace

extern "C" {

void stark_sha256(const uint8_t* data, size_t len, uint8_t* out32) {
  sha256_once(data, len, out32);
}

// Build the full Merkle tree over n u64 field values (leaf = H(8-byte BE)).
// `out` receives all levels concatenated bottom-up: n + ceil(n/2) + ... + 1
// digests of 32 bytes.  Returns the total digest count.
size_t stark_merkle_build(const uint64_t* values, size_t n, uint8_t* out) {
  uint8_t* level = out;
  for (size_t i = 0; i < n; i++) {
    uint8_t be[8];
    for (int j = 0; j < 8; j++) be[j] = uint8_t(values[i] >> (56 - 8 * j));
    sha256_once(be, 8, level + 32 * i);
  }
  size_t total = n;
  size_t size = n;
  while (size > 1) {
    uint8_t* next = out + 32 * total;
    size_t half = size / 2;
    for (size_t i = 0; i < half; i++)
      sha256_once(level + 64 * i, 64, next + 32 * i);
    size_t next_size = half;
    if (size % 2) {  // rs_merkle odd promotion
      std::memcpy(next + 32 * half, level + 32 * (size - 1), 32);
      next_size++;
    }
    level = next;
    total += next_size;
    size = next_size;
  }
  return total;
}

// Validate an auth path (concatenated 32-byte sibling digests, leaf level
// upward; promoted levels contribute nothing).  leaf8 = raw 8-byte BE value.
int stark_merkle_validate(const uint8_t* root32, const uint8_t* proof,
                          size_t proof_len, size_t index, const uint8_t* leaf8,
                          size_t num_leaves) {
  if (num_leaves == 0 || index >= num_leaves || proof_len % 32) return 0;
  uint8_t cur[32];
  sha256_once(leaf8, 8, cur);
  size_t off = 0, idx = index, size = num_leaves;
  uint8_t pair[64];
  while (size > 1) {
    if (!(idx == size - 1 && size % 2 == 1)) {
      if (off + 32 > proof_len) return 0;
      if (idx % 2 == 0) {
        std::memcpy(pair, cur, 32);
        std::memcpy(pair + 32, proof + off, 32);
      } else {
        std::memcpy(pair, proof + off, 32);
        std::memcpy(pair + 32, cur, 32);
      }
      sha256_once(pair, 64, cur);
      off += 32;
    }
    idx /= 2;
    size = (size + 1) / 2;
  }
  return off == proof_len && std::memcmp(cur, root32, 32) == 0;
}

// Fiat-Shamir send absorption: state' = sha256_hex(utf8(state_hex ++ hex(msg))).
// state_hex: 64 lowercase hex chars (or empty, len 0).  Writes 64 chars.
void stark_channel_absorb(const char* state_hex, size_t state_len,
                          const uint8_t* msg, size_t msg_len, char* out_hex) {
  static const char* hexd = "0123456789abcdef";
  Sha256Ctx c;
  c.update(reinterpret_cast<const uint8_t*>(state_hex), state_len);
  // stream hex(msg) without materializing it
  uint8_t hx[2];
  for (size_t i = 0; i < msg_len; i++) {
    hx[0] = uint8_t(hexd[msg[i] >> 4]);
    hx[1] = uint8_t(hexd[msg[i] & 15]);
    c.update(hx, 2);
  }
  uint8_t dig[32];
  c.final(dig);
  for (int i = 0; i < 32; i++) {
    out_hex[2 * i] = hexd[dig[i] >> 4];
    out_hex[2 * i + 1] = hexd[dig[i] & 15];
  }
}

}  // extern "C"
