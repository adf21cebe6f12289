// K5: the flagged, strictly sequential SHA-256 block chain of the
// Fiat-Shamir transcript.
//
// Replaces the TPU kernel stark_tpu/hash/pallas_chain.py
// _make_chain_kernel (driven by _chain_call / sha_chain; hex helper
// _hex_words).  Semantics are those of device_query._block_step, with one
// extension for the port's device channel:
//
//   flags[i] = (first, last)
//   first == 1: reset the compressor to H0 and hash the 64-char lowercase
//               hex of the chain state instead of row i;
//   first == 2: reset the compressor to H0 and hash row i as it is (the
//               first absorb of a fresh channel, which has no prior state);
//   last  != 0: the compression output becomes the new chain state.
//
// What bounds it on an H100: the latency of one serial chain — every block
// depends on the one before, so there is no parallelism to use and the
// time is ~B compressions back to back on one thread.  Design: one thread
// keeps the compressor and chain state in registers for the whole stream,
// reads 64 bytes of stream (as four 16-byte loads) and 8 bytes of flags
// per block, and writes the 32-byte chain state once at the end.  The
// caller launches it once per query (or per channel operation), so the
// stream never leaves the card between blocks.

#include <cstdint>
#include <cuda_runtime.h>

#include "sha256.cuh"

namespace {

// The UTF-8 bytes of the 8 lowercase hex chars of x, as two big-endian
// words of 4 chars each.
__device__ __forceinline__ void hex_words(uint32_t x, uint32_t* out) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t acc = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t nib = (x >> (28 - 4 * (4 * half + k))) & 0xFu;
      const uint32_t ch = nib < 10u ? 0x30u + nib : 0x57u + nib;
      acc |= ch << (24 - 8 * k);
    }
    out[half] = acc;
  }
}

__global__ void sha_chain(const uint4* __restrict__ stream,
                          const int2* __restrict__ flags,
                          const uint32_t* __restrict__ chain_in,
                          uint32_t* __restrict__ chain_out, int nblocks) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  uint32_t chain[8], st[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) { chain[k] = chain_in[k]; st[k] = 0u; }
  for (int i = 0; i < nblocks; ++i) {
    const int2 fl = flags[i];
    uint32_t w[16];
    if (fl.x == 1) {
#pragma unroll
      for (int k = 0; k < 8; ++k) hex_words(chain[k], w + 2 * k);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 v = stream[4 * i + q];
        w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z;
        w[4 * q + 3] = v.w;
      }
    }
    if (fl.x != 0) sha::init(st);
    sha::compress(st, w);
    if (fl.y != 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) chain[k] = st[k];
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) chain_out[k] = chain[k];
}

}  // namespace

// stream: (B, 16) words; flags: (B, 2) int32 (first, last);
// chain_in / chain_out: 8 words each.
extern "C" int stark_sha_chain(const void* stream, const void* flags,
                               const void* chain_in, void* chain_out,
                               int nblocks, void* s) {
  sha_chain<<<1, 1, 0, (cudaStream_t)s>>>(
      (const uint4*)stream, (const int2*)flags, (const uint32_t*)chain_in,
      (uint32_t*)chain_out, nblocks);
  return (int)cudaGetLastError();
}
