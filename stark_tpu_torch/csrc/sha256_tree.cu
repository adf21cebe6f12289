// K3 (leaves) and K4 (nodes): the batched SHA-256 of a Merkle tree build.
//
// Replaces the TPU kernels stark_tpu/hash/pallas_sha.py _make_leaf_kernel
// (driven by _leaf_call / _leaf_jit) and _make_node_kernel (driven by
// _node_call_halves and _node_call, orchestrated by build_tree_bitrev);
// the bit-reversed plane layout, the lane transposes and the XLA tail
// scan below 1024 nodes are not carried over.
//
// Layout: a tree is one (2n-1, 8) buffer of digest rows in natural node
// order, level after level; the children of parent j are rows 2j and 2j+1
// of the level below — 64 contiguous bytes.  Digests do not depend on the
// storage layout, so transcripts are unchanged.
//
// What bounds it on an H100: 32-bit integer work (one compression per
// leaf, two per node, ~2k simple ops each), with device-memory traffic
// small beside it (4 bytes in and 32 out per leaf, 64 in and 32 out per
// node).  Design: one thread per hash with the whole message schedule and
// working state in registers (64 rounds unrolled, rotates as funnel
// shifts); the constant words of the leaf preimage and of the node's
// padding block fold into immediates.  Nodes run for every level down to
// the root, so no level takes another path.

#include <cstdint>
#include <cuda_runtime.h>

#include "sha256.cuh"

namespace {

constexpr int kThreads = 256;

// Leaf i = SHA-256 of the 8-byte big-endian value (high word 0): the
// reference's Sha256::hash(value.to_be_bytes()).
__global__ void __launch_bounds__(kThreads)
sha_leaves(const uint32_t* __restrict__ values, uint4* __restrict__ out,
           int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t w[16] = {0u, values[i], 0x80000000u, 0u, 0u, 0u, 0u, 0u,
                    0u, 0u, 0u, 0u, 0u, 0u, 0u, 64u};
  uint32_t st[8];
  sha::init(st);
  sha::compress(st, w);
  out[2 * i] = make_uint4(st[0], st[1], st[2], st[3]);
  out[2 * i + 1] = make_uint4(st[4], st[5], st[6], st[7]);
}

// Parent j = SHA-256(child[2j] || child[2j+1]): one data block plus the
// constant padding block of a 64-byte message.
__global__ void __launch_bounds__(kThreads)
sha_nodes(const uint4* __restrict__ children, uint4* __restrict__ out,
          int m) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  uint32_t w[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = children[4 * j + q];
    w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
  uint32_t st[8];
  sha::init(st);
  sha::compress(st, w);
  uint32_t pad[16] = {0x80000000u, 0u, 0u, 0u, 0u, 0u, 0u, 0u,
                      0u, 0u, 0u, 0u, 0u, 0u, 0u, 512u};
  sha::compress(st, pad);
  out[2 * j] = make_uint4(st[0], st[1], st[2], st[3]);
  out[2 * j + 1] = make_uint4(st[4], st[5], st[6], st[7]);
}

}  // namespace

// values: n words; out: (n, 8) digest rows (16-byte aligned).
extern "C" int stark_sha_leaves(const void* values, void* out, int n,
                                void* stream) {
  if (n > 0)
    sha_leaves<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                 (cudaStream_t)stream>>>((const uint32_t*)values,
                                         (uint4*)out, n);
  return (int)cudaGetLastError();
}

// children: (2m, 8) digest rows; out: (m, 8) parent rows.
extern "C" int stark_sha_nodes(const void* children, void* out, int m,
                               void* stream) {
  if (m > 0)
    sha_nodes<<<(m + kThreads - 1) / kThreads, kThreads, 0,
                (cudaStream_t)stream>>>((const uint4*)children, (uint4*)out,
                                        m);
  return (int)cudaGetLastError();
}
