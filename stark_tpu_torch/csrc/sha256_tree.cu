// K3 (leaves) and K4 (nodes): the batched SHA-256 of a Merkle tree build.
//
// Replaces the TPU kernels stark_tpu/hash/pallas_sha.py _make_leaf_kernel
// in both its modes (driven by _leaf_call / _leaf_jit: the u32 mode, and
// the 64-bit `wide` mode of the Goldilocks field, whose leaf hashes the
// limb pair hi || lo), the XLA sha256_row_leaves of the multi-column trees
// (hash/sha256_jax.py:106, both widths), and _make_node_kernel (driven by
// _node_call_halves and _node_call, orchestrated by build_tree_bitrev);
// the bit-reversed plane layout, the lane transposes and the XLA tail scan
// below 1024 nodes are not carried over.
//
// Layout: a tree is one (2n-1, 8) buffer of digest rows in natural node
// order, level after level; the children of parent j are rows 2j and 2j+1
// of the level below — 64 contiguous bytes.  Digests do not depend on the
// storage layout, so transcripts are unchanged.
//
// What bounds it on an H100: 32-bit integer work (one compression per
// leaf, two per node, ~2k simple ops each), with device-memory traffic
// small beside it (4C bytes in and 32 out per leaf of C u32 columns, 8C in
// the 64-bit mode; 64 in and 32 out per node).  Design: one thread per
// hash with the whole message schedule and working state in registers (64
// rounds unrolled, rotates as funnel shifts); the constant words of the
// leaf preimage and of the node's padding block fold into immediates.
// Nodes run for every level down to the root, so no level takes another
// path.
//
// Tree batch (stark/batch.py's B proofs): blockIdx.y is the tree, and
// each tree's values and digest rows start a fixed 64-bit stride after
// the last tree's, so one launch hashes the leaves of all B trees and one
// launch a level their nodes (B x 2^22 leaves x 8 words passes 2^31, so
// the tree offsets are size_t).  A single tree is the batch of one.

#include <cstdint>
#include <cuda_runtime.h>

#include "sha256.cuh"

namespace {

constexpr int kThreads = 256;

// Leaf i = SHA-256 of row i of the column-major values: each column's
// value as 8 big-endian bytes, C = 1..6, so the message (8C bytes, then
// 0x80 and the 64-bit length) is one block.  The u32 mode (WIDE false)
// reads (C, n) words, each value's high word 0; the 64-bit mode reads the
// (C, 2, n) limb planes of the Goldilocks field, word 2c from the hi plane
// and 2c + 1 from the lo plane (stark_tpu/hash/pallas_sha.py:107-115 for
// C = 1, sha256_row_leaves(..., wide=True) for C > 1).  C = 1 is the
// reference's Sha256::hash(value.to_be_bytes()) of a one-column tree; C > 1
// is the row form (the leaves of MerkleTree.from_columns).  C and WIDE are
// template parameters, so the message words, the padding word and the bit
// length 64C are immediates, the u32 mode's zero high words included.
// Consecutive planes lie `ld` words apart (ld >= n), so one chunk of a
// larger tree's leaves (merkle/tree.py's chunked build) is read in place.
// Tree blockIdx.y reads its values `vstride` words and writes its digests
// `ostride` rows after tree 0's.
template <int C, bool WIDE>
__global__ void __launch_bounds__(kThreads)
sha_leaves(const uint32_t* __restrict__ values, uint4* __restrict__ out,
           int n, long long ld, long long vstride, long long ostride) {
  static_assert(C >= 1 && C <= 6, "one block holds at most 6 values");
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  values += static_cast<size_t>(blockIdx.y) * vstride;
  out += static_cast<size_t>(blockIdx.y) * ostride * 2;
  uint32_t w[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) w[k] = 0u;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if constexpr (WIDE) {
      w[2 * c] = values[(2 * c) * ld + i];
      w[2 * c + 1] = values[(2 * c + 1) * ld + i];
    } else {
      w[2 * c + 1] = values[c * ld + i];
    }
  }
  w[2 * C] = 0x80000000u;
  w[15] = 64u * C;
  uint32_t st[8];
  sha::init(st);
  sha::compress(st, w);
  out[2 * i] = make_uint4(st[0], st[1], st[2], st[3]);
  out[2 * i + 1] = make_uint4(st[4], st[5], st[6], st[7]);
}

// Parent j = SHA-256(child[2j] || child[2j+1]): one data block plus the
// constant padding block of a 64-byte message.  Tree blockIdx.y's rows
// lie `cstride` / `ostride` rows after tree 0's.
__global__ void __launch_bounds__(kThreads)
sha_nodes(const uint4* __restrict__ children, uint4* __restrict__ out,
          int m, long long cstride, long long ostride) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  children += static_cast<size_t>(blockIdx.y) * cstride * 2;
  out += static_cast<size_t>(blockIdx.y) * ostride * 2;
  uint32_t w[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = children[4 * j + q];
    w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
  uint32_t st[8];
  sha::pair(st, w);
  out[2 * j] = make_uint4(st[0], st[1], st[2], st[3]);
  out[2 * j + 1] = make_uint4(st[4], st[5], st[6], st[7]);
}

}  // namespace

// values: (cols, n) words, column-major rows of a trace (cols = 1: n
// values), or with `wide` the (cols, 2, n) limb planes of 64-bit values,
// each plane `ld` words after the one before (ld >= n), for each of
// `batch` trees, tree b's `vstride` words after tree 0's; out: (n, 8)
// digest rows (16-byte aligned) a tree, tree b's `ostride` rows after
// tree 0's.
extern "C" int stark_sha_leaves(const void* values, void* out, int n,
                                long long ld, long long vstride,
                                long long ostride, int cols, int wide,
                                int batch, void* stream) {
  using Leaves = void (*)(const uint32_t*, uint4*, int, long long, long long,
                          long long);
  static const Leaves kLeaves[2][6] = {
      {sha_leaves<1, false>, sha_leaves<2, false>, sha_leaves<3, false>,
       sha_leaves<4, false>, sha_leaves<5, false>, sha_leaves<6, false>},
      {sha_leaves<1, true>, sha_leaves<2, true>, sha_leaves<3, true>,
       sha_leaves<4, true>, sha_leaves<5, true>, sha_leaves<6, true>}};
  if (cols < 1 || cols > 6 || n < 0 || ld < n || batch < 0 ||
      batch > 65535 || vstride < 0 || ostride < 0)
    return (int)cudaErrorInvalidValue;
  if (n > 0 && batch > 0)
    kLeaves[wide != 0][cols - 1]<<<dim3((n + kThreads - 1) / kThreads,
                                        batch),
                                   kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)values, (uint4*)out, n, ld, vstride, ostride);
  return (int)cudaGetLastError();
}

// children: (2m, 8) digest rows; out: (m, 8) parent rows; for each of
// `batch` trees, tree b's `cstride` / `ostride` rows after tree 0's.
extern "C" int stark_sha_nodes(const void* children, void* out, int m,
                               long long cstride, long long ostride,
                               int batch, void* stream) {
  if (m < 0 || batch < 0 || batch > 65535 || cstride < 0 || ostride < 0)
    return (int)cudaErrorInvalidValue;
  if (m > 0 && batch > 0)
    sha_nodes<<<dim3((m + kThreads - 1) / kThreads, batch), kThreads, 0,
                (cudaStream_t)stream>>>((const uint4*)children, (uint4*)out,
                                        m, cstride, ostride);
  return (int)cudaGetLastError();
}
