// K3 (leaves, with the node levels above them) and K4 (one node level; the
// tail of a tree): the batched SHA-256 of a Merkle tree build.
//
// Replaces the TPU kernels stark_tpu/hash/pallas_sha.py _make_leaf_kernel
// in both its modes (driven by _leaf_call / _leaf_jit: the u32 mode, and
// the 64-bit `wide` mode of the Goldilocks field, whose leaf hashes the
// limb pair hi || lo), the XLA sha256_row_leaves of the multi-column trees
// (hash/sha256_jax.py:106, both widths), _make_node_kernel (driven by
// _node_call_halves and _node_call, orchestrated by build_tree_bitrev),
// and the XLA tail scan of the levels of at most 2^10 nodes
// (stark_tpu/merkle/tree.py:124 _tail_scan); the bit-reversed plane
// layout and the lane transposes are not carried over.
//
// Layout: a tree is one (2n-1, 8) buffer of digest rows in natural node
// order, level after level; the children of parent j are rows 2j and 2j+1
// of the level below — 64 contiguous bytes.  Digests do not depend on the
// storage layout, so transcripts are unchanged.
//
// What bounds it on an H100: 32-bit integer work (one compression per
// leaf, two per node, ~2k simple ops each), with device-memory traffic
// small beside it (4C bytes in and 32 out per leaf of C u32 columns, 8C in
// the 64-bit mode; 64 in and 32 out per node).  Every hash is one thread
// with the message schedule and working state in registers (64 rounds
// unrolled, rotates as funnel shifts); the constant words of the leaf
// preimage and of the node's padding block fold into immediates.
//
// sha_subtree: one block takes 2^span_log consecutive inputs — leaf
// values, hashed (C = 1..6 columns), or digest rows (C = 0) — keeps their
// digests in shared memory and hashes the `levels` node levels above them
// there, a barrier a level, the levels in two regions in turn.  Only the
// levels from `store_from` up reach device memory, so a pruned tree's
// unstored levels never leave the SM, and a level's nodes are dealt to the
// threads in turn, so no warp runs part-empty while the level has 32
// nodes or more: a 1024-input block keeps 5 node levels in whole warps.
// It is K3 with the first node levels fused (merkle/tree.py: 1024 leaves,
// 5 levels), K3 alone (levels = 0, one input a thread: the odd trees and
// the bare leaf wrappers), and the tail: one block from a level of at most
// 2^10 inputs to the root (the whole tree, leaves and all, when it has at
// most 2^10 leaves).  sha_nodes hashes one level a launch: the levels
// between a subtree's top and the tail, and the levels of odd size.
//
// Tree batch (stark/batch.py's B proofs): blockIdx.y is the tree, and
// each tree's inputs and digest rows start a fixed 64-bit stride after the
// last tree's, so one launch serves all B trees (B x 2^22 leaves x 8
// words passes 2^31, so the tree offsets are size_t).  A single tree is
// the batch of one.

#include <cstdint>
#include <cuda_runtime.h>

#include "sha256.cuh"

namespace {

constexpr int kThreads = 256;
// the largest block span: 4096 inputs, 3 x 4096 x 16 bytes of shared
// memory (a level and the half-level above it)
constexpr int kMaxSpanLog = 12;

// Row, from `out`, of node `node` of level l of a power-of-two tree of
// 2^tree_log inputs whose levels from `store_from` up lie one after the
// other (level 0: the inputs).
__device__ __forceinline__ size_t level_row(int tree_log, int store_from,
                                            int l, size_t node) {
  return 2 * ((size_t{1} << (tree_log - store_from)) -
              (size_t{1} << (tree_log - l))) + node;
}

__device__ __forceinline__ void put(uint4* p, const uint32_t st[8]) {
  p[0] = make_uint4(st[0], st[1], st[2], st[3]);
  p[1] = make_uint4(st[4], st[5], st[6], st[7]);
}

// The digest of input g.  C = 0: digest row g.  C = 1..6: leaf g, the
// SHA-256 of row g of the column-major values, each column's value as 8
// big-endian bytes, so the message (8C bytes, then 0x80 and the 64-bit
// length) is one block.  The u32 mode (WIDE false) reads (C, n) words,
// each value's high word 0; the 64-bit mode reads the (C, 2, n) limb
// planes of the Goldilocks field, word 2c from the hi plane and 2c + 1
// from the lo plane (stark_tpu/hash/pallas_sha.py:107-115 for C = 1,
// sha256_row_leaves(..., wide=True) for C > 1).  C = 1 is the reference's
// Sha256::hash(value.to_be_bytes()) of a one-column tree; C > 1 is the row
// form (the leaves of MerkleTree.from_columns).  C and WIDE are template
// parameters, so the message words, the padding word and the bit length
// 64C are immediates, the u32 mode's zero high words included.
// Consecutive planes lie `ld` words apart (ld >= n), so one chunk of a
// larger tree's leaves (merkle/tree.py's chunked build) is read in place.
template <int C, bool WIDE>
__device__ __forceinline__ void input_digest(const uint32_t* __restrict__ in,
                                             long long ld, long long g,
                                             uint32_t st[8]) {
  if constexpr (C == 0) {
    const uint4* row = reinterpret_cast<const uint4*>(in) + 2 * g;
    const uint4 lo = row[0], hi = row[1];
    st[0] = lo.x; st[1] = lo.y; st[2] = lo.z; st[3] = lo.w;
    st[4] = hi.x; st[5] = hi.y; st[6] = hi.z; st[7] = hi.w;
  } else {
    uint32_t w[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) w[k] = 0u;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if constexpr (WIDE) {
        w[2 * c] = in[(2 * c) * ld + g];
        w[2 * c + 1] = in[(2 * c + 1) * ld + g];
      } else {
        w[2 * c + 1] = in[c * ld + g];
      }
    }
    w[2 * C] = 0x80000000u;
    w[15] = 64u * C;
    sha::init(st);
    sha::compress(st, w);
  }
}

// Block blockIdx.x hashes inputs [blockIdx.x << span_log, +2^span_log) of
// the launch (n of them; with levels = 0 the last block may hold fewer)
// and the `levels` levels above them; its nodes are nodes (block0 +
// blockIdx.x) << (span_log - l) onward of level l of the tree, written at
// level_row.  Tree blockIdx.y reads its inputs `istride` words and writes
// its rows `ostride` rows after tree 0's.
template <int C, bool WIDE>
__global__ void __launch_bounds__(kThreads)
sha_subtree(const uint32_t* __restrict__ in, uint4* __restrict__ out,
            long long n, long long ld, long long istride, long long ostride,
            int span_log, int levels, int store_from, int tree_log,
            long long block0) {
  static_assert(C >= 0 && C <= 6, "one block holds at most 6 values");
  extern __shared__ uint4 sh[];
  const int span = 1 << span_log;
  const size_t b = static_cast<size_t>(block0) + blockIdx.x;
  in += static_cast<size_t>(blockIdx.y) * istride;
  out += static_cast<size_t>(blockIdx.y) * ostride * 2;
  // level l lives in region l % 2: span rows at sh, then span / 2 rows
  uint4* const odd = sh + 2 * span;
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const long long g = static_cast<long long>(blockIdx.x) * span + i;
    if (g >= n) break;
    uint32_t st[8];
    input_digest<C, WIDE>(in, ld, g, st);
    if (levels > 0) put(sh + 2 * i, st);
    if (store_from == 0)
      put(out + 2 * level_row(tree_log, 0, 0, (b << span_log) + i), st);
  }
  for (int l = 1; l <= levels; ++l) {
    __syncthreads();
    const uint4* kids = (l & 1) ? sh : odd;
    uint4* parents = (l & 1) ? odd : sh;
    const int count = span >> l;
    for (int j = threadIdx.x; j < count; j += kThreads) {
      uint32_t w[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 v = kids[4 * j + q];
        w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z;
        w[4 * q + 3] = v.w;
      }
      uint32_t st[8];
      sha::pair(st, w);
      if (l < levels) put(parents + 2 * j, st);
      if (l >= store_from)
        put(out + 2 * level_row(tree_log, store_from, l,
                                (b << (span_log - l)) + j), st);
    }
  }
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

// in: with cols = 1..6 the (cols, n) words of column-major rows (cols = 1:
// n values), or with `wide` the (cols, 2, n) limb planes of 64-bit values,
// each plane `ld` words after the one before (ld >= n); with cols = 0 the
// (n, 8) digest rows of a level (16-byte aligned).  For each of `batch`
// trees, tree b's inputs `istride` words after tree 0's and its rows
// `ostride` rows after tree 0's.  Hashes the inputs and the `levels` node
// levels above them, 2^span_log inputs a block (n a multiple of it unless
// levels = 0), and writes the levels from `store_from` up into `out` as
// the rows of a tree of 2^tree_log inputs whose stored levels start at
// `store_from`, the first block being block `block0` of that tree.
extern "C" int stark_sha_subtree(const void* in, void* out, long long n,
                                 long long ld, long long istride,
                                 long long ostride, int cols, int wide,
                                 int span_log, int levels, int store_from,
                                 int tree_log, long long block0, int batch,
                                 void* stream) {
  using Kernel = void (*)(const uint32_t*, uint4*, long long, long long,
                          long long, long long, int, int, int, int,
                          long long);
  static const Kernel kKernels[2][7] = {
      {sha_subtree<0, false>, sha_subtree<1, false>, sha_subtree<2, false>,
       sha_subtree<3, false>, sha_subtree<4, false>, sha_subtree<5, false>,
       sha_subtree<6, false>},
      {sha_subtree<0, false>, sha_subtree<1, true>, sha_subtree<2, true>,
       sha_subtree<3, true>, sha_subtree<4, true>, sha_subtree<5, true>,
       sha_subtree<6, true>}};
  const long long span = 1LL << (span_log < 0 ? 0 : span_log);
  if (cols < 0 || cols > 6 || n < 0 || (cols > 0 && ld < n) || batch < 0 ||
      batch > 65535 || istride < 0 || ostride < 0 || span_log < 0 ||
      span_log > kMaxSpanLog || levels < 0 || levels > span_log ||
      store_from < 0 || store_from > levels || (cols == 0 && store_from < 1) ||
      tree_log < span_log || tree_log > 40 || block0 < 0 ||
      (levels > 0 && n % span != 0))
    return (int)cudaErrorInvalidValue;
  const long long blocks = levels > 0 ? n / span : (n + span - 1) / span;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (blocks == 0 || batch == 0) return (int)cudaGetLastError();
  const Kernel kernel = kKernels[wide != 0][cols];
  const int smem = levels > 0 ? (int)(3 * span * sizeof(uint4)) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3((unsigned)blocks, batch), kThreads, smem,
           (cudaStream_t)stream>>>((const uint32_t*)in, (uint4*)out, n, ld,
                                   istride, ostride, span_log, levels,
                                   store_from, tree_log, block0);
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
