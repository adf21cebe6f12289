// The Goldilocks NTT / INTT: a two-pass family over p = 2^64 - 2^32 + 1
// for every power-of-two n from 1 to 2^28 (ntt64_pass1 + ntt64_pass2).
//
// Replaces no TPU kernel: the JAX package computes this transform in XLA
// (stark_tpu/ntt/ntt.py:36-50, the width-generic Stockham plan, the
// four-step from 2^14), and the port ran it as torch ops
// (ntt/ntt.py ntt_limbs, which stays the plain reference).  Added because
// that torch-op Stockham, about 100 int64 launches a stage over the whole
// array, took half of a Goldilocks prove.  A batch of C transforms of one
// length (the trace columns) is one launch of each pass with the
// transform index as blockIdx.y, as csrc/ntt.cu's K1/K2 do.  This file
// shares no code with that u32 family: a 64-bit value held as two 4-byte
// planes gives another tile, sector and twiddle layout.
//
// Algebra (K1/K2's): n = n1 * n2, j = j1*n2 + j2, k = k1 + n1*k2, w the
// order-n root (its inverse for the INTT):
//   Y[k1, j2] = sum_j1 x[j1*n2 + j2] (w^n2)^(j1*k1)             pass 1
//   C[k1, j2] = Y[k1, j2] * w^(j2*k1)                           pass 1
//   X[k1 + n1*k2] = [n^-1] sum_j2 C[k1, j2] (w^n1)^(j2*k2)      pass 2
// Both transforms are decimation in frequency (natural input, position q
// holding index bitrev(q) on output), so pass 1 writes its position q to
// row bitrev(q) of C and pass 2 its position q to k2 = bitrev(q): the
// bit-reversal is an address.
//
// Storage: x and X are int32 limb planes, (2, n) or (C, 2, n), the high
// words' plane before the low words'; x's planes may lie any fixed stride
// apart (a slice along the last axis).  The intermediate C is the
// kernels' own: one uint64 a value, row-major (n1, n2) per transform.
//
// ntt64_pass1<L1>: block b holds columns [b*8, (b+1)*8) of x.reshape(n1,
//   n2) whole in shared memory as uint64, n1 <= 2^11 (8 x 2^11 x 8 bytes
//   = 128 KB), so each row's load is one 32-byte sector in each limb
//   plane; the two words of a value land in its shared uint64 by two
//   4-byte asynchronous copies (the low word at the lower address), with
//   no register staging.  Above 2^11 rows (n > 2^25, n1 = n / 2^14) the
//   group narrows to 2^14 / n1 columns.
// ntt64_pass2<L2>: block k1 holds row k1 of C (n2 <= 2^14 values) in
//   shared memory.  The blocks of 8 adjacent rows form a thread block
//   cluster and, after a cluster barrier, write X[k1 + n1*k2] by reading
//   the 8 rows from each other's shared memory, so every 8 adjacent k1
//   leave as one 32-byte sector in each limb plane; the INTT's n^-1 is
//   applied there.
//
// What bounds it on an H100: per value 32 bytes of device memory (x read,
// C written and read, X written: 0.32 ms for (2, 2^24) at 3.35 TB/s) and
// log2(n)/2 butterflies of a Goldilocks product (four 32 x 32 products and
// the reduction, ~22 32-bit operations) plus an add and a subtract, with
// the pass-1 twiddle (a product of two table entries, then the product):
// ~0.45 ms for (2, 2^24) at the derived int32 rate.  What the design does:
//   - sizes at compile time: both kernels are templated on log2 of their
//     transform length; the column group and the cluster are powers of two
//     applied by shifts and masks;
//   - radix 16 in registers: a thread holds 16 values of a column and runs
//     4 DIF stages on them, one __syncthreads() a round;
//   - shared memory as uint64 padded by one value every 16 (128 bytes), so
//     the late rounds' strided groups (stride 2..16 values) and the
//     column groups' rows fall on distinct banks or at most two ways;
//   - twiddles: each pass copies its sub-transform's table (n_pass/2
//     powers, at most 2^13 values) into shared memory; w^(j2*k1) is
//     hi[e >> h] * lo[e & (2^h - 1)], e = j2*k1 < n, from two read-only
//     tables of about sqrt(n) values: no n-value table;
//   - the reduction 2^64 = 2^32 - 1 and 2^96 = -1 (mod p) on 64-bit
//     words: a product's 128 bits hi:lo become lo - hi[63:32] +
//     hi[31:0] * (2^32 - 1), each carry or borrow a +- (2^32 - 1), and one
//     conditional subtract of p leaves every output canonical, so the
//     result is bit-identical to ntt_limbs and to the JAX plan.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads1 = 512;
constexpr int kThreads2 = 512;
constexpr int kMaxLog = 14;  // a block holds at most 2^14 values of a pass
constexpr int kClusterLog = 3;  // pass 2: 8 rows a cluster
constexpr int kRadix = 16;
constexpr uint64_t kP = 0xFFFFFFFF00000001ull;
constexpr uint64_t kEps = 0xFFFFFFFFull;  // 2^64 mod p

// a + b mod p, canonical in and out: on a carry the sum is s + 2^64, and
// s + 2^64 - p wraps to s - p, as does s - p for s >= p
__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
  const uint64_t s = a + b;
  return (s < a || s >= kP) ? s - kP : s;
}

// a - b mod p: on a borrow the wrapped difference plus p wraps back
__device__ __forceinline__ uint64_t gl_sub(uint64_t a, uint64_t b) {
  const uint64_t d = a - b;
  return a < b ? d + kP : d;
}

// a * b mod p, canonical, for canonical a and b
__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  const uint32_t a0 = (uint32_t)a, a1 = (uint32_t)(a >> 32);
  const uint32_t b0 = (uint32_t)b, b1 = (uint32_t)(b >> 32);
  const uint64_t p00 = (uint64_t)a0 * b0, p01 = (uint64_t)a0 * b1;
  const uint64_t p10 = (uint64_t)a1 * b0, p11 = (uint64_t)a1 * b1;
  const uint64_t mid = (p00 >> 32) + (uint32_t)p01 + (uint32_t)p10;
  const uint64_t lo = (mid << 32) | (uint32_t)p00;
  const uint64_t hi = p11 + (p01 >> 32) + (p10 >> 32) + (mid >> 32);
  // lo + hl * 2^64 + hh * 2^96 = lo + hl * (2^32 - 1) - hh (mod p)
  const uint64_t hh = hi >> 32, hl = hi & kEps;
  uint64_t t0 = lo - hh;
  if (lo < hh) t0 -= kEps;  // the borrow's 2^64 is 2^32 - 1; cannot wrap
  const uint64_t t1 = (hl << 32) - hl;
  uint64_t t2 = t0 + t1;
  if (t2 < t1) t2 += kEps;  // the carry's 2^64; cannot carry again
  return t2 >= kP ? t2 - kP : t2;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t bitrev(uint32_t r, int bits) {
  return bits == 0 ? 0u : __brev(r) >> (32 - bits);
}

// shared-memory index with one pad value every 16 (one 128-byte bank row)
__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

__host__ __device__ constexpr int ilog2(int v) {
  return v <= 1 ? 0 : 1 + ilog2(v >> 1);
}

__host__ __device__ constexpr int padded_values(int values) {
  return values + (values >> 4) + 1;
}

// One round of log2(R) DIF stages, the first of block length L, down the
// 2^lc columns of the (N, 2^lc) array s (row-major, padded).  Each thread
// takes groups of R values at rows b*L + i0 + m*(L/R), m < R, of one
// column; tw[pad(k)] = root^k, k < N/2.
template <int LN, int L, int R>
__device__ __forceinline__ void dif_round(uint64_t* s, const uint64_t* tw,
                                          int lc) {
  constexpr int N = 1 << LN;
  constexpr int Q = L / R;
  constexpr int LQ = ilog2(Q);
  constexpr int LL = ilog2(L);
  constexpr int LR = ilog2(R);
  const int groups = (N / R) << lc;
  const int cmask = (1 << lc) - 1;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int c = g & cmask;
    const int q = g >> lc;
    const int i0 = q & (Q - 1);
    const int row0 = ((q >> LQ) << LL) + i0;
    uint64_t v[R];
#pragma unroll
    for (int m = 0; m < R; ++m) v[m] = s[pad(((row0 + m * Q) << lc) + c)];
#pragma unroll
    for (int st = 0; st < LR; ++st) {
      const int half = R >> (st + 1);
#pragma unroll
      for (int m = 0; m < R; ++m) {
        if (m & half) continue;
        // position of value m in its sub-block of length L >> st
        const int j = (m & (2 * half - 1)) * Q + i0;
        const uint64_t a = v[m], b = v[m + half];
        v[m] = gl_add(a, b);
        v[m + half] = gl_mul(gl_sub(a, b), tw[pad(((N / L) << st) * j)]);
      }
    }
#pragma unroll
    for (int m = 0; m < R; ++m) s[pad(((row0 + m * Q) << lc) + c)] = v[m];
  }
  __syncthreads();
}

// Every DIF stage of a length-N transform, block lengths L, L/2, .. 2: in
// rounds of radix kRadix, the last of a smaller radix.
template <int LN, int L>
__device__ __forceinline__ void dif_rounds(uint64_t* s, const uint64_t* tw,
                                           int lc) {
  if constexpr (L >= kRadix) {
    dif_round<LN, L, kRadix>(s, tw, lc);
    dif_rounds<LN, L / kRadix>(s, tw, lc);
  } else if constexpr (L >= 2) {
    dif_round<LN, L, L>(s, tw, lc);
  }
}

// Pass 1: block b owns columns j2 in [b << lc, (b + 1) << lc) of the
// (n1, n2) view of x, n1 = 2^LN; writes C[k1, j2] = Y[k1, j2] * w^(j2*k1).
// x's planes lie ld words apart: column y's high plane is plane 2y.
template <int LN>
__global__ void __launch_bounds__(kThreads1)
ntt64_pass1(const uint32_t* __restrict__ x, long long ld,
            const uint64_t* __restrict__ tw_g, const uint64_t* __restrict__ hi,
            const uint64_t* __restrict__ lo, uint64_t* __restrict__ c,
            int log_n2, int lc, int h) {
  constexpr int N = 1 << LN;
  extern __shared__ uint64_t smem[];
  const int values = N << lc;
  uint64_t* s = smem;
  uint64_t* tw = smem + padded_values(values);
  const int cmask = (1 << lc) - 1;
  const uint32_t j0 = blockIdx.x << lc;
  const uint32_t* xh = x + 2 * (size_t)blockIdx.y * (size_t)ld;
  const uint32_t* xl = xh + ld;
  c += (size_t)blockIdx.y << (LN + log_n2);
  for (int i = threadIdx.x; i < N / 2; i += blockDim.x)
    cp_async8(tw + pad(i), tw_g + i);
  for (int i = threadIdx.x; i < values; i += blockDim.x) {
    const size_t src = ((size_t)(i >> lc) << log_n2) + j0 + (i & cmask);
    uint32_t* d = reinterpret_cast<uint32_t*>(s + pad(i));
    cp_async4(d, xl + src);
    cp_async4(d + 1, xh + src);
  }
  cp_async_wait_all();
  __syncthreads();
  dif_rounds<LN, N>(s, tw, lc);
  const uint32_t hmask = (1u << h) - 1u;
  for (int i = threadIdx.x; i < values; i += blockDim.x) {
    const uint32_t j2 = j0 + (i & cmask);
    const uint32_t k1 = bitrev(i >> lc, LN);
    const uint32_t e = j2 * k1;  // < n <= 2^28
    const uint64_t w = gl_mul(__ldg(hi + (e >> h)), __ldg(lo + (e & hmask)));
    c[((size_t)k1 << log_n2) + j2] = gl_mul(s[pad(i)], w);
  }
}

// Pass 2: block k1 owns row k1 of C (n2 = 2^LN values); the cluster of
// 2^lcl adjacent rows writes X[k1 + n1*k2] in whole 2^lcl-word pieces of
// each limb plane, times scale (n^-1) for the inverse (scale 0: forward).
template <int LN>
__global__ void __launch_bounds__(kThreads2)
ntt64_pass2(const uint64_t* __restrict__ c, const uint64_t* __restrict__ tw_g,
            uint32_t* __restrict__ out, int log_n1, int lcl, uint64_t scale) {
  constexpr int N = 1 << LN;
  extern __shared__ uint64_t smem[];
  uint64_t* s = smem;
  uint64_t* tw = smem + padded_values(N);
  const uint32_t k1 = blockIdx.x;
  c += (size_t)blockIdx.y << (LN + log_n1);
  uint32_t* oh = out + ((size_t)blockIdx.y << (LN + log_n1 + 1));
  uint32_t* ol = oh + ((size_t)1 << (LN + log_n1));
  const uint64_t* row = c + ((size_t)k1 << LN);
  for (int i = threadIdx.x; i < N / 2; i += blockDim.x)
    cp_async8(tw + pad(i), tw_g + i);
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    cp_async8(s + pad(i), row + i);
  cp_async_wait_all();
  __syncthreads();
  dif_rounds<LN, N>(s, tw, 0);

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every row of the cluster transformed
  const int rank = (int)cluster.block_rank();
  const int cl = 1 << lcl;
  // value i of the cluster's N * cl outputs: position i >> lcl of row
  // k1base + (i & (cl - 1)); blockDim.x is a multiple of cl, so a thread
  // always reads the same row
  const int first = rank * blockDim.x + threadIdx.x;
  const int src = first & (cl - 1);
  const uint64_t* rs = cluster.map_shared_rank(s, src);
  const size_t col = (size_t)(k1 - rank) + src;
  for (int i = first; i < (N << lcl); i += blockDim.x << lcl) {
    const int q = i >> lcl;
    uint64_t v = rs[pad(q)];
    if (scale) v = gl_mul(v, scale);
    const size_t at = ((size_t)bitrev(q, LN) << log_n1) + col;
    oh[at] = (uint32_t)(v >> 32);
    ol[at] = (uint32_t)v;
  }
  cluster.sync();  // no block leaves while the others read its rows
}

using Pass1 = void (*)(const uint32_t*, long long, const uint64_t*,
                       const uint64_t*, const uint64_t*, uint64_t*, int, int,
                       int);
using Pass2 = void (*)(const uint64_t*, const uint64_t*, uint32_t*, int, int,
                       uint64_t);

#define STARK_NTT64_LOGS(K)                                                 \
  {K<0>,  K<1>,  K<2>,  K<3>,  K<4>,  K<5>,  K<6>,  K<7>,                   \
   K<8>,  K<9>,  K<10>, K<11>, K<12>, K<13>, K<14>}
const Pass1 kPass1[kMaxLog + 1] = STARK_NTT64_LOGS(ntt64_pass1);
const Pass2 kPass2[kMaxLog + 1] = STARK_NTT64_LOGS(ntt64_pass2);
#undef STARK_NTT64_LOGS

// a thread for every radix group of a round, within [32, most]
int threads_for(int values, int most) {
  const int t = values / kRadix;
  return t < 32 ? 32 : (t > most ? most : t);
}

size_t smem_bytes(int values, int len) {
  const int half = len / 2 > 0 ? len / 2 : 1;
  return (size_t)(padded_values(values) + padded_values(half)) *
         sizeof(uint64_t);
}

}  // namespace

// x: `columns` transforms of n = 2^(log1 + log2) canonical values, each
// two int32 planes (high words, then low words), plane k at x + k * ld;
// out: the same, contiguous ((C, 2, n)); c: columns * n uint64 of scratch
// (the intermediate C); tw1 / tw2: the powers of the pass roots w^n2 /
// w^n1 (max(n1/2, 1) and max(n2/2, 1) values); hi / lo: the powers of
// w^(2^h) (n >> h values) and of w (2^h values); cols_log: log2 of pass
// 1's column group; scale = n^-1 mod p for the inverse, 0 for the forward
// transform.  Launches pass 1, then pass 2 in clusters of min(8, n1)
// blocks, each with the transforms as the grid's y dimension.
extern "C" int stark_ntt64(const void* x, long long ld, const void* tw1,
                           const void* tw2, const void* hi, const void* lo,
                           void* c, void* out, int log1, int log2,
                           int cols_log, int h, int columns, uint64_t scale,
                           void* stream) {
  if (log1 < 0 || log2 < 0 || log1 > kMaxLog || log2 > kMaxLog ||
      cols_log < 0 || cols_log > log2 || log1 + cols_log > kMaxLog ||
      h < 0 || h > log1 + log2 || columns < 1 || columns > 65535 ||
      ld < (1ll << (log1 + log2)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;

  const int values1 = 1 << (log1 + cols_log);
  const size_t smem1 = smem_bytes(values1, 1 << log1);
  const Pass1 k1 = kPass1[log1];
  cudaError_t e = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (e != cudaSuccess) return (int)e;
  k1<<<dim3(1u << (log2 - cols_log), columns),
       threads_for(values1, kThreads1), smem1, st>>>(
      (const uint32_t*)x, ld, (const uint64_t*)tw1, (const uint64_t*)hi,
      (const uint64_t*)lo, (uint64_t*)c, log2, cols_log, h);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const int lcl = log1 < kClusterLog ? log1 : kClusterLog;
  const size_t smem2 = smem_bytes(1 << log2, 1 << log2);
  const Pass2 k2 = kPass2[log2];
  e = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem2);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1u << log1, columns);
  cfg.blockDim = dim3(threads_for(1 << log2, kThreads2));
  cfg.dynamicSmemBytes = smem2;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << lcl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, k2, (const uint64_t*)c, (const uint64_t*)tw2,
                         (uint32_t*)out, log1, lcl, scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
