// K1 and K2: one two-pass NTT / INTT family over GF(p), odd p < 2^32, for
// every power-of-two n from 1 to 2^30 (ntt_pass1 + ntt_pass2).
//
// Replaces the TPU kernels of stark_tpu/ntt/pallas_ntt.py:
//   K1  _PallasNTT._step1_kernel (:188) and _step2_kernel (:194), called
//       at :205 and :222 (n <= 2^22);
//   K2  _ThreeStepNTT._k1_kernel (:328) and _k2a_kernel (:334), called at
//       :343 and :360, with the XLA coarse stages after them (:374-388)
//       (2^22 < n <= 2^30).
// On the card both are these two kernels; the wrappers count K1 and K2 by
// the route (ntt/cuda_ntt.py).  A batch of C transforms of one length (the
// trace columns of a multi-column AIR, stark_tpu/ntt/ntt.py:291-303 and
// stark/trace.py:120-136) is one launch of each pass with the transform
// index as blockIdx.y: no pass-1 column group and no pass-2 cluster ever
// spans two transforms.
//
// Algebra (the TPU plans' own): n = n1 * n2, j = j1*n2 + j2,
// k = k1 + n1*k2, w the order-n root (its inverse for the INTT):
//   Y[k1, j2] = sum_j1 x[j1*n2 + j2] (w^n2)^(j1*k1)             pass 1
//   C[k1, j2] = Y[k1, j2] * w^(j2*k1)                           pass 1
//   X[k1 + n1*k2] = [n^-1] sum_j2 C[k1, j2] (w^n1)^(j2*k2)      pass 2
// Both transforms are decimation in frequency: natural input, position q
// holding index bitrev(q) on output.  So pass 1 writes its position q to
// row bitrev(q) of C and pass 2 its position q to k2 = bitrev(q): the
// bit-reversal costs an address, not a permutation in shared memory.
//
// ntt_pass1<L1>: block b holds columns [b*C, (b+1)*C) of x.reshape(n1, n2)
//   whole in shared memory, C = 8 while n1 <= 2^12 (8 x 2^12 words =
//   128 KB), so each row's 32 bytes are one sector on the strided load and
//   on the store to C.  Above 2^12 rows (n > 2^27: n1 = n / 2^15, on no
//   path of the prover) the group narrows to 2^15 / n1 columns: the same
//   kernel, a third of a sector or less a row, and no third pass.
// ntt_pass2<L2>: block k1 holds row k1 of C (n2 <= 2^15 contiguous words)
//   in shared memory.  Its strided side is the output, X[k1 + n1*k2]: the
//   blocks of 8 adjacent rows form a thread block cluster and, after a
//   cluster barrier, each block writes a share of the positions by reading
//   the 8 rows' values from the blocks' shared memory (distributed shared
//   memory), so every 8 adjacent k1 leave as one 32-byte sector.
//
// What bounds it on an H100: per element 16 bytes of device memory (x
// read, C written and read, X written; 0.32 ms at 2^26 at 3.35 TB/s) and
// log2(n)/2 butterflies of ~10 32-bit operations plus one twiddle product
// pair (w^(j2*k1) from two tables, then the product) and, for the inverse,
// the n^-1 product: about the same time (the operation bound at 2^26 is
// 0.29 ms on chip_smoke.py's yardstick).  What the design does:
//   - sizes at compile time: both kernels are templated on log2 of their
//     transform length; the column count and the cluster size are powers
//     of two applied by shifts and masks, so no index divides;
//   - radix 16 in registers: each thread loads 16 elements of a column,
//     runs 4 DIF stages on them and stores them back, so a transform of
//     2^L makes ceil(L/4) passes over shared memory with one
//     __syncthreads() each (a smaller radix for the last round);
//   - shared memory is padded by one word every 32 (index i at
//     i + i/32), so the groups' strided rows and the twiddle reads of the
//     late rounds hit distinct banks or at most two ways;
//   - twiddles: each pass copies its sub-transform's table (n_pass/2
//     mont powers, at most 2^14 words) into shared memory; w^(j2*k1) is
//     hi[e >> h] * lo[e & (2^h - 1)], e = j2*k1 < n, two read-only tables
//     of about sqrt(n) words each: no n-word table;
//   - canonical data: every twiddle is in Montgomery form, and a
//     Montgomery product of a canonical value and mont(t) is the canonical
//     product, so there is no to_mont or from_mont pass;
//   - 32-bit arithmetic: p may exceed 2^31 (3*2^30+1), so a sum of two
//     residues can carry out of 32 bits and lazy reduction into [0, 2p) is
//     not available.  add_mod compares a with p - b instead of forming
//     a + b, and the Montgomery product uses m = lo * p^-1, for which
//     (a*b - m*p) / 2^32 = hi - mh exactly: four multiplies, one compare,
//     one select and one add, no carry (the SASS is IMAD / IMAD.HI /
//     IADD3 / ISETP / SEL, no 64-bit add);
//   - no tensor cores: a 32-bit modular product needs its 64-bit result
//     (an int8 limb decomposition of the small DFTs is out of scope).
//   - asynchronous loads: each thread issues all its 4-byte cp.async
//     copies (global -> shared, no register staging) and waits once, so
//     a block keeps its whole tile in flight; a tile's copy does not
//     overlap its own butterflies, only other resident blocks' work.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// block sizes at the largest tiles, and the radix of a register round:
// the fastest of 512 / 1024 threads and radix 8 / 16 at 2^22..2^26 on the
// H100 (pass 1 has one 2^15-word tile a SM, so more threads hide more of
// its latency; pass 2 runs two tiles a SM at 2^14 and keeps 512)
constexpr int kThreads1 = 1024;
constexpr int kThreads2 = 512;
constexpr int kMaxLog = 15;  // a block holds at most 2^15 words of a pass
constexpr int kClusterLog = 3;  // pass 2: 8 rows a cluster
constexpr int kRadix = 16;

struct Field {
  uint32_t p, pinv;  // pinv = p^-1 mod 2^32
};

// a * b * 2^-32 mod p, canonical, for a * b < p * 2^32 (a or b canonical):
// with m = lo * p^-1 mod 2^32, m * p = mh * 2^32 + lo exactly, so
// (a*b - m*p) / 2^32 = hi - mh, which lies in (-p, p).  Four multiplies and
// three 32-bit operations, no carry out of 32 bits.
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b, Field f) {
  const uint32_t lo = a * b, hi = __umulhi(a, b);
  const uint32_t mh = __umulhi(lo * f.pinv, f.p);
  return hi - mh + (hi < mh ? f.p : 0u);
}

// p may exceed 2^31: a + b >= p exactly when a >= p - b, so the sum never
// has to be formed beyond 32 bits
__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, Field f) {
  return a + b - (a >= f.p - b ? f.p : 0u);
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, Field f) {
  return a - b + (a < b ? f.p : 0u);
}

// 4-byte asynchronous copy, global -> shared (no register staging, so a
// thread keeps all its copies in flight)
__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t bitrev(uint32_t r, int bits) {
  return bits == 0 ? 0u : __brev(r) >> (32 - bits);
}

// shared-memory index with one pad word every 32
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__host__ __device__ constexpr int ilog2(int v) {
  return v <= 1 ? 0 : 1 + ilog2(v >> 1);
}

__host__ __device__ constexpr int padded_words(int words) {
  return words + (words >> 5) + 1;
}

// One round of log2(R) DIF stages, the first of block length L, down the
// 2^lc columns of the (N, 2^lc) array s (row-major, padded).  Each thread
// takes groups of R elements at rows b*L + i0 + m*(L/R), m < R, of one
// column; tw[pad(k)] = mont(root^k), k < N/2.
template <int LN, int L, int R>
__device__ __forceinline__ void dif_round(uint32_t* s, const uint32_t* tw,
                                          int lc, Field f) {
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
    uint32_t v[R];
#pragma unroll
    for (int m = 0; m < R; ++m) v[m] = s[pad(((row0 + m * Q) << lc) + c)];
#pragma unroll
    for (int st = 0; st < LR; ++st) {
      const int half = R >> (st + 1);
#pragma unroll
      for (int m = 0; m < R; ++m) {
        if (m & half) continue;
        // position of element m in its sub-block of length L >> st
        const int j = (m & (2 * half - 1)) * Q + i0;
        const uint32_t w = tw[pad(((N / L) << st) * j)];
        const uint32_t a = v[m], b = v[m + half];
        v[m] = add_mod(a, b, f);
        v[m + half] = mont_mul(sub_mod(a, b, f), w, f);
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
__device__ __forceinline__ void dif_rounds(uint32_t* s, const uint32_t* tw,
                                           int lc, Field f) {
  if constexpr (L >= kRadix) {
    dif_round<LN, L, kRadix>(s, tw, lc, f);
    dif_rounds<LN, L / kRadix>(s, tw, lc, f);
  } else if constexpr (L >= 2) {
    dif_round<LN, L, L>(s, tw, lc, f);
  }
}

// Pass 1: block b owns columns j2 in [b << lc, (b + 1) << lc) of the
// (n1, n2) view of x, n1 = 2^LN; writes C[k1, j2] = Y[k1, j2] * w^(j2*k1).
template <int LN>
__global__ void __launch_bounds__(kThreads1)
ntt_pass1(const uint32_t* __restrict__ x, const uint32_t* __restrict__ tw_g,
          const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
          uint32_t* __restrict__ c, int log_n2, int lc, int h, Field f) {
  constexpr int N = 1 << LN;
  extern __shared__ uint32_t smem[];
  const int words = N << lc;
  uint32_t* s = smem;
  uint32_t* tw = smem + padded_words(words);
  const int cmask = (1 << lc) - 1;
  const uint32_t j0 = blockIdx.x << lc;
  // column blockIdx.y of a batched (C, n) input
  const size_t column = (size_t)blockIdx.y << (LN + log_n2);
  x += column;
  c += column;
  for (int i = threadIdx.x; i < N / 2; i += blockDim.x)
    cp_async4(tw + pad(i), tw_g + i);
  for (int i = threadIdx.x; i < words; i += blockDim.x)
    cp_async4(s + pad(i), x + ((size_t)(i >> lc) << log_n2) + j0 + (i & cmask));
  cp_async_wait_all();
  __syncthreads();
  dif_rounds<LN, N>(s, tw, lc, f);
  const uint32_t hmask = (1u << h) - 1u;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const uint32_t j2 = j0 + (i & cmask);
    const uint32_t k1 = bitrev(i >> lc, LN);
    const uint32_t e = j2 * k1;  // < n <= 2^30
    const uint32_t w =
        mont_mul(__ldg(hi + (e >> h)), __ldg(lo + (e & hmask)), f);
    c[((size_t)k1 << log_n2) + j2] = mont_mul(s[pad(i)], w, f);
  }
}

// Pass 2: block k1 owns row k1 of C (n2 = 2^LN words); the cluster of
// 2^lcl adjacent rows writes X[k1 + n1*k2] in whole 2^lcl-word pieces.
template <int LN>
__global__ void __launch_bounds__(kThreads2)
ntt_pass2(const uint32_t* __restrict__ c, const uint32_t* __restrict__ tw_g,
          uint32_t* __restrict__ out, int log_n1, int lcl, Field f,
          uint32_t scale) {
  constexpr int N = 1 << LN;
  extern __shared__ uint32_t smem[];
  uint32_t* s = smem;
  uint32_t* tw = smem + padded_words(N);
  const uint32_t k1 = blockIdx.x;
  // column blockIdx.y of a batched (C, n) input
  const size_t column = (size_t)blockIdx.y << (LN + log_n1);
  c += column;
  out += column;
  const uint32_t* row = c + ((size_t)k1 << LN);
  for (int i = threadIdx.x; i < N / 2; i += blockDim.x)
    cp_async4(tw + pad(i), tw_g + i);
  for (int i = threadIdx.x; i < N; i += blockDim.x) cp_async4(s + pad(i), row + i);
  cp_async_wait_all();
  __syncthreads();
  dif_rounds<LN, N>(s, tw, 0, f);

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every row of the cluster transformed
  const int rank = (int)cluster.block_rank();
  const int cl = 1 << lcl;
  // element i of the cluster's N * cl outputs: position i >> lcl of row
  // k1base + (i & (cl - 1)); blockDim.x is a multiple of cl, so a thread
  // always reads the same row
  const int first = rank * blockDim.x + threadIdx.x;
  const int src = first & (cl - 1);
  const uint32_t* rs = cluster.map_shared_rank(s, src);
  const size_t col = (size_t)(k1 - rank) + src;
  for (int i = first; i < (N << lcl); i += blockDim.x << lcl) {
    const int q = i >> lcl;
    uint32_t v = rs[pad(q)];
    if (scale) v = mont_mul(v, scale, f);  // n^-1 (inverse only)
    out[((size_t)bitrev(q, LN) << log_n1) + col] = v;
  }
  cluster.sync();  // no block leaves while the others read its rows
}

using Pass1 = void (*)(const uint32_t*, const uint32_t*, const uint32_t*,
                       const uint32_t*, uint32_t*, int, int, int, Field);
using Pass2 = void (*)(const uint32_t*, const uint32_t*, uint32_t*, int, int,
                       Field, uint32_t);

#define STARK_NTT_LOGS(K)                                                   \
  {K<0>,  K<1>,  K<2>,  K<3>,  K<4>,  K<5>,  K<6>,  K<7>,                   \
   K<8>,  K<9>,  K<10>, K<11>, K<12>, K<13>, K<14>, K<15>}
const Pass1 kPass1[kMaxLog + 1] = STARK_NTT_LOGS(ntt_pass1);
const Pass2 kPass2[kMaxLog + 1] = STARK_NTT_LOGS(ntt_pass2);
#undef STARK_NTT_LOGS

// a thread for every radix group of a round, within [32, most]
int threads_for(int words, int most) {
  const int t = words / kRadix;
  return t < 32 ? 32 : (t > most ? most : t);
}

size_t smem_bytes(int words, int len) {
  const int half = len / 2 > 0 ? len / 2 : 1;
  return (size_t)(padded_words(words) + padded_words(half)) * sizeof(uint32_t);
}

}  // namespace

// x, out: `columns` transforms of n = 2^(log1 + log2) canonical words
// each, one after another ((C, n) row-major); c: as many words of scratch
// (the intermediate C); tw1 / tw2: mont powers of the pass roots w^n2 /
// w^n1 (max(n1/2, 1) and max(n2/2, 1) words); hi / lo: mont powers of
// w^(2^h) (n >> h words) and of w (2^h words); cols_log: log2 of pass 1's
// column group; scale = mont(n^-1) for the inverse transform, 0 for the
// forward one.  Launches pass 1, then pass 2 in clusters of min(8, n1)
// blocks, each with the transforms as the grid's y dimension: a column
// group and a cluster always lie in one transform.
extern "C" int stark_ntt(const void* x, const void* tw1, const void* tw2,
                         const void* hi, const void* lo, void* c, void* out,
                         int log1, int log2, int cols_log, int h,
                         int columns, uint32_t p, uint32_t pinv,
                         uint32_t scale, void* stream) {
  if (log1 < 0 || log2 < 0 || log1 > kMaxLog || log2 > kMaxLog ||
      cols_log < 0 || cols_log > log2 || log1 + cols_log > kMaxLog ||
      h < 0 || h > log1 + log2 || columns < 1 || columns > 65535)
    return (int)cudaErrorInvalidValue;
  const Field f{p, pinv};
  cudaStream_t st = (cudaStream_t)stream;

  const int words1 = 1 << (log1 + cols_log);
  const size_t smem1 = smem_bytes(words1, 1 << log1);
  const Pass1 k1 = kPass1[log1];
  cudaError_t e = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (e != cudaSuccess) return (int)e;
  k1<<<dim3(1u << (log2 - cols_log), columns), threads_for(words1, kThreads1),
       smem1, st>>>(
      (const uint32_t*)x, (const uint32_t*)tw1, (const uint32_t*)hi,
      (const uint32_t*)lo, (uint32_t*)c, log2, cols_log, h, f);
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
  e = cudaLaunchKernelEx(&cfg, k2, (const uint32_t*)c, (const uint32_t*)tw2,
                         (uint32_t*)out, log1, lcl, f, scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
