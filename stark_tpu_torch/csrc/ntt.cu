// K1: two-step NTT / INTT over GF(p), p < 2^32, for n = n1 * n2 <= 2^22.
//
// Replaces the TPU kernels stark_tpu/ntt/pallas_ntt.py
// _PallasNTT._step1_kernel and _PallasNTT._step2_kernel (driven by
// _PallasNTT._run), including the XLA row gathers around them.
//
//   A  = x.reshape(n1, n2)[bitrev(n1)]             folded into step 1's loads
//   C  = DIT_n1(to_mont(A)) * T,  T[k1,j2] = w^(j2*k1)          step 1
//   Ct = C.T[bitrev(n2)]                           folded into step 2's loads
//   X  = from_mont(DIT_n2(Ct) [* n^-1])  in natural order       step 2
//
// What bounds it on an H100: device-memory traffic (x, T and C read, C and
// X written: ~5 passes of 4n bytes) plus 32-bit integer multiplies
// (log2(n) Montgomery products per element).  Design: each block holds a
// group of `cols` whole columns in shared memory, so every butterfly stage
// of a sub-transform runs there between __syncthreads() and device memory
// is touched once per step.  Neighbouring threads take neighbouring
// columns on loads, stores and butterflies, so global accesses coalesce
// and shared-memory accesses hit distinct banks.  Every power-of-two n
// from 2 up runs through it; the modulus and Montgomery constants are
// arguments (the golden vectors run at p = 97).
//
// K2: three-step NTT / INTT for 2^22 < n <= 2^30, where a length-n2
// column no longer fits one block's shared memory beside 7 others.
//
// Replaces the TPU kernels stark_tpu/ntt/pallas_ntt.py
// _ThreeStepNTT._k1_kernel and _ThreeStepNTT._k2a_kernel (driven by
// _ThreeStepNTT._run), the XLA transpose and row gathers around them and
// the XLA coarse stages after them.  n = n1 * n2 with n1 = 2^R rows (R = 11
// unless the caller asks for another split), b = min(n1, n2), a = n2 / b:
//
//   C  = DIT_n1(to_mont(x.reshape(n1, n2)[bitrev(n1)])) * T    ntt_step1
//   Ct = C.T[bitrev(n2)] as (a, b, n1); the DIT stages l <= b
//        of each length-b segment of each column                ntt_block_stages
//   the coarse stages l = 2b .. n2 on the (n2, n1) array, the
//        last one fused with n^-1 and from_mont                 ntt_coarse_stage
//
// The transpose and the bit-reversal of step 2 fold into the block
// stage's loads: bitrev_{log n2}(i*b + r) = bitrev_{log b}(r)*a +
// bitrev_{log a}(i), so row r of segment i of column k1 reads
// C[k1, bitrev_b(r)*a + bitrev_a(i)].  The butterflies of a DIT with
// bit-reversed input stay inside contiguous l-row blocks, so the stages
// l <= b of one segment need no other segment; its twiddles are those of
// a length-b DIT of the root w2^a (w2 = w^n1), since w2^(n2/l) =
// (w2^a)^(b/l).
//
// What bounds it on an H100: device-memory traffic, ~3 passes of 4n bytes
// (step 1, block stages, one read-write per coarse stage) plus the n-word
// table T, and log2(n) Montgomery products per element.  Design: steps 1
// and 2a hold whole columns of 2^R words (64 KB for 8 columns at R = 11)
// in shared memory, as K1 does; the block stage reads a row of C at
// stride a, and the blocks of neighbouring segments run side by side, so
// the rest of each sector is still in L2 when they read it.  The coarse
// stages are one launch each (log2(a) of them: 2 at n = 2^24, 4 at 2^26)
// with consecutive k1 in consecutive threads, so they coalesce.  Every
// index product is size_t: T has n words, 2^30 at the top size.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxCols = 8;

struct Field {
  uint32_t p, ninv;  // ninv = -p^-1 mod 2^32
};

// REDC((hi, lo)) with the reference's exact wrap semantics
// (stark_tpu/fields/fp.py Fp._redc).
__device__ __forceinline__ uint32_t redc(uint32_t hi, uint32_t lo, Field f) {
  uint32_t m = lo * f.ninv;
  uint64_t s = (uint64_t)hi + __umulhi(m, f.p) + (lo != 0u);
  return s >= f.p ? (uint32_t)(s - f.p) : (uint32_t)s;
}

__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b, Field f) {
  return redc(__umulhi(a, b), a * b, f);
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, Field f) {
  uint64_t s = (uint64_t)a + b;
  return s >= f.p ? (uint32_t)(s - f.p) : (uint32_t)s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, Field f) {
  return a < b ? a - b + f.p : a - b;
}

__device__ __forceinline__ int bitrev(int r, int bits) {
  return bits == 0 ? 0 : (int)(__brev((unsigned)r) >> (32 - bits));
}

// All radix-2 DIT stages of a length-2^logn transform, down each of `cols`
// columns stored row-major in s[row * cols + col]; input rows bit-reversed,
// output natural.  tw[k] = mont(root^k) for k < 2^logn / 2.
__device__ void dit_stages(uint32_t* s, const uint32_t* __restrict__ tw,
                           int logn, int cols, Field f) {
  const int n = 1 << logn;
  const int nb = (n >> 1) * cols;
  for (int l = 2, stride = n >> 1; l <= n; l <<= 1, stride >>= 1) {
    const int half = l >> 1;
    for (int b = threadIdx.x; b < nb; b += blockDim.x) {
      const int cc = b % cols;
      const int bi = b / cols;
      const int j = bi & (half - 1);
      const int i0 = ((bi - j) * 2 + j) * cols + cc;  // (g*l + j) rows
      const int i1 = i0 + half * cols;
      const uint32_t bw = mont_mul(s[i1], __ldg(tw + j * stride), f);
      const uint32_t a = s[i0];
      s[i0] = add_mod(a, bw, f);
      s[i1] = sub_mod(a, bw, f);
    }
    __syncthreads();
  }
}

// Step 1: block b owns columns [b*cols, (b+1)*cols) of the (n1, n2) view.
__global__ void __launch_bounds__(kThreads)
ntt_step1(const uint32_t* __restrict__ x, const uint32_t* __restrict__ table,
          const uint32_t* __restrict__ tw, uint32_t* __restrict__ c,
          int log1, int n2, int cols, Field f, uint32_t r2) {
  extern __shared__ uint32_t s[];
  const int n1 = 1 << log1;
  const int c0 = blockIdx.x * cols;
  for (int i = threadIdx.x; i < n1 * cols; i += blockDim.x) {
    const int r = i / cols, cc = i % cols;
    const size_t src = (size_t)bitrev(r, log1) * n2 + c0 + cc;
    s[i] = mont_mul(x[src], r2, f);  // to_mont
  }
  __syncthreads();
  dit_stages(s, tw, log1, cols, f);
  for (int i = threadIdx.x; i < n1 * cols; i += blockDim.x) {
    const int r = i / cols, cc = i % cols;
    const size_t dst = (size_t)r * n2 + c0 + cc;
    c[dst] = mont_mul(s[i], __ldg(table + dst), f);  // * w^(j2*k1)
  }
}

// Step 2: block b owns columns k1 in [b*cols, (b+1)*cols) of Ct (n2, n1);
// column k1 of Ct is row k1 of C, read contiguously.
__global__ void __launch_bounds__(kThreads)
ntt_step2(const uint32_t* __restrict__ c, const uint32_t* __restrict__ tw,
          uint32_t* __restrict__ out, int log1, int log2, int cols, Field f,
          uint32_t scale) {
  extern __shared__ uint32_t s[];
  const int n1 = 1 << log1, n2 = 1 << log2;
  const int c0 = blockIdx.x * cols;
  for (int i = threadIdx.x; i < n2 * cols; i += blockDim.x) {
    const int cc = i / n2, rp = i % n2;
    s[bitrev(rp, log2) * cols + cc] = c[(size_t)(c0 + cc) * n2 + rp];
  }
  __syncthreads();
  dit_stages(s, tw, log2, cols, f);
  for (int i = threadIdx.x; i < n2 * cols; i += blockDim.x) {
    const int r = i / cols, cc = i % cols;
    uint32_t v = s[i];
    if (scale) v = mont_mul(v, scale, f);  // n^-1 (inverse only)
    out[(size_t)r * n1 + c0 + cc] = redc(0u, v, f);  // from_mont
  }
}

// K2 step 2a: block (i, g) owns segment i (rows i*b .. i*b+b-1 of Ct) of
// the columns k1 in [g*cols, (g+1)*cols); Montgomery in and out.  With
// `finish` (a == 1: no coarse stage follows) it also scales by `scale`
// (when non-zero) and leaves Montgomery form.
__global__ void __launch_bounds__(kThreads)
ntt_block_stages(const uint32_t* __restrict__ c, const uint32_t* __restrict__ tw,
                 uint32_t* __restrict__ d, int log_a, int log_b, int n1,
                 int cols, Field f, int finish, uint32_t scale) {
  extern __shared__ uint32_t s[];
  const int b = 1 << log_b;
  const size_t n2 = (size_t)b << log_a;
  const int i = blockIdx.x;
  const int c0 = blockIdx.y * cols;
  const size_t ri = (size_t)bitrev(i, log_a);
  // rp runs along a row of C at stride a; row bitrev_b(rp) of the segment
  for (int t = threadIdx.x; t < b * cols; t += blockDim.x) {
    const int cc = t / b, rp = t % b;
    s[bitrev(rp, log_b) * cols + cc] =
        c[(size_t)(c0 + cc) * n2 + ((size_t)rp << log_a) + ri];
  }
  __syncthreads();
  dit_stages(s, tw, log_b, cols, f);
  for (int t = threadIdx.x; t < b * cols; t += blockDim.x) {
    const int r = t / cols, cc = t % cols;
    uint32_t v = s[t];
    if (finish) {
      if (scale) v = mont_mul(v, scale, f);  // n^-1 (inverse only)
      v = redc(0u, v, f);                    // from_mont
    }
    d[((size_t)i * b + r) * n1 + c0 + cc] = v;
  }
}

// K2 step 2b: one coarse stage l = 2 * 2^log_half of the length-n2 DIT on
// the (n2, n1) array d, in place; thread t takes column k1 = t mod n1 of
// pair row t / n1.  tw[j] = mont(w2^(j * n2 / l)) for j < l/2.
__global__ void __launch_bounds__(kThreads)
ntt_coarse_stage(uint32_t* __restrict__ d, const uint32_t* __restrict__ tw,
                 int log_n1, int log_half, size_t pairs, Field f, int finish,
                 uint32_t scale) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= pairs) return;
  const size_t k1 = t & (((size_t)1 << log_n1) - 1);
  const size_t pr = t >> log_n1;
  const size_t j = pr & (((size_t)1 << log_half) - 1);
  const size_t row0 = ((pr >> log_half) << (log_half + 1)) + j;
  const size_t i0 = (row0 << log_n1) + k1;
  const size_t i1 = i0 + ((size_t)1 << (log_half + log_n1));
  const uint32_t bw = mont_mul(d[i1], __ldg(tw + j), f);
  const uint32_t a = d[i0];
  uint32_t top = add_mod(a, bw, f), bot = sub_mod(a, bw, f);
  if (finish) {
    if (scale) {
      top = mont_mul(top, scale, f);
      bot = mont_mul(bot, scale, f);
    }
    top = redc(0u, top, f);
    bot = redc(0u, bot, f);
  }
  d[i0] = top;
  d[i1] = bot;
}

}  // namespace

// x, out: n words; c: n words of scratch; table: n1*n2 mont twiddles;
// tw1 / tw2: n1/2 and n2/2 mont powers of the sub-transform roots.
// scale = mont(n^-1) for the inverse transform, 0 for the forward one.
extern "C" int stark_ntt_two_step(const void* x, const void* table,
                                  const void* tw1, const void* tw2, void* c,
                                  void* out, int log1, int log2, uint32_t p,
                                  uint32_t ninv, uint32_t r2, uint32_t scale,
                                  void* stream) {
  const int n1 = 1 << log1, n2 = 1 << log2;
  const int cols1 = n2 < kMaxCols ? n2 : kMaxCols;
  const int cols2 = n1 < kMaxCols ? n1 : kMaxCols;
  const size_t smem1 = (size_t)cols1 * n1 * sizeof(uint32_t);
  const size_t smem2 = (size_t)cols2 * n2 * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      ntt_step1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(
      ntt_step2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (e != cudaSuccess) return (int)e;
  const Field f{p, ninv};
  cudaStream_t st = (cudaStream_t)stream;
  ntt_step1<<<n2 / cols1, kThreads, smem1, st>>>(
      (const uint32_t*)x, (const uint32_t*)table, (const uint32_t*)tw1,
      (uint32_t*)c, log1, n2, cols1, f, r2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ntt_step2<<<n1 / cols2, kThreads, smem2, st>>>(
      (const uint32_t*)c, (const uint32_t*)tw2, (uint32_t*)out, log1, log2,
      cols2, f, scale);
  return (int)cudaGetLastError();
}

// K2.  x, out: n = 2^(log1 + log2) words; c: n words of scratch; table:
// n1*n2 mont twiddles w^(j2*k1); tw1: n1/2 mont powers of w^n2; tw2a: b/2
// mont powers of w2^a; tw2b: the coarse stages' tables one after another,
// stage l = 2*half holding `half` mont powers of w2^(n2/l) at offset
// half - b.
// scale = mont(n^-1) for the inverse transform, 0 for the forward one.
// Launches: step 1, the block stages, then log2(a) coarse stages in place
// on out.
extern "C" int stark_ntt_three_step(const void* x, const void* table,
                                    const void* tw1, const void* tw2a,
                                    const void* tw2b, void* c, void* out,
                                    int log1, int log2, uint32_t p,
                                    uint32_t ninv, uint32_t r2, uint32_t scale,
                                    void* stream) {
  const int n1 = 1 << log1, n2 = 1 << log2;
  const int log_b = log1 < log2 ? log1 : log2;
  const int log_a = log2 - log_b;
  const int b = 1 << log_b;
  const int cols1 = n2 < kMaxCols ? n2 : kMaxCols;
  const int cols2 = n1 < kMaxCols ? n1 : kMaxCols;
  const size_t smem1 = (size_t)cols1 * n1 * sizeof(uint32_t);
  const size_t smem2 = (size_t)cols2 * b * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      ntt_step1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(ntt_block_stages,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem2);
  if (e != cudaSuccess) return (int)e;
  const Field f{p, ninv};
  cudaStream_t st = (cudaStream_t)stream;
  ntt_step1<<<n2 / cols1, kThreads, smem1, st>>>(
      (const uint32_t*)x, (const uint32_t*)table, (const uint32_t*)tw1,
      (uint32_t*)c, log1, n2, cols1, f, r2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ntt_block_stages<<<dim3(1u << log_a, n1 / cols2), kThreads, smem2, st>>>(
      (const uint32_t*)c, (const uint32_t*)tw2a, (uint32_t*)out, log_a, log_b,
      n1, cols2, f, log_a == 0, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t pairs = ((size_t)n1 * n2) >> 1;
  const unsigned grid = (unsigned)((pairs + kThreads - 1) / kThreads);
  for (int log_half = log_b; log_half < log2; ++log_half) {
    ntt_coarse_stage<<<grid, kThreads, 0, st>>>(
        (uint32_t*)out, (const uint32_t*)tw2b + ((1 << log_half) - b), log1,
        log_half, pairs, f, log_half == log2 - 1, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}
