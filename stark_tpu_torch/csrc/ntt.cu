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
