// Sequential AIR trace generation on the host, built with the host C++
// compiler and loaded with ctypes (stark_tpu_torch/_build.py).
//
// Copied from stark_tpu/native/sha256_merkle.cpp (stark_fib_trace,
// stark_mimc_trace and stark_fibmul_trace with mulmod64 and addmod64,
// :217-253), with extern "C" linkage added: the port may not
// import stark_tpu, whose package init imports JAX.  The recurrence is
// serial (each step depends on the last), so a scalar host loop is the
// right tool.  Exact mod-p arithmetic for any p < 2^64 (128-bit
// intermediates).

#include <cstddef>
#include <cstdint>

static inline uint64_t mulmod64(uint64_t a, uint64_t b, uint64_t p) {
  return (uint64_t)(((__uint128_t)a * b) % p);
}

static inline uint64_t addmod64(uint64_t a, uint64_t b, uint64_t p) {
  return (uint64_t)(((__uint128_t)a + b) % p);
}

// Fibonacci-square: a_{i+2} = a_{i+1}^2 + a_i^2 (STARK-101).  Writes n
// values.
extern "C" void stark_fib_trace(uint64_t p, uint64_t a0, uint64_t a1,
                                size_t n, uint64_t* out) {
  uint64_t x = a0 % p, y = a1 % p;
  for (size_t i = 0; i < n; i++) {
    out[i] = x;
    uint64_t nxt = addmod64(mulmod64(x, x, p), mulmod64(y, y, p), p);
    x = y;
    y = nxt;
  }
}

// MiMC cube chain: x_{i+1} = (x_i + k)^3 (stark/air.py MimcAIR).  Writes
// n values.
extern "C" void stark_mimc_trace(uint64_t p, uint64_t x0, uint64_t k,
                                 size_t n, uint64_t* out) {
  uint64_t x = x0 % p;
  k %= p;
  for (size_t i = 0; i < n; i++) {
    out[i] = x;
    uint64_t t = addmod64(x, k, p);
    x = mulmod64(mulmod64(t, t, p), t, p);
  }
}

// Two-column multiplicative Fibonacci (stark/air.py FibMulAIR):
// a_{i+1} = b_i, b_{i+1} = a_i * b_i.  Writes both columns as
// [a_0..a_{n-1}, b_0..b_{n-1}] (row-major (2, n)).
extern "C" void stark_fibmul_trace(uint64_t p, uint64_t a0, uint64_t b0,
                                   size_t n, uint64_t* out) {
  uint64_t a = a0 % p, b = b0 % p;
  for (size_t i = 0; i < n; i++) {
    out[i] = a;
    out[n + i] = b;
    uint64_t nb = mulmod64(a, b, p);
    a = b;
    b = nb;
  }
}
