// Sequential AIR trace generation on the host, built with the host C++
// compiler and loaded with ctypes (stark_tpu_torch/_build.py).
//
// Copied from stark_tpu/native/sha256_merkle.cpp (stark_fib_trace with
// mulmod64 and addmod64), with extern "C" linkage added: the port may not
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
