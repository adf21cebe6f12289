// Fibonacci-square's host trace loop, frozen for the benchmark
// (benchmark/tracemaker.py): a_{i+2} = a_{i+1}^2 + a_i^2 mod p from
// a_0 = 1, a_1 = the witness, n values.  Exact for any p < 2^64
// (128-bit intermediates).

#include <cstddef>
#include <cstdint>

static inline uint64_t mulmod64(uint64_t a, uint64_t b, uint64_t p) {
  return (uint64_t)(((__uint128_t)a * b) % p);
}

extern "C" void bench_trace(uint64_t p, uint64_t witness, size_t n,
                            uint64_t* out) {
  uint64_t x = 1 % p, y = witness % p;
  for (size_t i = 0; i < n; i++) {
    out[i] = x;
    uint64_t nxt = (uint64_t)(((__uint128_t)mulmod64(x, x, p) +
                               mulmod64(y, y, p)) % p);
    x = y;
    y = nxt;
  }
}
