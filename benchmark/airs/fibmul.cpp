// FibMul's host trace loop, frozen for the benchmark
// (benchmark/tracemaker.py): a_{i+1} = b_i, b_{i+1} = a_i b_i mod p from
// a_0 = 1, b_0 = the witness; writes [a_0 .. a_{n-1}, b_0 .. b_{n-1}].
// Exact for any p < 2^64 (128-bit intermediates).

#include <cstddef>
#include <cstdint>

extern "C" void bench_trace(uint64_t p, uint64_t witness, size_t n,
                            uint64_t* out) {
  uint64_t a = 1 % p, b = witness % p;
  for (size_t i = 0; i < n; i++) {
    out[i] = a;
    out[n + i] = b;
    uint64_t nb = (uint64_t)(((__uint128_t)a * b) % p);
    a = b;
    b = nb;
  }
}
