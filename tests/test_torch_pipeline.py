"""The port's fused forward step (``stark/pipeline.py``
``build_prove_core``: trace INTT, coset LDE, trace tree, composition,
first FRI fold; plain kernel versions on the CPU) against the JAX
package's on the same seeded trace and challenges at 2^6 rows, exact
equality of the root, the composition and the fold."""

import numpy as np

import jax.numpy as jnp

from stark_tpu.config import ProverConfig as JProverConfig
from stark_tpu.stark.pipeline import build_prove_core as jbuild
from stark_tpu.stark.trace import fibonacci_square_trace
from stark_tpu_torch.config import ProverConfig
from stark_tpu_torch.interop import tensor_to_u32, u32_to_tensor
from stark_tpu_torch.stark.pipeline import build_prove_core

KW = dict(log2_trace=6, blowup=4, num_queries=3)


def test_prove_core_equals_jax():
    jcfg = JProverConfig(**KW)
    p = jcfg.modulus
    trace = np.asarray(fibonacci_square_trace(p, jcfg.trace_length, 1,
                                              271828))
    rs = np.random.RandomState(6)
    alphas = [int(x) for x in rs.randint(0, p, size=3)]
    beta = int(rs.randint(0, p))
    a0, a_last = int(trace[0]), int(trace[-1])
    want = jbuild(jcfg)(jnp.asarray(trace),
                        jnp.asarray(alphas, dtype=jnp.uint32),
                        jnp.uint32(beta), jnp.uint32(a0), jnp.uint32(a_last))
    got = build_prove_core(ProverConfig(**KW), "cpu")(
        u32_to_tensor(trace, device="cpu"), alphas, beta, a0, a_last)
    assert got[0].shape == (1, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(tensor_to_u32(g), np.asarray(w))
