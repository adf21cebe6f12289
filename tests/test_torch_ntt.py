"""The port's NTT layer (stark_tpu_torch/ntt, plain version of kernel K1
on CPU tensors) against the JAX package on the same seeded inputs, exact
equality.  The JAX side runs its Pallas kernel in interpret mode where it
has one."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stark_tpu.ntt.ntt import coset_evaluate as j_coset_evaluate
from stark_tpu.ntt.ntt import coset_interpolate as j_coset_interpolate
from stark_tpu.ntt.ntt import get_stockham_plan
from stark_tpu.stark.trace import trace_polynomial as j_trace_polynomial
from stark_tpu_torch.interop import tensor_to_u32, u32_to_tensor
from stark_tpu_torch.ntt import ntt as tn
from stark_tpu_torch.ntt.cuda_ntt import CudaNTTPlan, ntt_plain, ntt_two_step
from stark_tpu_torch.stark.trace import (fibonacci_square_host,
                                         trace_polynomial)

P = 3 * 2**30 + 1


def _rand(p, n, seed):
    rs = np.random.RandomState(seed)
    return rs.randint(0, p, size=n, dtype=np.int64).astype(np.uint32)


@pytest.mark.parametrize("p,log_n", [(P, k) for k in range(0, 12)]
                         + [(97, k) for k in range(1, 6)])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_matches_jax_stockham(p, log_n, inverse):
    x = _rand(p, 1 << log_n, seed=log_n + 100 * inverse)
    want = np.asarray(get_stockham_plan(p, 1 << log_n, inverse)(
        jnp.asarray(x)))
    fn = tn.intt if inverse else tn.ntt
    np.testing.assert_array_equal(tensor_to_u32(fn(u32_to_tensor(x), p)),
                                  want)


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_matches_jax_pallas_kernel_interpret(inverse):
    """K1's plain version vs the TPU kernel it replaces (pallas_ntt, in
    interpret mode) at 2^14."""
    from stark_tpu.ntt.pallas_ntt import pallas_intt, pallas_ntt

    x = _rand(P, 1 << 14, seed=14 + inverse)
    jfn = pallas_intt if inverse else pallas_ntt
    want = np.asarray(jfn(jnp.asarray(x), P, interpret=True))
    got = ntt_two_step(u32_to_tensor(x), P, inverse)
    np.testing.assert_array_equal(tensor_to_u32(got), want)


@pytest.mark.parametrize("log_n", [1, 6, 10])
def test_ntt_plain_round_trips(log_n):
    x = u32_to_tensor(_rand(P, 1 << log_n, seed=log_n))
    assert torch.equal(ntt_plain(ntt_plain(x, P), P, inverse=True), x)


def test_ntt_plain_rejects_batched_input():
    with pytest.raises(ValueError, match="1-D"):
        ntt_plain(u32_to_tensor(np.zeros((2, 8), np.uint32)), P)


@pytest.mark.parametrize("p,n,big_n,offset", [(P, 64, 512, 5),
                                              (97, 4, 16, 5)])
def test_coset_evaluate_and_interpolate_match_jax(p, n, big_n, offset):
    c = _rand(p, n, seed=n)
    want = np.asarray(j_coset_evaluate(jnp.asarray(c), p, big_n, offset))
    got = tn.coset_evaluate(u32_to_tensor(c), p, big_n, offset)
    np.testing.assert_array_equal(tensor_to_u32(got), want)
    e = _rand(p, n, seed=n + 1)
    want_i = np.asarray(j_coset_interpolate(jnp.asarray(e), p, offset))
    got_i = tn.coset_interpolate(u32_to_tensor(e), p, offset)
    np.testing.assert_array_equal(tensor_to_u32(got_i), want_i)


@pytest.mark.parametrize("p,log_n", [(P, 6), (P, 11), (97, 2)])
def test_trace_polynomial_matches_jax(p, log_n):
    trace = fibonacci_square_host(p, (1 << log_n) - 1, 1, 3141592)
    want = np.asarray(j_trace_polynomial(jnp.asarray(trace), p))
    got = trace_polynomial(u32_to_tensor(trace), p)
    np.testing.assert_array_equal(tensor_to_u32(got), want)
    assert want[-1] == 0


def test_stark101_anchor():
    trace = fibonacci_square_host(P, 1023, 1, 3141592)
    assert int(trace[1022]) == 2338775057


def test_k1_plan_bounds():
    """K1 covers 2 <= n <= 2^22; above it the K2 port is named."""
    with pytest.raises(NotImplementedError, match="K2"):
        CudaNTTPlan(P, 1 << 23, False, "cpu")
    with pytest.raises(ValueError):
        CudaNTTPlan(P, 48, False, "cpu")


def test_wrapper_refuses_devices_without_a_route():
    x = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain path"):
        ntt_two_step(x, P)
