"""The port's NTT layer (stark_tpu_torch/ntt, plain versions of kernels
K1 and K2 on CPU tensors) against the JAX package on the same seeded
inputs, exact equality.  The JAX side runs its Pallas kernels in
interpret mode where it has them."""

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
from stark_tpu_torch.ntt import cuda_ntt
from stark_tpu_torch.ntt.cuda_ntt import (CudaNTTPlan, CudaThreeStepPlan,
                                          ntt_plain, ntt_three_step,
                                          ntt_three_step_plain, ntt_two_step)
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
    got = fn(u32_to_tensor(x, device="cpu"), p)
    np.testing.assert_array_equal(tensor_to_u32(got), want)


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_matches_jax_pallas_kernel_interpret(inverse):
    """K1's plain version vs the TPU kernel it replaces (pallas_ntt, in
    interpret mode) at 2^14."""
    from stark_tpu.ntt.pallas_ntt import pallas_intt, pallas_ntt

    x = _rand(P, 1 << 14, seed=14 + inverse)
    jfn = pallas_intt if inverse else pallas_ntt
    want = np.asarray(jfn(jnp.asarray(x), P, interpret=True))
    got = ntt_two_step(u32_to_tensor(x, device="cpu"), P, inverse)
    np.testing.assert_array_equal(tensor_to_u32(got), want)


@pytest.mark.parametrize("log_n", [1, 6, 10])
def test_ntt_plain_round_trips(log_n):
    x = u32_to_tensor(_rand(P, 1 << log_n, seed=log_n), device="cpu")
    assert torch.equal(ntt_plain(ntt_plain(x, P), P, inverse=True), x)


def test_ntt_plain_rejects_batched_input():
    with pytest.raises(ValueError, match="1-D"):
        ntt_plain(u32_to_tensor(np.zeros((2, 8), np.uint32), device="cpu"), P)


@pytest.mark.parametrize("p,n,big_n,offset", [(P, 64, 512, 5),
                                              (97, 4, 16, 5)])
def test_coset_evaluate_and_interpolate_match_jax(p, n, big_n, offset):
    c = _rand(p, n, seed=n)
    want = np.asarray(j_coset_evaluate(jnp.asarray(c), p, big_n, offset))
    got = tn.coset_evaluate(u32_to_tensor(c, device="cpu"), p, big_n, offset)
    np.testing.assert_array_equal(tensor_to_u32(got), want)
    e = _rand(p, n, seed=n + 1)
    want_i = np.asarray(j_coset_interpolate(jnp.asarray(e), p, offset))
    got_i = tn.coset_interpolate(u32_to_tensor(e, device="cpu"), p, offset)
    np.testing.assert_array_equal(tensor_to_u32(got_i), want_i)


@pytest.mark.parametrize("p,log_n", [(P, 6), (P, 11), (97, 2)])
def test_trace_polynomial_matches_jax(p, log_n):
    trace = fibonacci_square_host(p, (1 << log_n) - 1, 1, 3141592)
    want = np.asarray(j_trace_polynomial(jnp.asarray(trace), p))
    got = trace_polynomial(u32_to_tensor(trace, device="cpu"), p)
    np.testing.assert_array_equal(tensor_to_u32(got), want)
    assert want[-1] == 0


def test_stark101_anchor():
    trace = fibonacci_square_host(P, 1023, 1, 3141592)
    assert int(trace[1022]) == 2338775057


def test_k1_plan_bounds():
    """K1 covers power-of-two 2 <= n <= 2^22 and names K2 above; K2
    covers n <= 2^30 in fields with the subgroup."""
    with pytest.raises(ValueError, match="K2"):
        CudaNTTPlan(P, 1 << 23, False, "cpu")
    with pytest.raises(ValueError):
        CudaNTTPlan(P, 48, False, "cpu")
    with pytest.raises(ValueError, match=r"2\^30"):
        CudaThreeStepPlan(P, 1 << 31, False, "cpu")
    with pytest.raises(ValueError, match="subgroup"):
        CudaThreeStepPlan(97, 1 << 6, False, "cpu", rows_log=3)
    with pytest.raises(ValueError, match="rows_log"):
        CudaThreeStepPlan(P, 1 << 12, False, "cpu", rows_log=13)


@pytest.mark.parametrize("wrapper", [ntt_two_step, ntt_three_step])
def test_wrapper_refuses_devices_without_a_route(wrapper):
    x = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain path"):
        wrapper(x, P)


# K2 at CPU sizes: the row split shrunk as the JAX package's own tests
# shrink it (tests/test_pallas.py TestThreeStepNTT), so a = n2/b > 1 and
# the block stages and the coarse stages both run
THREE_STEP_CASES = [(15, 7, False), (16, 7, False), (17, 8, False),
                    (16, 7, True)]


@pytest.mark.parametrize("log_n,rows_log,inverse", THREE_STEP_CASES)
def test_three_step_plain_matches_jax_plan3(log_n, rows_log, inverse):
    """K2's plain version vs the TPU kernels it replaces
    (pallas_ntt._plan3, interpret mode)."""
    from stark_tpu.ntt.pallas_ntt import _plan3

    x = _rand(P, 1 << log_n, seed=40 + log_n + inverse)
    want = np.asarray(_plan3(P, 1 << log_n, inverse, True, rows_log)(
        jnp.asarray(x)))
    got = ntt_three_step_plain(u32_to_tensor(x, device="cpu"), P, inverse,
                               rows_log)
    np.testing.assert_array_equal(tensor_to_u32(got), want)


@pytest.mark.parametrize("p,log_n,rows_log,inverse",
                         [(P, *c) for c in THREE_STEP_CASES]
                         + [(P, 11, 11, False), (P, 9, 3, True),
                            (P, 4, 1, False), (97, 5, 2, True)])
def test_three_step_plain_matches_stockham(p, log_n, rows_log, inverse):
    """The same transform as K1's plain version, the Stockham dataflow:
    also at a = 1 (n <= 2^(2 rows_log)) and in GF(97)."""
    x = u32_to_tensor(_rand(p, 1 << log_n, seed=log_n + 7), device="cpu")
    assert torch.equal(ntt_three_step_plain(x, p, inverse, rows_log),
                       ntt_plain(x, p, inverse))


def test_three_step_plain_round_trips():
    x = u32_to_tensor(_rand(P, 1 << 16, seed=45), device="cpu")
    fwd = ntt_three_step(x, P, False, 7)
    assert torch.equal(ntt_three_step(fwd, P, True, 7), x)
    assert ntt_three_step.plain is ntt_three_step_plain


@pytest.fixture
def k2_route(monkeypatch):
    """Force K2 above 2^9 with a 2^5-row split, and record which wrapper
    each transform of ``ntt.ntt`` / ``ntt.intt`` takes."""
    monkeypatch.setattr(cuda_ntt, "MAX_LOG_N", 9)
    monkeypatch.setattr(cuda_ntt, "ROWS_LOG", 5)
    calls = []

    def spy(name, fn):
        def wrapped(x, p, inverse, *rest):
            calls.append((name, int(x.shape[0]), inverse) + tuple(rest))
            return fn(x, p, inverse, *rest)
        return wrapped

    monkeypatch.setattr(tn, "ntt_two_step", spy("K1", ntt_two_step))
    monkeypatch.setattr(tn, "ntt_three_step", spy("K2", ntt_three_step))
    return calls


@pytest.mark.parametrize("log_n", [12, 14])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_routes_large_sizes_to_k2(k2_route, log_n, inverse):
    x = _rand(P, 1 << log_n, seed=log_n + 200 * inverse)
    want = np.asarray(get_stockham_plan(P, 1 << log_n, inverse)(
        jnp.asarray(x)))
    fn = tn.intt if inverse else tn.ntt
    got = fn(u32_to_tensor(x, device="cpu"), P)
    np.testing.assert_array_equal(tensor_to_u32(got), want)
    assert k2_route == [("K2", 1 << log_n, inverse, 5)]
    small = u32_to_tensor(_rand(P, 1 << 9, seed=3), device="cpu")
    fn(small, P)
    assert k2_route[-1] == ("K1", 1 << 9, inverse)
