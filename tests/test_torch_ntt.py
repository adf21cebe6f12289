"""The port's NTT layer (stark_tpu_torch/ntt, the plain version of the
K1/K2 kernels on CPU tensors) against the JAX package on the same seeded
inputs, exact equality.  The JAX side runs its Pallas kernels in
interpret mode where it has them."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stark_tpu.ntt.ntt import coset_evaluate as j_coset_evaluate
from stark_tpu.ntt.ntt import coset_interpolate as j_coset_interpolate
from stark_tpu.ntt.ntt import get_stockham_plan
from stark_tpu.stark.trace import trace_polynomial as j_trace_polynomial
from stark_tpu_torch.interop import tensor_to_u32, u32_to_tensor
from stark_tpu_torch.ntt import cuda_ntt
from stark_tpu_torch.ntt.cuda_ntt import (CudaNTTPlan, ntt_k1, ntt_k2,
                                          ntt_passes_plain, ntt_plain, split)
from stark_tpu_torch.stark.trace import (fibonacci_square_host,
                                         trace_polynomial)

# the module (the package exports the function ntt under its name, as
# the JAX package's does)
tn = importlib.import_module("stark_tpu_torch.ntt.ntt")

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
    """The kernels' plain version (the K1 route) vs the TPU kernel it
    replaces (pallas_ntt, in interpret mode) at 2^14."""
    from stark_tpu.ntt.pallas_ntt import pallas_intt, pallas_ntt

    x = _rand(P, 1 << 14, seed=14 + inverse)
    jfn = pallas_intt if inverse else pallas_ntt
    want = np.asarray(jfn(jnp.asarray(x), P, interpret=True))
    got = ntt_k1(u32_to_tensor(x, device="cpu"), P, inverse)
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
    """The kernels cover power-of-two n <= 2^30 in fields with the
    subgroup, and at most 2^(2 BLOCK_LOG); the K1 route stops at 2^22 and
    names K2."""
    with pytest.raises(ValueError, match="K2"):
        ntt_k1(torch.zeros(1 << 23, dtype=torch.int32, device="meta"), P)
    with pytest.raises(ValueError):
        CudaNTTPlan(P, 48, False, "cpu")
    with pytest.raises(ValueError, match=r"2\^30"):
        CudaNTTPlan(P, 1 << 31, False, "cpu")
    with pytest.raises(ValueError, match="subgroup"):
        CudaNTTPlan(97, 1 << 6, False, "cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_ntt, "BLOCK_LOG", 4)
        with pytest.raises(ValueError, match=r"2\^8"):
            CudaNTTPlan(P, 1 << 9, False, "cpu")


@pytest.mark.parametrize("log_n,want", [
    (1, (1, 0, 0)), (2, (1, 1, 1)), (12, (6, 6, 3)), (22, (11, 11, 3)),
    (23, (12, 11, 3)), (24, (12, 12, 3)), (25, (12, 13, 3)),
    (26, (12, 14, 3)), (27, (12, 15, 3)), (28, (13, 15, 2)),
    (30, (15, 15, 0))])
def test_split_keeps_every_pass_in_one_block(log_n, want):
    """Two passes up to 2^30; 8-column groups (32 bytes a row) up to 2^27,
    narrower above; no pass over 2^15 words."""
    log1, log2, cols_log = split(log_n)
    assert (log1, log2, cols_log) == want
    assert log1 + cols_log <= cuda_ntt.BLOCK_LOG >= log2


@pytest.mark.parametrize("wrapper", [ntt_k1, ntt_k2])
def test_wrapper_refuses_devices_without_a_route(wrapper):
    x = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain path"):
        wrapper(x, P)


# the kernels' plain version at CPU sizes: the block budget shrunk so that
# the passes split as they do at 2^24..2^30 (8-column, then narrower
# column groups), against the JAX three-step plan at its own shrunk row
# split (tests/test_pallas.py TestThreeStepNTT): (log n, JAX rows_log,
# port BLOCK_LOG, inverse)
PASS_CASES = [(15, 7, 9, False), (16, 7, 9, False), (17, 8, 9, False),
              (16, 7, 9, True)]


@pytest.mark.parametrize("log_n,rows_log,block_log,inverse", PASS_CASES)
def test_passes_plain_matches_jax_plan3(monkeypatch, log_n, rows_log,
                                        block_log, inverse):
    """The kernels' plain version vs the TPU kernels of K2
    (pallas_ntt._plan3, interpret mode)."""
    from stark_tpu.ntt.pallas_ntt import _plan3

    monkeypatch.setattr(cuda_ntt, "BLOCK_LOG", block_log)
    x = _rand(P, 1 << log_n, seed=40 + log_n + inverse)
    want = np.asarray(_plan3(P, 1 << log_n, inverse, True, rows_log)(
        jnp.asarray(x)))
    got = ntt_passes_plain(u32_to_tensor(x, device="cpu"), P, inverse)
    np.testing.assert_array_equal(tensor_to_u32(got), want)


@pytest.mark.parametrize("p,log_n,block_log,inverse",
                         [(P, c[0], c[2], c[3]) for c in PASS_CASES]
                         + [(P, 11, 15, False), (P, 9, 5, True),
                            (P, 4, 2, False), (97, 5, 3, True)])
def test_passes_plain_matches_stockham(monkeypatch, p, log_n, block_log,
                                       inverse):
    """The same transform as the Stockham dataflow: also at the default
    budget, at the top of a shrunk one (one column a group) and in
    GF(97)."""
    monkeypatch.setattr(cuda_ntt, "BLOCK_LOG", block_log)
    x = u32_to_tensor(_rand(p, 1 << log_n, seed=log_n + 7), device="cpu")
    assert torch.equal(ntt_passes_plain(x, p, inverse),
                       ntt_plain(x, p, inverse))


def test_passes_plain_round_trips(monkeypatch):
    monkeypatch.setattr(cuda_ntt, "BLOCK_LOG", 9)
    x = u32_to_tensor(_rand(P, 1 << 16, seed=45), device="cpu")
    fwd = ntt_k2(x, P, False)
    assert torch.equal(ntt_k2(fwd, P, True), x)
    assert ntt_k2.plain is ntt_passes_plain is ntt_k1.plain


@pytest.fixture
def k2_route(monkeypatch):
    """Send n above 2^9 to the K2 route with a 2^7-word block budget, and
    record which wrapper each transform of ``ntt.ntt`` / ``ntt.intt``
    takes."""
    monkeypatch.setattr(cuda_ntt, "MAX_LOG_N", 9)
    monkeypatch.setattr(cuda_ntt, "BLOCK_LOG", 7)
    calls = []

    def spy(name, fn):
        def wrapped(x, p, inverse):
            calls.append((name, int(x.shape[0]), inverse))
            return fn(x, p, inverse)
        return wrapped

    monkeypatch.setattr(tn, "ntt_k1", spy("K1", ntt_k1))
    monkeypatch.setattr(tn, "ntt_k2", spy("K2", ntt_k2))
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
    assert k2_route == [("K2", 1 << log_n, inverse)]
    small = u32_to_tensor(_rand(P, 1 << 9, seed=3), device="cpu")
    fn(small, P)
    assert k2_route[-1] == ("K1", 1 << 9, inverse)


# the batched form: a (C, n) tensor of columns, one wrapper call a
# transform, on the K1 route and (budget and route limit shrunk) the K2
# route with 8-column and narrower pass-1 groups
BATCH_ROUTES = {"K1": (22, 15), "K2": (9, 7), "K2-narrow": (7, 5)}


@pytest.fixture(params=sorted(BATCH_ROUTES))
def batch_route(request, monkeypatch):
    max_log, block_log = BATCH_ROUTES[request.param]
    monkeypatch.setattr(cuda_ntt, "MAX_LOG_N", max_log)
    monkeypatch.setattr(cuda_ntt, "BLOCK_LOG", block_log)
    calls = []

    def spy(name, fn):
        def wrapped(x, p, inverse):
            calls.append((name, tuple(x.shape)))
            return fn(x, p, inverse)
        return wrapped

    monkeypatch.setattr(tn, "ntt_k1", spy("K1", ntt_k1))
    monkeypatch.setattr(tn, "ntt_k2", spy("K2", ntt_k2))
    return request.param, calls


@pytest.mark.parametrize("cols", [2, 3])
@pytest.mark.parametrize("inverse", [False, True])
def test_batched_ntt_matches_jax(batch_route, cols, inverse):
    """ntt / intt of (C, 2^12) columns: one wrapper call, each row equal
    to the JAX transform of that column."""
    route, calls = batch_route
    log_n = 9 if route == "K2-narrow" else 12  # 2 columns a pass-1 group
    x = _rand(P, cols << log_n, seed=300 + cols + inverse).reshape(cols, -1)
    plan = get_stockham_plan(P, 1 << log_n, inverse)
    want = np.stack([np.asarray(plan(jnp.asarray(r))) for r in x])
    fn = tn.intt if inverse else tn.ntt
    got = fn(u32_to_tensor(x, device="cpu"), P)
    np.testing.assert_array_equal(tensor_to_u32(got), want)
    assert calls == [(route[:2], (cols, 1 << log_n))]


@pytest.mark.parametrize("cols", [2, 3])
@pytest.mark.parametrize("log_n", [6, 11])
def test_batched_trace_polynomial_and_lde_match_jax(batch_route, cols,
                                                    log_n):
    """trace_polynomial over a (C, N-1) trace and coset_evaluate of its
    (C, N) coefficients (blowup 4) against JAX's on the same (C, n)
    input, exact: two wrapper calls in all, whatever C."""
    route, calls = batch_route
    if route == "K2-narrow":
        log_n = min(log_n, 8)  # the LDE at the 2^10 top of a 2^5 budget
    trace = _rand(P, cols * ((1 << log_n) - 1), seed=400 + log_n + cols)
    trace = trace.reshape(cols, -1)
    want = np.asarray(j_trace_polynomial(jnp.asarray(trace), P))
    got = trace_polynomial(u32_to_tensor(trace, device="cpu"), P)
    np.testing.assert_array_equal(tensor_to_u32(got), want)
    assert (want[:, -1] == 0).all()
    want_e = np.asarray(j_coset_evaluate(jnp.asarray(want), P,
                                         4 << log_n, 5))
    got_e = tn.coset_evaluate(got, P, 4 << log_n, 5)
    np.testing.assert_array_equal(tensor_to_u32(got_e), want_e)
    assert [s for _, s in calls] == [(cols, 1 << log_n),
                                     (cols, 4 << log_n)]


@pytest.mark.parametrize("cols", [1, 2, 3])
def test_batched_passes_plain_equals_each_column(monkeypatch, cols):
    """The kernels' plain version on (C, n) is the 1-D transform of each
    column, also when one pass-1 group spans a whole row of the (n1, n2)
    view (block budget 2^7 at 2^12)."""
    monkeypatch.setattr(cuda_ntt, "BLOCK_LOG", 7)
    x = u32_to_tensor(_rand(P, cols << 12, seed=500 + cols),
                      device="cpu").reshape(cols, -1)
    for inverse in (False, True):
        got = ntt_passes_plain(x, P, inverse)
        assert got.shape == x.shape
        for c in range(cols):
            assert torch.equal(got[c], ntt_plain(x[c], P, inverse))
    one = x[0]
    assert torch.equal(ntt_k2(one[None], P)[0], ntt_k2(one, P))


def test_batched_scale_pad_and_interpolate_match_jax():
    c = _rand(P, 2 * 64, seed=600).reshape(2, 64)
    got = tn.scale_pad(u32_to_tensor(c, device="cpu"), P, 256, 7)
    assert got.shape == (2, 256) and not got[:, 64:].any()
    for r in range(2):
        assert torch.equal(got[r], tn.scale_pad(
            u32_to_tensor(c[r], device="cpu"), P, 256, 7))
    want = np.asarray(j_coset_interpolate(jnp.asarray(c), P, 5))
    got_i = tn.coset_interpolate(u32_to_tensor(c, device="cpu"), P, 5)
    np.testing.assert_array_equal(tensor_to_u32(got_i), want)
