"""The port's native host trace (stark_tpu_torch/native, a C++ loop built
with the host compiler) against the JAX package's native trace, the
Python-int oracle and the STARK-101 anchor, exact equality."""

import numpy as np
import pytest

from stark_tpu import native as jnative
from stark_tpu_torch import _build, native
from stark_tpu_torch.config import ProverConfig
from stark_tpu_torch.stark.air import FibMulAIR, FibonacciSquareAIR, MimcAIR
from stark_tpu_torch.stark.trace import fibonacci_square_host

P = 3 * 2**30 + 1


@pytest.mark.parametrize("p,a1", [(P, 3141592), (97, 3)])
@pytest.mark.parametrize("n", [1, 2, 5000])
def test_native_trace_matches_jax_and_python(p, a1, n):
    got = native.fib_trace(p, 1, a1, n)
    assert got.dtype == np.uint64 and got.shape == (n,)
    want = jnative.host_trace("fib", p, 1, a1, n)
    assert want is not None
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.astype(np.uint32),
                                  fibonacci_square_host(p, n, 1, a1))


def _mimc_python(p, x0, k, n):
    out, x = [], x0 % p
    for _ in range(n):
        out.append(x)
        x = pow((x + k) % p, 3, p)
    return out


def _fibmul_python(p, a0, b0, n):
    out, a, b = [], a0 % p, b0 % p
    for _ in range(n):
        out.append((a, b))
        a, b = b, a * b % p
    return np.asarray(out, dtype=np.uint64).T.tolist()


@pytest.mark.parametrize("p", [P, 97])
@pytest.mark.parametrize("n", [1, 2, 5000])
@pytest.mark.parametrize("kind", ["mimc", "fibmul"])
def test_native_mimc_fibmul_match_jax_and_python(p, n, kind):
    """MiMC (x0, k) and FibMul (a0, b0; a row-major (2, n)) against the
    JAX package's native host_trace and a Python loop."""
    args = (271828, 777) if kind == "mimc" else (1, 2718281)
    fn = native.mimc_trace if kind == "mimc" else native.fibmul_trace
    got = fn(p, *args, n)
    assert got.dtype == np.uint64
    assert got.shape == ((n,) if kind == "mimc" else (2, n))
    want = jnative.host_trace(kind, p, *args, n)
    assert want is not None
    np.testing.assert_array_equal(got, want)
    py = (_mimc_python if kind == "mimc" else _fibmul_python)(p, *args, n)
    assert got.tolist() == py


def test_air_host_traces_are_native():
    cfg = ProverConfig(log2_trace=6, blowup=4, num_queries=2)
    t = cfg.trace_length
    np.testing.assert_array_equal(MimcAIR(x0=5, k=9).host_trace(cfg),
                                  native.mimc_trace(P, 5, 9, t))
    fm = FibMulAIR(a0=2, b0=3).host_trace(cfg)
    assert fm.dtype == np.uint32 and fm.shape == (2, t)
    np.testing.assert_array_equal(fm, native.fibmul_trace(P, 2, 3, t))


def test_native_trace_stark101_anchor():
    assert int(native.fib_trace(P, 1, 3141592, 1023)[1022]) == 2338775057


def test_air_host_trace_is_native():
    cfg = ProverConfig(log2_trace=10, blowup=4, num_queries=2)
    trace = FibonacciSquareAIR().host_trace(cfg)
    assert trace.dtype == np.uint32 and len(trace) == cfg.trace_length
    np.testing.assert_array_equal(
        trace, native.fib_trace(P, 1, 3141592, cfg.trace_length))


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A compiler that fails makes the trace raise; nothing falls back to
    the Python loop."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed"):
        native.fib_trace(P, 1, 3, 8)
    assert "host_trace" not in _build._libs


def test_native_rejects_bad_modulus():
    with pytest.raises(ValueError):
        native.fib_trace(0, 1, 3, 8)
