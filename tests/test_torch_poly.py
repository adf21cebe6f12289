"""The port's host polynomial algebra (stark_tpu_torch/poly) against the
JAX package's (stark_tpu/poly), exact equality.

The reference battery of tests/test_poly.py runs as cases of one
parametrised test, each case on both packages; then seeded inputs go
through both packages' Polynomial arithmetic and interpolation, on the
schoolbook path and on the NTT path (the product's coefficient count on
each side of ``_NTT_MUL_THRESHOLD`` = 128), over the 2-adic
p = 3 * 2^30 + 1 and over GF(97), which has too little 2-adicity for
the NTT and so takes the fallbacks."""

import types
import zlib

import numpy as np
import pytest

import stark_tpu.fields as j_fields
import stark_tpu.poly as j_poly
import stark_tpu.poly.ops as j_ops
import stark_tpu_torch.fields as t_fields
import stark_tpu_torch.poly as t_poly
import stark_tpu_torch.poly.ops as t_ops

M = 7
TEST_MODULUS = 97
P = 3 * 2**30 + 1
PACKAGES = {
    "jax": types.SimpleNamespace(ops=j_ops, fe=j_fields.fe, **{
        n: getattr(j_poly, n) for n in j_poly.__all__}),
    "torch": types.SimpleNamespace(ops=t_ops, fe=t_fields.fe, **{
        n: getattr(t_poly, n) for n in t_poly.__all__}),
}


def _coeffs(x):
    """A comparable form of a battery result."""
    if isinstance(x, (list, tuple)):
        return [_coeffs(v) for v in x]
    if hasattr(x, "coeffs"):
        return ("poly", x.modulus, list(x.coeffs))
    if hasattr(x, "value"):
        return ("fe", x.value)
    if isinstance(x, np.ndarray):
        return [int(v) for v in x]
    return x


def _div_rem_reconstruction(T):
    rng = np.random.default_rng(2)
    out = []
    for _ in range(20):
        a = T.Polynomial.random(rng.integers(0, 12), M, rng)
        b = T.Polynomial.random(rng.integers(0, 8), M, rng)
        if b.is_zero():
            continue
        q, r = divmod(a, b)
        assert q * b + r == a
        assert r.degree < b.degree or r.is_zero()
        out.append((q, r))
    return out


def _ntt_mul_matches_schoolbook(T):
    rng = np.random.default_rng(3)
    a = T.Polynomial.random(90, TEST_MODULUS, rng)
    b = T.Polynomial.random(80, TEST_MODULUS, rng)
    got = a * b
    thresh = T.ops._NTT_MUL_THRESHOLD
    T.ops._NTT_MUL_THRESHOLD = 10**9
    try:
        want = a * b
    finally:
        T.ops._NTT_MUL_THRESHOLD = thresh
    assert got == want
    return got


def _kronecker(T):
    xs = [1, 2, 3, 4]
    basis = T.gen_lagrange_polynomials(xs, M)
    for i, li in enumerate(basis):
        for j, xj in enumerate(xs):
            assert li.evaluate(xj).value == (1 if i == j else 0)
    return basis


def _interpolate_fixed(T):
    xs, ys = [1, 2, 3], [4, 5, 6]
    f = T.interpolate_lagrange(xs, ys, M)
    assert [f.evaluate(x).value for x in xs] == ys
    return f


def _interpolate_random(T):
    rng = np.random.default_rng(4)
    xs = rng.permutation(TEST_MODULUS)[:20].tolist()
    ys = rng.integers(0, TEST_MODULUS, size=20).tolist()
    f = T.interpolate_lagrange(xs, ys, TEST_MODULUS)
    assert f.degree < 20
    assert [f.evaluate(x).value for x in xs] == ys
    return f


def _raises(exc, fn):
    def case(T):
        with pytest.raises(exc):
            fn(T)
        return exc.__name__
    return case


# tests/test_poly.py: (name, case(T) -> result, expected or None)
BATTERY = [
    ("trim", lambda T: T.poly([1, 2, 0, 0], M).coeffs, [1, 2]),
    ("zero_degree", lambda T: (T.Polynomial.zero(M).degree,
                               T.poly([0, 0], M).degree), (-1, -1)),
    ("degree", lambda T: T.poly([1, 2, 3], M).degree, 2),
    ("negative_coeffs", lambda T: T.poly([-1, -8], M).coeffs, [6, 6]),
    ("from_iter", lambda T: T.Polynomial.from_iter(iter([1, 2]), M).coeffs,
     [1, 2]),
    ("add", lambda T: (T.poly([1, 2], M) + T.poly([3, 4, 5], M)).coeffs,
     [4, 6, 5]),
    ("add_cancels", lambda T: (T.poly([1, 2], M)
                               + T.poly([6, 5], M)).is_zero(), True),
    ("sub", lambda T: (T.poly([1, 2], M) - T.poly([3, 4], M)).coeffs,
     [5, 5]),
    ("neg", lambda T: (-T.poly([1, 2], M)).coeffs, [6, 5]),
    ("mul", lambda T: (T.poly([1, 2], M) * T.poly([3, 4], M)).coeffs,
     [3, 3, 1]),
    ("mul_zero", lambda T: (T.poly([1, 2], M)
                            * T.Polynomial.zero(M)).is_zero(), True),
    ("scalar_mul", lambda T: ((T.poly([1, 2], M) * 3).coeffs,
                              (3 * T.poly([1, 2], M)).coeffs),
     ([3, 6], [3, 6])),
    ("scalar_via_field_element",
     lambda T: (T.poly([1, 2], M) * T.fe(3, M)).coeffs, [3, 6]),
    ("div_rem_reconstruction", _div_rem_reconstruction, None),
    ("div_by_zero", _raises(ZeroDivisionError, lambda T: divmod(
        T.poly([1], M), T.Polynomial.zero(M))), "ZeroDivisionError"),
    ("exact_div", lambda T: (T.poly([1, 2, 1], M)
                             / T.poly([1, 1], M)).coeffs, [1, 1]),
    ("nonexact_div", _raises(ValueError, lambda T: T.poly([1, 1, 1], M)
                             / T.poly([1, 1], M)), "ValueError"),
    ("mod", lambda T: (T.poly([1, 1, 1], M) % T.poly([1, 1], M)).coeffs,
     [1]),
    ("pow", lambda T: ((T.poly([1, 1], M) ** 2).coeffs,
                       (T.poly([1, 1], M) ** 0).coeffs), ([1, 2, 1], [1])),
    ("ntt_mul_matches_schoolbook", _ntt_mul_matches_schoolbook, None),
    ("evaluate_horner", lambda T: T.poly([1, 2, 3], M).evaluate(2).value, 3),
    ("evaluate_empty", lambda T: T.Polynomial.zero(M).evaluate(5).value, 0),
    ("evaluate_batch", lambda T: T.poly([1, 2, 3], TEST_MODULUS)
     .evaluate_batch(np.arange(10)).tolist(),
     [(1 + 2 * x + 3 * x * x) % TEST_MODULUS for x in range(10)]),
    ("compose", lambda T: T.poly([0, 0, 1], M).compose(
        T.poly([1, 1], M)).coeffs, [1, 2, 1]),
    ("callable_sugar", lambda T: (T.poly([0, 0, 1], M)(3).value,
                                  T.poly([0, 0, 1], M)(
                                      T.poly([1, 1], M)).coeffs),
     (2, [1, 2, 1])),
    ("roots_product", lambda T: T.gen_polynomial_from_roots([1, 2], M)
     .coeffs, [2, 4, 1]),
    ("lagrange_kronecker_delta", _kronecker, None),
    ("interpolate_fixed", _interpolate_fixed, None),
    ("interpolate_roundtrip_random", _interpolate_random, None),
    ("duplicate_points", _raises(ValueError, lambda T:
                                 T.gen_lagrange_polynomials([1, 1], M)),
     "ValueError"),
    ("length_mismatch", _raises(ValueError, lambda T:
                                T.interpolate_lagrange([1, 2], [1], M)),
     "ValueError"),
]


@pytest.mark.parametrize("name,case,expected", BATTERY,
                         ids=[b[0] for b in BATTERY])
def test_reference_battery(name, case, expected):
    got = _coeffs(case(PACKAGES["torch"]))
    assert got == _coeffs(case(PACKAGES["jax"]))
    if expected is not None:
        assert got == _coeffs(expected)


def _pair(T, p, deg_a, deg_b, seed):
    rng = np.random.default_rng(seed)
    return (T.Polynomial.random(deg_a, p, rng),
            T.Polynomial.random(deg_b, p, rng))


OPS = {
    "add": lambda T, a, b: a + b,
    "sub": lambda T, a, b: a - b,
    "mul": lambda T, a, b: a * b,
    "divmod": lambda T, a, b: list(divmod(a, b)),
    "pow": lambda T, a, b: a ** 3,
    # a degree-2 inner polynomial: the result's degree 2 deg a takes the
    # NTT route of compose where the field has one; a's first 6
    # coefficients give degree 10, the Horner route
    "compose": lambda T, a, b: a.compose(T.poly(b.coeffs[:3], b.modulus)),
    "compose_low": lambda T, a, b: T.poly(a.coeffs[:6], a.modulus).compose(
        T.poly(b.coeffs[:3], b.modulus)),
    "evaluate_batch": lambda T, a, b: a.evaluate_batch(
        np.asarray(b.coeffs, dtype=np.uint64)),
    "interpolate": lambda T, a, b: T.Polynomial.interpolate(
        list(range(1, 25)), b.coeffs[:24], a.modulus),
}
# (deg a, deg b): the product's coefficient count below 128 (schoolbook)
# and above it (NTT over p; the fallback over GF(97))
SIZES = {"schoolbook": (40, 30), "ntt": (90, 70)}


@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("p", [P, TEST_MODULUS])
def test_seeded_arithmetic_matches_jax(op, size, p):
    seed = zlib.crc32(f"{op} {size} {p}".encode())
    got = _coeffs(OPS[op](PACKAGES["torch"],
                          *_pair(PACKAGES["torch"], p, *SIZES[size], seed)))
    want = _coeffs(OPS[op](PACKAGES["jax"],
                           *_pair(PACKAGES["jax"], p, *SIZES[size], seed)))
    assert got == want


@pytest.mark.parametrize("n", [1, 5, 16])
@pytest.mark.parametrize("p", [P, TEST_MODULUS])
def test_interpolation_functions_match_jax(n, p):
    rng = np.random.default_rng(n + p % 1000)
    xs = rng.permutation(min(p, 1000))[:n].tolist()
    ys = rng.integers(0, p, size=n).tolist()
    T, J = PACKAGES["torch"], PACKAGES["jax"]
    assert _coeffs(T.gen_polynomial_from_roots(xs, p)) == _coeffs(
        J.gen_polynomial_from_roots(xs, p))
    assert _coeffs(T.gen_lagrange_polynomials(xs, p)) == _coeffs(
        J.gen_lagrange_polynomials(xs, p))
    assert _coeffs(T.interpolate_lagrange(xs, ys, p)) == _coeffs(
        J.interpolate_lagrange(xs, ys, p))


def test_poly_takes_the_ntt_path_above_the_threshold(monkeypatch):
    """Above 128 coefficients the port's mul goes through its own host NTT
    (ntt/reference_ntt.py), as the JAX package's does."""
    calls = []
    real = t_ops._try_ntt_mul

    def spy(a, b, p):
        calls.append(len(a) + len(b))
        return real(a, b, p)

    monkeypatch.setattr(t_ops, "_try_ntt_mul", spy)
    a, b = _pair(PACKAGES["torch"], P, *SIZES["ntt"], 7)
    _ = a * b
    a, b = _pair(PACKAGES["torch"], P, *SIZES["schoolbook"], 7)
    _ = a * b
    assert calls == [sum(SIZES["ntt"]) + 2]
