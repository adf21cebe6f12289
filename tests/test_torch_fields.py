"""The port's field layer (stark_tpu_torch/fields) against the JAX package's
Fp on the same seeded inputs, exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stark_tpu.fields.element import FieldElement as JFieldElement
from stark_tpu.fields.fp import Fp as JFp
from stark_tpu_torch.fields import FieldElement, Fp
from stark_tpu_torch.fields.fp import lift, store
from stark_tpu_torch.interop import tensor_to_u32, u32_to_tensor

MODULI = [3 * 2**30 + 1, 97, 2**31 - 1, 4294967291]  # last: largest u32 prime


def _inputs(p, seed, n=512):
    rs = np.random.RandomState(seed)
    edges = np.array([0, 1, 2, p - 1, p - 2, p // 2, p // 2 + 1],
                     dtype=np.uint64)
    vals = rs.randint(0, p, size=n, dtype=np.int64).astype(np.uint64)
    return np.concatenate([edges, vals]).astype(np.uint32)


def _pair(p, seed):
    a = _inputs(p, seed)
    b = np.roll(_inputs(p, seed + 1), 3)
    return a, b


def _port(fn, *arrs):
    return tensor_to_u32(store(fn(*[u32_to_tensor(a) for a in arrs])))


@pytest.mark.parametrize("p", MODULI)
@pytest.mark.parametrize("op", ["add", "sub", "mul", "mont_mul"])
def test_binary_ops_match_jax(p, op):
    a, b = _pair(p, seed=p % 1000)
    want = np.asarray(getattr(JFp.get(p), op)(jnp.asarray(a), jnp.asarray(b)))
    got = _port(getattr(Fp.get(p), op), a, b)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", MODULI)
@pytest.mark.parametrize("op", ["neg", "to_mont", "from_mont"])
def test_unary_ops_match_jax(p, op):
    a = _inputs(p, seed=7)
    want = np.asarray(getattr(JFp.get(p), op)(jnp.asarray(a)))
    got = _port(getattr(Fp.get(p), op), a)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", MODULI)
def test_mont_mul_on_full_u32_words_matches_jax(p):
    """REDC keeps the JAX wrap semantics even for non-canonical words."""
    rs = np.random.RandomState(11)
    a = rs.randint(0, 2**32, size=256, dtype=np.uint64).astype(np.uint32)
    b = rs.randint(0, 2**32, size=256, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(JFp.get(p).mont_mul(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(_port(Fp.get(p).mont_mul, a, b), want)


@pytest.mark.parametrize("p", MODULI)
@pytest.mark.parametrize("exp", [0, 1, 2, 5, 1023, 2**20 + 7])
def test_pow_static_matches_jax(p, exp):
    a = _inputs(p, seed=exp % 97, n=64)
    want = np.asarray(JFp.get(p).pow_static(jnp.asarray(a), exp))
    got = _port(lambda t: Fp.get(p).pow_static(t, exp), a)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", MODULI)
def test_inv_rolled_matches_jax(p):
    a = _inputs(p, seed=3, n=64)
    want = np.asarray(JFp.get(p).inv_rolled(jnp.asarray(a)))
    got = _port(Fp.get(p).inv_rolled, a)
    np.testing.assert_array_equal(got, want)
    nz = a != 0
    prod = got[nz].astype(object) * a[nz].astype(object) % p
    assert all(int(x) == 1 for x in prod)


@pytest.mark.parametrize("p", [3 * 2**30 + 1, 97])
def test_host_tables_match_jax(p):
    jf, tf = JFp.get(p), Fp.get(p)
    for mont in (False, True):
        np.testing.assert_array_equal(tf.host_powers(5, 37, mont),
                                      jf.host_powers(5, 37, mont))
        ratios = jf.host_powers(7, 8)
        np.testing.assert_array_equal(
            tf.host_geometric_table(ratios, 16, mont),
            jf.host_geometric_table(ratios, 16, mont))
    np.testing.assert_array_equal(
        tensor_to_u32(tf.coset_domain(5, 3, 32, "cpu")),
        np.asarray(jf.jit_coset_domain(5, 3, 32)))
    np.testing.assert_array_equal(
        tf.powers(3, 33, "cpu").numpy().astype(np.uint32),
        np.asarray(jf.powers(3, 33)))


def test_lift_store_roundtrip_keeps_bits():
    words = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=np.uint32)
    t = u32_to_tensor(words)
    assert t.dtype == torch.int32
    assert lift(t).tolist() == [int(w) for w in words]
    np.testing.assert_array_equal(tensor_to_u32(store(lift(t))), words)


def test_wide_and_invalid_moduli_raise():
    with pytest.raises(NotImplementedError, match="item 12"):
        Fp.get(2**64 - 2**32 + 1)
    with pytest.raises(ValueError):
        Fp(10)


def test_field_element_copy_matches_reference():
    for p in (97, 3 * 2**30 + 1):
        for v in (0, 1, 5, p - 1, 123456789):
            a, ja = FieldElement(v, p), JFieldElement(v, p)
            b, jb = FieldElement(v * 7 + 3, p), JFieldElement(v * 7 + 3, p)
            assert (a * b).value == (ja * jb).value
            assert (a - b).value == (ja - jb).value
            assert a.to_bytes() == ja.to_bytes()
            if v % p:
                assert a.inverse().value == ja.inverse().value
