"""The port's declarative AIR builder (stark_tpu_torch/stark/air_builder.py)
and its shipped families (stark/families.py) against the JAX package's,
over the u32 field p = 3·2^30+1: each family's proof equals the JAX prove
byte for byte (one JAX prove a family, a module-scoped fixture), each
package's verifier accepts the other's proof, a tampered proof or a
cheating witness is rejected; the declarative re-derivations of the
hand-written AIRs equal the port's hand-written proves; the degree
inference, the validation errors and ``air_from_name`` agree with JAX.
The Goldilocks families are in test_torch_air_builder_gl.py."""

import copy

import numpy as np
import pytest

from stark_tpu.config import ProverConfig as JProverConfig
from stark_tpu.stark import AirSpec as JAirSpec
from stark_tpu.stark import Boundary as JBoundary
from stark_tpu.stark import StarkProof as JStarkProof
from stark_tpu.stark import StarkVerificationError as JStarkVerificationError
from stark_tpu.stark import prove as jprove
from stark_tpu.stark import verify as jverify
from stark_tpu.stark.air import air_from_name as jair_from_name
from stark_tpu.stark.families import FAMILIES as JFAMILIES
from stark_tpu_torch.config import ProverConfig
from stark_tpu_torch.interop import air_from
from stark_tpu_torch.stark import (AirSpec, Boundary, FibMulAIR,
                                   FibonacciSquareAIR, MimcAIR, StarkProof,
                                   StarkVerificationError, air_from_name,
                                   prove, verify)
from stark_tpu_torch.stark import prover as tprover
from stark_tpu_torch.stark.air_builder import lookup_spec
from stark_tpu_torch.stark.families import FAMILIES, build_air

GOLDILOCKS = 2**64 - 2**32 + 1
# each family's least blowup (mimc5's degree 5 needs 8)
BLOWUP = {"tribmul": 4, "mimc5": 8, "mimc5rc": 8}


def family_cfg(name, **field):
    return dict(log2_trace=5, blowup=BLOWUP[name], num_queries=3, **field)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """(name, port proof, JAX proof) of the family's default statement."""
    name = request.param
    kw = family_cfg(name)
    port = prove(ProverConfig(**kw), air=FAMILIES[name][0](), device="cpu")
    ref = jprove(JProverConfig(**kw), air=JFAMILIES[name][0]())
    return name, port, ref


def test_family_proof_equals_jax(family):
    name, port, ref = family
    assert port.air_name == name
    assert port.serialize() == ref.serialize()
    assert port.serialize(compress=True) == ref.serialize(compress=True)
    assert port.publics == ref.publics


def test_family_proofs_verify_across_packages(family):
    _, port, ref = family
    assert verify(StarkProof.deserialize(ref.serialize()))
    assert jverify(JStarkProof.deserialize(port.serialize()))


def test_family_tamper_and_cheating_witness_rejected(family):
    _, port, _ = family
    for i in (0, 3, len(port.proof) - 1):
        bad = copy.deepcopy(port)
        msg = bytearray(bad.proof[i])
        msg[0] ^= 1
        bad.proof[i] = bytes(msg)
        with pytest.raises(StarkVerificationError):
            verify(bad)
    cheat = copy.deepcopy(port)
    cheat.a_last = (cheat.a_last + 1) % cheat.config.modulus
    with pytest.raises(StarkVerificationError):
        verify(cheat)
    with pytest.raises(JStarkVerificationError):
        jverify(JStarkProof.deserialize(cheat.serialize()))


@pytest.mark.parametrize("field", [{}, dict(modulus=GOLDILOCKS, generator=7)],
                         ids=["u32", "goldilocks"])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_host_trace_equals_jax_scan(name, field):
    """The host loop's trace (and so its row order and periodic values)
    equals the JAX package's lax.scan trace."""
    cfg = family_cfg(name, **field)
    words = FAMILIES[name][0](**{FAMILIES[name][1]: 12345}).host_trace(
        ProverConfig(**cfg))
    ref = np.asarray(JFAMILIES[name][0](**{JFAMILIES[name][1]: 12345})
                     .build_trace(JProverConfig(**cfg)))
    assert words.dtype == np.uint32
    assert np.array_equal(words, ref)


# -- declarative re-derivations of the hand-written AIRs --------------------
FIB_DECL = AirSpec(
    name="fib-decl",
    columns=1,
    init=((("a0", 1),), (("a1", 3141592),)),  # window of 2 rows
    step=lambda f, rows, P: (
        f.add(f.mul(rows[1][0], rows[1][0]), f.mul(rows[0][0], rows[0][0])),
    ),
    boundaries=(
        Boundary(column=0, row=0, public="input"),
        Boundary(column=0, row=-1, public="output"),
    ),
)

MIMC_DECL = AirSpec(
    name="mimc-decl",
    columns=1,
    init=((("x0", 271828),),),
    step=lambda f, rows, P: (
        (lambda t: f.mul(f.mul(t, t), t))(f.add(rows[0][0], P["k"])),
    ),
    boundaries=(
        Boundary(column=0, row=0, public="input"),
        Boundary(column=0, row=-1, public="output"),
    ),
    params={"k": 777},
)

FIBMUL_DECL = AirSpec(
    name="fibmul-decl",
    columns=2,
    init=((("a0", 1), ("b0", 2718281)),),
    step=lambda f, rows, P: (rows[0][1], f.mul(rows[0][0], rows[0][1])),
    boundaries=(
        Boundary(column=0, row=0, public="input"),
        Boundary(column=1, row=0, public="b0"),
        Boundary(column=1, row=-1, public="output"),
    ),
)

DECL = {"fib": (FIB_DECL, FibonacciSquareAIR(a1=3141592)),
        "mimc": (MIMC_DECL, MimcAIR(x0=271828, k=777)),
        "fibmul": (FIBMUL_DECL, FibMulAIR(a0=1, b0=2718281))}
DECL_CFG = ProverConfig(log2_trace=5, blowup=4, num_queries=4)


@pytest.mark.parametrize("field", [{}, dict(modulus=GOLDILOCKS, generator=7)],
                         ids=["u32", "goldilocks"])
@pytest.mark.parametrize("name", sorted(DECL))
def test_declarative_equals_hand_written(name, field):
    spec, hand = DECL[name]
    cfg = ProverConfig(log2_trace=5, blowup=4, num_queries=4, **field)
    decl = prove(cfg, air=spec(), device="cpu")
    want = prove(cfg, air=hand, device="cpu")
    assert decl.proof == want.proof
    assert (decl.a0, decl.a_last) == (want.a0, want.a_last)
    assert verify(decl)


def test_explicit_transitions_match_auto():
    explicit = AirSpec(
        name="fibmul-explicit",
        columns=2,
        init=((("a0", 1), ("b0", 2718281)),),
        step=lambda f, rows, P: (rows[0][1], f.mul(rows[0][0], rows[0][1])),
        boundaries=FIBMUL_DECL.boundaries,
        transitions=lambda f, rows, P: (
            f.sub(rows[1][0], rows[0][1]),
            f.sub(rows[1][1], f.mul(rows[0][0], rows[0][1])),
        ),
        register=False,
    )
    a = prove(DECL_CFG, air=FIBMUL_DECL(), device="cpu")
    b = prove(DECL_CFG, air=explicit(), device="cpu")
    assert a.proof == b.proof


# -- degree inference, validation, the registry -----------------------------
def jax_twin(spec):
    """The JAX package's AirSpec of a port spec (same constructor fields,
    unregistered)."""
    return JAirSpec(
        name=spec.name, columns=spec.num_columns, init=spec.init,
        step=spec.step,
        boundaries=[JBoundary(b.column, b.row, b.public)
                    for b in spec.boundaries],
        params=spec.params_spec, periodic=spec.periodic, register=False)


def validate_error(fn, cfg):
    """The message of the ValueError fn(cfg) raises, or None."""
    try:
        fn(cfg)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("log2,blowup", [(5, 4), (6, 8), (9, 2)])
def test_degree_inference_equals_jax(log2, blowup):
    cfg = ProverConfig(log2_trace=log2, blowup=blowup)
    jcfg = JProverConfig(log2_trace=log2, blowup=blowup)
    specs = [FAMILIES[n][0] for n in sorted(FAMILIES)] + [
        DECL[n][0] for n in sorted(DECL)]
    for spec in specs:
        twin = jax_twin(spec)
        assert spec.num_folds(cfg) == twin.num_folds(jcfg)
        assert spec.num_alphas == twin.num_alphas
        assert (validate_error(spec.validate, cfg)
                == validate_error(twin.validate, jcfg))
    # the hand-written AIRs' fold counts come out of the degree inference
    for name, (spec, hand) in DECL.items():
        assert spec.num_folds(cfg) == hand.num_folds(cfg), name
        assert spec.num_alphas == hand.num_alphas, name
    # mimc5: log2(N) + 2 folds, so its least blowup is 8
    assert FAMILIES["mimc5"][0].num_folds(cfg) == log2 + 2


BAD_SPECS = {
    "missing-input": dict(boundaries=("B", 0, -1, "output")),
    "bad-shifts": dict(shifts=(1, 2)),
    "param-public": dict(params={"input": 3}),
    "cycle-length": dict(periodic={"rc": (1, 2, 3)}),
    "param-periodic": dict(params={"k": 1}, periodic={"k": (1, 2)}),
    "duplicate-public": dict(boundaries=("B", 0, 0, "input"),
                             extra=("B", 0, 1, "input")),
    "empty-init": dict(init=()),
    "init-width": dict(init=((1, 2),)),
    "auto-needs-window": dict(shifts=(0, 2)),
}


def _spec_args(case, boundary_cls):
    kw = dict(BAD_SPECS[case])
    bounds = [boundary_cls(0, 0, "input"), boundary_cls(0, -1, "output")]
    if "boundaries" in kw:
        bounds = [boundary_cls(*kw.pop("boundaries")[1:])]
        if "extra" in kw:
            bounds.append(boundary_cls(*kw.pop("extra")[1:]))
    args = dict(name=f"bad-{case}", columns=1, init=((("x0", 1),),),
                step=lambda f, rows, P: (rows[0][0],), boundaries=bounds,
                register=False)
    args.update(kw)
    return args


@pytest.mark.parametrize("case", sorted(BAD_SPECS))
def test_spec_validation_errors_equal_jax(case):
    with pytest.raises(ValueError) as mine:
        AirSpec(**_spec_args(case, Boundary))
    with pytest.raises(ValueError) as ref:
        JAirSpec(**_spec_args(case, JBoundary))
    assert str(mine.value) == str(ref.value)


def test_config_validation_errors_equal_jax():
    spec = AirSpec(
        name="badp2", columns=1, init=((("x0", 1),),),
        step=lambda f, rows, P: (f.add(rows[0][0], P["rc"]),),
        boundaries=(Boundary(0, 0, "input"), Boundary(0, -1, "output")),
        periodic={"rc": tuple(range(32))}, register=False)
    cases = [(spec, dict(log2_trace=5, blowup=4), "N/2"),
             (FAMILIES["mimc5"][0], dict(log2_trace=5, blowup=4), "blowup")]
    for s, kw, match in cases:
        with pytest.raises(ValueError, match=match) as mine:
            s.validate(ProverConfig(**kw))
        with pytest.raises(ValueError) as ref:
            jax_twin(s).validate(JProverConfig(**kw))
        assert str(mine.value).replace(s.name, "") == str(ref.value).replace(
            s.name, "")
    with pytest.raises(ValueError, match="unknown"):
        FAMILIES["tribmul"][0](nope=1)


@pytest.mark.parametrize("name", ["fibonacci-square", "mimc3", "fibmul",
                                  *sorted(FAMILIES), "no-such-air"])
def test_air_from_name_equals_jax(name):
    publics = {"a0": 2, "a_last": 5, "input": 7, "output": 9, "k": 11,
               "b0": 13, "c0": 17}
    try:
        ref = jair_from_name(name, publics)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            air_from_name(name, publics)
        return
    air = air_from_name(name, publics)
    assert air.name == ref.name
    assert (air.num_columns, tuple(air.shifts), air.num_alphas) == (
        ref.num_columns, tuple(ref.shifts), ref.num_alphas)
    assert air.witness_params() == ref.witness_params()
    if name in FAMILIES:
        assert air is lookup_spec(name)


def test_build_air_names():
    assert build_air("fibonacci-square", 5) is None
    assert build_air("mimc3", 5, mimc_key=9).witness_params() == {"x0": 5,
                                                                   "k": 9}
    assert build_air("fibmul", 5).witness_params()["b0"] == 5
    assert build_air("tribmul", 5).witness_params()["witness"]["b0"] == 5
    assert build_air("mimc5rc", 5).witness_params()["witness"]["x0"] == 5
    with pytest.raises(ValueError, match="unknown AIR family"):
        build_air("nope", 1)


def test_air_from_maps_a_jax_spec():
    """interop.air_from rebuilds a JAX spec (bound witness included) as a
    port spec that proves the same statement as the port's family."""
    jspec = JFAMILIES["tribmul"][0](b0=99)
    air = air_from(jspec)
    assert air.witness_params() == jspec.witness_params()
    assert lookup_spec("tribmul") is FAMILIES["tribmul"][0]  # unregistered
    a = prove(DECL_CFG, air=air, device="cpu")
    b = prove(DECL_CFG, air=FAMILIES["tribmul"][0](b0=99), device="cpu")
    assert a.proof == b.proof and a.publics == b.publics


def test_witness_binding_and_context_cache():
    tribmul = FAMILIES["tribmul"][0]
    p1 = prove(DECL_CFG, air=tribmul(), device="cpu")
    p2 = prove(DECL_CFG, air=tribmul(b0=99), device="cpu")
    assert p1.publics["output"] != p2.publics["output"]
    assert set(p2.publics) == {"input", "output", "b0", "c0"}
    assert verify(p2)
    # bound copies share one context; a spec of another structure under
    # the same name does not
    ctx = tprover.get_air_context(tribmul(b0=5), DECL_CFG, "cpu")
    assert tprover.get_air_context(tribmul(), DECL_CFG, "cpu") is ctx
    other = AirSpec(name="tribmul", columns=3, init=tribmul.init,
                    step=lambda f, rows, P: (rows[0][1], rows[0][2],
                                             f.mul(rows[0][0], rows[0][2])),
                    boundaries=tribmul.boundaries, register=False)
    assert tprover.get_air_context(other, DECL_CFG, "cpu") is not ctx


def test_periodic_length_one_equals_param():
    """L = 1 periodic == a fixed param: the same trace and the same proof
    bytes (the interpolant is the constant polynomial)."""
    def quintic(key):
        return lambda f, rows, P: (
            (lambda t: f.mul(f.mul(f.mul(f.mul(t, t), t), t), t))(
                f.add(rows[0][0], P[key])),)

    bounds = (Boundary(0, 0, "input"), Boundary(0, -1, "output"))
    const_spec = AirSpec(name="mimc5-const-k", columns=1,
                         init=((("x0", 5),),), step=quintic("rc"),
                         boundaries=bounds, periodic={"rc": (777,)},
                         register=False)
    param_spec = AirSpec(name="mimc5-param-k", columns=1,
                         init=((("x0", 5),),), step=quintic("k"),
                         boundaries=bounds, params={"k": 777},
                         register=False)
    cfg = ProverConfig(log2_trace=5, blowup=8, num_queries=4)
    assert np.array_equal(const_spec.host_trace(cfg),
                          param_spec.host_trace(cfg))
    a = prove(cfg, air=const_spec(), device="cpu")
    b = prove(cfg, air=param_spec(), device="cpu")
    assert a.proof == b.proof
    assert verify(a, air=const_spec)
