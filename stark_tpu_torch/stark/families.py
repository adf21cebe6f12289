"""The shipped declarative statement families (counterpart of
``stark_tpu/stark/families.py``; the constants and step functions are
the JAX package's, letter for letter): ``tribmul`` (three columns),
``mimc5`` (a degree-5 S-box chain: log2(N) + 2 folds, blowup >= 8) and
``mimc5rc`` (its round constants as an 8-cycle periodic column), and
:func:`build_air`, the one entry point of the CLI and the prover daemon
from an AIR's name and secret.
"""

from __future__ import annotations

from stark_tpu_torch.stark.air import FibMulAIR, MimcAIR
from stark_tpu_torch.stark.air_builder import AirSpec, Boundary

# Three-column tribonacci-mul:  a' = b, b' = c, c' = a*b + c.
# Exercises the C=3 row-leaf commitment and multi-value openings.
TRIBMUL = AirSpec(
    name="tribmul",
    columns=3,
    init=((("a0", 1), ("b0", 2), ("c0", 3)),),
    step=lambda f, rows, P: (
        rows[0][1],
        rows[0][2],
        f.add(f.mul(rows[0][0], rows[0][1]), rows[0][2]),
    ),
    boundaries=(
        Boundary(column=0, row=0, public="input"),
        Boundary(column=1, row=0, public="b0"),
        Boundary(column=2, row=0, public="c0"),
        Boundary(column=2, row=-1, public="output"),
    ),
)

# Degree-5 S-box chain  x' = (x + k)^5  (the MiMC/Rescue-style quintic
# permutation used by fields where gcd(5, p-1) = 1).  The degree
# inference derives 4 extra bits of composition degree: log2(N)+2 FRI
# folds and minimum blowup 8 — nothing is hand-computed.
MIMC5 = AirSpec(
    name="mimc5",
    columns=1,
    init=((("x0", 271828),),),
    step=lambda f, rows, P: (
        (lambda t: f.mul(f.mul(f.mul(f.mul(t, t), t), t), t))(
            f.add(rows[0][0], P["k"])
        ),
    ),
    boundaries=(
        Boundary(column=0, row=0, public="input"),
        Boundary(column=0, row=-1, public="output"),
    ),
    params={"k": 777},
)

# MiMC5 with a proper round-constant SCHEDULE (cycle of 8) instead of a
# single fixed k — the standard construction (MiMC, Rescue, Poseidon all
# need per-round constants).  Exercises the periodic-column mechanism:
# the schedule appears in the composition as the low-degree interpolant
# K(x) = K_hat(x^(N/8)) and in the verifier mirror as a scalar Horner.
MIMC5RC = AirSpec(
    name="mimc5rc",
    columns=1,
    init=((("x0", 314159),),),
    step=lambda f, rows, P: (
        (lambda t: f.mul(f.mul(f.mul(f.mul(t, t), t), t), t))(
            f.add(rows[0][0], P["rc"])
        ),
    ),
    boundaries=(
        Boundary(column=0, row=0, public="input"),
        Boundary(column=0, row=-1, public="output"),
    ),
    periodic={"rc": (0x42, 0x1337, 0xDEAD, 0xBEEF,
                     0xCAFE, 0xF00D, 0x0BAD, 0xFACE)},
)

# name -> (spec, witness kwarg that carries the CLI --secret value)
FAMILIES: dict[str, tuple[AirSpec, str]] = {
    "tribmul": (TRIBMUL, "b0"),
    "mimc5": (MIMC5, "x0"),
    "mimc5rc": (MIMC5RC, "x0"),
}


def build_air(name: str, secret: int, mimc_key: int = 777):
    """Construct a prover-side AIR from its registry name + the secret
    witness value — the single shared entry point for the CLI and the
    prover daemon (stark_tpu_torch.serve).  Returns None for the default
    fibonacci-square family (prove() takes the secret as ``a1``)."""
    if name == "fibonacci-square":
        return None
    if name == "mimc3":
        return MimcAIR(x0=secret, k=mimc_key)
    if name == "fibmul":
        return FibMulAIR(b0=secret)
    if name in FAMILIES:
        spec, secret_key = FAMILIES[name]
        return spec(**{secret_key: secret})
    raise ValueError(f"unknown AIR family {name!r}")
