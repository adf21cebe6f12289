#!/usr/bin/env python3
"""Transcript digests of the JAX package's single-device and mesh proves
of five small statements: the vectors ``tests/test_torch_mesh_prove.py``
holds the port's mesh proves against (``tests/vectors/mesh_digests.json``).

    JAX_PLATFORMS=cpu python3 scripts/jax_mesh_digests.py \
        > tests/vectors/mesh_digests.json

Each statement (Fibonacci-square, MiMC³, FibMul, Fibonacci-square over
Goldilocks, the ``tribmul`` family with its default witness) is proved
at 2^4 rows, blowup 4, 2 queries: once on one device and once on a mesh
of 1, 2 and 4 virtual CPU devices.  The script checks that every mesh
transcript equals the single-device one and that the proof verifies,
then writes one JSON object: per statement the SHA-256 of the
single-device transcript (its messages concatenated), of each mesh
prove's, and the publics.  About 3 minutes on a CPU, mostly XLA
compiles.
"""

import hashlib
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_default_device", jax.local_devices(backend="cpu")[0])

from stark_tpu.config import ProverConfig  # noqa: E402
from stark_tpu.dist import make_mesh  # noqa: E402
from stark_tpu.stark import prove, verify  # noqa: E402
from stark_tpu.stark.air import (FibMulAIR, FibonacciSquareAIR,  # noqa: E402
                                 MimcAIR)
from stark_tpu.stark.families import FAMILIES  # noqa: E402

GOLDILOCKS = 2**64 - 2**32 + 1
KW = dict(log2_trace=4, blowup=4, num_queries=2)
SHARDS = (1, 2, 4)


def statements():
    """(name, config, AIR) of each prove."""
    cfg = ProverConfig(**KW)
    yield "fib-sq", cfg, FibonacciSquareAIR(a1=3141592)
    yield "mimc3", cfg, MimcAIR(x0=271828, k=777)
    yield "fibmul", cfg, FibMulAIR(a0=1, b0=2718281)
    yield ("fib-sq-GL", ProverConfig(modulus=GOLDILOCKS, generator=7, **KW),
           FibonacciSquareAIR(a1=3141592))
    yield "tribmul", cfg, FAMILIES["tribmul"][0]()


def digest(pr) -> str:
    return hashlib.sha256(b"".join(pr.proof)).hexdigest()


def main() -> int:
    devices = jax.local_devices(backend="cpu")
    out = {"config": KW, "statements": {}}
    for name, cfg, air in statements():
        single = prove(cfg, air=air)
        assert verify(single, expected_config=cfg)
        mesh = {}
        for s in SHARDS:
            pr = prove(cfg, air=air, mesh=make_mesh(s, devices=devices[:s]))
            assert pr.proof == single.proof, (name, s)
            mesh[str(s)] = digest(pr)
        out["statements"][name] = {
            "single": digest(single), "mesh": mesh,
            "publics": single.publics}
        print(name, "done", file=sys.stderr, flush=True)
    print(json.dumps(out, indent=1, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
