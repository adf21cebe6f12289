#!/usr/bin/env python3
"""Transcript digests of proves made by the JAX package on the CPU: the
anchors that ``chip_smoke.py`` holds the port's proves on the card
against (``GL_ANCHORS`` and ``FAMILY_ANCHORS`` there).

    JAX_PLATFORMS=cpu python3 scripts/jax_anchor_digests.py [log2_trace ...]
    JAX_PLATFORMS=cpu python3 scripts/jax_anchor_digests.py --families \
        [log2_trace ...]

For each trace size (default 12) it proves the Fibonacci-square
statement (a1 = 3141592) and the two-column FibMul statement
(a0 = 1, b0 = 2718281) over p = 2^64 - 2^32 + 1 (generator 7) at blowup
4 and 16 queries.  With ``--families`` (default size 8) it proves the
declarative families ``tribmul``, ``mimc5`` and ``mimc5rc`` with their
default witnesses over p = 3·2^30 + 1 and over Goldilocks, at blowup 4
(8 for the mimc5 families, their least) and 16 queries.  It checks each
proof with the JAX verifier and prints one JSON line per prove: the
statement, the size, the SHA-256 of the transcript (its messages
concatenated) and the prove's wall seconds.
"""

import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_default_device", jax.local_devices(backend="cpu")[0])

from stark_tpu.config import ProverConfig  # noqa: E402
from stark_tpu.stark import prove, verify  # noqa: E402
from stark_tpu.stark.air import FibMulAIR, FibonacciSquareAIR  # noqa: E402
from stark_tpu.stark.families import FAMILIES  # noqa: E402

GOLDILOCKS = 2**64 - 2**32 + 1
FIELDS = {"": {}, "-GL": dict(modulus=GOLDILOCKS, generator=7)}


def statements(log2: int, families: bool):
    """(name, config, AIR) of each prove at 2^log2 rows."""
    if not families:
        cfg = ProverConfig(modulus=GOLDILOCKS, generator=7, log2_trace=log2,
                           blowup=4, num_queries=16)
        yield "fib-sq-GL", cfg, FibonacciSquareAIR(a1=3141592)
        yield "FibMul-GL", cfg, FibMulAIR(a0=1, b0=2718281)
        return
    for suffix, field in FIELDS.items():
        for name, (spec, _) in FAMILIES.items():
            blowup = 8 if name.startswith("mimc5") else 4
            yield (name + suffix,
                   ProverConfig(log2_trace=log2, blowup=blowup,
                                num_queries=16, **field), spec())


def main() -> int:
    args = sys.argv[1:]
    families = "--families" in args
    logs = ([int(a) for a in args if a != "--families"]
            or [8 if families else 12])
    for log2 in logs:
        for name, cfg, air in statements(log2, families):
            t0 = time.perf_counter()
            pr = prove(cfg, air=air)
            wall = time.perf_counter() - t0
            assert verify(pr, expected_config=cfg)
            digest = hashlib.sha256(b"".join(pr.proof)).hexdigest()
            print(json.dumps({"statement": name, "log2_trace": log2,
                              "transcript_sha256": digest,
                              "publics": pr.publics,
                              "prove_s": round(wall, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
