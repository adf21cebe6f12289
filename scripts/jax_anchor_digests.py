#!/usr/bin/env python3
"""Transcript digests of Goldilocks proves made by the JAX package on the
CPU: the anchors that ``chip_smoke.py`` holds the port's proves on the
card against (``GL_ANCHORS`` there).

    JAX_PLATFORMS=cpu python3 scripts/jax_anchor_digests.py [log2_trace ...]

For each trace size (default 12) it proves the Fibonacci-square
statement (a1 = 3141592) and the two-column FibMul statement
(a0 = 1, b0 = 2718281) over p = 2^64 - 2^32 + 1 (generator 7) at blowup
4 and 16 queries, checks each proof with the JAX verifier, and prints
one JSON line per prove: the statement, the size, the SHA-256 of the
transcript (its messages concatenated) and the prove's wall seconds.
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

GOLDILOCKS = 2**64 - 2**32 + 1


def main() -> int:
    logs = [int(a) for a in sys.argv[1:]] or [12]
    for log2 in logs:
        cfg = ProverConfig(modulus=GOLDILOCKS, generator=7, log2_trace=log2,
                           blowup=4, num_queries=16)
        for name, air in (("fib-sq-GL", FibonacciSquareAIR(a1=3141592)),
                          ("FibMul-GL", FibMulAIR(a0=1, b0=2718281))):
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
