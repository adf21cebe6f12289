#!/usr/bin/env python3
"""Warm prove walls of the port (``stark_tpu_torch``) of one checkout on
one CUDA device, to compare two commits in one run on one card.

    python3 scripts/prove_walls.py --root DIR [--reps N] [--split] NAME ...

Imports ``stark_tpu_torch`` and ``chip_smoke`` from the checkout at DIR
(so an unpacked parent commit is measured with its own code), and for
each NAME (a key of that checkout's ``chip_smoke.PROVES``, e.g. "2^24"
or "FibMul 2^24") proves once cold, then N times warm, each ending in
``torch.cuda.synchronize()``.  Prints one JSON line per prove: the
checkout, the card's name, the cold seconds, the warm walls in ms and
their median; with ``--split``, also the prove's steps as that
checkout's ``chip_smoke.phase_split`` times them (synced after each
step, the third of three runs; its "FRI commit" is the FRI commit
phase).  Run parent, change, change, parent and compare medians within
the call.
"""

import argparse
import json
import os
import statistics
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="the checkout to measure")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--split", action="store_true",
                    help="also the synced step split of each prove")
    ap.add_argument("names", nargs="+")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("prove_walls: needs a CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke
    from stark_tpu_torch.stark import prove

    dev = torch.device("cuda:0")
    for name in args.names:
        cfg, air = chip_smoke.prove_setup(name)
        t0 = time.perf_counter()
        prove(cfg, air=air, device=dev)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            prove(cfg, air=air, device=dev)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        row = {"root": root, "prove": name,
               "device": torch.cuda.get_device_name(0), "cold_s": cold,
               "warm_ms": walls, "median_ms": statistics.median(walls)}
        if args.split:
            for _ in range(3):
                row["split_ms"] = chip_smoke.phase_split(cfg, air, dev)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
