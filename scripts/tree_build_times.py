#!/usr/bin/env python3
"""Times of the Merkle tree build of the port (``stark_tpu_torch``) of one
checkout on one CUDA device, to compare two commits in one run on one
card.

    python3 scripts/tree_build_times.py --root DIR [--reps N]

Imports ``stark_tpu_torch`` and ``chip_smoke`` from the checkout at DIR
(so an unpacked parent commit is measured with its own code) and prints
one JSON line per measurement, each with the checkout and the card:

* ``leaves``: ``sha_leaves`` over 2^20, 2^22 and 2^26 seeded u32 values:
  the wrapper's CUDA-event time (host work between the events included)
  and the device time of its kernel alone (``torch.profiler``);
* ``nodes``: ``sha_nodes`` over 2^10, 2^5 and 2^0 parents: device time a
  launch, and the host time of one wrapper call (the mean of a loop of
  calls that does not wait for the card);
* ``build``: one whole ``build_tree`` of 2^20, 2^22 and 2^26 leaves,
  unpruned and with 4 pruned levels: its CUDA-event time, and each tree
  kernel's device time and launch count under ``torch.profiler``.

Run parent, change, change, parent and compare within the call; the
FRI commit's split beside the prove walls is ``scripts/prove_walls.py
--split``'s.
"""

import argparse
import json
import os
import sys
import time

# the tree kernels of either design: K3's leaves (the level-at-a-time
# build) or its subtree form, K4's level kernel and the tail
KERNELS = r"sha_(leaves|subtree|nodes)<?[^(]*"


def measure(cs, dev, reps: int, emit) -> None:
    """Every measurement above with the port imported on sys.path and
    `cs` its checkout's chip_smoke module, each passed to
    emit(kind, **fields)."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    from stark_tpu_torch.hash.cuda_sha import sha_leaves, sha_nodes
    from stark_tpu_torch.merkle.tree import build_tree

    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)

    def device_ms(fn):
        """{kernel: (device ms a call, launches a call)} under the
        profiler, over `reps` calls after a warm-up."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            m = re.search(KERNELS, e.key)
            if m:
                out[m.group(0)] = (e.self_device_time_total / reps / 1e3,
                                   e.count / reps)
        return out

    for log_n in (20, 22, 26):
        vals = cs.rand_u32_dev(gen, (1 << log_n,), cs.P, dev)
        out = torch.empty((1 << log_n, 8), dtype=torch.int32, device=dev)
        emit("leaves", log_n=log_n,
             events_ms=cs.cuda_ms(lambda: sha_leaves(vals, out=out), reps),
             device=device_ms(lambda: sha_leaves(vals, out=out)))
        del out
        for prune in (0, 4):
            emit("build", log_n=log_n, prune=prune,
                 events_ms=cs.cuda_ms(lambda: build_tree(vals, prune=prune),
                                      reps),
                 device=device_ms(lambda: build_tree(vals, prune=prune)))
        del vals
        torch.cuda.empty_cache()
    for log_m in (10, 5, 0):
        kids = cs.rand_u32_dev(gen, (2 << log_m, 8), 1 << 31, dev)
        par = torch.empty((1 << log_m, 8), dtype=torch.int32, device=dev)
        calls = 2000
        sha_nodes(kids, out=par)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            sha_nodes(kids, out=par)
        host_us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        emit("nodes", log_m=log_m, host_us_a_call=host_us,
             device=device_ms(lambda: sha_nodes(kids, out=par)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="the checkout to measure")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("tree_build_times: needs a CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke

    card = chip_smoke.card_smi()

    def emit(kind, **kw):
        print(json.dumps({"root": root, "card": card, "kind": kind, **kw}),
              flush=True)

    measure(chip_smoke, torch.device("cuda:0"), args.reps, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
