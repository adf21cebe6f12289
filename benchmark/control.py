"""The control and the planted faults of a cell, read through the same
run and check as ``run.py`` (not part of a benchmark run).

    python3 benchmark/control.py --workload NAME --seeds A B C \
        [--mode control|stale|flip|alternate] [--seconds S] [--log2-trace K]

* ``control``: the plain reference put in the program's place with one
  guarantee of the configuration broken: one query fewer than it states
  (soundness).  The window proves with it; the check compares with the
  reference at the configuration's own query count.
* ``stale``: the program returning its previous answer, its state left
  unchanged (the first prove's is its own).
* ``flip``: the program's answer altered where it is produced (one byte
  of one message of every proof).
* ``alternate``: the same alteration in every other proof of each
  statement only (answers that differ between proves of one statement).

Each seed prints one JSON line: the mode, the seed, ``correct`` and the
numbers compared with their limits.  ``--log2-trace`` shrinks the
configuration (the CPU tests); ``--device`` defaults to the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[:1] != [ROOT]:
    sys.path.insert(0, ROOT)

from benchmark import run as bench_run  # noqa: E402
from benchmark.reference import stark as ref  # noqa: E402


def control_program(spec: dict, device, devices=None):
    """The reference proving with one query fewer than `spec` states (on
    `device`, whatever the shards)."""
    rspec = ref.Spec.from_config(spec)

    def prove(st, metrics=None):
        if st.words is not None:
            import torch

            cols = ref.columns_from_words(
                rspec, torch.from_numpy(st.words.astype("int64")))
        else:
            cols = ref.plain_trace(rspec, st.witness)
        return ref.prove(rspec, cols, device,
                         num_queries=rspec.num_queries - 1)

    return prove


def stale_program(spec: dict, device, devices=None):
    """The program, answering each prove with its previous answer."""
    real = bench_run.program(spec, device, devices)
    last = []

    def prove(st, metrics=None):
        out = real(st, metrics)
        answer = last[0] if last else out
        last[:] = [out]
        return answer

    return prove


def flip_program(spec: dict, device, devices=None,
                 every_other: bool = False):
    """The program, with one byte of one message of each proof altered
    (`every_other`: only in every other proof of each statement)."""
    real = bench_run.program(spec, device, devices)
    seen: dict = {}

    def prove(st, metrics=None):
        messages, publics = real(st, metrics)
        seen[st.key] = seen.get(st.key, 0) + 1
        if every_other and seen[st.key] % 2:
            return messages, publics
        j = len(messages) // 2
        m = bytearray(messages[j])
        m[0] ^= 1
        return messages[:j] + [bytes(m)] + messages[j + 1:], publics

    return prove


def alternate_program(spec: dict, device, devices=None):
    return flip_program(spec, device, devices, every_other=True)


MODES = {"control": control_program, "stale": stale_program,
         "flip": flip_program, "alternate": alternate_program}


def read(workload: str, seed: int, mode: str, seconds: float, device,
         log2_trace: int | None = None) -> dict:
    """One run of `workload` with `mode`'s program in place: its
    correctness and the numbers compared."""
    bench = bench_run.load_bench()
    cell = bench_run.find(bench["workloads"], workload, "workload")
    override = {} if log2_trace is None else {"log2_trace": log2_trace}
    res = bench_run.run_cell(bench, cell, seed, seconds, False,
                             device=device, spec_override=override,
                             prove_fn=MODES[mode],
                             warmup=0 if mode == "control" else None)
    return {"mode": mode, "workload": workload, "seed": seed,
            "correct": res["correct"], "attempted": res["attempted"],
            "checks": res["checks"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--mode", choices=sorted(MODES), default="control")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--log2-trace", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(read(args.workload, seed, args.mode, args.seconds,
                              args.device, args.log2_trace)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
