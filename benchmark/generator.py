"""The one traffic generator: it reads a traffic mix (a JSON file under
``benchmark/traffic/``) and a configuration and gives the statements a
run proves, all drawn from the run's seed.

A mix's keys:

* ``kind``: ``"trace"`` — each prove is handed a finished trace, as a
  prover behind an executor is; the traces are a pool of ``pool``
  statements made in set-up by the benchmark's own trace maker and
  proved in turn; or ``"witness"`` — each prove gets a fresh witness and
  the program makes the trace itself;
* ``warmup``: proves run in set-up, before the measured window.

Statement i's witness is a hash of (seed, i) reduced into [2, p), so any
statement can be made again from the seed alone, and every seed gives
the same sizes in another order of values.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from concurrent.futures import ThreadPoolExecutor

from benchmark import tracemaker

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Statement:
    index: int  # the request's position in the run
    key: int  # which statement: a pool slot, or the index itself
    witness: int
    words: object = None  # the trace's storage words (trace mixes)


def load_mix(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as fh:
        return json.load(fh)


def witness(seed: int, key: int, p: int) -> int:
    """The witness of statement `key` under `seed`: in [2, p)."""
    h = hashlib.sha256(f"{seed}/{key}".encode()).digest()
    return 2 + int.from_bytes(h, "big") % (p - 2)


class Traffic:
    """The statements of one run: ``statement(i)`` for i = 0, 1, ...;
    the first ``warmup`` go to set-up."""

    def __init__(self, mix: dict, spec: dict, seed: int):
        if mix["kind"] not in ("trace", "witness"):
            raise ValueError(f"unknown traffic kind {mix['kind']!r}")
        self.mix, self.spec, self.seed = mix, spec, seed
        self.kind = mix["kind"]
        self.warmup = int(mix.get("warmup", 2))
        self.pool = int(mix.get("pool", 0))
        self.p = int(spec["modulus"])
        self.rows = (1 << int(spec["log2_trace"])) - 1
        self.words: list = []

    def make_pool(self) -> None:
        """Make the trace pool (trace mixes): one trace maker call a
        statement, on as many threads (the loops release the
        interpreter)."""
        if self.kind != "trace":
            return

        def make(key):
            vals = tracemaker.values(self.spec["air"], self.p,
                                     witness(self.seed, key, self.p),
                                     self.rows)
            return tracemaker.storage_words(vals, self.p)

        with ThreadPoolExecutor(max_workers=self.pool) as ex:
            self.words = list(ex.map(make, range(self.pool)))

    def statement(self, i: int) -> Statement:
        k = i % self.pool if self.kind == "trace" else i
        return Statement(i, k, witness(self.seed, k, self.p),
                         self.words[k] if self.kind == "trace" else None)
