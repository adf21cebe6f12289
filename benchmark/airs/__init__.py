"""The AIRs the benchmark knows, found by a configuration's ``air``; a
new AIR is a new pair of files here, and a name without them is refused:

* ``<air>.py``: what the plain reference needs (the columns, the rows a
  query opens, the number of composition weights, the plain trace from
  a witness, the publics and the constraints) and the name of the
  program's AIR class in ``stark_tpu_torch.stark`` with its witness
  keyword.  It imports nothing of the program.
* ``<air>.cpp``: the frozen host trace loop (``tracemaker.py``), one
  function ``bench_trace(p, witness, n, out)`` writing the n rows of
  each column, column after column.
"""

from __future__ import annotations

import importlib.util
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
_loaded: dict = {}


def path(name: str, ext: str) -> str:
    """The AIR's file with extension `ext`; ValueError for an unknown
    AIR."""
    file = os.path.join(HERE, f"{name}{ext}")
    if not _NAME.fullmatch(name) or not os.path.isfile(file):
        raise ValueError(f"unknown AIR {name!r}: no benchmark/airs/{name}"
                         f"{ext}")
    return file


def load(name: str):
    """The AIR's definition module (``<name>.py``), loaded once."""
    if name not in _loaded:
        spec = importlib.util.spec_from_file_location(
            "benchmark.airs.air_" + re.sub(r"\W", "_", name),
            path(name, ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[name] = mod
    return _loaded[name]
