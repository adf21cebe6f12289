"""The check that nothing the benchmark ran loaded JAX or the JAX
package: the top-level name of each loaded module (the part before the
first dot) is compared whole, so ``stark_tpu_torch`` passes and
``stark_tpu`` does not."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "stark_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules (default ``sys.modules``) whose top-level name is
    forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
