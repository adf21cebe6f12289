"""stark_tpu_torch — the PyTorch/CUDA port of ``stark_tpu``.

Same pipeline, same transcript bytes; the JAX package beside it stays the
reference.  Field values live in ``torch.int32`` tensors holding uint32
bits (``fields/fp.py``); the hot kernels are hand-written CUDA C++ for
Hopper (``csrc/``), each with a plain torch version beside it that runs
on CPU tensors.  This package imports ``torch`` (plus numpy, hashlib and
ctypes) and never ``jax`` or ``stark_tpu``.
"""

from stark_tpu_torch.config import (DEFAULT_GENERATOR, DEFAULT_MODULUS,
                                    ProverConfig)
from stark_tpu_torch.fields import FieldElement, Fp

__version__ = "0.1.0"

__all__ = [
    "FieldElement",
    "Fp",
    "ProverConfig",
    "DEFAULT_MODULUS",
    "DEFAULT_GENERATOR",
]
