"""NTT/INTT, coset evaluation and the low-degree extension over GF(p)
(the K1/K2 kernels for u32 fields, the 64-bit kernels for Goldilocks),
and the host reference NTT."""

from stark_tpu_torch.ntt.ntt import (coset_evaluate, coset_interpolate, intt,
                                     lde, ntt)
from stark_tpu_torch.ntt.reference_ntt import (naive_dft, ntt_available,
                                               ntt_host, root_of_unity)

__all__ = [
    "ntt", "intt", "lde", "coset_evaluate", "coset_interpolate",
    "ntt_host", "ntt_available", "root_of_unity", "naive_dft",
]
