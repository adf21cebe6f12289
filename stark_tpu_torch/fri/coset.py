"""Coset domain generator (counterpart of ``stark_tpu/fri/coset.py``, the
reference's CosetFri, ``src/fri/coset_fri.rs:9-50``).

``generate_coset_domain`` is {offset * omega^i : i < domain_size} built on
the device (``Fp.coset_domain``: an outer product of two host tables of
about sqrt(size) entries, one product on the device).
``next_coset_domain`` is the fold domain FRI needs (the first half,
squared, ``fri_commit.rs:18-24``); ``next_coset_domain_full`` squares
every element and keeps the length, as the reference's disabled code is
written.  Domains are int32 storage (limb planes for Goldilocks).
"""

from __future__ import annotations

import torch

from stark_tpu_torch.fields.fp import Fp


class CosetFri:
    def __init__(self, p: int, offset: int, omega: int, domain_size: int,
                 device="cuda"):
        self.fp = Fp.get(p)
        self.offset = int(offset) % p
        self.omega = int(omega) % p
        self.domain_size = int(domain_size)
        self.device = torch.device(device)

    def generate_coset_domain(self) -> torch.Tensor:
        return self.fp.coset_domain(self.offset, self.omega,
                                    self.domain_size, self.device)

    def next_coset_domain(self, domain: torch.Tensor) -> torch.Tensor:
        """The standard FRI fold domain: the first half, squared."""
        half = domain[..., : int(domain.shape[-1]) // 2]
        return self.fp.storage(self.fp.sqr(half))

    def next_coset_domain_full(self, domain: torch.Tensor) -> torch.Tensor:
        """The reference's as-written variant: every element squared, the
        length kept."""
        return self.fp.storage(self.fp.sqr(domain))
