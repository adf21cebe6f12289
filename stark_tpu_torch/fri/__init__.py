"""FRI: the commit (folds, per-layer trees, the device Fiat-Shamir
state), the decommitment, the host verifier and the coset domains."""

from stark_tpu_torch.fri.commit import (FRIProof, decommit_fri,
                                        decommit_fri_layers, fri_commit)
from stark_tpu_torch.fri.coset import CosetFri
from stark_tpu_torch.fri.verify import FRIVerificationError, verify_fri

__all__ = [
    "FRIProof", "fri_commit", "decommit_fri", "decommit_fri_layers",
    "verify_fri", "FRIVerificationError", "CosetFri",
]
