"""The STARK pipeline: trace, AIR, prover and verifier."""

from stark_tpu_torch.stark.air import FibonacciSquareAIR
from stark_tpu_torch.stark.prover import StarkProof, prove
from stark_tpu_torch.stark.verifier import StarkVerificationError, verify

__all__ = ["FibonacciSquareAIR", "StarkProof", "prove", "verify",
           "StarkVerificationError"]
