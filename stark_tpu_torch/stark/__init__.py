"""The STARK pipeline: trace, AIR, prover and verifier."""

from stark_tpu_torch.stark.air import FibMulAIR, FibonacciSquareAIR, MimcAIR
from stark_tpu_torch.stark.prover import StarkProof, prove
from stark_tpu_torch.stark.verifier import StarkVerificationError, verify

__all__ = ["FibonacciSquareAIR", "MimcAIR", "FibMulAIR", "StarkProof",
           "prove", "verify", "StarkVerificationError"]
