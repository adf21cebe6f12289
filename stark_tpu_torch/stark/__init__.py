"""The STARK pipeline: trace, AIR, prover and verifier; checkpoint /
resume and batch proving."""

from stark_tpu_torch.stark.trace import (fibonacci_square_trace,
                                         trace_polynomial)
from stark_tpu_torch.stark.air import (AIR, FibMulAIR, FibonacciSquareAIR,
                                       MimcAIR, air_from_name)
from stark_tpu_torch.stark.air_builder import AirSpec, Boundary, register_spec
from stark_tpu_torch.stark.prover import StarkProof, prove
from stark_tpu_torch.stark.verifier import StarkVerificationError, verify
from stark_tpu_torch.stark.checkpoint import ProverCheckpoint, prove_resumable
from stark_tpu_torch.stark.batch import prove_batch

__all__ = ["fibonacci_square_trace", "trace_polynomial", "StarkProof",
           "prove", "verify", "StarkVerificationError", "AIR",
           "FibonacciSquareAIR", "MimcAIR", "FibMulAIR", "air_from_name",
           "AirSpec", "Boundary", "register_spec", "ProverCheckpoint",
           "prove_resumable", "prove_batch"]
