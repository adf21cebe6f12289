"""SHA-256: the tree kernels' and the chain's wrappers (``cuda_sha.py``,
``cuda_chain.py``), their plain torch versions and digest bytes."""

from stark_tpu_torch.hash.sha256 import (digest_to_bytes, sha256_pairs,
                                         sha256_u64_leaves)

__all__ = ["sha256_u64_leaves", "sha256_pairs", "digest_to_bytes"]
