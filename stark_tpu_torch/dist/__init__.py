"""The sharded prove over a device mesh, one process (counterpart of
``stark_tpu/dist``; its multi-host half is not ported yet)."""

from stark_tpu_torch.dist.mesh import (SHARD_AXIS, make_mesh, replicated,
                                       shard_spec, sharded)
from stark_tpu_torch.dist.ntt import dist_coset_evaluate, dist_intt, dist_ntt
from stark_tpu_torch.dist.merkle import dist_merkle_tree

__all__ = [
    "SHARD_AXIS", "make_mesh", "sharded", "replicated", "shard_spec",
    "dist_ntt", "dist_intt", "dist_coset_evaluate", "dist_merkle_tree",
]
