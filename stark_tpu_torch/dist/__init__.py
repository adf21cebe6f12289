"""The sharded prove over a device mesh, in one process or across the
processes of a ``torch.distributed`` group (counterpart of
``stark_tpu/dist``)."""

from stark_tpu_torch.dist.mesh import (SHARD_AXIS, make_mesh, replicated,
                                       shard_spec, sharded)
from stark_tpu_torch.dist.ntt import dist_coset_evaluate, dist_intt, dist_ntt
from stark_tpu_torch.dist.merkle import dist_merkle_tree
from stark_tpu_torch.dist.multihost import (global_mesh, multihost_prove,
                                            process_info)
from stark_tpu_torch.dist.multihost import initialize as \
    distributed_initialize

__all__ = [
    "SHARD_AXIS", "make_mesh", "sharded", "replicated", "shard_spec",
    "dist_ntt", "dist_intt", "dist_coset_evaluate", "dist_merkle_tree",
    "distributed_initialize", "global_mesh", "multihost_prove",
    "process_info",
]
