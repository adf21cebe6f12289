"""K3 / K4 wrappers: SHA-256 Merkle leaves and nodes
(``csrc/sha256_tree.cu``; replaces ``stark_tpu/hash/pallas_sha.py``
``_make_leaf_kernel`` / ``_make_node_kernel``).

A CPU tensor runs the plain torch version (``hash/sha256.py``); a CUDA
tensor launches the kernel or raises.  Each wrapper counts its launches
in its ``launches`` attribute.
"""

from __future__ import annotations

import torch

from stark_tpu_torch import _build
from stark_tpu_torch.hash.sha256 import sha256_pairs, sha256_u64_leaves


def sha_leaves(values: torch.Tensor, out: torch.Tensor | None = None):
    """(n,) int32 field values -> (n, 8) int32 leaf digests, written into
    `out` when given (a contiguous (n, 8) view, e.g. a tree buffer's leaf
    level)."""
    n = int(values.shape[0])
    if _build.plain_device(values):
        res = sha256_u64_leaves(values)
        return res if out is None else out.copy_(res)
    _build.require(values, "values", (n,))
    if out is None:
        out = torch.empty((n, 8), dtype=torch.int32, device=values.device)
    _build.require(out, "out", (n, 8), align=16)
    _build.check(_build.lib("sha256_tree").stark_sha_leaves(
        values.data_ptr(), out.data_ptr(), n,
        _build.stream_ptr(values.device)), "K3 sha_leaves")
    sha_leaves.launches += 1
    return out


def sha_nodes(children: torch.Tensor, out: torch.Tensor | None = None):
    """(2m, 8) child digest rows -> (m, 8) parent rows, parent j hashing
    children 2j and 2j+1; written into `out` when given."""
    m = int(children.shape[0]) // 2
    if _build.plain_device(children):
        res = sha256_pairs(children)
        return res if out is None else out.copy_(res)
    _build.require(children, "children", (2 * m, 8), align=16)
    if out is None:
        out = torch.empty((m, 8), dtype=torch.int32, device=children.device)
    _build.require(out, "out", (m, 8), align=16)
    _build.check(_build.lib("sha256_tree").stark_sha_nodes(
        children.data_ptr(), out.data_ptr(), m,
        _build.stream_ptr(children.device)), "K4 sha_nodes")
    sha_nodes.launches += 1
    return out


sha_leaves.launches = 0
sha_nodes.launches = 0
sha_leaves.plain = sha256_u64_leaves
sha_nodes.plain = sha256_pairs
