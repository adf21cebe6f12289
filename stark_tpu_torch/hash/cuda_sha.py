"""K3 / K4 wrappers: SHA-256 Merkle leaves and nodes
(``csrc/sha256_tree.cu``; replaces ``stark_tpu/hash/pallas_sha.py``
``_make_leaf_kernel`` in its u32 and its 64-bit ``wide`` mode /
``_make_node_kernel``).

K3 has two wrappers over one kernel templated on the column count and the
width: :func:`sha_leaves` hashes one value a leaf (every FRI tree and a
one-column trace), :func:`sha_row_leaves` the rows of a multi-column
trace (the row form, C = 1..6; the XLA ``sha256_row_leaves`` of the JAX
package).  Both take the field's width explicitly (``wide=True`` for
Goldilocks limb planes), never from the shape: a (2, n) tensor is two u32
columns or one Goldilocks column.  A CPU tensor runs the plain torch
version (``hash/sha256.py``); a CUDA tensor launches the kernel or
raises.  The values may be a slice along the last axis of a larger
tensor (one chunk of a tree's leaves, ``merkle/tree.py``): the kernel
reads each plane in place, a fixed stride after the one before.  Each
wrapper counts its u32 launches in ``launches`` and its 64-bit ones in
``wide_launches``.
"""

from __future__ import annotations

import torch

from stark_tpu_torch import _build
from stark_tpu_torch.hash.sha256 import (sha256_pairs, sha256_row_leaves,
                                         sha256_u64_leaves)


def _launch_leaves(values, shape: tuple, out, cols: int, wide: bool,
                   what: str):
    n = shape[-1]
    ld = _build.require_planes(values, "values", shape)
    if out is None:
        out = torch.empty((n, 8), dtype=torch.int32, device=values.device)
    _build.require(out, "out", (n, 8), align=16)
    _build.check(_build.lib("sha256_tree").stark_sha_leaves(
        values.data_ptr(), out.data_ptr(), n, ld, 0, 0, cols, int(wide), 1,
        _build.stream_ptr(values.device)), what)
    return out


def _count(wrapper, wide: bool) -> None:
    if wide:
        wrapper.wide_launches += 1
    else:
        wrapper.launches += 1


def sha_leaves(values: torch.Tensor, out: torch.Tensor | None = None, *,
               wide: bool = False):
    """(n,) int32 u32 field values, or with `wide` the (2, n) limb planes
    of Goldilocks values (planes contiguous, a fixed stride apart) ->
    (n, 8) int32 leaf digests, written into `out` when given (a contiguous
    (n, 8) view, e.g. a tree buffer's leaf level)."""
    n = int(values.shape[-1])
    if _build.plain_device(values):
        res = sha256_u64_leaves(values, wide)
        return res if out is None else out.copy_(res)
    out = _launch_leaves(values, (2, n) if wide else (n,), out, 1, wide,
                         f"K3 sha_leaves{' (64-bit)' * wide}")
    _count(sha_leaves, wide)
    return out


def sha_row_leaves(cols: torch.Tensor, out: torch.Tensor | None = None, *,
                   wide: bool = False):
    """K3's row form: (C, n) int32 u32 columns, or with `wide` (C, 2, n)
    Goldilocks limb planes, C = 1..6 -> (n, 8) int32 digests of the rows'
    8C-byte messages, written into `out` when given."""
    if (cols.dim() != 2 + wide or not 1 <= cols.shape[0] <= 6
            or (wide and cols.shape[1] != 2)):
        raise ValueError(f"row leaves take a (C, {'2, ' * wide}n) tensor "
                         f"with C = 1..6, got shape {tuple(cols.shape)}")
    if _build.plain_device(cols):
        res = sha256_row_leaves(cols, wide)
        return res if out is None else out.copy_(res)
    out = _launch_leaves(cols, tuple(cols.shape), out, int(cols.shape[0]),
                         wide, f"K3 sha_row_leaves{' (64-bit)' * wide}")
    _count(sha_row_leaves, wide)
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
        children.data_ptr(), out.data_ptr(), m, 0, 0, 1,
        _build.stream_ptr(children.device)), "K4 sha_nodes")
    sha_nodes.launches += 1
    return out


sha_leaves.launches = sha_leaves.wide_launches = 0
sha_row_leaves.launches = sha_row_leaves.wide_launches = 0
sha_nodes.launches = 0
sha_leaves.plain = sha256_u64_leaves
sha_row_leaves.plain = sha256_row_leaves
sha_nodes.plain = sha256_pairs


# -- the tree batch (stark/batch.py: B proofs' trees in one launch) ---------

def _batch_stride(t, name: str, inner: tuple, align: int) -> int:
    """Check a batch operand: a CUDA int32 tensor of shape (B,) + inner
    whose every tree is one contiguous block (a tree buffer's level is a
    view of (B, rows, 8)), each `align`-byte aligned; returns the stride
    between trees in its inner units (words or digest rows)."""
    _build._require(t, name, tuple(t.shape))
    if tuple(t.shape[1:]) != tuple(inner):
        raise ValueError(f"{name}: expected (B,) + {tuple(inner)}, got "
                         f"{tuple(t.shape)}")
    if not t[0].is_contiguous() or t.data_ptr() % align or (
            t.shape[0] > 1 and (4 * t.stride(0)) % align):
        raise ValueError(f"{name}: each tree must be one contiguous, "
                         f"{align}-byte aligned block")
    return t.stride(0) if t.shape[0] > 1 else 0


def sha_leaves_batch(values: torch.Tensor, out: torch.Tensor, *,
                     rows: bool = False, wide: bool = False):
    """K3 over B trees in one launch (the tree as grid y): values (B, n)
    u32 words, (B, 2, n) Goldilocks limb planes with `wide`, or with
    `rows` the row form's (B, C, n) / (B, C, 2, n) columns -> leaf digests
    into `out`, (B, n, 8) with each tree's rows contiguous (the leaf level
    of a (B, rows, 8) tree buffer).  A CPU tensor runs the plain version
    tree by tree."""
    b, n = int(values.shape[0]), int(values.shape[-1])
    if _build.plain_device(values):
        for k in range(b):
            if rows:
                out[k].copy_(sha256_row_leaves(values[k], wide))
            else:
                out[k].copy_(sha256_u64_leaves(values[k], wide))
        return out
    cols = int(values.shape[1]) if rows else 1
    inner = tuple(values.shape[1:])
    vstride = _batch_stride(values, "values", inner, 4)
    ld = values.stride(-2) if values.dim() > 2 else n
    ostride = _batch_stride(out, "out", (n, 8), 16) // 8
    _build.check(_build.lib("sha256_tree").stark_sha_leaves(
        values.data_ptr(), out.data_ptr(), n, ld, vstride, ostride, cols,
        int(wide), b, _build.stream_ptr(values.device)),
        f"K3 sha_leaves_batch{' (64-bit)' * wide}")
    _count(sha_leaves_batch, wide)
    return out


def sha_nodes_batch(children: torch.Tensor, out: torch.Tensor):
    """K4 over B trees' levels in one launch: children (B, 2m, 8) ->
    parents into `out` (B, m, 8), each tree's rows contiguous (views of a
    (B, rows, 8) tree buffer)."""
    b, m = int(children.shape[0]), int(children.shape[1]) // 2
    if _build.plain_device(children):
        for k in range(b):
            out[k].copy_(sha256_pairs(children[k]))
        return out
    cstride = _batch_stride(children, "children", (2 * m, 8), 16) // 8
    ostride = _batch_stride(out, "out", (m, 8), 16) // 8
    _build.check(_build.lib("sha256_tree").stark_sha_nodes(
        children.data_ptr(), out.data_ptr(), m, cstride, ostride, b,
        _build.stream_ptr(children.device)), "K4 sha_nodes_batch")
    sha_nodes_batch.launches += 1
    return out


sha_leaves_batch.launches = sha_leaves_batch.wide_launches = 0
sha_nodes_batch.launches = 0
