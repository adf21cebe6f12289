"""K3 / K4 wrappers: SHA-256 Merkle leaves and nodes
(``csrc/sha256_tree.cu``; replaces ``stark_tpu/hash/pallas_sha.py``
``_make_leaf_kernel`` in its u32 and its 64-bit ``wide`` mode,
``_make_node_kernel``, and the XLA tail scan of
``stark_tpu/merkle/tree.py`` ``_tail_scan``).

Two kernels.  ``sha_subtree`` hashes a block's span of inputs — leaf
values, or the digest rows of a level — and the node levels above them
in shared memory, writing only the levels a tree stores; ``sha_nodes``
hashes one level of child pairs.  Their wrappers:

* :func:`sha_subtree` (K3 as a tree build launches it): the leaves of a
  tree and its first node levels, 2^span_log leaves a block;
* :func:`sha_tail` (K4's tail): every level of a power-of-two tree of at
  most a block's inputs, from a level of nodes or from the leaves, up to
  the root, in one block;
* :func:`sha_leaves`, :func:`sha_row_leaves` (K3 alone, no node level:
  an odd-size tree's leaves), :func:`sha_nodes` (K4: one level);
* ``_batch`` forms of the first two and of ``sha_nodes`` for
  ``stark/batch.py``'s B proofs (the tree as grid y).

One value a leaf (every FRI tree and a one-column trace) or the rows of a
multi-column trace (``rows``, the row form, C = 1..6; the XLA
``sha256_row_leaves`` of the JAX package).  Every wrapper takes the
field's width explicitly (``wide=True`` for Goldilocks limb planes),
never from the shape: a (2, n) tensor is two u32 columns or one
Goldilocks column.  A CPU tensor runs the plain torch version (the same
levels, hashed level by level with ``hash/sha256.py``'s leaves and pairs
and written to the same rows); a CUDA tensor launches the kernel or
raises.  The values may be a slice along the last axis of a larger
tensor (one chunk of a tree's leaves, ``merkle/tree.py``): the kernel
reads each plane in place, a fixed stride after the one before.  Each
wrapper counts its launches (by form and width where it has several).

Output rows: level l (0: the launch's inputs) of a power-of-two tree of
2^tree_log inputs whose stored levels start at `store_from` lies at row
:func:`level_row` ``(tree_log, store_from, l, 0)`` of the buffer, so a
block's nodes of each level land where the whole tree's would.
"""

from __future__ import annotations

import torch

from stark_tpu_torch import _build
from stark_tpu_torch.hash.sha256 import (sha256_pairs, sha256_row_leaves,
                                         sha256_u64_leaves)

# the leaves-only launch: one leaf a thread, 256 a block
_LEAF_SPAN_LOG = 8


def level_row(tree_log: int, store_from: int, level: int, node: int) -> int:
    """Buffer row of node `node` of level `level` of a power-of-two tree
    of 2^tree_log leaves whose levels from `store_from` up are stored one
    after the other."""
    return 2 * ((1 << (tree_log - store_from))
                - (1 << (tree_log - level))) + node


def _digests(inp, form: str, wide: bool):
    if form == "digests":
        return inp
    if form == "rows":
        return sha256_row_leaves(inp, wide)
    return sha256_u64_leaves(inp, wide)


def _levels_plain(inp, out, form: str, wide: bool, span_log: int,
                  levels: int, store_from: int, tree_log: int, block0: int):
    """The plain version of a ``sha_subtree`` launch: its inputs' digests
    and the `levels` levels above them, level by level over the whole
    launch (a block's pairs never cross its span), each level from
    `store_from` up written to the launch's rows of `out`."""
    level = _digests(inp, form, wide)
    n = int(level.shape[0])
    for lv in range(levels + 1):
        if lv:
            level = sha256_pairs(level)
        if lv >= store_from:
            row = level_row(tree_log, store_from, lv,
                            block0 << (span_log - lv))
            out[row:row + (n >> lv)] = level
    return out


def _launch(inp, out, form: str, wide: bool, span_log: int, levels: int,
            store_from: int, tree_log: int, block0: int, batch: bool,
            what: str) -> None:
    """Check the operands of one ``sha_subtree`` launch (one tree, or with
    `batch` B trees along the leading axis) and launch it."""
    inner = tuple(inp.shape[1:] if batch else inp.shape)
    n = int(inner[0] if form == "digests" else inner[-1])
    cols = 0 if form == "digests" else int(inner[0]) if form == "rows" else 1
    if not (0 <= levels <= span_log <= tree_log
            and 0 <= store_from <= levels):
        raise ValueError(f"{what}: levels {levels}, span 2^{span_log}, tree "
                         f"2^{tree_log}, stored from {store_from}")
    if levels and n % (1 << span_log):
        raise ValueError(f"{what}: {n} inputs are not whole blocks of "
                         f"2^{span_log}")
    rows = int(out.shape[-2])
    need = max(level_row(tree_log, store_from, lv,
                         (block0 << (span_log - lv)) + (n >> lv))
               for lv in range(store_from, levels + 1))
    if need > rows:
        raise ValueError(f"{what}: writes rows up to {need}, out has {rows}")
    b, istride, ostride = 1, 0, 0
    if batch:
        b = int(inp.shape[0])
        istride = _batch_stride(inp, "inputs", inner,
                                16 if form == "digests" else 4)
        ostride = _batch_stride(out, "out", (rows, 8), 16) // 8
        ld = inp.stride(-2) if inp.dim() > 2 else n
    else:
        _build.require(out, "out", (rows, 8), align=16)
        if form == "digests":
            _build.require(inp, "inputs", (n, 8), align=16)
            ld = 0
        else:
            ld = _build.require_planes(inp, "values", inner)
    _build.check(_build.lib("sha256_tree").stark_sha_subtree(
        inp.data_ptr(), out.data_ptr(), n, ld, istride, ostride, cols,
        int(wide), span_log, levels, store_from, tree_log, block0, b,
        _build.stream_ptr(inp.device)), what)


def _width(wide: bool) -> str:
    return " (64-bit)" * wide


# -- K3 alone: leaf digests, no node level ----------------------------------

def _leaves(values, out, form: str, wide: bool, what: str):
    n = int(values.shape[-1])
    if out is None:
        out = torch.empty((n, 8), dtype=torch.int32, device=values.device)
    _launch(values, out, form, wide, _LEAF_SPAN_LOG, 0, 0, _LEAF_SPAN_LOG,
            0, False, f"{what}{_width(wide)}")
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
    if _build.plain_device(values):
        res = sha256_u64_leaves(values, wide)
        return res if out is None else out.copy_(res)
    out = _leaves(values, out, "values", wide, "K3 sha_leaves")
    _count(sha_leaves, wide)
    return out


def _check_rows(cols, wide: bool, what: str) -> None:
    if (cols.dim() != 2 + wide or not 1 <= cols.shape[0] <= 6
            or (wide and cols.shape[1] != 2)):
        raise ValueError(f"{what} take a (C, {'2, ' * wide}n) tensor "
                         f"with C = 1..6, got shape {tuple(cols.shape)}")


def sha_row_leaves(cols: torch.Tensor, out: torch.Tensor | None = None, *,
                   wide: bool = False):
    """K3's row form: (C, n) int32 u32 columns, or with `wide` (C, 2, n)
    Goldilocks limb planes, C = 1..6 -> (n, 8) int32 digests of the rows'
    8C-byte messages, written into `out` when given."""
    _check_rows(cols, wide, "row leaves")
    if _build.plain_device(cols):
        res = sha256_row_leaves(cols, wide)
        return res if out is None else out.copy_(res)
    out = _leaves(cols, out, "rows", wide, "K3 sha_row_leaves")
    _count(sha_row_leaves, wide)
    return out


# -- K3 with the first node levels, and the tail ----------------------------

def sha_subtree_plain(values, out, *, rows: bool = False, wide: bool = False,
                      span_log: int, levels: int, store_from: int = 0,
                      tree_log: int, block0: int = 0):
    """The plain version of :func:`sha_subtree` (any device)."""
    return _levels_plain(values, out, "rows" if rows else "values", wide,
                         span_log, levels, store_from, tree_log, block0)


def sha_subtree(values: torch.Tensor, out: torch.Tensor, *,
                rows: bool = False, wide: bool = False, span_log: int,
                levels: int, store_from: int = 0, tree_log: int,
                block0: int = 0):
    """K3 with the `levels` node levels above the leaves in the same
    launch: the leaves of `values` (as :func:`sha_leaves` takes them, or
    with `rows` as :func:`sha_row_leaves`), 2^span_log a block, their
    count a multiple of that, are leaves block0 << span_log onward of a
    power-of-two tree of 2^tree_log leaves; the levels from `store_from`
    up are written into `out`, a contiguous (rows, 8) buffer holding that
    tree's levels from `store_from` up (:func:`level_row`).  Counted in
    ``launches``, ``wide_launches``, ``row_launches`` and
    ``row_wide_launches`` by form.  Returns `out`."""
    if rows:
        _check_rows(values, wide, "sha_subtree(rows=True)")
    args = (span_log, levels, store_from, tree_log, block0)
    form = "rows" if rows else "values"
    if _build.plain_device(values):
        return _levels_plain(values, out, form, wide, *args)
    _launch(values, out, form, wide, *args, False,
            f"K3 sha_subtree{' rows' * rows}{_width(wide)}")
    name = "row_" * rows + "wide_" * wide + "launches"
    setattr(sha_subtree, name, getattr(sha_subtree, name) + 1)
    return out


def _tail_args(inp, leaves: bool, store_from):
    n = int(inp.shape[-1] if leaves else inp.shape[-2])
    t = n.bit_length() - 1
    if n != 1 << t or (not leaves and n < 2):
        raise ValueError(f"the tail takes a power-of-two count of leaves, "
                         f"or of nodes above one; got {n}")
    sf = (0 if leaves else 1) if store_from is None else store_from
    return t, t, sf, t, 0


def _tail_form(leaves: bool, rows: bool) -> str:
    return ("rows" if rows else "values") if leaves else "digests"


def sha_tail_plain(inp, out, *, leaves: bool = False, rows: bool = False,
                   wide: bool = False, store_from: int | None = None):
    """The plain version of :func:`sha_tail` (any device)."""
    return _levels_plain(inp, out, _tail_form(leaves, rows), wide,
                         *_tail_args(inp, leaves, store_from))


def sha_tail(inp: torch.Tensor, out: torch.Tensor, *, leaves: bool = False,
             rows: bool = False, wide: bool = False,
             store_from: int | None = None):
    """K4's tail: every level of a power-of-two tree up to its root in one
    block.  `inp` is a (2^t, 8) level of digest rows (not written again:
    `out` takes levels 1..t, its 2^t - 1 rows, unless `store_from` says
    otherwise), or with `leaves` the tree's 2^t leaf values as
    :func:`sha_subtree` takes them (`out` the levels from `store_from`,
    default 0, up).  At most 2^12 inputs.  Returns `out`."""
    args = _tail_args(inp, leaves, store_from)
    form = _tail_form(leaves, rows)
    if _build.plain_device(inp):
        return _levels_plain(inp, out, form, wide, *args)
    _launch(inp, out, form, wide, *args, False, f"K4 sha_tail{_width(wide)}")
    sha_tail.launches += 1
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
sha_subtree.launches = sha_subtree.wide_launches = 0
sha_subtree.row_launches = sha_subtree.row_wide_launches = 0
sha_tail.launches = 0
sha_nodes.launches = 0
sha_leaves.plain = sha256_u64_leaves
sha_row_leaves.plain = sha256_row_leaves
sha_subtree.plain = sha_subtree_plain
sha_tail.plain = sha_tail_plain
sha_nodes.plain = sha256_pairs


# -- the tree batch (stark/batch.py: B proofs' trees in one launch) ---------

def _batch_stride(t, name: str, inner: tuple, align: int) -> int:
    """Check a batch operand: a CUDA int32 tensor of shape (B,) + inner
    whose every tree is one contiguous block (a tree buffer's level is a
    view of (B, rows, 8)), each `align`-byte aligned; returns the stride
    between trees in words."""
    _build._require(t, name, tuple(t.shape))
    if tuple(t.shape[1:]) != tuple(inner):
        raise ValueError(f"{name}: expected (B,) + {tuple(inner)}, got "
                         f"{tuple(t.shape)}")
    if not t[0].is_contiguous() or t.data_ptr() % align or (
            t.shape[0] > 1 and (4 * t.stride(0)) % align):
        raise ValueError(f"{name}: each tree must be one contiguous, "
                         f"{align}-byte aligned block")
    return t.stride(0) if t.shape[0] > 1 else 0


def _batch_plain(inp, out, form: str, wide: bool, *args):
    for k in range(int(inp.shape[0])):
        _levels_plain(inp[k], out[k], form, wide, *args)
    return out


def sha_subtree_batch(values: torch.Tensor, out: torch.Tensor, *,
                      rows: bool = False, wide: bool = False, span_log: int,
                      levels: int, store_from: int = 0, tree_log: int,
                      block0: int = 0):
    """:func:`sha_subtree` over B trees in one launch (the tree as grid
    y): values (B, n) u32 words, (B, 2, n) Goldilocks limb planes with
    `wide`, or with `rows` the row form's (B, C, n) / (B, C, 2, n)
    columns; `out` (B, rows, 8) with each tree's rows contiguous (the
    views of a (B, rows, 8) tree buffer).  A CPU tensor runs the plain
    version tree by tree.  Counted in ``launches`` / ``wide_launches``."""
    args = (span_log, levels, store_from, tree_log, block0)
    form = "rows" if rows else "values"
    if _build.plain_device(values):
        return _batch_plain(values, out, form, wide, *args)
    _launch(values, out, form, wide, *args, True,
            f"K3 sha_subtree_batch{_width(wide)}")
    _count(sha_subtree_batch, wide)
    return out


def sha_tail_batch(inp: torch.Tensor, out: torch.Tensor, *,
                   leaves: bool = False, rows: bool = False,
                   wide: bool = False, store_from: int | None = None):
    """:func:`sha_tail` over B trees in one launch: `inp` (B, 2^t, 8)
    digest rows, or with `leaves` (B, ...) leaf values as
    :func:`sha_subtree_batch` takes them; `out` (B, rows, 8)."""
    args = _tail_args(inp, leaves, store_from)
    form = _tail_form(leaves, rows)
    if _build.plain_device(inp):
        return _batch_plain(inp, out, form, wide, *args)
    _launch(inp, out, form, wide, *args, True,
            f"K4 sha_tail_batch{_width(wide)}")
    sha_tail_batch.launches += 1
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


sha_subtree_batch.launches = sha_subtree_batch.wide_launches = 0
sha_tail_batch.launches = 0
sha_nodes_batch.launches = 0
