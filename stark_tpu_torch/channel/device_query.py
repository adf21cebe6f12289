"""Device-resident query phase (counterpart of
``stark_tpu/channel/device_query.py``; a u32 or the Goldilocks field,
1..6 trace columns or none (the standalone FRI query phase), power-of-two
trees, pruned or not).

For each query, on the device and without a host sync:

    idx   <- int(state_hex, 16) mod range              [receive_random_int]
    state <- sha256(utf8(state_hex))
    gather the trace and FRI openings at idx (values and auth paths)
    absorb each opened message into the Fiat-Shamir chain

Every ``Channel.send`` hashes utf8(state_hex ++ msg_hex): a first block
that is exactly the 64-char state hex, then the message's hex chars and
static SHA padding.  So a query is one flagged block stream (see
``hash/cuda_chain.py``); queries chain through the state.  A trace
opening of a C-column AIR is one row message of C values (8 big-endian
bytes each, the leaf preimage of ``MerkleTree.from_columns``), 4C hex
words that spill into a full block for C >= 4; FRI openings stay single
values.  The stream's constant words and flags are built once per plan
and packed, with one gather slot per opened word and digest, into
:class:`QueryTables`; a slot names the stream word its hex starts at.  A
u32 value is one slot (its 8 hex chars after 8 hex zeros of the
template); a Goldilocks value (``elem_width`` 2) is two, its hi word
from the hi plane and its lo word from the lo plane, so the kernel is the
same for both widths.  On
a CUDA device the whole phase is ONE launch of K5's query form
(``csrc/sha_chain.cu`` ``stark_query_chain``): per query the kernel
draws idx, gathers through the slot table, writes the hex rows into its
shared-memory copy of the template and runs the chain, as the JAX
package's ``lax.scan`` over queries does.  :func:`query_chain_plain`
runs the same tables as a per-query loop.

On a mesh (``DeviceQueryPlan(..., shards=S)``, ``stark_tpu_torch/dist/``)
the same launch reads sharded sources: each of the four sources is a
list of entries (a sharded array one a block, a sharded tree one a
subtree plus one for its top levels, the FRI tail one a layer), and a
slot names its first entry and the log2 of the lanes an entry holds, so
a position resolves to (entry, element) in the kernel.  A digest slot
carries its level's block size, so no slot searches for its level.
Unsharded, each source is one entry and every slot's lane lies in it,
today's launch bit for bit.

A pruned tree (``merkle/tree.py``) does not store its first ``prune``
levels.  Their siblings are recomputed per query from the leaf values:
one recompute task per pruned authentication path (a trace opening at
one offset, an FRI opening) hashes the aligned 2^prune-leaf block at
``(j >> prune) << prune`` of its leaf j and reduces it level by level,
and the path's slots for those levels read the task's nodes.  Since
query q + 1's index depends on the digests query q absorbed, this runs
inside the one launch, after each draw (where the JAX package's scan
calls ``_subtree_sibs``).

The host then replays the canonical transcript from the one fetch and
checks that the device-derived chain equals the host derivation.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from stark_tpu_torch import _build
from stark_tpu_torch.channel.channel import ChannelError
from stark_tpu_torch.channel.device_channel import (ascii_hex_words,
                                                    mod_state, pad_row,
                                                    state_words)
from stark_tpu_torch.dist.comm import sharded_layers
from stark_tpu_torch.dist.merkle import shards_tree
from stark_tpu_torch.fields.fp import store
from stark_tpu_torch.fri.commit import layer_layout
from stark_tpu_torch.hash.cuda_chain import FIRST_HEX, sha_chain_plain
from stark_tpu_torch.hash.sha256 import sha256_pairs, sha256_row_leaves
from stark_tpu_torch.merkle.tree import level_offsets
from stark_tpu_torch.utils.gather import fetch_packed

# the slot table's columns; a slot reads element
# base + (lane & (2^shard - 1)) of source entry ptab + (lane >> shard),
# lane = ((((idx + add) & mask) ^ xr) >> shift) ^ flip, and writes its hex
# from word `word` of the query's stream (row-major (R, 16) words): a
# value's 2 hex words, a digest's 16.  A recomputed sibling reads node
# base + lane of the query's recompute buffer
SLOT_COLUMNS = ("source", "ptab", "base", "add", "mask", "xr", "shift",
                "flip", "word", "shard")
NO_SHARD = 62  # the shard field of a slot whose entry holds every lane
# sources (the kernel's enum): trace values, FRI values, stored trace and
# FRI digests, and the recomputed siblings of a pruned trace or FRI tree
# (position = a node of the query's recompute tasks)
(TRACE_VALUE, FRI_VALUE, TRACE_DIGEST, FRI_DIGEST, TRACE_SUBTREE,
 FRI_SUBTREE) = range(6)
# the recompute tasks' columns: the leaf j = ((idx + add) & mask) ^ xr of
# the tree over the values of source entry `ptab` (the trace LDE or the
# FRI values, unsharded); the task hashes leaves (j >> prune) << prune + i,
# i < 2^prune, each the row message of `cols` values whose word planes lie
# at base + plane * stride of that buffer, and keeps levels 0 .. prune - 1
# of that block from node row `node` of the query's recompute buffer on,
# level l at node + 2^(prune + 1) - 2^(prune - l + 1)
TASK_COLUMNS = ("ptab", "add", "mask", "xr", "prune", "base", "stride",
                "cols", "node")
HEX_ZEROS = 0x30303030  # "0000"
MAX_COLUMNS = 6  # a row leaf's message is one SHA block (sha256_row_leaves)


def value_rows(ncols: int, elem_width: int = 1) -> np.ndarray:
    """The constant words of a value message's payload rows (the JAX
    package's ``_value_rows``): `ncols` 8-byte BE values are 16 hex chars
    each, written per query: a u32 value's 8 after 8 zeros (its high word
    0), a Goldilocks value's 16 (both words); then SHA padding.  4 * ncols
    hex words fill full blocks first, and the 0, 4, 8 or 12 words left
    share the padded tail block.  (rows, 16) int64."""
    zeros = HEX_ZEROS if elem_width == 1 else 0
    words = np.tile(np.array([zeros, zeros, 0, 0], np.int64), ncols)
    tail = np.zeros(16 - len(words) % 16, np.int64)
    tail[0] = 0x80000000
    tail[-1] = (64 + 16 * ncols) * 8
    return np.concatenate([words, tail]).reshape(-1, 16)


@dataclasses.dataclass(frozen=True)
class QueryTables:
    """One plan's packed tables, on one device, as K5's query form reads
    them."""

    template: torch.Tensor  # (R, 16) int32 stream rows, constants in place
    flags: torch.Tensor  # (R, 2) int32 (first, last)
    slots: torch.Tensor  # (S, 10) int64 rows of SLOT_COLUMNS, values first
    num_values: int  # value slots (words): 2 a Goldilocks value
    rng: int
    num_queries: int
    # f_evals words (C x width x trace length), stored trace tree rows,
    # FRI values words, stored FRI digest rows
    sizes: tuple
    # per source (f_evals, trace digests, FRI values, FRI digests) the
    # sizes of its entries, in the order their tensors are passed (value
    # words, digest rows); one entry each when unsharded
    entries: tuple
    shards: int  # the mesh's shard count (1: unsharded sources)
    # per entry (in entry order): whether every process of a process mesh
    # holds it (a tree's top levels, an unsharded FRI layer and its tree)
    # or only its block's owner (a block, a subtree)
    replicated: tuple
    tasks: torch.Tensor  # (T, 9) int64 rows of TASK_COLUMNS
    max_prune: int  # the deepest task's prune (0: no task)
    subtree_rows: int  # digest rows of a query's recomputed nodes
    elem_width: int  # u32 words a value (a task's leaf message)


def _assemble(tb: QueryTables, v: torch.Tensor, d: torch.Tensor):
    """One query's stream: the template with the hex of the opened values
    (Nv,) and digests (Nd, 8) written at their slots' words."""
    nv = tb.num_values
    word = tb.slots[:, SLOT_COLUMNS.index("word")]
    stream = tb.template.clone()
    flat = stream.view(-1)
    span = torch.arange(16, device=word.device)
    flat[word[:nv, None] + span[:2]] = store(ascii_hex_words(v[:, None]))
    flat[word[nv:, None] + span] = store(ascii_hex_words(d))
    return stream


def _subtrees_plain(tb: QueryTables, idx, ents):
    """One query's recomputed nodes, (subtree_rows, 8), level by level
    for all tasks together as the kernel computes them: every task's
    block of leaves hashed with the plain K3 (its row form, one call a
    column count), then each level's pairs of all the tasks that keep the
    level above with one plain K4 call.  `ents`: the source entries."""
    dev = idx.device
    sub = torch.empty((tb.subtree_rows, 8), dtype=torch.int32, device=dev)
    tasks = tb.tasks.cpu().tolist()
    blocks = []
    for ptab, add, mask, xr, prune, base, stride, cols, _ in tasks:
        values = ents[ptab]
        j = ((idx + add) & mask) ^ xr
        lanes = (j >> prune << prune) + torch.arange(1 << prune, device=dev)
        planes = torch.arange(cols * tb.elem_width, device=dev)
        blocks.append(values[base + planes[:, None] * stride + lanes[None]])
    levels = [None] * len(tasks)
    for cols in {t[7] for t in tasks}:
        mine = [k for k, t in enumerate(tasks) if t[7] == cols]
        words = torch.cat([blocks[k] for k in mine], dim=1)
        if tb.elem_width == 2:
            words = words.view(cols, 2, -1)
        digests = sha256_row_leaves(words, tb.elem_width == 2)
        for k, d in zip(mine, digests.split(
                [blocks[k].shape[1] for k in mine])):
            levels[k] = d
    for lv in range(tb.max_prune):
        live = [k for k, t in enumerate(tasks) if t[4] > lv]
        for k in live:
            prune, node = tasks[k][4], tasks[k][8]
            off = node + (2 << prune) - (2 << (prune - lv))
            sub[off:off + levels[k].shape[0]] = levels[k]
        above = [k for k in live if tasks[k][4] > lv + 1]
        if above:
            parents = sha256_pairs(torch.cat([levels[k] for k in above]))
            for k, d in zip(above, parents.split(
                    [levels[k].shape[0] // 2 for k in above])):
                levels[k] = d
    return sub


def source_entries(tb: QueryTables, sources) -> list:
    """The flat entry list of the four sources (f_evals, trace digests,
    FRI values, FRI digests), each a tensor (one entry) or a sequence of
    tensors (its entries, in the plan's order), checked against the
    plan's entry counts."""
    ents = []
    for name, src, sizes in zip(_SOURCE_NAMES, sources, tb.entries):
        got = list(src) if isinstance(src, (list, tuple)) else [src]
        if len(got) != len(sizes):
            raise ValueError(f"{name}: the plan reads {len(sizes)} entries, "
                             f"got {len(got)}")
        ents += got
    return ents


_SOURCE_NAMES = ("f_evals", "trace_digests", "fri_values", "fri_digests")


def _slot_columns(tb: QueryTables, dev):
    """The slot table's columns on `dev`, and each source kind's slots."""
    cols = dict(zip(SLOT_COLUMNS, tb.slots.to(dev).unbind(1)))
    src = tb.slots[:, 0].cpu()
    sel = [torch.nonzero(src == k).flatten().to(dev) for k in range(6)]
    return cols, sel


def _gather_plain(tb: QueryTables, cols, sel, idx, ents, v, d) -> None:
    """One query's opened values into `v` (Nv,) and digests into `d`
    (Nd, 8) at idx, through the slot table: each slot from its entry (a
    None entry left as it is: zero in the cut form), a pruned path's
    siblings from the recompute."""
    nv = tb.num_values
    pos, ent = _positions(cols, idx), _entries(cols, idx)
    for k in (TRACE_VALUE, FRI_VALUE, TRACE_DIGEST, FRI_DIGEST):
        out, first = (v, 0) if k in (TRACE_VALUE, FRI_VALUE) else (d, nv)
        for e in torch.unique(ent[sel[k]]).tolist():
            buf = ents[e]
            if buf is None:
                continue
            m = sel[k][ent[sel[k]] == e]
            out[m - first] = buf[pos[m].to(buf.device)].to(v.device)
    if tb.max_prune:
        sub = _subtrees_plain(tb, idx, ents)
        for k in (TRACE_SUBTREE, FRI_SUBTREE):
            d[sel[k] - nv] = sub[pos[sel[k]]]


def query_chain_plain(chain, f_evals, trace_digests, fri_values,
                      fri_digests, tb: QueryTables):
    """Plain version of K5's query form, with the kernel's inputs: the
    per-query loop over the packed tables, gathers through the source
    entries (each source a tensor, or on a mesh the list of its entries,
    on any device) and the pruned trees' recompute (plain K3 / K4), each
    query's chain through :func:`sha_chain_plain` (on the host).  Returns
    (final chain (8,), idxs (Q,) int64, vals (Q, Nv), digs (Q, Nd, 8)) on
    the chain's device."""
    dev = chain.device
    ents = source_entries(tb, (f_evals, trace_digests, fri_values,
                               fri_digests))
    nv = tb.num_values
    nd = int(tb.slots.shape[0]) - nv
    cols, sel = _slot_columns(tb, dev)
    idxs = torch.empty(tb.num_queries, dtype=torch.int64, device=dev)
    vals = torch.empty((tb.num_queries, nv), dtype=torch.int32, device=dev)
    digs = torch.empty((tb.num_queries, nd, 8), dtype=torch.int32,
                       device=dev)
    for q in range(tb.num_queries):
        idx = mod_state(chain, tb.rng)
        _gather_plain(tb, cols, sel, idx, ents, vals[q], digs[q])
        chain = sha_chain_plain(_assemble(tb, vals[q], digs[q]), tb.flags,
                                chain)
        idxs[q] = idx
    return chain, idxs, vals, digs


def _query_ptrs(tb: QueryTables, b: int, dev, ents) -> torch.Tensor:
    """The source table of K5's query form on `dev`: each entry's address
    and per-proof stride (b proofs; 0: one, no batch axis), after
    checking it; a None entry (another process's) is address 0, which the
    kernel reads as zeros.  Entries on another card than `dev` are read
    through peer access, enabled here; a pair without it raises."""
    lib = _build.lib("sha_chain")
    lead = (b,) if b else ()
    sizes = [(name, k, size) for name, sz in zip(_SOURCE_NAMES, tb.entries)
             for k, size in enumerate(sz)]
    rows = []
    for t, (name, k, size) in zip(ents, sizes):
        if t is None:
            rows.append([0, 0])
            continue
        if name.endswith("digests"):
            _build.require(t, f"{name}[{k}]", lead + (size, 8), align=16)
        else:
            _build.require(t, f"{name}[{k}]", lead + (size,))
        if t.device != dev:
            if not torch.cuda.can_device_access_peer(dev, t.device):
                raise ValueError(f"{name}[{k}] lies on {t.device}, which "
                                 f"{dev} cannot access")
            with torch.cuda.device(dev):
                _build.check(lib.stark_enable_peer(t.device.index),
                             f"peer access {dev} -> {t.device}")
        rows.append([t.data_ptr(), t[0].numel() * 4 if b else 0])
    return torch.tensor(rows, dtype=torch.int64).to(dev)


def _launch_query(tb: QueryTables, b: int, chain, ptrs, idxs, vals, digs,
                  vstride: int, dstride: int, absorb: int = -1,
                  queries: tuple | None = None, chain_drawn: bool = True):
    """One launch of K5's query form: one proof (b = 0, no batch axis) or
    b proofs of the plan, one block each, every operand with a leading
    proof axis; `ptrs` from :func:`_query_ptrs`.  Runs `queries` (lo, hi;
    default all), chained when `chain_drawn`, after chaining query
    `absorb` (>= 0) from `vals` / `digs` (the cut form).  Returns the
    chain state after it."""
    lib = _build.lib("sha_chain")
    nrows, nslots = int(tb.template.shape[0]), int(tb.slots.shape[0])
    ntasks = int(tb.tasks.shape[0])
    max_rows = lib.stark_query_chain_max_rows(tb.subtree_rows)
    if nrows > max_rows:
        raise ValueError(
            f"query stream of {nrows} rows and {tb.subtree_rows} recomputed "
            f"nodes exceeds the shared memory of K5's query form "
            f"({max_rows} rows with those nodes)")
    lead = (b,) if b else ()
    dev = chain.device
    _build.require(chain, "chain", lead + (8,))
    _build.require(tb.template, "template", (nrows, 16), align=16)
    _build.require(tb.flags, "flags", (nrows, 2), align=8)
    _build.require(tb.slots, "slots", (nslots, len(SLOT_COLUMNS)),
                   dtype=torch.int64, align=8)
    _build.require(tb.tasks, "tasks", (ntasks, len(TASK_COLUMNS)),
                   dtype=torch.int64, align=8)
    q_n = tb.num_queries
    lo, hi = queries or (0, q_n)
    out = torch.empty(lead + (8,), dtype=torch.int32, device=dev)
    _build.check(lib.stark_query_chain(
        chain.data_ptr(), ptrs.data_ptr(), tb.template.data_ptr(),
        tb.flags.data_ptr(), tb.slots.data_ptr(), tb.tasks.data_ptr(), nrows,
        nslots, tb.num_values, ntasks, tb.max_prune, tb.subtree_rows,
        int(tb.elem_width == 2), tb.rng, q_n, out.data_ptr(),
        idxs.data_ptr(), vals.data_ptr(), digs.data_ptr(), absorb, lo, hi,
        int(chain_drawn), vstride, dstride, max(b, 1),
        _build.stream_ptr(dev)), "K5 query_chain" + "_batch" * bool(b))
    return out


def _query_outputs(tb: QueryTables, b: int, dev):
    """(idxs, vals, digs) of the one-launch form, (b,) leading."""
    lead = (b,) if b else ()
    q_n, nv = tb.num_queries, tb.num_values
    return (torch.empty(lead + (q_n,), dtype=torch.int64, device=dev),
            torch.empty(lead + (q_n, nv), dtype=torch.int32, device=dev),
            torch.empty(lead + (q_n, int(tb.slots.shape[0]) - nv, 8),
                        dtype=torch.int32, device=dev))


def _one_launch(tb: QueryTables, b: int, chain, sources, ptrs=None):
    if ptrs is None:
        ptrs = _query_ptrs(tb, b, chain.device, source_entries(tb, sources))
    idxs, vals, digs = _query_outputs(tb, b, chain.device)
    nv = tb.num_values
    out = _launch_query(tb, b, chain, ptrs, idxs, vals, digs, nv,
                        8 * (int(tb.slots.shape[0]) - nv))
    return out, idxs, vals, digs


def query_chain(chain, f_evals, trace_digests, fri_values, fri_digests,
                tb: QueryTables, ptrs: torch.Tensor | None = None):
    """K5's query form: every query of the phase in one launch, the
    pruned trees' siblings recomputed in it.  Each source is a tensor or,
    for a plan over a mesh, the list of its entries.  `ptrs`: the
    sources' table (:meth:`DeviceQueryPlan.source_table`), built here
    when None (an upload, which a CUDA graph capture refuses).  A CPU
    tensor runs :func:`query_chain_plain`; a CUDA tensor launches the
    kernel or raises."""
    if _build.plain_device(chain):
        return query_chain_plain(chain, f_evals, trace_digests, fri_values,
                                 fri_digests, tb)
    res = _one_launch(tb, 0, chain, (f_evals, trace_digests, fri_values,
                                     fri_digests), ptrs)
    query_chain.launches += 1
    query_chain.sharded_launches += tb.shards > 1
    return res


# launches: every launch; sharded_launches: those over a mesh's sources
query_chain.launches = 0
query_chain.sharded_launches = 0
query_chain.plain = query_chain_plain


def query_chain_batch(chain, f_evals, trace_digests, fri_values,
                      fri_digests, tb: QueryTables):
    """K5's query form for B proofs of one plan in one launch, one block
    a proof (stark/batch.py): each input with a leading proof axis
    ((B, 8) chains, (B, n) value words, (B, rows, 8) digests, contiguous)
    -> (final chains (B, 8), idxs (B, Q), vals (B, Q, Nv), digs (B, Q,
    Nd, 8)).  A CPU tensor runs :func:`query_chain_plain` proof by
    proof."""
    b = int(chain.shape[0])
    if _build.plain_device(chain):
        outs = [query_chain_plain(chain[k], f_evals[k], trace_digests[k],
                                  fri_values[k], fri_digests[k], tb)
                for k in range(b)]
        return tuple(torch.stack(x) for x in zip(*outs))
    res = _one_launch(tb, b, chain, (f_evals, trace_digests, fri_values,
                                     fri_digests))
    query_chain_batch.launches += 1
    return res


query_chain_batch.launches = 0
query_chain_batch.plain = query_chain_plain


def _cut_step_plain(tb: QueryTables, cols, sel, ents, chain, words, idxs,
                    k: int):
    """Step k of the cut form, plain: chain query k - 1 from row k - 1 of
    `words`, then draw query k and gather its slots into row k."""
    nv = tb.num_values
    if k > 0:
        row = words[k - 1]
        chain = sha_chain_plain(_assemble(tb, row[:nv], row[nv:].view(-1, 8)),
                                tb.flags, chain)
    if k < tb.num_queries:
        idx = mod_state(chain, tb.rng)
        idxs[k] = idx
        row = words[k]
        _gather_plain(tb, cols, sel, idx, ents, row[:nv],
                      row[nv:].view(-1, 8))
    return chain


def _cut(chain, sources, tb: QueryTables, mesh, plain: bool) -> tuple:
    """The query phase cut at the query boundary: step k (k = 0 .. Q)
    chains query k - 1 from its summed slot words and draws and gathers
    query k into row k of one (Q, Nv + 8 Nd) word buffer, which the
    process group then sums (`mesh` a process mesh; else nothing to
    sum).  On a process mesh a process reads only the entries it holds,
    and the replicated ones on rank 0 alone, so each word is summed
    once.  Each step is one launch of K5's query form, or with `plain`
    its plain version."""
    if tb.max_prune:
        raise ValueError("the cut query form reads unpruned trees (a mesh "
                         "plan)")
    process = mesh is not None and mesh.process
    ents = [None if t is None or (process and rep and mesh.rank != 0)
            else t for t, rep in zip(source_entries(tb, sources),
                                     tb.replicated)]
    q_n, nv = tb.num_queries, tb.num_values
    stride = nv + 8 * (int(tb.slots.shape[0]) - nv)
    dev = chain.device
    words = torch.zeros((q_n, stride), dtype=torch.int32, device=dev)
    idxs = torch.empty(q_n, dtype=torch.int64, device=dev)
    if plain:
        cols, sel = _slot_columns(tb, dev)
    else:
        ptrs = _query_ptrs(tb, 0, dev, ents)
    for k in range(q_n + 1):
        if plain:
            chain = _cut_step_plain(tb, cols, sel, ents, chain, words, idxs,
                                    k)
        else:
            chain = _launch_query(
                tb, 0, chain, ptrs, idxs, words, words[:, nv:], stride,
                stride, absorb=k - 1, queries=(k, min(k + 1, q_n)),
                chain_drawn=False)
            query_chain_cut.launches += 1
        if k < q_n and process:
            mesh.all_reduce_(words[k], "query")
    return chain, idxs, words[:, :nv], words[:, nv:].reshape(q_n, -1, 8)


def query_chain_cut_plain(chain, f_evals, trace_digests, fri_values,
                          fri_digests, tb: QueryTables, mesh=None):
    """Plain version of K5's cut query form (:func:`query_chain_cut`), on
    any device: each step through the plain gather and
    :func:`sha_chain_plain`."""
    return _cut(chain, (f_evals, trace_digests, fri_values, fri_digests),
                tb, mesh, plain=True)


def query_chain_cut(chain, f_evals, trace_digests, fri_values, fri_digests,
                    tb: QueryTables, mesh=None):
    """K5's query form cut at the query boundary, for a process mesh
    (`mesh`; None: one process, nothing summed): Q + 1 launches, launch k
    chaining query k - 1 from the slot words the processes summed and
    drawing and gathering query k, this process's entries only (another
    process's blocks are None), with one all-reduce of the query's words
    between launches.  Every process runs the same chain and gets the
    same (final chain (8,), idxs (Q,), vals (Q, Nv), digs (Q, Nd, 8)) as
    the one-launch form over the whole sources.  A CPU tensor runs
    :func:`query_chain_cut_plain`; a CUDA tensor launches the kernel or
    raises."""
    return _cut(chain, (f_evals, trace_digests, fri_values, fri_digests),
                tb, mesh, plain=_build.plain_device(chain))


# one a launch: Q + 1 a query phase
query_chain_cut.launches = 0
query_chain_cut.plain = query_chain_cut_plain


def build_script(num_offsets: int, fri_lengths: tuple) -> list:
    """The per-query message sequence, shared by the device assembly and
    the host replay (trace openings, then FRI openings per layer)."""
    script: list = [("draw",)]
    for t in range(num_offsets):
        script.append(("value", ("trace_v", t)))
        script.append(("path", ("trace_p", t)))
    for l, ln in enumerate(fri_lengths):
        if ln == 1:
            # quirk reproduced: a length-1 layer sends its value once more
            # before the value/sibling pair (fri_commit.rs:146-148)
            script.append(("value", ("fri_q", l)))
        for which in (0, 1):
            script.append(("value", ("fri_v", l, which)))
            script.append(("path", ("fri_p", l, which)))
    return script


def _log2(n: int) -> int:
    return n.bit_length() - 1


class _Slots:
    """Gather slots: slot s reads element
    base[s] + (lane & (2^shard[s] - 1)) of source entry
    ptab[s] + (lane >> shard[s]), lane =
    ((((idx + add[s]) & mask[s]) ^ xr[s]) >> shift[s]) ^ flip[s], and
    writes its hex from stream word word[s]."""

    def __init__(self):
        self.cols = {k: [] for k in SLOT_COLUMNS}

    def add(self, source, word, base, add, mask, xr, shift=0, flip=0,
            ptab=0, shard=NO_SHARD):
        for k, v in zip(SLOT_COLUMNS, (source, ptab, base, add, mask, xr,
                                       shift, flip, word, shard)):
            self.cols[k].append(v)


def _lanes(t: dict, idx: torch.Tensor) -> torch.Tensor:
    j = ((idx + t["add"]) & t["mask"]) ^ t["xr"]
    return (j >> t["shift"]) ^ t["flip"]


def _positions(t: dict, idx: torch.Tensor) -> torch.Tensor:
    """Each slot's element within its entry (for an unsharded plan, its
    position in its source's one buffer)."""
    return t["base"] + (_lanes(t, idx) & ((1 << t["shard"]) - 1))


def _entries(t: dict, idx: torch.Tensor) -> torch.Tensor:
    """Each slot's source entry."""
    return t["ptab"] + (_lanes(t, idx) >> t["shard"])


def _value_layout(n: int, planes: int, shards: int, sharded: bool):
    """(entry sizes in words, block lanes or None) of `planes` planes of n
    values: one entry a block on a mesh, else one entry."""
    if sharded:
        return [planes * (n // shards)] * shards, n // shards
    return [planes * n], None


def _tree_layout(n: int, prune: int, shards: int, sharded: bool):
    """(entry sizes in digest rows, subtree leaves or None) of a tree of n
    leaves: one entry a subtree plus the top levels' when it shards
    (``dist/merkle.py``), else its stored levels as one entry."""
    if sharded and shards_tree(n, shards):
        k = n // shards
        return [2 * k - 1] * shards + [2 * shards - 1], k
    return [2 * (n >> prune) - 1], None


def _tree_replicated(sizes, sharded: bool) -> list:
    """Per entry of a tree's layout: its subtrees (sharded) are their
    owners', the top levels, or a whole tree, every process's."""
    return [False] * (len(sizes) - 1) + [True] if sharded else \
        [True] * len(sizes)


class DeviceQueryPlan:
    """The whole query phase for one static configuration: draw range,
    query count, trace offsets, trace length (of each column; None, with
    no offsets, for the standalone FRI query phase, which opens no
    trace), the FRI length ladder (all powers of two), the trace's column
    count, the field's width in u32 words (1, or 2 for Goldilocks), the
    prune depths of the trace tree and of each FRI layer's tree (default:
    none pruned), and the shard count of a mesh prove's sources (trees
    not pruned there): the trace LDE and tree sharded as ``dist/`` builds
    them, the FRI layers and trees as ``dist.comm.sharded_layers`` says,
    the rest one entry a layer."""

    def __init__(self, rng: int, num_queries: int, offsets: tuple,
                 trace_len: int | None, fri_lengths: tuple,
                 num_columns: int = 1, elem_width: int = 1,
                 trace_prune: int = 0, fri_prune: tuple = (),
                 shards: int = 1):
        if rng <= 0 or rng >= 1 << 32:
            raise ValueError(f"draw range {rng} not in [1, 2^32)")
        if elem_width not in (1, 2):
            raise ValueError(f"elem_width must be 1 or 2, got {elem_width}")
        if not 1 <= num_columns <= MAX_COLUMNS:
            raise ValueError(
                f"the device query phase takes 1..{MAX_COLUMNS} trace "
                f"columns (a row leaf's one-block message), got "
                f"{num_columns}")
        if trace_len is None and (offsets or trace_prune):
            raise ValueError("trace offsets and a trace prune need a trace "
                             "length")
        trace = (trace_len,) if trace_len is not None else ()
        for ln in tuple(fri_lengths) + trace:
            if ln < 1 or ln & (ln - 1):
                raise ValueError("device query phase needs power-of-two sizes")
        fri_prune = tuple(int(x) for x in fri_prune) or (0,) * len(
            fri_lengths)
        if (len(fri_prune) != len(fri_lengths)
                or not _prunes_fit(trace + tuple(fri_lengths),
                                   (trace_prune,) * len(trace) + fri_prune)):
            raise ValueError(f"prune depths {trace_prune}, {fri_prune} do "
                             f"not fit trees of {trace_len}, {fri_lengths} "
                             "leaves")
        if shards < 1 or shards & (shards - 1) or (shards > 1 and (
                trace_prune or any(fri_prune))):
            raise ValueError(f"a plan over {shards} shards needs a "
                             "power-of-two shard count and unpruned trees")
        self.shards = int(shards)
        self.rng = rng
        self.num_queries = num_queries
        self.offsets = tuple(int(o) for o in offsets)
        self.trace_len = None if trace_len is None else int(trace_len)
        self.num_columns = int(num_columns)
        self.elem_width = int(elem_width)
        self.fri_lengths = tuple(int(x) for x in fri_lengths)
        self.trace_prune = int(trace_prune)
        self.fri_prune = fri_prune
        self.script = build_script(len(self.offsets), self.fri_lengths)
        self.fri_layout = layer_layout(self.fri_lengths, elem_width,
                                       fri_prune)[0]

        # static stream template (constant words in place), flags, the
        # gather slots in script order (trace ops come first in the
        # script, so trace slots then FRI slots is script order; a path's
        # slots name its recomputed siblings, then its stored ones) and
        # the recompute tasks of the pruned paths
        rows, first, last = [], [], []
        val_rows, dig_rows = [], []
        tv, fv, td, fd = _Slots(), _Slots(), _Slots(), _Slots()
        tasks, nodes = [], 0
        val_src, tree_src = self._source_layout()

        def message(payload: np.ndarray, tail=None) -> int:
            """Append a message (state-hex row, payload rows, tail row);
            returns the stream row of its first payload row."""
            rows.append(np.zeros(16, np.int64))  # replaced by the state hex
            first.append(FIRST_HEX)
            last.append(0)
            start = len(rows)
            body = list(payload) + ([] if tail is None else [tail])
            rows.extend(body)
            first.extend([0] * len(body))
            last.extend([0] * len(body))
            last[-1] = 1
            return start

        for op in self.script:
            if op[0] == "draw":
                message(np.zeros((0, 16), np.int64), pad_row(64))
                continue
            src = op[1]
            if src[0] in ("trace_v", "trace_p"):
                ln, add, xr = self.trace_len, self.offsets[src[1]], 0
            else:
                ln, add = self.fri_lengths[src[1]], 0
                xr = ln // 2 if src[0] != "fri_q" and src[2] else 0
            mask = 0 if src[0] == "fri_q" else ln - 1
            if op[0] == "value":
                # a trace opening: one row message of every column's value
                # (plane k of column c at (c * width + k) * lanes of the
                # (C, M) or (C, 2, M) LDE or of its block); an FRI opening:
                # one value (plane k at its layer's offset + k * lanes).  A
                # u32 value's hex starts after the 8 hex zeros of its
                # message words; a Goldilocks value's hi word at 4c, lo at
                # 4c + 2
                trace_v = src[0] == "trace_v"
                ncols = self.num_columns if trace_v else 1
                row = message(value_rows(ncols, self.elem_width))
                val_rows.append(row)
                wd = self.elem_width
                ptab, base, block = val_src[-1 if trace_v else src[1]]
                shard = _log2(block) if block else NO_SHARD
                sl, kind = (tv, TRACE_VALUE) if trace_v else (fv, FRI_VALUE)
                for c in range(ncols):
                    for k in range(wd):
                        word = 16 * row + 4 * c + 2 * (k + 2 - wd)
                        sl.add(kind, word, base + (c * wd + k) * (block or ln),
                               add, mask, xr, ptab=ptab, shard=shard)
                continue
            h = _log2(ln)
            row = message(np.zeros((h, 16), np.int64), pad_row(64 + 64 * h))
            dig_rows.extend(range(row, row + h))
            k = -1 if src[0] == "trace_p" else src[1]
            (vptab, vbase, _), (ptab, doff, block) = val_src[k], tree_src[k]
            if src[0] == "trace_p":
                sl, prune = td, self.trace_prune
                stored_src, recomputed_src = TRACE_DIGEST, TRACE_SUBTREE
                cols = self.num_columns
            else:
                sl, prune = fd, self.fri_prune[src[1]]
                stored_src, recomputed_src = FRI_DIGEST, FRI_SUBTREE
                cols = 1
            if prune:
                # levels 0 .. prune - 1: the in-block siblings among the
                # task's nodes, at j's low `prune` bits
                tasks.append((vptab, add, mask, xr, prune, vbase, ln, cols,
                              nodes))
                low = (1 << prune) - 1
                for l in range(prune):
                    sl.add(recomputed_src, 16 * (row + l),
                           nodes + (2 << prune) - (2 << (prune - l)), add,
                           low, xr & low, l, 1)
                nodes += (2 << prune) - 2
            # a stored level's node (j >> l) ^ 1: in the one buffer, or on
            # a mesh in the subtree of block node >> (log2 block - l) below
            # the top levels and in the top buffer above them
            stored = level_offsets(ln >> prune)
            lb = _log2(block) if block else h
            for l in range(prune, h):
                if l < lb and block:
                    at = (ptab, level_offsets(block)[l][0], lb - l)
                elif block:
                    at = (ptab + self.shards,
                          level_offsets(self.shards)[l - lb][0], NO_SHARD)
                else:
                    at = (ptab, doff + stored[l - prune][0], NO_SHARD)
                sl.add(stored_src, 16 * (row + l), at[1], add, mask, xr, l,
                       1, ptab=at[0], shard=at[2])
        self._tasks = tasks
        self._subtree_rows = nodes
        self._template = np.stack(rows)
        self._flags = np.stack([first, last], axis=1).astype(np.int32)
        self._val_rows = val_rows  # first payload row of each value message
        self._dig_rows = dig_rows
        self._slots = (tv, fv, td, fd)
        self._packed: dict = {}

    def _source_layout(self):
        """The sources' entries: sets their sizes (``QueryTables.entries``)
        and returns, keyed by FRI layer (-1 the trace), each value array's
        (first entry, base, block lanes or None) and each tree's (first
        entry, digest-row offset, subtree leaves or None).  Unsharded:
        one entry a source, the FRI layers at their ``layer_layout``
        offsets; on a mesh one entry a block or subtree (plus a tree's
        top levels), or one a layer for the FRI tail."""
        s, wd, mesh = self.shards, self.elem_width, self.shards > 1
        f_sizes, td_sizes = ([], []) if mesh else ([0], [0])
        val_src, tree_src = {}, {}
        # per entry: blocks and subtrees are their owners', the rest every
        # process's
        rep = [True] * (len(f_sizes) + len(td_sizes))
        if self.trace_len is not None:
            f_sizes, fblk = _value_layout(self.trace_len,
                                          self.num_columns * wd, s, mesh)
            td_sizes, tblk = _tree_layout(self.trace_len, self.trace_prune,
                                          s, mesh)
            val_src[-1] = (0, 0, fblk)
            tree_src[-1] = (len(f_sizes), 0, tblk)
            rep = [fblk is None] * len(f_sizes) + _tree_replicated(
                td_sizes, tblk is not None)
        fv0 = len(f_sizes) + len(td_sizes)
        if mesh:
            lengths = self.fri_lengths
            sharded = sharded_layers(lengths[0], s, len(lengths) - 1)
            fv_sizes, fd_sizes, trees = [], [], []
            for k, (ln, sh) in enumerate(zip(lengths, sharded)):
                sizes, blk = _value_layout(ln, wd, s, sh)
                val_src[k] = (fv0 + len(fv_sizes), 0, blk)
                fv_sizes += sizes
                rep += [not sh] * len(sizes)
                trees.append(_tree_layout(ln, 0, s, sh))
            fd0 = fv0 + len(fv_sizes)
            for k, (sizes, blk) in enumerate(trees):
                tree_src[k] = (fd0 + len(fd_sizes), 0, blk)
                fd_sizes += sizes
                rep += _tree_replicated(sizes, blk is not None)
        else:
            layout, vt, dt = layer_layout(self.fri_lengths, wd,
                                          self.fri_prune)
            fv_sizes, fd_sizes = [vt], [dt]
            rep += [True, True]
            for k, (_, voff, doff) in enumerate(layout):
                val_src[k] = (fv0, voff, None)
                tree_src[k] = (fv0 + 1, doff, None)
        self._entry_sizes = (f_sizes, td_sizes, fv_sizes, fd_sizes)
        self._replicated = tuple(rep)
        return val_src, tree_src

    def pack(self, device) -> QueryTables:
        """The plan's tables in the layout the query kernel reads, on
        `device` (built once per device): the stream template with every
        constant word in place, the flags, one slot table row per opened
        value and digest (values first, digests in script order), and
        one task row per pruned authentication path."""
        key = str(device)
        if key not in self._packed:
            slots = [row for sl in self._slots
                     for row in zip(*sl.cols.values())]
            self._packed[key] = QueryTables(
                template=torch.from_numpy(self._template.astype(
                    np.uint32).view(np.int32)).to(device),
                flags=torch.from_numpy(self._flags).to(device),
                slots=torch.tensor(slots, dtype=torch.int64, device=device),
                num_values=len(self._slots[0].cols["word"])
                + len(self._slots[1].cols["word"]),
                rng=self.rng, num_queries=self.num_queries,
                sizes=tuple(sum(e) for e in self._entry_sizes),
                entries=tuple(tuple(e) for e in self._entry_sizes),
                shards=self.shards, replicated=self._replicated,
                tasks=torch.tensor(self._tasks, dtype=torch.int64,
                                   device=device).reshape(
                                       -1, len(TASK_COLUMNS)),
                max_prune=max((t[4] for t in self._tasks), default=0),
                subtree_rows=self._subtree_rows,
                elem_width=self.elem_width)
        return self._packed[key]

    def stream(self, v: torch.Tensor, d: torch.Tensor):
        """(stream, flags) of one query for K5, from its opened values
        (Nv,) and digests (Nd, 8) in script order."""
        tb = self.pack(v.device)
        return _assemble(tb, v, d), tb.flags

    def source_table(self, f_evals, trace_digests, fri_values,
                     fri_digests) -> torch.Tensor | None:
        """The source table K5's query form reads for these unsharded
        sources (their addresses, checked against the plan), on their
        device: built once for buffers that stay put (the single-dispatch
        prove's static buffers) and passed to :meth:`run_device` as
        `ptrs`.  None on the CPU, whose plain version reads the tensors."""
        if _build.plain_device(fri_values):
            return None
        tb = self.pack(fri_values.device)
        return _query_ptrs(tb, 0, fri_values.device, source_entries(
            tb, (f_evals.reshape(-1), trace_digests, fri_values,
                 fri_digests)))

    def run_device(self, state, f_evals, trace_digests, fri_values,
                   fri_digests, ptrs: torch.Tensor | None = None):
        """The query phase on the device, no fetch: one launch of K5's
        query form on a CUDA device.  `state`: (8,) int32 Fiat-Shamir
        state; `f_evals`: the (M,) or (C, M) trace LDE ((2, M) or
        (C, 2, M) limb planes for Goldilocks); `trace_digests` /
        `fri_digests`: the stored levels of the trees, pruned at the
        plan's depths, in the layout of ``merkle/tree.py`` /
        ``fri/commit.py``; `fri_values`: every FRI layer concatenated.
        On a mesh `f_evals` is the ``Sharded`` LDE and the others the
        entry lists of ``DistMerkleTree.entries`` and of a mesh
        ``fri_commit``, all read from the state's device; on a process
        mesh (None for another process's blocks) K5's query form cut at
        the query boundary (:func:`query_chain_cut`).  Unsharded,
        `ptrs` is these sources' :meth:`source_table` (built here when
        None).  Returns
        (final_state (8,), idxs (Q,) int64, vals (Q, Nv), digs
        (Q, Nd, 8)) in script order, a trace opening's C values
        together, a Goldilocks value as its (hi, lo) words.  A plan
        without a trace takes None for `f_evals` and `trace_digests`."""
        from stark_tpu_torch.dist.mesh import Sharded

        if self.trace_len is None:
            f_evals = torch.empty(0, dtype=torch.int32, device=state.device)
            trace_digests = torch.empty((0, 8), dtype=torch.int32,
                                        device=state.device)
        tb = self.pack(state.device)
        if isinstance(f_evals, Sharded):
            mesh = f_evals.mesh
            f_evals = [None if b is None else b.reshape(-1)
                       for b in f_evals.blocks]
            if mesh.process:
                return query_chain_cut(state, f_evals, trace_digests,
                                       fri_values, fri_digests, tb, mesh)
        else:
            f_evals = f_evals.reshape(-1)
        return query_chain(state, f_evals, trace_digests, fri_values,
                           fri_digests, tb, ptrs)

    def run(self, channel, f_evals, trace_digests, fri_values,
            fri_digests, device=None) -> None:
        """The query phase from the host channel's state: on `device`
        (default the FRI values' device; a mesh's first) with
        :meth:`run_device`, one fetch, then the canonical transcript
        replayed into `channel` (:meth:`replay`)."""
        if not channel.state:
            raise ChannelError(
                "query phase before any send (empty channel state)")
        if device is None:
            device = fri_values.device
        state = state_words(channel.state, device)
        final_h, idxs_h, vals_h, digs_h = fetch_packed(self.run_device(
            state, f_evals, trace_digests, fri_values, fri_digests))
        self.replay(channel, final_h, idxs_h, vals_h, digs_h)

    def replay(self, channel, final_h, idxs_h, vals_h, digs_h) -> None:
        """Replay the canonical transcript into `channel` from fetched
        host arrays, asserting the device chain matches."""
        for q in range(self.num_queries):
            idx = channel.receive_random_int(0, self.rng - 1, True)
            dev_idx = int(idxs_h[q]) & 0xFFFFFFFF
            if idx != dev_idx:
                raise RuntimeError(
                    "device query Fiat-Shamir diverged from host transcript "
                    f"(query {q}: device idx {dev_idx} != host {idx})")
            vi = di = 0
            for op in self.script:
                if op[0] == "value":
                    k = (self.num_columns if op[1][0] == "trace_v"
                         else 1) * self.elem_width
                    row = np.asarray(vals_h[q][vi:vi + k], dtype=np.int64)
                    vi += k
                    # each value as 8 BE bytes: its (hi, lo) words, the
                    # high word 0 in a u32 field
                    words = row.reshape(-1, self.elem_width) & 0xFFFFFFFF
                    if self.elem_width == 1:
                        words = np.concatenate([np.zeros_like(words), words],
                                               axis=1)
                    channel.send(words.astype(">u4").tobytes())
                elif op[0] == "path":
                    src = op[1]
                    ln = (self.trace_len if src[0] == "trace_p"
                          else self.fri_lengths[src[1]])
                    h = _log2(ln)
                    rows = np.asarray(digs_h[q][di:di + h], dtype=np.int64)
                    di += h
                    channel.send((rows & 0xFFFFFFFF).astype(">u4").tobytes())
        final_hex = (np.asarray(final_h, dtype=np.int64)
                     & 0xFFFFFFFF).astype(">u4").tobytes().hex()
        if channel.state != final_hex:
            raise RuntimeError(
                "device query Fiat-Shamir final state diverged from the "
                "host replay — transcript would not verify")


def _prunes_fit(lengths, prunes) -> bool:
    return all(0 <= p and 1 << p <= ln for ln, p in zip(lengths, prunes))


@functools.lru_cache(maxsize=None)
def get_plan(rng: int, num_queries: int, offsets: tuple,
             trace_len: int | None, fri_lengths: tuple,
             num_columns: int = 1, elem_width: int = 1, trace_prune: int = 0,
             fri_prune: tuple = (), shards: int = 1) -> "DeviceQueryPlan":
    """The :class:`DeviceQueryPlan` of these arguments, built once."""
    return DeviceQueryPlan(rng, num_queries, offsets, trace_len, fri_lengths,
                           num_columns, elem_width, trace_prune, fri_prune,
                           shards)


def supported(rng: int, trace_len: int | None, fri_lengths,
              num_columns: int = 1, elem_width: int = 1,
              trace_prune: int = 0, fri_prune: tuple = ()) -> bool:
    """Whether this plan handles the configuration (power-of-two sizes,
    draw range below 2^32, 1..6 trace columns, a field of 1 or 2 u32
    words, prune depths no deeper than their trees; `trace_len` None for
    the FRI query phase alone)."""
    if (not 0 < rng < 1 << 32 or not 1 <= num_columns <= MAX_COLUMNS
            or elem_width not in (1, 2)):
        return False
    trace = [trace_len] if trace_len is not None else []
    sizes = list(fri_lengths) + trace
    fri_prune = tuple(fri_prune) or (0,) * len(fri_lengths)
    return (all(s > 0 and not (s & (s - 1)) for s in sizes)
            and len(fri_prune) == len(fri_lengths)
            and _prunes_fit(trace + list(fri_lengths),
                            [trace_prune] * len(trace) + list(fri_prune)))
