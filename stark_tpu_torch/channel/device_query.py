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

import numpy as np
import torch

from stark_tpu_torch import _build
from stark_tpu_torch.channel.channel import ChannelError
from stark_tpu_torch.channel.device_channel import (ascii_hex_words,
                                                    mod_state, pad_row,
                                                    state_words)
from stark_tpu_torch.fields.fp import store
from stark_tpu_torch.fri.commit import layer_layout
from stark_tpu_torch.hash.cuda_chain import FIRST_HEX, sha_chain_plain
from stark_tpu_torch.hash.sha256 import sha256_pairs, sha256_row_leaves
from stark_tpu_torch.merkle.tree import level_offsets
from stark_tpu_torch.utils.gather import fetch_packed

# the slot table's columns; a slot reads position
# base + ((((idx + add) & mask) ^ xr) >> shift) ^ flip of its source and
# writes its hex from word `word` of the query's stream (row-major (R, 16)
# words): a value's 2 hex words, a digest's 16
SLOT_COLUMNS = ("source", "base", "add", "mask", "xr", "shift", "flip",
                "word")
# sources (the kernel's enum): trace values, FRI values, stored trace and
# FRI digests, and the recomputed siblings of a pruned trace or FRI tree
# (position = a node of the query's recompute tasks)
(TRACE_VALUE, FRI_VALUE, TRACE_DIGEST, FRI_DIGEST, TRACE_SUBTREE,
 FRI_SUBTREE) = range(6)
# the recompute tasks' columns: the leaf j = ((idx + add) & mask) ^ xr of
# the source's tree (TRACE_VALUE or FRI_VALUE); the task hashes leaves
# (j >> prune) << prune + i, i < 2^prune, each the row message of `cols`
# values whose word planes lie at base + plane * stride of the source's
# value buffer, and keeps levels 0 .. prune - 1 of that block from node
# row `node` of the query's recompute buffer on, level l at
# node + 2^(prune + 1) - 2^(prune - l + 1)
TASK_COLUMNS = ("source", "add", "mask", "xr", "prune", "base", "stride",
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
    slots: torch.Tensor  # (S, 8) int64 rows of SLOT_COLUMNS, values first
    num_values: int  # value slots (words): 2 a Goldilocks value
    rng: int
    num_queries: int
    # f_evals words (C x width x trace length), stored trace tree rows,
    # FRI values words, stored FRI digest rows
    sizes: tuple
    tasks: torch.Tensor  # (T, 9) int64 rows of TASK_COLUMNS
    max_prune: int  # the deepest task's prune (0: no task)
    subtree_rows: int  # digest rows of a query's recomputed nodes
    elem_width: int  # u32 words a value (a task's leaf message)


def _assemble(tb: QueryTables, v: torch.Tensor, d: torch.Tensor):
    """One query's stream: the template with the hex of the opened values
    (Nv,) and digests (Nd, 8) written at their slots' words."""
    nv = tb.num_values
    word = tb.slots[:, 7]
    stream = tb.template.clone()
    flat = stream.view(-1)
    span = torch.arange(16, device=word.device)
    flat[word[:nv, None] + span[:2]] = store(ascii_hex_words(v[:, None]))
    flat[word[nv:, None] + span] = store(ascii_hex_words(d))
    return stream


def _subtrees_plain(tb: QueryTables, idx, f_evals, fri_values):
    """One query's recomputed nodes, (subtree_rows, 8), level by level
    for all tasks together as the kernel computes them: every task's
    block of leaves hashed with the plain K3 (its row form, one call a
    column count), then each level's pairs of all the tasks that keep the
    level above with one plain K4 call."""
    dev = f_evals.device
    sub = torch.empty((tb.subtree_rows, 8), dtype=torch.int32, device=dev)
    tasks = tb.tasks.cpu().tolist()
    blocks = []
    for src, add, mask, xr, prune, base, stride, cols, _ in tasks:
        values = f_evals if src == TRACE_VALUE else fri_values
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


def query_chain_plain(chain, f_evals, trace_digests, fri_values,
                      fri_digests, tb: QueryTables):
    """Plain version of K5's query form, with the kernel's inputs: the
    per-query loop over the packed tables, gathers and the pruned trees'
    recompute (plain K3 / K4) on the tensors' device, each query's chain
    through :func:`sha_chain_plain` (on the host).  Returns (final chain
    (8,), idxs (Q,) int64, vals (Q, Nv), digs (Q, Nd, 8))."""
    dev = chain.device
    nv = tb.num_values
    nd = int(tb.slots.shape[0]) - nv
    cols = dict(zip(SLOT_COLUMNS, tb.slots.unbind(1)))
    src = tb.slots[:, 0].cpu()
    sel = [torch.nonzero(src == k).flatten().to(dev) for k in range(6)]
    idxs = torch.empty(tb.num_queries, dtype=torch.int64, device=dev)
    vals = torch.empty((tb.num_queries, nv), dtype=torch.int32, device=dev)
    digs = torch.empty((tb.num_queries, nd, 8), dtype=torch.int32,
                       device=dev)
    for q in range(tb.num_queries):
        idx = mod_state(chain, tb.rng)
        pos = _positions(cols, idx)
        sub = _subtrees_plain(tb, idx, f_evals, fri_values)
        v, d = vals[q], digs[q]
        for k, buf in ((TRACE_VALUE, f_evals), (FRI_VALUE, fri_values)):
            v[sel[k]] = buf[pos[sel[k]]]
        for k, buf in ((TRACE_DIGEST, trace_digests),
                       (FRI_DIGEST, fri_digests), (TRACE_SUBTREE, sub),
                       (FRI_SUBTREE, sub)):
            d[sel[k] - nv] = buf[pos[sel[k]]]
        chain = sha_chain_plain(_assemble(tb, v, d), tb.flags, chain)
        idxs[q] = idx
    return chain, idxs, vals, digs


def _launch_query(tb: QueryTables, b: int, chain, f_evals, trace_digests,
                  fri_values, fri_digests):
    """One launch of K5's query form: one proof (b = 0, no batch axis) or
    b proofs of the plan, one block each, every operand with a leading
    proof axis."""
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
    n_f, n_td, n_fv, n_fd = tb.sizes
    _build.require(chain, "chain", lead + (8,))
    _build.require(f_evals, "f_evals", lead + (n_f,))
    _build.require(trace_digests, "trace_digests", lead + (n_td, 8),
                   align=16)
    _build.require(fri_values, "fri_values", lead + (n_fv,))
    _build.require(fri_digests, "fri_digests", lead + (n_fd, 8), align=16)
    _build.require(tb.template, "template", (nrows, 16), align=16)
    _build.require(tb.flags, "flags", (nrows, 2), align=8)
    _build.require(tb.slots, "slots", (nslots, 8), dtype=torch.int64,
                   align=8)
    _build.require(tb.tasks, "tasks", (ntasks, len(TASK_COLUMNS)),
                   dtype=torch.int64, align=8)
    dev, q_n, nv = chain.device, tb.num_queries, tb.num_values
    out = torch.empty(lead + (8,), dtype=torch.int32, device=dev)
    idxs = torch.empty(lead + (q_n,), dtype=torch.int64, device=dev)
    vals = torch.empty(lead + (q_n, nv), dtype=torch.int32, device=dev)
    digs = torch.empty(lead + (q_n, nslots - nv, 8), dtype=torch.int32,
                       device=dev)
    strides = tb.sizes if b else (0, 0, 0, 0)
    _build.check(lib.stark_query_chain(
        chain.data_ptr(), f_evals.data_ptr(), trace_digests.data_ptr(),
        fri_values.data_ptr(), fri_digests.data_ptr(),
        tb.template.data_ptr(), tb.flags.data_ptr(), tb.slots.data_ptr(),
        tb.tasks.data_ptr(), nrows, nslots, nv, ntasks, tb.max_prune,
        tb.subtree_rows, int(tb.elem_width == 2), tb.rng, q_n,
        out.data_ptr(), idxs.data_ptr(), vals.data_ptr(), digs.data_ptr(),
        *strides, max(b, 1), _build.stream_ptr(dev)),
        "K5 query_chain" + "_batch" * bool(b))
    return out, idxs, vals, digs


def query_chain(chain, f_evals, trace_digests, fri_values, fri_digests,
                tb: QueryTables):
    """K5's query form: every query of the phase in one launch, the
    pruned trees' siblings recomputed in it.  A CPU tensor runs
    :func:`query_chain_plain`; a CUDA tensor launches the kernel or
    raises."""
    if _build.plain_device(chain):
        return query_chain_plain(chain, f_evals, trace_digests, fri_values,
                                 fri_digests, tb)
    res = _launch_query(tb, 0, chain, f_evals, trace_digests, fri_values,
                        fri_digests)
    query_chain.launches += 1
    return res


query_chain.launches = 0
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
    res = _launch_query(tb, b, chain, f_evals, trace_digests, fri_values,
                        fri_digests)
    query_chain_batch.launches += 1
    return res


query_chain_batch.launches = 0
query_chain_batch.plain = query_chain_plain


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
    """Gather slots: slot s reads position
    base[s] + ((((idx + add[s]) & mask[s]) ^ xr[s]) >> shift[s]) ^ flip[s]
    of its source's buffer and writes its hex from stream word word[s]."""

    def __init__(self):
        self.cols = {k: [] for k in SLOT_COLUMNS}

    def add(self, source, word, base, add, mask, xr, shift=0, flip=0):
        for k, v in zip(SLOT_COLUMNS,
                        (source, base, add, mask, xr, shift, flip, word)):
            self.cols[k].append(v)


def _positions(t: dict, idx: torch.Tensor) -> torch.Tensor:
    j = ((idx + t["add"]) & t["mask"]) ^ t["xr"]
    return t["base"] + ((j >> t["shift"]) ^ t["flip"])


class DeviceQueryPlan:
    """The whole query phase for one static configuration: draw range,
    query count, trace offsets, trace length (of each column; None, with
    no offsets, for the standalone FRI query phase, which opens no
    trace), the FRI length ladder (all powers of two), the trace's column
    count, the field's width in u32 words (1, or 2 for Goldilocks), and
    the prune depths of the trace tree and of each FRI layer's tree
    (default: none pruned)."""

    def __init__(self, rng: int, num_queries: int, offsets: tuple,
                 trace_len: int | None, fri_lengths: tuple,
                 num_columns: int = 1, elem_width: int = 1,
                 trace_prune: int = 0, fri_prune: tuple = ()):
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
                # (plane k of column c at (c * width + k) * trace_len of
                # the (C, M) or (C, 2, M) LDE); an FRI opening: one value
                # (plane k at its layer's offset + k * length).  A u32
                # value's hex starts after the 8 hex zeros of its message
                # words; a Goldilocks value's hi word at 4c, lo at 4c + 2
                ncols = self.num_columns if src[0] == "trace_v" else 1
                row = message(value_rows(ncols, self.elem_width))
                val_rows.append(row)
                wd = self.elem_width
                for c in range(ncols):
                    for k in range(wd):
                        word = 16 * row + 4 * c + 2 * (k + 2 - wd)
                        if src[0] == "trace_v":
                            tv.add(TRACE_VALUE, word,
                                   (c * wd + k) * self.trace_len, add, mask,
                                   xr)
                        else:
                            fv.add(FRI_VALUE, word,
                                   self.fri_layout[src[1]][1] + k * ln, add,
                                   mask, xr)
                continue
            h = _log2(ln)
            row = message(np.zeros((h, 16), np.int64), pad_row(64 + 64 * h))
            dig_rows.extend(range(row, row + h))
            if src[0] == "trace_p":
                sl, prune, doff = td, self.trace_prune, 0
                values, stored_src, recomputed_src = (
                    TRACE_VALUE, TRACE_DIGEST, TRACE_SUBTREE)
                vbase, cols = 0, self.num_columns
            else:
                sl, prune = fd, self.fri_prune[src[1]]
                _, vbase, doff = self.fri_layout[src[1]]
                values, stored_src, recomputed_src = (
                    FRI_VALUE, FRI_DIGEST, FRI_SUBTREE)
                cols = 1
            if prune:
                # levels 0 .. prune - 1: the in-block siblings among the
                # task's nodes, at j's low `prune` bits
                tasks.append((values, add, mask, xr, prune, vbase, ln, cols,
                              nodes))
                low = (1 << prune) - 1
                for l in range(prune):
                    sl.add(recomputed_src, 16 * (row + l),
                           nodes + (2 << prune) - (2 << (prune - l)), add,
                           low, xr & low, l, 1)
                nodes += (2 << prune) - 2
            stored = level_offsets(ln >> prune)
            for l in range(prune, h):
                sl.add(stored_src, 16 * (row + l),
                       doff + stored[l - prune][0], add, mask, xr, l, 1)
        self._tasks = tasks
        self._subtree_rows = nodes
        self._template = np.stack(rows)
        self._flags = np.stack([first, last], axis=1).astype(np.int32)
        self._val_rows = val_rows  # first payload row of each value message
        self._dig_rows = dig_rows
        self._slots = (tv, fv, td, fd)
        self._packed: dict = {}

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
            _, vt, dt = layer_layout(self.fri_lengths, self.elem_width,
                                     self.fri_prune)
            self._packed[key] = QueryTables(
                template=torch.from_numpy(self._template.astype(
                    np.uint32).view(np.int32)).to(device),
                flags=torch.from_numpy(self._flags).to(device),
                slots=torch.tensor(slots, dtype=torch.int64, device=device),
                num_values=len(self._slots[0].cols["word"])
                + len(self._slots[1].cols["word"]),
                rng=self.rng, num_queries=self.num_queries,
                sizes=self._trace_sizes() + (vt, dt),
                tasks=torch.tensor(self._tasks, dtype=torch.int64,
                                   device=device).reshape(
                                       -1, len(TASK_COLUMNS)),
                max_prune=max((t[4] for t in self._tasks), default=0),
                subtree_rows=self._subtree_rows,
                elem_width=self.elem_width)
        return self._packed[key]

    def _trace_sizes(self) -> tuple:
        """(trace LDE words, stored trace digest rows); (0, 0) without a
        trace."""
        if self.trace_len is None:
            return 0, 0
        return (self.num_columns * self.elem_width * self.trace_len,
                2 * (self.trace_len >> self.trace_prune) - 1)

    def stream(self, v: torch.Tensor, d: torch.Tensor):
        """(stream, flags) of one query for K5, from its opened values
        (Nv,) and digests (Nd, 8) in script order."""
        tb = self.pack(v.device)
        return _assemble(tb, v, d), tb.flags

    def run_device(self, state, f_evals, trace_digests, fri_values,
                   fri_digests):
        """The query phase on the device, no fetch: one launch of K5's
        query form on a CUDA device.  `state`: (8,) int32 Fiat-Shamir
        state; `f_evals`: the (M,) or (C, M) trace LDE ((2, M) or
        (C, 2, M) limb planes for Goldilocks); `trace_digests` /
        `fri_digests`: the stored levels of the trees, pruned at the
        plan's depths, in the layout of ``merkle/tree.py`` /
        ``fri/commit.py``; `fri_values`: every FRI layer concatenated.
        Returns (final_state (8,), idxs (Q,) int64, vals (Q, Nv), digs
        (Q, Nd, 8)) in script order, a trace opening's C values
        together, a Goldilocks value as its (hi, lo) words.  A plan
        without a trace takes None for `f_evals` and `trace_digests`."""
        if self.trace_len is None:
            f_evals = torch.empty(0, dtype=torch.int32, device=state.device)
            trace_digests = torch.empty((0, 8), dtype=torch.int32,
                                        device=state.device)
        return query_chain(state, f_evals.reshape(-1), trace_digests,
                           fri_values, fri_digests, self.pack(state.device))

    def run(self, channel, f_evals, trace_digests, fri_values,
            fri_digests) -> None:
        """The query phase from the host channel's state: on the values'
        device (:meth:`run_device`), one fetch, then the canonical
        transcript replayed into `channel` (:meth:`replay`)."""
        if not channel.state:
            raise ChannelError(
                "query phase before any send (empty channel state)")
        state = state_words(channel.state, fri_values.device)
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
