"""Device-resident query phase (counterpart of
``stark_tpu/channel/device_query.py``; u32 field, one trace column,
unpruned power-of-two trees).

For each query, on the device and without a host sync:

    idx   <- int(state_hex, 16) mod range              [receive_random_int]
    state <- sha256(utf8(state_hex))
    gather the trace and FRI openings at idx (values and auth paths)
    absorb each opened message into the Fiat-Shamir chain

Every ``Channel.send`` hashes utf8(state_hex ++ msg_hex): a first block
that is exactly the 64-char state hex, then the message's hex chars and
static SHA padding.  So a query is one flagged block stream (see
``hash/cuda_chain.py``), run through kernel K5 once per query; queries
chain through the state.  The stream's constant rows and flags are built
once per plan; per query only the opened values and digests are
gathered (one index operation per buffer) and written in as hex rows.

The host then replays the canonical transcript from the one fetch and
checks that the device-derived chain equals the host derivation.
"""

from __future__ import annotations

import numpy as np
import torch

from stark_tpu_torch.channel.device_channel import (VALUE_TAIL,
                                                    ascii_hex_words,
                                                    mod_state, pad_row)
from stark_tpu_torch.fields.fp import store
from stark_tpu_torch.fri.commit import layer_layout
from stark_tpu_torch.hash.cuda_chain import FIRST_HEX, sha_chain
from stark_tpu_torch.merkle.tree import level_offsets


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
    """Gather slots of one source buffer: slot s reads position
    base[s] + ((((idx + add[s]) & mask[s]) ^ xr[s]) >> shift[s]) ^ flip[s]."""

    def __init__(self):
        self.cols = {k: [] for k in ("base", "add", "mask", "xr", "shift",
                                     "flip")}

    def add(self, base, add, mask, xr, shift=0, flip=0):
        for k, v in zip(self.cols, (base, add, mask, xr, shift, flip)):
            self.cols[k].append(v)

    def to(self, device):
        return {k: torch.tensor(v, dtype=torch.int64, device=device)
                for k, v in self.cols.items()}


def _positions(t: dict, idx: torch.Tensor) -> torch.Tensor:
    j = ((idx + t["add"]) & t["mask"]) ^ t["xr"]
    return t["base"] + ((j >> t["shift"]) ^ t["flip"])


class DeviceQueryPlan:
    """The whole query phase for one static configuration: draw range,
    query count, trace offsets, trace length and the FRI length ladder
    (all powers of two)."""

    def __init__(self, rng: int, num_queries: int, offsets: tuple,
                 trace_len: int, fri_lengths: tuple):
        if rng <= 0 or rng >= 1 << 32:
            raise ValueError(f"draw range {rng} not in [1, 2^32)")
        for ln in fri_lengths + (trace_len,):
            if ln & (ln - 1):
                raise ValueError("device query phase needs power-of-two sizes")
        self.rng = rng
        self.num_queries = num_queries
        self.offsets = tuple(int(o) for o in offsets)
        self.trace_len = int(trace_len)
        self.fri_lengths = tuple(int(x) for x in fri_lengths)
        self.script = build_script(len(self.offsets), self.fri_lengths)
        self.fri_layout = layer_layout(self.fri_lengths)[0]

        # static stream template, flags, and the gather slots in script
        # order (trace ops come first in the script, so trace slots then
        # FRI slots is script order)
        rows, first, last = [], [], []
        val_rows, dig_rows = [], []
        tv, fv, td, fd = _Slots(), _Slots(), _Slots(), _Slots()
        tlevels = level_offsets(self.trace_len)

        def message(dynamic: list, tail):
            rows.append(np.zeros(16, np.int64))  # replaced by the state hex
            first.append(FIRST_HEX)
            last.append(0)
            for kind in dynamic:
                (val_rows if kind == "v" else dig_rows).append(len(rows))
                rows.append(np.zeros(16, np.int64))
                first.append(0)
                last.append(0)
            if tail is not None:
                rows.append(tail)
                first.append(0)
                last.append(0)
            last[-1] = 1

        for op in self.script:
            if op[0] == "draw":
                message([], pad_row(64))
                continue
            src = op[1]
            if src[0] in ("trace_v", "trace_p"):
                ln, add, xr = self.trace_len, self.offsets[src[1]], 0
            else:
                ln, add = self.fri_lengths[src[1]], 0
                xr = ln // 2 if src[0] != "fri_q" and src[2] else 0
            mask = 0 if src[0] == "fri_q" else ln - 1
            if op[0] == "value":
                if src[0] == "trace_v":
                    tv.add(0, add, mask, xr)
                else:
                    fv.add(self.fri_layout[src[1]][1], add, mask, xr)
                message(["v"], None)
                continue
            h = _log2(ln)
            if src[0] == "trace_p":
                for l in range(h):
                    td.add(tlevels[l][0], add, mask, xr, l, 1)
            else:
                doff = self.fri_layout[src[1]][2]
                for l, (loff, _) in enumerate(level_offsets(ln)[:h]):
                    fd.add(doff + loff, add, mask, xr, l, 1)
            message(["d"] * h, pad_row(64 + 64 * h))
        self._template = np.stack(rows)
        self._flags = np.stack([first, last], axis=1).astype(np.int32)
        self._val_rows = val_rows
        self._dig_rows = dig_rows
        self._slots = (tv, fv, td, fd)
        self._dev_cache: dict = {}

    def _tables(self, device):
        key = str(device)
        if key not in self._dev_cache:
            self._dev_cache[key] = dict(
                template=torch.from_numpy(self._template).to(device),
                flags=torch.from_numpy(self._flags).to(device),
                val_rows=torch.tensor(self._val_rows, device=device),
                dig_rows=torch.tensor(self._dig_rows, device=device),
                value_tail=torch.from_numpy(VALUE_TAIL).to(device),
                slots=[s.to(device) for s in self._slots])
        return self._dev_cache[key]

    def stream(self, v: torch.Tensor, d: torch.Tensor):
        """(stream, flags) of one query for K5, from its opened values
        (Nv,) and digests (Nd, 8) in script order."""
        tb = self._tables(v.device)
        stream = tb["template"].clone()
        # 16 hex chars of each 8-byte BE value, then padding
        hv = ascii_hex_words(torch.stack([torch.zeros_like(v), v], -1))
        stream[tb["val_rows"]] = torch.cat(
            [hv, tb["value_tail"].expand(len(self._val_rows), -1)], dim=1)
        stream[tb["dig_rows"]] = ascii_hex_words(d)
        return store(stream), tb["flags"]

    def run_device(self, state, f_evals, trace_digests, fri_values,
                   fri_digests):
        """The query phase on the device, no fetch.  `state`: (8,) int32
        Fiat-Shamir state; `trace_digests` / `fri_digests`: tree buffers
        in the layout of ``merkle/tree.py`` / ``fri/commit.py``;
        `fri_values`: every FRI layer concatenated.  Returns
        (final_state (8,), idxs (Q,) int64, vals (Q, Nv), digs (Q, Nd, 8))
        in script order."""
        dev = state.device
        tb = self._tables(dev)
        tv, fv, td, fd = tb["slots"]
        q_n = self.num_queries
        nv, nd = len(self._val_rows), len(self._dig_rows)
        idxs = torch.empty(q_n, dtype=torch.int64, device=dev)
        vals = torch.empty((q_n, nv), dtype=torch.int32, device=dev)
        digs = torch.empty((q_n, nd, 8), dtype=torch.int32, device=dev)
        chain = state
        for q in range(q_n):
            idx = mod_state(chain, self.rng)
            v = torch.cat([f_evals[_positions(tv, idx)],
                           fri_values[_positions(fv, idx)]])
            d = torch.cat([trace_digests.index_select(0, _positions(td, idx)),
                           fri_digests.index_select(0, _positions(fd, idx))])
            chain = sha_chain(*self.stream(v, d), chain)
            idxs[q] = idx
            vals[q] = v
            digs[q] = d
        return chain, idxs, vals, digs

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
                    val = int(vals_h[q][vi]) & 0xFFFFFFFF
                    vi += 1
                    channel.send(val.to_bytes(8, "big"))
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


def supported(rng: int, trace_len: int, fri_lengths) -> bool:
    """Whether this plan handles the configuration (power-of-two sizes,
    draw range below 2^32)."""
    if not 0 < rng < 1 << 32:
        return False
    sizes = list(fri_lengths) + [trace_len]
    return all(s > 0 and not (s & (s - 1)) for s in sizes)
