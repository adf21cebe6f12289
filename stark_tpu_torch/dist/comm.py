"""Communication accounting of a sharded prove (counterpart of
``stark_tpu/dist/comm.py``).

Exact byte counts of every array a mesh prove sends between shards,
derived from the shard layout, not measured: the four-step NTT's three
all-to-alls, the subtree-root gathers of the Merkle trees, the
composition's halo, the FRI fold exchanges and the FRI tail gather.
The counterpart of the JAX package's HLO cross-check is the mesh's own
copy counter (:meth:`Mesh.exchange`): the tests hold the bytes a prove
actually copies against :func:`prove_collectives`.

One process (`ranks` None): a gather goes to the first shard only, and
every copy between two shards counts.  A process mesh of `ranks`
processes, each holding the same number of contiguous shards: only what
crosses processes counts, summed over the ranks; every rank holds the
trace and its coefficients whole, so nothing is scattered; the gathers
are all-gathers (every rank builds the top tree levels and folds the
FRI tail), and the query phase all-reduces each query's slot words.
The drawn challenges, which every shard reads, are not arrays and are
not counted.

:func:`scaling_report` projects a prove's time over 1, 2, 4, ... cards,
one process a card, from these bytes and the H100's data-sheet rates
(specification figures, not measurements).
"""

from __future__ import annotations

import dataclasses
import json

from stark_tpu_torch.dist.merkle import shards_tree

# NVIDIA H100 SXM data-sheet figures: specifications, not measurements
HBM_GBPS = 3350.0  # HBM3, GB/s per card
NVLINK_GBPS = 450.0  # NVLink 4, GB/s each way per card (900 both ways)

_ELEM = 4  # a u32 field element
_DIGEST = 32  # SHA-256 digest


@dataclasses.dataclass
class CollectiveVolume:
    """Bytes of one logical collective, summed over the shards."""

    name: str  # e.g. "ntt/all_to_all[0]"
    kind: str  # all_to_all | gather | permute | halo | scatter
    wire_bytes: int  # bytes crossing shard boundaries, all shards
    per_chip_bytes: int  # bytes one shard sends (or the first receives)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def ntt_collectives(n: int, s: int, elem: int = 4,
                    columns: int = 1) -> list[CollectiveVolume]:
    """Four-step NTT (``dist/ntt.py``) of `columns` (…, n) arrays of
    `elem`-byte values: three all-to-all transposes, in each of which a
    shard keeps 1/s of its block and sends the rest.  Domains below s^2
    run on one shard (no transposes)."""
    if s <= 1 or n % (s * s):
        return []
    per_chip = (n // s) * elem * columns * (s - 1) // s
    return [CollectiveVolume(f"ntt/all_to_all[{i}]", "all_to_all",
                             per_chip * s, per_chip) for i in range(3)]


def merkle_collectives(n_leaves: int, s: int) -> list[CollectiveVolume]:
    """Sharded tree (``dist/merkle.py``): subtrees need nothing; the
    other s - 1 subtree roots go to the first shard for the top levels.
    Sizes that do not split build whole on the first shard."""
    if not shards_tree(n_leaves, s):
        return []
    wire = _DIGEST * (s - 1)
    return [CollectiveVolume("merkle/root_gather", "gather", wire, wire)]


def fri_fold_schedule(n: int, s: int, num_folds: int,
                      min_sharded: int | None = None,
                      elem: int = 4) -> list[dict]:
    """The FRI re-shard schedule.  Layer k has size n/2^k.  A fold pairs
    element i with i + size/2: under contiguous sharding shard d pairs
    with shard d + s/2, each sends the other half of its block, so a
    sharded fold moves size/2 elements and leaves its output blocks
    interleaved over the shards.  Once a layer is smaller than
    `min_sharded` (default 8 s) it is gathered to the first shard once
    (its (s - 1)/s off that shard) and every later fold is local."""
    if min_sharded is None:
        min_sharded = 8 * s
    sched = []
    size = n
    gathered = s <= 1
    for k in range(num_folds):
        if not gathered and size < min_sharded:
            sched.append({"layer": k, "size": size, "op": "gather_tail",
                          "wire_bytes": size * elem * (s - 1) // s})
            gathered = True
        wire = 0 if gathered else (size // 2) * elem
        sched.append({"layer": k, "size": size,
                      "op": "fold_sharded" if not gathered else "fold_local",
                      "wire_bytes": wire})
        size //= 2
    return sched


def sharded_layers(n: int, s: int, num_folds: int) -> tuple[bool, ...]:
    """Which of the num_folds + 1 FRI layers a mesh prove stores sharded:
    the first (the composition) and every one a sharded fold made."""
    folds = [st["op"] == "fold_sharded"
             for st in fri_fold_schedule(n, s, num_folds)
             if st["op"] != "gather_tail"]
    return (s > 1,) + tuple(folds)


def fri_collectives(n: int, s: int, num_folds: int,
                    elem: int = 4) -> list[CollectiveVolume]:
    out = []
    for step in fri_fold_schedule(n, s, num_folds, elem=elem):
        if step["wire_bytes"]:
            kind = "gather" if step["op"] == "gather_tail" else "permute"
            out.append(CollectiveVolume(
                f"fri/{step['op']}[{step['layer']}]", kind,
                step["wire_bytes"], step["wire_bytes"] // max(s, 1)))
    return out


def prove_collectives(log2_trace: int, blowup: int, s: int, num_folds: int,
                      halo: int, columns: int = 1, elem: int = 4,
                      ranks: int | None = None, query_words: int = 0,
                      num_queries: int = 0) -> list[CollectiveVolume]:
    """Every array one mesh prove sends between shards: the trace
    coefficients scattered to the shards whose block of the padded LDE
    input they reach, the LDE's NTT, the trace tree, the composition's
    halo (`halo` points of every column from the next shards, the
    largest row shift times the blowup), then the FRI commit's trees and
    folds and, when a sharded fold made the last layer, its gather.
    (The JAX model also counts a trace INTT and a composition INTT/NTT
    that neither prove runs sharded.)  With `ranks` > 1, what a process
    mesh of that many processes sends between them
    (:func:`_process_collectives`; `query_words` the query plan's slot
    words a query, ``QueryTables.num_values`` + 8 digests)."""
    n = 1 << log2_trace
    big = n * blowup
    if ranks is not None and ranks > 1:
        return _process_collectives(big, s, ranks, num_folds, halo, columns,
                                    elem, query_words * num_queries)
    layers = sharded_layers(big, s, num_folds)
    out = []
    if s > 1 and big % (s * s) == 0:
        scatter = max(0, n - big // s) * elem * columns
        if scatter:
            out.append(CollectiveVolume("lde/scatter", "scatter", scatter,
                                        scatter))
    elif s > 1:  # one-shard LDE, re-sharded
        wire = big * elem * columns * (s - 1) // s
        out.append(CollectiveVolume("lde/reshard", "scatter", wire, wire))
    out += [dataclasses.replace(c, name=f"trace_ntt/{c.name}")
            for c in ntt_collectives(big, s, elem, columns)]
    out += merkle_collectives(big, s)
    if s > 1:
        wire = s * halo * elem * columns
        out.append(CollectiveVolume("composition/halo", "halo", wire,
                                    wire // s))
    for k, shard in enumerate(layers):
        if shard:
            out += [dataclasses.replace(c, name=f"layer{k}/{c.name}")
                    for c in merkle_collectives(big >> k, s)]
    out += fri_collectives(big, s, num_folds, elem)
    if layers[-1]:
        # a last layer that a sharded fold made goes whole to the first
        # shard for the final-constant send
        last = big >> num_folds
        wire = last * elem * (s - 1) // s
        out.append(CollectiveVolume("fri/final_gather", "gather", wire,
                                    wire))
    return out


def _process_collectives(big: int, s: int, ranks: int, num_folds: int,
                         halo: int, columns: int, elem: int,
                         query_words: int) -> list[CollectiveVolume]:
    """The bytes that cross processes in a prove over `ranks` processes
    of s / ranks contiguous shards each (shard i on rank i // (s /
    ranks)), summed over the senders: the NTT's pieces between shards of
    two ranks; each subtree root and the gathered FRI tail sent to every
    other rank (all-gathers); the halo pieces from another rank's block;
    the fold pairs whose owners lie on two ranks (the owners interleave
    fold by fold, as ``fri/commit.py`` folds); every rank's share of the
    query all-reduces."""
    per = s // ranks

    def cross(a: int, b: int) -> bool:
        return a // per != b // per

    def gathered(name: str, nbytes: int) -> CollectiveVolume:
        wire = nbytes * (ranks - 1)
        return CollectiveVolume(name, "gather", wire, wire // ranks)

    out = []
    if big % (s * s) == 0:
        piece = big // (s * s) * elem * columns
        wire = piece * sum(cross(i, j) for i in range(s) for j in range(s))
        out += [CollectiveVolume(f"trace_ntt/ntt/all_to_all[{i}]",
                                 "all_to_all", wire, wire // ranks)
                for i in range(3)]

    def tree(n_leaves: int, prefix: str) -> None:
        if shards_tree(n_leaves, s):
            out.append(gathered(f"{prefix}merkle/root_gather", _DIGEST * s))

    tree(big, "")
    k, wire = big // s, 0
    for d in range(s):
        need, b = halo, d
        while need > 0:
            b = (b + 1) % s
            take = min(need, k)
            wire += take * elem * columns * cross(b, d)
            need -= take
    if wire:
        out.append(CollectiveVolume("composition/halo", "halo", wire,
                                    wire // ranks))
    layers = sharded_layers(big, s, num_folds)
    for j, shard in enumerate(layers):
        if shard:
            tree(big >> j, f"layer{j}/")
    owners = list(range(s))
    for step in fri_fold_schedule(big, s, num_folds, elem=elem):
        size, name = step["size"], f"fri/{step['op']}[{step['layer']}]"
        if step["op"] == "gather_tail":
            out.append(gathered(name, size * elem))
        elif step["op"] == "fold_sharded":
            h, wire, new = size // s // 2, 0, [0] * s
            for d in range(s // 2):
                lo, hi = owners[d], owners[d + s // 2]
                wire += 2 * h * elem * cross(lo, hi)
                new[2 * d], new[2 * d + 1] = lo, hi
            owners = new
            if wire:
                out.append(CollectiveVolume(name, "permute", wire,
                                            wire // ranks))
    if layers[-1]:
        out.append(gathered("fri/final_gather", (big >> num_folds) * elem))
    if query_words:
        wire = ranks * query_words * 4
        out.append(CollectiveVolume("queries/all_reduce", "all_reduce",
                                    wire, wire // ranks))
    return out


# the Mesh.stats kind each collective's bytes are counted under
STATS_KIND = {"all_to_all": "ntt", "scatter": "scatter", "halo": "halo",
              "permute": "fri", "all_reduce": "query"}


def stats_bytes(collectives) -> dict:
    """Bytes by ``Mesh.stats`` kind: tree root gathers under "merkle", the
    FRI tail gather under "fri", the rest by STATS_KIND."""
    out: dict[str, int] = {}
    for c in collectives:
        kind = ("merkle" if c.name.endswith("root_gather")
                else "fri" if c.kind == "gather" else STATS_KIND[c.kind])
        out[kind] = out.get(kind, 0) + c.wire_bytes
    return out


# -- scaling projection ------------------------------------------------------
def _phase_model(log2_trace: int, blowup: int, s: int, hbm_gbps: float,
                 wire_gbps: float) -> dict:
    """Roofline time model of one Fibonacci-square prove (its fold count,
    its halo of 2 rows) over s cards, one process a card: the device
    bytes each phase touches over the HBM rate, split over the cards,
    plus the bytes that cross processes (the commit phases'; the query
    all-reduces, a few KB a query, are left out) over the link rate."""
    n = 1 << log2_trace
    big = n * blowup
    num_folds = log2_trace  # the composition's degree is below n
    # HBM bytes touched per phase (reads + writes): the NTTs ~6 passes of
    # the trace INTT and the LDE, the trees' leaves and two digests a
    # node, three passes a fold
    ntt_bytes = 4 * (6 * _ELEM * (n + big))
    merkle_leaves = 2 * big + sum(big >> (k + 1) for k in range(num_folds))
    merkle_bytes = merkle_leaves * (_ELEM + 2 * _DIGEST)
    fri_bytes = sum((big >> k) * _ELEM * 3 for k in range(num_folds))
    compute_bytes = ntt_bytes + merkle_bytes + fri_bytes
    collectives = prove_collectives(log2_trace, blowup, s, num_folds,
                                    2 * blowup, ranks=s)
    wire_bytes = sum(c.wire_bytes for c in collectives)
    t_compute = compute_bytes / s / (hbm_gbps * 1e9)
    t_wire = wire_bytes / s / (wire_gbps * 1e9) if s > 1 else 0.0
    return {"devices": s, "compute_bytes": compute_bytes,
            "wire_bytes": wire_bytes,
            "wire_bytes_by_kind": stats_bytes(collectives),
            "t_model_s": t_compute + t_wire,
            "t_compute_s": t_compute, "t_wire_s": t_wire}


def scaling_report(log2_trace: int = 20, blowup: int = 8,
                   device_counts=(1, 2, 4, 8, 16, 32),
                   hbm_gbps: float = HBM_GBPS,
                   link_gbps: float = NVLINK_GBPS) -> dict:
    """Projected scaling-efficiency table, Efficiency(s) = T(1) / (s *
    T(s)), over the H100's data-sheet rates (a model, not a
    measurement).  Each row's ``wire_bytes_by_kind`` is what the
    process mesh's ``Mesh.stats`` sum to over the ranks."""
    rows = [_phase_model(log2_trace, blowup, s, hbm_gbps, link_gbps)
            for s in device_counts]
    t1 = rows[0]["t_model_s"]
    for r in rows:
        r["efficiency"] = t1 / (r["devices"] * r["t_model_s"])
    return {"log2_trace": log2_trace, "blowup": blowup,
            "hbm_gbps": hbm_gbps, "link_gbps": link_gbps,
            "rates": "NVIDIA H100 SXM data sheet (specifications)",
            "rows": rows}


def write_scaling_report(path: str, **kw) -> dict:
    """:func:`scaling_report` written as JSON to `path`."""
    rep = scaling_report(**kw)
    with open(path, "w") as f:
        json.dump(rep, f, indent=1)
    return rep
