"""Communication accounting of a sharded prove (counterpart of the
analytic half of ``stark_tpu/dist/comm.py``).

Exact byte counts of every array a mesh prove sends between shards,
derived from the shard layout, not measured: the four-step NTT's three
all-to-alls, the subtree-root gathers of the Merkle trees, the
composition's halo, the FRI fold exchanges and the FRI tail gather.
The counterpart of the JAX package's HLO cross-check is the mesh's own
copy counter (:meth:`Mesh.send`): the tests hold the bytes a prove
actually copies against :func:`prove_collectives`.

The port's exchanges are those of one process driving every shard: a
gather goes to the first shard only (the JAX package replicates to
every chip), and the drawn challenges, read by every shard, are not
arrays and are not counted.  Bandwidth figures and the scaling
projection of the JAX module are TPU figures and are not carried over.
"""

from __future__ import annotations

import dataclasses

from stark_tpu_torch.dist.merkle import shards_tree

_DIGEST = 32  # SHA-256 digest


@dataclasses.dataclass
class CollectiveVolume:
    """Bytes of one logical collective, summed over the shards."""

    name: str  # e.g. "ntt/all_to_all[0]"
    kind: str  # all_to_all | gather | permute | halo | scatter
    wire_bytes: int  # bytes crossing shard boundaries, all shards
    per_chip_bytes: int  # bytes one shard sends (or the first receives)


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
                      halo: int, columns: int = 1,
                      elem: int = 4) -> list[CollectiveVolume]:
    """Every array one mesh prove sends between shards: the trace
    coefficients scattered to the shards whose block of the padded LDE
    input they reach, the LDE's NTT, the trace tree, the composition's
    halo (`halo` points of every column from the next shards, the
    largest row shift times the blowup), then the FRI commit's trees and
    folds and, when a sharded fold made the last layer, its gather.
    (The JAX model also counts a trace INTT and a composition INTT/NTT
    that neither prove runs sharded.)"""
    n = 1 << log2_trace
    big = n * blowup
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


# the Mesh.stats kind each collective's bytes are counted under
STATS_KIND = {"all_to_all": "ntt", "scatter": "scatter", "halo": "halo",
              "permute": "fri"}


def stats_bytes(collectives) -> dict:
    """Bytes by ``Mesh.stats`` kind: tree root gathers under "merkle", the
    FRI tail gather under "fri", the rest by STATS_KIND."""
    out: dict[str, int] = {}
    for c in collectives:
        kind = ("merkle" if c.name.endswith("root_gather")
                else "fri" if c.kind == "gather" else STATS_KIND[c.kind])
        out[kind] = out.get(kind, 0) + c.wire_bytes
    return out
