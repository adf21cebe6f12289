"""The composition polynomial over a mesh (the sharded counterpart of the
contexts' ``compose`` in ``stark/air.py`` and ``stark/air_builder.py``;
the JAX package lets GSPMD partition its rolls).

A composer reads the LDE at x and at x * w^(b s) for each row shift s of
the AIR (b the blowup): a roll by b s along the domain.  On a mesh each
shard composes its own block from its block followed by a halo of the
next max(b s) lanes, taken from the shards after it and wrapping from
the last shard to shard 0 (on a process mesh, the pieces of another
rank's blocks are the messages of one all-to-all), with a context whose tables cover only its
block's lanes (built once per shard and cached; S blocks cost one whole
build).  The output is sharded like the LDE, and equal to the
single-device composition lane for lane.
"""

from __future__ import annotations

import torch

from stark_tpu_torch.dist.mesh import Sharded, replicated


def halos(lde: Sharded, halo: int) -> list:
    """For each block d this process holds, the `halo` lanes after it
    (cyclic) on shard d's device, from one exchange of every block's
    pieces; None for another process's blocks."""
    mesh, k, s = lde.mesh, lde.block_len, lde.mesh.size
    lead = tuple(lde._any().shape[:-1])
    items, spans = [], []
    for d in range(s):
        start, need, b = len(items), halo, d
        while need > 0:
            b = (b + 1) % s
            take = min(need, k)
            t = lde.blocks[b]
            items.append((lde.owners[b], lde.owners[d],
                          None if t is None else t[..., :take],
                          lead + (take,)))
            need -= take
        spans.append((start, len(items)))
    got = mesh.exchange(items, "halo")
    return [None if lde.blocks[d] is None else got[a:b]
            for d, (a, b) in enumerate(spans)]


def compose_sharded(air, cfg, lde: Sharded, alphas, publics: dict,
                    context) -> Sharded:
    """The composition of `air` on the sharded LDE.  `context(block,
    device)` returns the AIR's context of the lanes block = (start,
    size) on `device` (cached by the caller); `alphas` are the drawn
    challenges on this process's first shard (every rank draws them
    alike)."""
    mesh, k = lde.mesh, lde.block_len
    per_shard = list(zip(*(replicated(mesh, a) for a in alphas)))
    pieces = halos(lde, max(air.shifts) * cfg.blowup)

    def compose(block, d):
        own = lde.owners[d]
        ctx = context((d * k, k), mesh.devices[own])
        return ctx.compose(torch.cat([block, *pieces[d]], dim=-1),
                           per_shard[own], publics)

    return lde.map(compose)
