"""The composition polynomial over a mesh (the sharded counterpart of the
contexts' ``compose`` in ``stark/air.py`` and ``stark/air_builder.py``;
the JAX package lets GSPMD partition its rolls).

A composer reads the LDE at x and at x * w^(b s) for each row shift s of
the AIR (b the blowup): a roll by b s along the domain.  On a mesh each
shard composes its own block from its block followed by a halo of the
next max(b s) lanes, taken from the shards after it and wrapping from
the last shard to shard 0, with a context whose tables cover only its
block's lanes (built once per shard and cached; S blocks cost one whole
build).  The output is sharded like the LDE, and equal to the
single-device composition lane for lane.
"""

from __future__ import annotations

import torch

from stark_tpu_torch.dist.mesh import Sharded, replicated


def halo_block(lde: Sharded, d: int, halo: int) -> torch.Tensor:
    """Block d of `lde` followed by the `halo` lanes after it (cyclic), on
    shard d's device."""
    mesh, k = lde.mesh, lde.block_len
    parts = [lde.blocks[d]]
    need, b = halo, d
    while need > 0:
        b = (b + 1) % mesh.size
        take = min(need, k)
        parts.append(mesh.send(lde.blocks[b][..., :take], lde.owners[b],
                               lde.owners[d], "halo"))
        need -= take
    return torch.cat(parts, dim=-1)


def compose_sharded(air, cfg, lde: Sharded, alphas, publics: dict,
                    context) -> Sharded:
    """The composition of `air` on the sharded LDE.  `context(block,
    device)` returns the AIR's context of the lanes block = (start,
    size) on `device` (cached by the caller); `alphas` are the first
    shard's drawn challenges."""
    mesh, k = lde.mesh, lde.block_len
    halo = max(air.shifts) * cfg.blowup
    per_shard = list(zip(*(replicated(mesh, a) for a in alphas)))
    out = []
    for d in range(mesh.size):
        dev = mesh.devices[lde.owners[d]]
        ctx = context((d * k, k), dev)
        out.append(ctx.compose(halo_block(lde, d, halo),
                               per_shard[lde.owners[d]], publics))
    return Sharded(out, mesh, lde.owners)
