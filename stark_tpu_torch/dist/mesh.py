"""Device mesh (counterpart of ``stark_tpu/dist/mesh.py``).

The evaluation domain is the unit of sharding: a 1-D mesh axis
``"shard"`` carries contiguous blocks of the domain.  The JAX package's
mesh is single-controller, one process driving every device of the host;
so is this one: a :class:`Mesh` is an ordered tuple of torch devices in
one process, a sharded array is a list of blocks, block b held by shard
b's device (:class:`Sharded`), and a collective is a set of copies
between those devices.  A device may repeat: several logical shards on
one card (or on the CPU, as the tests run) run the sharded algorithm,
its exchanges and its kernels, without splitting memory across cards.

Every copy of an array between two shards goes through
:meth:`Mesh.send`, which counts it (copies and bytes, by kind) whether
the two shards share a device or not; :mod:`stark_tpu_torch.dist.comm`
predicts the same counts.  Between distinct CUDA devices the copy is
``Tensor.to(device, non_blocking=True)``, which PyTorch orders against
both devices' current streams; a mesh of distinct CUDA devices needs
peer access between every pair (K5's query form reads every shard from
the first device), and raises at construction where the driver refuses
it.  On a repeated device ``send`` returns the block itself: the
consumer's concatenation is the copy.
"""

from __future__ import annotations

import torch

SHARD_AXIS = "shard"


def _device(d) -> torch.device:
    """A torch device with its index filled in ("cuda" -> "cuda:<cur>")."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A 1-D mesh: shard i lives on ``devices[i]`` (devices may repeat).
    The shard count must be a power of two: the domain is split into
    equal power-of-two blocks."""

    def __init__(self, devices):
        devices = tuple(_device(d) for d in devices)
        s = len(devices)
        if s < 1 or s & (s - 1):
            raise ValueError(f"a mesh needs a power-of-two shard count, got "
                             f"{s}")
        self.devices = devices
        distinct = sorted({d for d in devices if d.type == "cuda"},
                          key=str)
        for a in distinct:
            for b in distinct:
                if a != b and not torch.cuda.can_device_access_peer(a, b):
                    raise ValueError(
                        f"{a} cannot access {b}: a mesh of distinct cards "
                        "needs peer access between every pair")
        # kind -> [copies, bytes] of the arrays sent between shards
        self.stats: dict[str, list[int]] = {}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        """The device of shard 0: the Fiat-Shamir state, the top tree
        levels, the gathered FRI tail and K5's query form live there."""
        return self.devices[0]

    def send(self, t: torch.Tensor, src: int, dst: int,
             kind: str) -> torch.Tensor:
        """Block `t` of shard `src` as shard `dst` reads it; counted under
        `kind` when the shards differ."""
        if src != dst:
            entry = self.stats.setdefault(kind, [0, 0])
            entry[0] += 1
            entry[1] += t.numel() * t.element_size()
        dev = self.devices[dst]
        return t if t.device == dev else t.to(dev, non_blocking=True)

    def reset_stats(self) -> None:
        self.stats.clear()

    def copied_bytes(self) -> int:
        return sum(b for _, b in self.stats.values())

    def __repr__(self) -> str:
        return f"Mesh({', '.join(map(str, self.devices))})"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh over the first `n_devices` of `devices` (default: every
    visible GPU; a device may repeat, e.g. ``["cuda:0"] * 4`` or
    ``["cpu"] * 2`` for logical shards).  Raises when there are fewer."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have "
                             f"{len(devices)}")
        devices = devices[:n_devices]
    return Mesh(devices)


class Sharded:
    """An array split along its last axis into equal contiguous blocks:
    block b (a tensor of shape lead + (n / S,)) is held by shard
    ``owners[b]`` on that shard's device.  Owners are 0..S-1 in order
    except after a sharded FRI fold, which interleaves them."""

    def __init__(self, blocks, mesh: Mesh, owners=None):
        self.blocks = tuple(blocks)
        self.mesh = mesh
        self.owners = tuple(owners if owners is not None
                            else range(len(self.blocks)))
        if len(self.blocks) != mesh.size or len(self.owners) != mesh.size:
            raise ValueError(f"{len(self.blocks)} blocks on a mesh of "
                             f"{mesh.size} shards")

    @property
    def block_len(self) -> int:
        return int(self.blocks[0].shape[-1])

    @property
    def shape(self) -> tuple:
        b = self.blocks[0]
        return tuple(b.shape[:-1]) + (self.block_len * len(self.blocks),)

    def __getitem__(self, i) -> "Sharded":
        """Index the leading axes of every block (a column of a C-column
        LDE)."""
        return Sharded([b[i] for b in self.blocks], self.mesh, self.owners)

    def rows(self) -> "RowBlocks":
        """The row view BatchGather takes: element i of the whole array is
        row i ((n,) blocks as they are; (2, n) limb planes as (n, 2))."""
        return RowBlocks([b.T if b.dim() == 2 else b for b in self.blocks],
                         self.block_len)

    def join(self, device=None) -> torch.Tensor:
        """The whole array on `device` (default the mesh's first); for
        tests and arrays too small to shard, never for a prove's sharded
        arrays."""
        device = self.mesh.first if device is None else device
        return torch.cat([b.to(device) for b in self.blocks], dim=-1)


class RowBlocks:
    """Rows spread over blocks of `rows` rows each (the row view of a
    :class:`Sharded`): :meth:`locate` maps a global row to (block tensor,
    local row)."""

    def __init__(self, blocks, rows: int):
        self.blocks = tuple(blocks)
        self.rows = rows
        self.shape = (rows * len(self.blocks),) + tuple(
            self.blocks[0].shape[1:])

    def locate(self, row: int):
        return self.blocks[row // self.rows], row % self.rows


def sharded(mesh: Mesh, x: torch.Tensor) -> Sharded:
    """`x` split along its last axis into mesh.size contiguous blocks,
    block i on shard i's device (counted under "scatter" as copied from
    the shard that holds `x`'s device, shard 0 when none does)."""
    n, s = int(x.shape[-1]), mesh.size
    if n % s:
        raise ValueError(f"{n} points do not split into {s} shards")
    src = next((i for i, d in enumerate(mesh.devices) if d == x.device), 0)
    k = n // s
    return Sharded([mesh.send(x[..., i * k:(i + 1) * k].contiguous(), src, i,
                              "scatter") for i in range(s)], mesh)


def replicated(mesh: Mesh, x: torch.Tensor) -> tuple:
    """`x` (a drawn challenge: a scalar or a limb pair) as each shard reads
    it: one tensor per shard, `x` itself on its own device (a host int as
    it is).  Not counted: the counter measures array exchanges."""
    if not torch.is_tensor(x):
        return (x,) * mesh.size
    return tuple(x if d == x.device else x.to(d, non_blocking=True)
                 for d in mesh.devices)


def shard_spec() -> int:
    """The axis a mesh splits: the last (the evaluation domain's)."""
    return -1
