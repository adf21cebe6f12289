"""Device mesh (counterpart of ``stark_tpu/dist/mesh.py``).

The evaluation domain is the unit of sharding: a 1-D mesh axis
``"shard"`` carries contiguous blocks of the domain.  A :class:`Mesh` is
the global, ordered list of shards, a sharded array a list of blocks,
block b held by the shard ``owners[b]`` (:class:`Sharded`).  A device may
repeat: several logical shards on one card (or on the CPU, as the tests
run) run the sharded algorithm, its exchanges and its kernels, without
splitting memory across cards.

One process (``make_mesh(devices=...)``), as the JAX package's
single-controller mesh: every shard is this process's, and an exchange
is a set of copies between its devices.  Between distinct CUDA devices
the copy is ``Tensor.to(device, non_blocking=True)``, which PyTorch
orders against both devices' current streams; a mesh of distinct CUDA
devices needs peer access between every pair (K5's query form reads
every shard from the first device), and raises at construction where the
CUDA runtime refuses it.  On a repeated device a copy returns the block
itself: the consumer's concatenation is the copy.

A process mesh (``make_mesh(devices=..., backend="gloo" | "nccl")``
after ``distributed_initialize``; ``multihost.global_mesh``): shard i is
a (rank, device) pair, every rank's local devices in rank order, each
rank the same number of them.  A ``Sharded`` on a rank holds only the
blocks its shards own (None for the others), and every rank runs the
same sequence of exchanges, each one collective of the process group:
:meth:`Mesh.exchange` packs every block piece bound for another rank
into one ``all_to_all_single``, so a transpose of the four-step NTT is
one collective whatever the shards a rank holds; a piece sent to every
rank (a tree's subtree roots, the gathered FRI tail) is an all-gather,
and the data it builds is replicated.  NCCL takes CUDA tensors (one card
a rank); gloo takes CPU tensors, so CUDA tensors go through pinned host
memory.  Nothing falls back to another transport: a failed collective
raises.  Data every rank holds whole (the trace, its coefficients) is
sliced where it lies, with no exchange.

Every array an exchange moves is counted in ``Mesh.stats`` (copies and
bytes, by kind): in one process each copy between two shards, whether
they share a device or not; on a process mesh each piece this rank sends
to another rank (once a receiving rank).  ``stark_tpu_torch.dist.comm``
predicts both counts (its `ranks` argument for the process mesh, the sum
over the ranks).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

SHARD_AXIS = "shard"


def _device(d) -> torch.device:
    """A torch device with its index filled in ("cuda" -> "cuda:<cur>")."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A 1-D mesh: shard i lives on ``devices[i]`` (devices may repeat)
    of process ``ranks[i]`` (None: every shard is this process's).  The
    shard count must be a power of two: the domain is split into equal
    power-of-two blocks."""

    def __init__(self, devices, ranks=None, rank: int = 0):
        s = len(devices)
        if s < 1 or s & (s - 1):
            raise ValueError(f"a mesh needs a power-of-two shard count, got "
                             f"{s}")
        self.ranks = None if ranks is None else tuple(int(r) for r in ranks)
        self.rank = int(rank)
        if self.ranks is not None and (len(self.ranks) != s
                                       or list(self.ranks) != sorted(
                                           self.ranks)):
            raise ValueError("a process mesh lists each rank's shards "
                             "together, in rank order")
        self.world = 1 if self.ranks is None else self.ranks[-1] + 1
        self.local = tuple(i for i in range(s) if self.owns(i))
        if not self.local or s % self.world or len(self.local) != s // \
                self.world:
            raise ValueError(f"every rank of a process mesh holds the same "
                             f"number of shards: {self.ranks}")
        # another rank's devices are named as that rank reported them
        self.devices = tuple(_device(d) if self.owns(i) else torch.device(d)
                             for i, d in enumerate(devices))
        distinct = sorted({self.devices[i] for i in self.local
                           if self.devices[i].type == "cuda"}, key=str)
        for a in distinct:
            for b in distinct:
                if a != b and not torch.cuda.can_device_access_peer(a, b):
                    raise ValueError(
                        f"{a} cannot access {b}: a mesh of distinct cards "
                        "in one process needs peer access between every "
                        "pair")
        # kind -> [copies, bytes] of the arrays sent between shards (on a
        # process mesh: from this rank to another)
        self.stats: dict[str, list[int]] = {}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def process(self) -> bool:
        """Whether the shards span several processes."""
        return self.world > 1

    def owns(self, shard: int) -> bool:
        """Whether `shard` is this process's."""
        return self.ranks is None or self.ranks[shard] == self.rank

    @property
    def first(self) -> torch.device:
        """The device of this process's first shard: the Fiat-Shamir
        state, the top tree levels, the gathered FRI tail and K5's query
        form live there (replicated on every rank of a process mesh)."""
        return self.devices[self.local[0]]

    @property
    def local_devices(self) -> set:
        return {self.devices[i] for i in self.local}

    def _count(self, kind: str | None, t: torch.Tensor) -> None:
        if kind is not None:
            entry = self.stats.setdefault(kind, [0, 0])
            entry[0] += 1
            entry[1] += t.numel() * t.element_size()

    def _copy(self, t: torch.Tensor, src: int, dst: int,
              kind: str | None) -> torch.Tensor:
        """Block `t` of shard `src` as shard `dst` reads it, in one
        process; counted under `kind` when the shards differ."""
        if src != dst:
            self._count(kind, t)
        dev = self.devices[dst]
        return t if t.device == dev else t.to(dev, non_blocking=True)

    def take(self, t: torch.Tensor, dst: int, kind: str) -> torch.Tensor:
        """A piece of an array every process holds whole (`t`, on this
        process's device), as shard `dst` reads it: in one process a copy
        counted from the shard on `t`'s device (the first when none is);
        on a process mesh nothing crosses, `dst` being this rank's."""
        if self.process:
            dev = self.devices[dst]
            return t if t.device == dev else t.to(dev)
        src = next((i for i, d in enumerate(self.devices) if d == t.device),
                   0)
        return self._copy(t, src, dst, kind)

    def exchange(self, items, kind: str | None) -> list:
        """Move pieces between shards, every rank calling with the same
        `items`: (src shard, dst shard or None, the piece on src's
        process (else None), its shape) of int32 pieces; dst None sends
        the piece to every process's first shard.  Returns, item by item,
        the piece on its destination's device where this process is one
        (else None).  In one process each item is a device copy; on a
        process mesh it is one ``all_to_all_single`` of every piece bound
        for another rank (none when nothing crosses), counted under
        `kind` on the sending rank, once a receiving rank (None: not
        counted)."""
        items = list(items)
        if not self.process:
            return [self._copy(t, src, self.local[0] if dst is None else
                               dst, kind) for src, dst, t, _ in items]
        out = [None] * len(items)
        sends = [[] for _ in range(self.world)]  # pieces, by rank
        recvs = [[] for _ in range(self.world)]  # (item, shape), by rank
        crosses = False  # alike on every rank: the items are
        for k, (src, dst, t, shape) in enumerate(items):
            r_src = self.ranks[src]
            ranks = range(self.world) if dst is None else (self.ranks[dst],)
            dev = self.first if dst is None else self.devices[dst]
            for r in ranks:
                crosses |= r != r_src
                if r_src == self.rank == r:
                    out[k] = t if t.device == dev else t.to(dev)
                elif r_src == self.rank:
                    if t.dtype != torch.int32:
                        raise TypeError(f"exchange moves int32 pieces, got "
                                        f"{t.dtype}")
                    sends[r].append(t)
                    self._count(kind, t)
                elif r == self.rank:
                    recvs[r_src].append((k, tuple(shape), dev))
        if not crosses:
            return out
        got = _all_to_all(self, sends, [[math.prod(sh) for _, sh, _ in rv]
                                        for rv in recvs])
        for rv, pieces in zip(recvs, got):
            for (k, shape, dev), piece in zip(rv, pieces):
                out[k] = piece.view(shape).to(dev)
        return out

    def all_reduce_(self, t: torch.Tensor, kind: str | None) -> None:
        """Sum the int32 tensor `t` over the processes, in place (counted
        under `kind` as what this rank contributes)."""
        if not self.process:
            return
        self._count(kind, t)
        buf = _transport(self, t)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
        if buf is not t:
            t.copy_(buf)

    def reset_stats(self) -> None:
        self.stats.clear()

    def copied_bytes(self) -> int:
        return sum(b for _, b in self.stats.values())

    def __repr__(self) -> str:
        if not self.process:
            return f"Mesh({', '.join(map(str, self.devices))})"
        shards = ", ".join(f"{r}:{d}" for r, d in zip(self.ranks,
                                                       self.devices))
        return f"Mesh({shards}; rank {self.rank}, {dist.get_backend()})"


def _staged() -> bool:
    """Whether the process group takes host tensors (gloo), so CUDA data
    goes through pinned host memory."""
    return dist.get_backend() != "nccl"


def _transport(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """`t` where the process group reads it: itself under NCCL or when it
    lies on the CPU, else a pinned host copy (gloo)."""
    if not _staged() or t.device.type == "cpu":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _all_to_all(mesh: Mesh, sends, recv_sizes) -> list:
    """One ``all_to_all_single`` of int32 words: `sends[r]` the pieces for
    rank r (in item order), `recv_sizes[r]` the sizes of the pieces from
    rank r.  Returns, by rank, the received pieces as flat views."""
    staged = _staged()
    dev = torch.device("cpu") if staged else mesh.first
    pin = staged and any(t.is_cuda for ts in sends for t in ts)
    out_splits = [sum(sz) for sz in recv_sizes]
    in_splits = [sum(t.numel() for t in ts) for ts in sends]
    inp = torch.empty(sum(in_splits), dtype=torch.int32, device=dev,
                      pin_memory=pin)
    pos = 0
    for ts in sends:
        for t in ts:
            inp[pos:pos + t.numel()].copy_(t.reshape(-1))
            pos += t.numel()
    out = torch.empty(sum(out_splits), dtype=torch.int32, device=dev,
                      pin_memory=pin)
    dist.all_to_all_single(out, inp, out_splits, in_splits)
    got, pos = [], 0
    for sizes in recv_sizes:
        pieces = []
        for n in sizes:
            pieces.append(out[pos:pos + n])
            pos += n
        got.append(pieces)
    return got


def rank_device() -> torch.device:
    """This process's card in a process group: ``cuda:<LOCAL_RANK>`` (as
    torchrun sets it), else the rank modulo the cards visible.  Raises
    where no CUDA device is visible."""
    import os

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards == 0:
        raise ValueError("no CUDA device is visible: name this process's "
                         "devices (e.g. devices=[\"cpu\"]) for a CPU mesh")
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", int(local) if local is not None
                        else dist.get_rank() % cards)


def make_mesh(n_devices: int | None = None, devices=None,
              backend: str | None = None) -> Mesh:
    """A mesh over the first `n_devices` of `devices` (default: every
    visible GPU; a device may repeat, e.g. ``["cuda:0"] * 4`` or
    ``["cpu"] * 2`` for logical shards).  Raises when there are fewer.

    `backend` asks for a process mesh: it must name the backend of the
    process group ``distributed_initialize`` formed ("gloo" or "nccl"),
    `devices` are this rank's local ones (default: :func:`rank_device`)
    and the global mesh is every rank's, in rank order.  One process
    with a backend is the one-process mesh."""
    if backend is not None and not dist.is_initialized():
        raise ValueError(f"a {backend} mesh needs the process group: call "
                         "stark_tpu_torch.dist.distributed_initialize first")
    if devices is None:
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if backend is None or dist.get_world_size() == 1
                   else [rank_device()])
    devices = list(devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have "
                             f"{len(devices)}")
        devices = devices[:n_devices]
    if backend is None or dist.get_world_size() == 1:
        return Mesh(devices)
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, not "
                         f"{backend}")
    local = [_device(d) for d in devices]
    if backend == "nccl":
        torch.cuda.set_device(local[0])
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, [str(d) for d in local])
    return Mesh([d for ds in every for d in ds],
                ranks=[r for r, ds in enumerate(every) for _ in ds],
                rank=dist.get_rank())


class Sharded:
    """An array split along its last axis into equal contiguous blocks:
    block b (a tensor of shape lead + (n / S,)) is held by shard
    ``owners[b]`` on that shard's device, and is None on a process that
    does not hold it.  Owners are 0..S-1 in order except after a sharded
    FRI fold, which interleaves them."""

    def __init__(self, blocks, mesh: Mesh, owners=None):
        self.blocks = tuple(blocks)
        self.mesh = mesh
        self.owners = tuple(owners if owners is not None
                            else range(len(self.blocks)))
        if len(self.blocks) != mesh.size or len(self.owners) != mesh.size:
            raise ValueError(f"{len(self.blocks)} blocks on a mesh of "
                             f"{mesh.size} shards")

    def _any(self) -> torch.Tensor:
        """A block this process holds (they all have one shape)."""
        return next(t for t in self.blocks if t is not None)

    @property
    def block_len(self) -> int:
        return int(self._any().shape[-1])

    @property
    def shape(self) -> tuple:
        b = self._any()
        return tuple(b.shape[:-1]) + (self.block_len * len(self.blocks),)

    def map(self, fn) -> "Sharded":
        """fn(block, b) on every block this process holds, same owners."""
        return Sharded([None if t is None else fn(t, b)
                        for b, t in enumerate(self.blocks)], self.mesh,
                       self.owners)

    def __getitem__(self, i) -> "Sharded":
        """Index the leading axes of every block (a column of a C-column
        LDE)."""
        return self.map(lambda t, _: t[i])

    def rows(self) -> "RowBlocks":
        """The row view BatchGather takes: element i of the whole array is
        row i ((n,) blocks as they are; (2, n) limb planes as (n, 2))."""
        if self.mesh.process:
            raise ValueError("BatchGather reads every block: not on a "
                             "process mesh")
        return RowBlocks([b.T if b.dim() == 2 else b for b in self.blocks],
                         self.block_len)

    def join(self, device=None) -> torch.Tensor:
        """The whole array on `device` (default this process's first
        shard's; on a process mesh an all-gather, on every rank); for
        tests and arrays too small to shard, never for a prove's sharded
        arrays.  Not counted."""
        device = self.mesh.first if device is None else device
        blocks = self.blocks
        if self.mesh.process:
            shape = tuple(self._any().shape)
            blocks = self.mesh.exchange(
                [(o, None, t, shape) for t, o in zip(blocks, self.owners)],
                None)
        return torch.cat([b.to(device) for b in blocks], dim=-1)


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
    block i on shard i's device: in one process counted under "scatter"
    as copied from the shard that holds `x`'s device (shard 0 when none
    does); on a process mesh, where every rank holds `x` whole, each
    rank slices its own blocks."""
    n, s = int(x.shape[-1]), mesh.size
    if n % s:
        raise ValueError(f"{n} points do not split into {s} shards")
    k = n // s
    return Sharded([mesh.take(x[..., i * k:(i + 1) * k].contiguous(), i,
                              "scatter") if mesh.owns(i) else None
                    for i in range(s)], mesh)


def replicated(mesh: Mesh, x) -> tuple:
    """`x` (a drawn challenge: a scalar or a limb pair, which every rank
    draws alike) as each of this process's shards reads it: one entry a
    shard (None for another process's), `x` itself on its own device (a
    host int as it is).  Not counted: the counter measures array
    exchanges."""
    return tuple(None if not mesh.owns(i)
                 else x if not torch.is_tensor(x) or d == x.device
                 else x.to(d, non_blocking=True)
                 for i, d in enumerate(mesh.devices))


def shard_spec() -> int:
    """The axis a mesh splits: the last (the evaluation domain's)."""
    return -1
