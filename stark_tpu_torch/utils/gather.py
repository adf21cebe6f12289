"""Packed device->host fetches (counterpart of ``stark_tpu/utils/gather.py``
and of the JAX package's ``utils/packfetch.py``).

:func:`fetch_packed` copies several device tensors to the host as ONE
``.cpu()`` of their words (:func:`pack_words` on the device, then
:func:`unpack_words` on the host: the single-dispatch prove packs inside
its CUDA graph and copies after the replay); :class:`BatchGather` collects row requests
against a fixed tuple of device tensors and resolves them with one
flat index upload, one gather per tensor on the device and one such
fetch (the per-query host loop of the per-phase prove and of
``fri/commit.py`` ``decommit_fri``).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def pack_words(tensors) -> torch.Tensor:
    """The device half of :func:`fetch_packed`: every tensor's values as
    int32 words (an int64 tensor's low 32 bits), flattened into one
    tensor on their device (inside the single-dispatch prove's graph)."""
    return torch.cat([t.reshape(-1).to(torch.int32) for t in tensors])


def unpack_words(host: np.ndarray, shapes) -> list[np.ndarray]:
    """The host half: the fetched words of :func:`pack_words`, split into
    numpy arrays of the tensors' `shapes`."""
    out, pos = [], 0
    for shape in shapes:
        n = math.prod(shape)
        out.append(host[pos:pos + n].reshape(shape))
        pos += n
    return out


def fetch_packed(tensors) -> list[np.ndarray]:
    """Every tensor's values as int32 words (an int64 tensor's low 32
    bits), in one device->host copy: numpy arrays of the tensors'
    shapes."""
    tensors = list(tensors)
    if not tensors:
        return []
    return unpack_words(pack_words(tensors).cpu().numpy(),
                        [tuple(t.shape) for t in tensors])


class BatchGather:
    """Accumulates row requests against a fixed tuple of device tensors,
    resolved by :meth:`run` in one gather per tensor and one host fetch.

    Usage::

        bg = BatchGather((values, tree.buffer, ...))
        h1 = bg.want(0, idx)          # row of arrays[0]
        h2 = bg.want(1, row)          # row of arrays[1]
        bg.run()
        value = bg.value_u64(h1)      # a field element, as a host int
        digest = bg.digest(h2)        # an (n, 8) digest row: 32 bytes

    A row is one element along axis 0: of a 1-D value tensor, an (n, 2)
    limb-pair view, an (n, 8) digest buffer.  (The JAX package's `axes`
    served its plane-form tree levels; the port's trees store rows.)

    With `mesh` (a ``dist.mesh.Mesh``) an array may also be sharded: an
    object whose ``locate(row)`` names the tensor and local row holding a
    global row (``Sharded.rows()``, a ``DistMerkleTree``); each tensor's
    rows are gathered on its own device and the packed result goes to the
    mesh's first device for the one fetch, so no array is gathered
    whole."""

    def __init__(self, arrays: tuple, mesh=None):
        self.arrays = tuple(arrays)
        self.mesh = mesh
        self._reqs: list[list[int]] = [[] for _ in self.arrays]
        self._handles: list[tuple[int, int]] = []
        self._result: np.ndarray | None = None
        self._offsets: list[int] | None = None

    def _row_elems(self, i: int) -> int:
        return int(np.prod(self.arrays[i].shape[1:], dtype=np.int64))

    def want(self, array_i: int, row: int) -> int:
        """Request a row; returns a handle resolved after run()."""
        self._reqs[array_i].append(int(row))
        self._handles.append((array_i, len(self._reqs[array_i]) - 1))
        return len(self._handles) - 1

    def run(self) -> None:
        """One upload of every requested row index, one gather a tensor,
        one fetch of the packed rows."""
        if self.mesh is not None:
            return self._run_mesh()
        flat = [r for reqs in self._reqs for r in reqs]
        dev = self.arrays[0].device
        idx = torch.tensor(flat, dtype=torch.int64, device=dev)
        parts, offs, acc, pos = [], [], 0, 0
        for i, (arr, reqs) in enumerate(zip(self.arrays, self._reqs)):
            offs.append(acc)
            if reqs:
                rows = arr.index_select(0, idx[pos:pos + len(reqs)])
                parts.append(rows.reshape(-1))
            pos += len(reqs)
            acc += len(reqs) * self._row_elems(i)
        self._result = (fetch_packed([torch.cat(parts)])[0].view(np.uint32)
                        if parts else np.zeros(0, np.uint32))
        self._offsets = offs

    def _run_mesh(self) -> None:
        """The gather over a mesh: the rows of each tensor (a sharded
        array's block, a tree's subtree or top buffer) gathered on its
        device, moved to the first shard, one fetch."""
        first = self.mesh.first
        parts, offs, acc = [], [], 0
        for i, (arr, reqs) in enumerate(zip(self.arrays, self._reqs)):
            offs.append(acc)
            acc += len(reqs) * self._row_elems(i)
            if not reqs:
                continue
            located = ([arr.locate(r) for r in reqs]
                       if hasattr(arr, "locate") else [(arr, r) for r in reqs])
            groups: dict[int, tuple] = {}
            for k, (t, row) in enumerate(located):
                groups.setdefault(id(t), (t, [], []))
                groups[id(t)][1].append(k)
                groups[id(t)][2].append(row)
            rows = torch.empty((len(reqs), self._row_elems(i)),
                               dtype=torch.int32, device=first)
            for t, ks, locs in groups.values():
                got = t.index_select(0, torch.tensor(locs, device=t.device))
                rows[torch.tensor(ks, device=first)] = got.reshape(
                    len(ks), -1).to(first)
            parts.append(rows.reshape(-1))
        self._result = (fetch_packed([torch.cat(parts)])[0].view(np.uint32)
                        if parts else np.zeros(0, np.uint32))
        self._offsets = offs

    def _slot(self, handle: int) -> tuple[int, int]:
        array_i, pos = self._handles[handle]
        row_elems = self._row_elems(array_i)
        return self._offsets[array_i] + pos * row_elems, row_elems

    def scalar(self, handle: int) -> int:
        start, row_elems = self._slot(handle)
        if row_elems != 1:
            raise ValueError("scalar() on a multi-element row")
        return int(self._result[start])

    def value_u64(self, handle: int) -> int:
        """A field element as a host int: a 1-element row is a u32
        value, a 2-element row the (hi, lo) limb pair of a Goldilocks
        value (limb planes enter the gather transposed to (n, 2))."""
        start, row_elems = self._slot(handle)
        if row_elems == 1:
            return int(self._result[start])
        if row_elems == 2:
            return (int(self._result[start]) << 32
                    | int(self._result[start + 1]))
        raise ValueError(f"value_u64() on a {row_elems}-element row")

    def digest(self, handle: int) -> bytes:
        start, row_elems = self._slot(handle)
        return self._result[start:start + row_elems].astype(">u4").tobytes()
