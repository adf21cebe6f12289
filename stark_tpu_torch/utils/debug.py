"""Debug invariant checks (counterpart of ``stark_tpu/utils/debug.py``).

The risk they guard against is a non-canonical value (>= p) reaching
field arithmetic, e.g. a raw hash word used as a field element.

* :func:`assert_canonical` reduces on the tensor's device and fetches
  only the verdict (and, when it fails, the first bad index).
* :func:`check_canonical` returns its input and queues a device-side
  assertion, with no host synchronisation.
* ``STARK_TPU_TORCH_DEBUG=1`` turns :func:`maybe_assert_canonical` from a
  no-op into :func:`assert_canonical`; the prover calls it at each phase
  boundary (the trace, the LDE, the composition, the FRI layers).  Unset,
  it returns before touching the tensor.  The mega prove checks the
  trace and the LDE only, before its CUDA graph: a verdict fetch cannot
  sit inside the graph (as the JAX package's mega path).

Layouts: int32 storage words are read as uint32 (int64 compute values
as they are); for the Goldilocks prime a value is its (hi, lo) limb
pair, on the axis before the lanes ((2, n), (C, 2, n)) or a (2,) pair.
A tuple or list is checked entry by entry, and a mesh's ``Sharded``
block by block (the blocks this process holds).
"""

from __future__ import annotations

import os

import torch

MASK32 = 0xFFFFFFFF


def debug_enabled() -> bool:
    return bool(os.environ.get("STARK_TPU_TORCH_DEBUG"))


def _words(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & MASK32 if x.dtype == torch.int32 else x


def _over(x: torch.Tensor, p: int) -> torch.Tensor:
    """Bool mask of the values >= p: the lanes' shape (a Goldilocks
    value's limb axis reduced)."""
    if p < 1 << 32:
        if x.dtype != torch.int32:
            return x >= p
        # the unsigned word of int32 storage, compared without a copy
        return ((x < 0) & (x >= p - (1 << 32)) if p >= 1 << 31
                else (x < 0) | (x >= p))
    if x.dim() == 0 or (x.dim() == 1 and x.shape[0] != 2) or (
            x.dim() > 1 and x.shape[-2] != 2):
        raise AssertionError(
            f"modulus {p} >= 2^32 but shape {tuple(x.shape)} holds no "
            "(hi, lo) limb pair")
    hi, lo = (x[0], x[1]) if x.dim() == 1 else (x[..., 0, :], x[..., 1, :])
    # p = (2^32 - 1) * 2^32 + 1: a pair >= p has hi = 2^32 - 1, lo >= 1
    return (_words(hi) == MASK32) & (_words(lo) >= 1)


def _value(x: torch.Tensor, p: int, idx: int) -> int:
    if p < 1 << 32:
        return int(_words(x.reshape(-1)[idx]))
    hi, lo = (x[0], x[1]) if x.dim() == 1 else (x[..., 0, :], x[..., 1, :])
    return (int(_words(hi.reshape(-1)[idx])) << 32
            | int(_words(lo.reshape(-1)[idx])))


def _leaves(arr, name: str):
    """(name, tensor) of every tensor in `arr`."""
    blocks = getattr(arr, "blocks", None)
    if blocks is not None:
        return [leaf for b, t in enumerate(blocks) if t is not None
                for leaf in _leaves(t, f"{name}[block {b}]")]
    if isinstance(arr, (tuple, list)):
        return [leaf for c, a in enumerate(arr)
                for leaf in _leaves(a, f"{name}[col {c}]")]
    return [(name, torch.as_tensor(arr))]


def assert_canonical(arr, p: int, name: str = "array") -> None:
    """Raise AssertionError unless every value of `arr` lies in [0, p).
    One reduction a tensor on its device; one fetch of the verdicts a
    device."""
    leaves = _leaves(arr, name)
    masks = [_over(t, p) for _, t in leaves]
    bad = []
    for dev in {m.device for m in masks}:
        on = [i for i, m in enumerate(masks) if m.device == dev]
        hits = torch.stack([masks[i].any() for i in on]).tolist()
        bad += [i for i, hit in zip(on, hits) if hit]
    if bad:
        i = min(bad)
        (lname, t), m = leaves[i], masks[i]
        idx = int(torch.nonzero(m.reshape(-1))[0])
        raise AssertionError(
            f"{lname}: non-canonical value {_value(t, p, idx)} >= modulus "
            f"{p} at flat index {idx}")


def maybe_assert_canonical(arr, p: int, name: str = "array") -> None:
    """:func:`assert_canonical` when STARK_TPU_TORCH_DEBUG is set; it
    returns at once otherwise, without touching `arr`."""
    if debug_enabled():
        assert_canonical(arr, p, name)


def check_canonical(x: torch.Tensor, p: int) -> torch.Tensor:
    """Return `x` and queue the assertion that every value is canonical,
    without a host synchronisation.  It is ``torch._assert_async``: on a
    CPU tensor it raises RuntimeError at once; on a CUDA tensor it is a
    device-side assertion that fails the stream's next synchronising call
    (and, as every CUDA device assert, leaves the context unusable)."""
    torch._assert_async(~_over(x, p).any(),
                        "non-canonical field value (>= modulus)")
    return x
