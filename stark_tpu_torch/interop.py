"""Converters between the JAX package's host values and the port's
tensors, configurations, statements and checkpoints — the port's
"weights carried across", used by the tests.

Field values and digest words are uint32 in JAX and int32 (same bits) in
the port, so numpy views carry them over without copying values; a
Goldilocks array is the same words as (hi, lo) limb planes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stark_tpu_torch.config import ProverConfig


def u32_to_tensor(arr, *, device) -> torch.Tensor:
    """numpy (or array-like) uint32 -> int32 storage tensor on `device`."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def tensor_to_u32(t: torch.Tensor) -> np.ndarray:
    """int32 storage tensor -> numpy uint32 (host copy)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32).copy()


def limbs_to_tensor(arr, *, device) -> torch.Tensor:
    """A JAX Goldilocks array, (2, n) or (C, 2, n) uint32 limb planes
    (hi, lo), -> the port's int32 storage of the same shape on `device`."""
    a = np.asarray(arr)
    if a.ndim < 2 or a.shape[-2] != 2:
        raise ValueError(f"limb planes are (2, n) or (C, 2, n), got "
                         f"{a.shape}")
    return u32_to_tensor(a, device=device)


def tensor_to_limbs(t: torch.Tensor) -> np.ndarray:
    """The port's (2, n) or (C, 2, n) int32 limb planes (storage or int64
    compute) -> numpy uint32 of the same shape, as the JAX package holds
    them."""
    if t.dim() < 2 or t.shape[-2] != 2:
        raise ValueError(f"limb planes are (2, n) or (C, 2, n), got "
                         f"{tuple(t.shape)}")
    return tensor_to_u32(t.to(torch.int32))


def state_to_hex(state: torch.Tensor) -> str:
    """(8,) Fiat-Shamir state words -> the channel's 64-char hex state."""
    return tensor_to_u32(state).astype(">u4").tobytes().hex()


def hex_to_state(state_hex: str, *, device) -> torch.Tensor:
    """64-char hex state -> (8,) int32 state words on `device`."""
    from stark_tpu_torch.channel.device_channel import state_words

    return state_words(state_hex, device)


def config_from(cfg) -> ProverConfig:
    """Any ProverConfig-like object (e.g. the JAX package's) -> the port's."""
    return ProverConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(ProverConfig)})


def config_fields(cfg: ProverConfig) -> dict:
    """The port's config as a plain dict (to build the JAX package's)."""
    return dataclasses.asdict(cfg)


def air_from(jax_air):
    """The port's AIR of the same statement as a JAX package AIR: a
    hand-written one rebuilt from its `name` and `witness_params()`; a
    declarative AirSpec rebuilt from its constructor fields (the step and
    transition functions are field-generic, so the same objects serve
    both packages) and bound to its witness and params.  The copy is not
    registered."""
    from stark_tpu_torch.stark.air import (FibMulAIR, FibonacciSquareAIR,
                                           MimcAIR)
    from stark_tpu_torch.stark.air_builder import AirSpec, Boundary

    for cls in (FibonacciSquareAIR, MimcAIR, FibMulAIR):
        if jax_air.name == cls.name:
            return cls(**jax_air.witness_params())
    if not hasattr(jax_air, "params_spec"):
        raise ValueError(f"unknown AIR {jax_air.name!r}")
    spec = AirSpec(
        name=jax_air.name, columns=jax_air.num_columns, init=jax_air.init,
        step=jax_air.step, transitions=jax_air.transitions,
        shifts=jax_air.shifts,
        boundaries=[Boundary(b.column, b.row, b.public)
                    for b in jax_air.boundaries],
        params=jax_air.params_spec, periodic=jax_air.periodic,
        register=False)
    bound = jax_air.witness_params()
    return spec(**bound["witness"], **bound["params"])


def airs_from(jax_airs) -> list:
    """The port's AIRs of a batch of JAX package statements
    (:func:`air_from` each)."""
    return [air_from(a) for a in jax_airs]


def checkpoint_from(jax_checkpoint):
    """The port's ProverCheckpoint of a JAX package checkpoint, through
    its serialized bytes, which the port must read back to the same
    config (:func:`config_from`) and serialize to the same bytes."""
    from stark_tpu_torch.stark.checkpoint import ProverCheckpoint

    blob = jax_checkpoint.serialize()
    ckpt = ProverCheckpoint.deserialize(blob)
    if (ckpt.config != config_from(jax_checkpoint.config)
            or ckpt.serialize() != blob):
        raise ValueError("the checkpoint does not carry across unchanged")
    return ckpt
