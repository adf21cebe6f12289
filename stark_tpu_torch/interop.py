"""Converters between the JAX package's host values and the port's
tensors — the port's "weights carried across", used by the tests.

Field values and digest words are uint32 in JAX and int32 (same bits) in
the port, so numpy views carry them over without copying values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stark_tpu_torch.config import ProverConfig


def u32_to_tensor(arr, device="cpu") -> torch.Tensor:
    """numpy (or array-like) uint32 -> int32 storage tensor on `device`."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def tensor_to_u32(t: torch.Tensor) -> np.ndarray:
    """int32 storage tensor -> numpy uint32 (host copy)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32).copy()


def state_to_hex(state: torch.Tensor) -> str:
    """(8,) Fiat-Shamir state words -> the channel's 64-char hex state."""
    return tensor_to_u32(state).astype(">u4").tobytes().hex()


def hex_to_state(state_hex: str, device="cpu") -> torch.Tensor:
    """64-char hex state -> (8,) int32 state words on `device`."""
    words = np.frombuffer(bytes.fromhex(state_hex), dtype=">u4")
    return u32_to_tensor(words.astype(np.uint32), device)


def config_from(cfg) -> ProverConfig:
    """Any ProverConfig-like object (e.g. the JAX package's) -> the port's."""
    return ProverConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(ProverConfig)})


def config_fields(cfg: ProverConfig) -> dict:
    """The port's config as a plain dict (to build the JAX package's)."""
    return dataclasses.asdict(cfg)
