"""K5 wrapper: the flagged sequential SHA-256 chain of the Fiat-Shamir
transcript (``csrc/sha_chain.cu``; replaces ``stark_tpu/hash/pallas_chain.py``
``_make_chain_kernel``).

Each block row carries two flags, ``first`` and ``last``:

* ``first == 1`` (FIRST_HEX) starts a message: the compressor resets to H0
  and hashes the 64-char lowercase hex of the chain state instead of the
  row — the 64-byte state prefix every ``Channel.send`` hashes first;
* ``first == 2`` (FIRST_ROW) resets to H0 and hashes the row as it is —
  the first absorb of a fresh channel, whose state is the empty string
  (``stark_tpu/channel/device_channel.py:100-107``).  JAX streams carry
  only 0 and 1, so on them both versions equal ``_block_step``;
* ``last != 0`` commits the compression output as the new chain state.

A CPU tensor runs :func:`sha_chain_plain`, a host loop over the rows in
Python ints (one serial lane has no tensor parallelism); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from stark_tpu_torch import _build
from stark_tpu_torch.hash.sha256 import H0, compress

FIRST_HEX = 1
FIRST_ROW = 2


def _hex_words(chain: list) -> list:
    """The 64 UTF-8 hex chars of the 8 chain words, 4 chars per word."""
    text = "".join(f"{x:08x}" for x in chain).encode()
    return [int.from_bytes(text[4 * k:4 * k + 4], "big") for k in range(16)]


def sha_chain_plain(stream: torch.Tensor, flags: torch.Tensor,
                    chain: torch.Tensor) -> torch.Tensor:
    """Plain version of K5 with the kernel's signature: (B, 16) rows,
    (B, 2) flags, (8,) chain -> (8,) int32 final chain state."""
    rows = stream.cpu().numpy().view(np.uint32).tolist()
    fl = flags.cpu().numpy().tolist()
    ch = chain.cpu().numpy().view(np.uint32).tolist()
    st = [0] * 8
    for row, (first, last) in zip(rows, fl):
        if first:
            st = list(H0)
        st = compress(st, _hex_words(ch) if first == FIRST_HEX else row)
        if last:
            ch = st
    out = np.asarray(ch, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(out.copy()).to(chain.device)


def sha_chain(stream: torch.Tensor, flags: torch.Tensor,
              chain: torch.Tensor) -> torch.Tensor:
    """Run the flagged chain: (B, 16) int32 block rows, (B, 2) int32
    flags, (8,) int32 initial state -> (8,) int32 final state."""
    if _build.plain_device(stream):
        return sha_chain_plain(stream, flags, chain)
    b = int(stream.shape[0])
    _build.require(stream, "stream", (b, 16), align=16)
    _build.require(flags, "flags", (b, 2), align=8)
    _build.require(chain, "chain", (8,))
    out = torch.empty(8, dtype=torch.int32, device=stream.device)
    _build.check(_build.lib("sha_chain").stark_sha_chain(
        stream.data_ptr(), flags.data_ptr(), chain.data_ptr(),
        out.data_ptr(), b, _build.stream_ptr(stream.device)), "K5 sha_chain")
    sha_chain.launches += 1
    return out


sha_chain.launches = 0
sha_chain.plain = sha_chain_plain
