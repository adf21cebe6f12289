"""The native host library (counterpart of ``stark_tpu/native``): the
Fibonacci-square, MiMC and two-column FibMul trace loops
(``native/host_trace.cpp``), and SHA-256, the Merkle tree build and
authentication-path check, and the channel's absorb
(``native/host_hash.cpp``).

Each C++ source is built with the host C++ compiler at first use into
``build/stark_tpu_torch/`` and loaded with ``ctypes`` by the same route
as the CUDA kernels (``_build.py``).  A failed build raises: unlike the
JAX package, nothing falls back to Python or hashlib.
"""

from __future__ import annotations

import ctypes

import numpy as np

from stark_tpu_torch import _build


def _run(fn: str, p: int, arg0: int, arg1: int, shape) -> np.ndarray:
    if not 0 < p < 1 << 64:
        raise ValueError(f"modulus {p} not in (0, 2^64)")
    out = np.empty(shape, dtype=np.uint64)
    getattr(_build.lib("host_trace"), fn)(p, arg0 % p, arg1 % p,
                                          shape[-1], out.ctypes.data)
    return out


def fib_trace(p: int, a0: int, a1: int, n: int) -> np.ndarray:
    """a_{i+2} = a_{i+1}^2 + a_i^2 mod p, `n` values from a_0, a_1, as a
    numpy uint64 array.  Exact for 0 < p < 2^64."""
    return _run("stark_fib_trace", p, a0, a1, (n,))


def mimc_trace(p: int, x0: int, k: int, n: int) -> np.ndarray:
    """x_{i+1} = (x_i + k)^3 mod p, `n` values from x_0 (uint64)."""
    return _run("stark_mimc_trace", p, x0, k, (n,))


def fibmul_trace(p: int, a0: int, b0: int, n: int) -> np.ndarray:
    """a_{i+1} = b_i, b_{i+1} = a_i * b_i mod p: the (2, n) uint64 array
    of the columns a and b."""
    return _run("stark_fibmul_trace", p, a0, b0, (2, n))


def host_trace(kind: str, p: int, arg0: int, arg1: int, n: int):
    """The AIR trace `kind` by its loop above: "fib" (arg0 = a0, arg1 =
    a1), "mimc" (x0, k) or "fibmul" (a0, b0; a (2, n) array)."""
    fn = {"fib": fib_trace, "mimc": mimc_trace, "fibmul": fibmul_trace}[kind]
    return fn(p, arg0, arg1, n)


def get_lib() -> ctypes.CDLL:
    """The loaded host hash library, built at first use."""
    return _build.lib("host_hash")


def sha256(data: bytes) -> bytes:
    out = ctypes.create_string_buffer(32)
    get_lib().stark_sha256(data, len(data), out)
    return out.raw


def merkle_validate(root_hex: str, proof: bytes, index: int, leaf8: bytes,
                    num_leaves: int) -> bool:
    """``MerkleTree.validate`` for an 8-byte leaf value, in one C call
    (False for a root that is not 64 hex digits or a leaf of another
    length)."""
    try:
        root = bytes.fromhex(root_hex)
    except ValueError:
        return False
    if len(root) != 32 or len(leaf8) != 8 or not 0 <= index < num_leaves:
        return False
    return bool(get_lib().stark_merkle_validate(root, proof, len(proof),
                                                index, leaf8, num_leaves))


def merkle_build_host(values) -> list[bytes]:
    """Every digest of the rs_merkle tree over u64 field values, bottom
    up: n + ceil(n/2) + ... + 1 digests of 32 bytes."""
    vals = np.ascontiguousarray(np.asarray(values, dtype=np.uint64))
    n = len(vals)
    total, size = n, n
    while size > 1:
        size = (size + 1) // 2
        total += size
    buf = ctypes.create_string_buffer(32 * max(total, 1))
    wrote = get_lib().stark_merkle_build(vals.ctypes.data, n, buf)
    if wrote != total:
        raise RuntimeError(
            f"native merkle build wrote {wrote} nodes, expected {total}")
    raw = buf.raw  # one copy: each .raw copies the whole buffer
    return [raw[32 * i:32 * (i + 1)] for i in range(total)]


def channel_absorb(state_hex: str, message: bytes) -> str:
    """state' = sha256_hex(utf8(state ++ hex(message))), the channel's
    send (channel.rs:35-44)."""
    out = ctypes.create_string_buffer(64)
    get_lib().stark_channel_absorb(state_hex.encode(), len(state_hex),
                                   message, len(message), out)
    return out.raw.decode()
