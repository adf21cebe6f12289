# Copied from stark_tpu/channel/compress.py (host-only): the port must not
# import stark_tpu, whose package init imports JAX.
"""Transcript compression — a real ``compressed_proof``.

The reference declares a ``compressed_proof`` alongside ``proof`` but
pushes every message to both verbatim (src/channel/channel.rs:42-43), so
``compressed_proof_size`` (channel.rs:91-95) always equals ``proof_size``
— compression was intended, never built.  This module builds it, as a
*serialization layer*: the Fiat-Shamir transcript itself is untouched
(byte-exact parity preserved), but the wire form deduplicates the
redundancy a STARK transcript actually has:

* **Merkle path nodes.**  Queries into the same tree share all path
  digests above their lowest common ancestors; FRI tail layers are tiny
  trees where paths overlap almost entirely.  Every 32-byte node is sent
  once and back-referenced afterwards.
* **Repeated messages.**  The reference's len==1 decommit quirk re-sends
  the final value twice per query (fri_commit.rs:146-148); repeated
  8-byte value messages in the FRI tail collide across queries.
* **Hex-string roots.**  Merkle roots travel as 64 ASCII hex chars
  (merkle/mod.rs:24-26); they pack to 32 bytes.

``decompress_messages(compress_messages(msgs)) == msgs`` exactly — the
verifier replays the identical transcript, so compression can never
affect soundness or transcript parity.

Wire grammar (all ints are unsigned LEB128 varints)::

    blob    := MAGIC "TC1" , n_messages , message*
    message := 0x00 len bytes          -- literal
             | 0x01 msg_id             -- exact repeat of earlier message
             | 0x02 len packed         -- even-length lowercase-hex ASCII,
                                          nibble-packed to len/2 bytes
             | 0x03 n_nodes node*      -- length-32k digest vector
    node    := 0x00 byte[32]           -- new node (assigned next node id)
             | 0x01 node_id            -- back-reference
"""

from __future__ import annotations

_MAGIC = b"TC1"
_HEX = frozenset(b"0123456789abcdef")


class CompressionError(Exception):
    pass


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    n = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise CompressionError("truncated varint")
        b = data[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7
        if shift > 63:
            raise CompressionError("varint overflow")


def _is_hex_ascii(m: bytes) -> bool:
    return len(m) >= 2 and len(m) % 2 == 0 and all(c in _HEX for c in m)


def compress_messages(messages: list[bytes]) -> bytes:
    out = bytearray(_MAGIC)
    out += _varint(len(messages))
    msg_ids: dict[bytes, int] = {}
    node_ids: dict[bytes, int] = {}
    for i, m in enumerate(messages):
        m = bytes(m)
        prev = msg_ids.get(m)
        if prev is not None:
            out.append(0x01)
            out += _varint(prev)
            continue
        msg_ids[m] = i
        if _is_hex_ascii(m):
            out.append(0x02)
            out += _varint(len(m))
            out += bytes.fromhex(m.decode())
        elif len(m) >= 32 and len(m) % 32 == 0:
            out.append(0x03)
            out += _varint(len(m) // 32)
            for j in range(0, len(m), 32):
                node = m[j : j + 32]
                nid = node_ids.get(node)
                if nid is None:
                    node_ids[node] = len(node_ids)
                    out.append(0x00)
                    out += node
                else:
                    out.append(0x01)
                    out += _varint(nid)
        else:
            out.append(0x00)
            out += _varint(len(m))
            out += m
    return bytes(out)


def decompress_messages(data: bytes) -> list[bytes]:
    if data[: len(_MAGIC)] != _MAGIC:
        raise CompressionError("bad magic")
    pos = len(_MAGIC)
    n, pos = _read_varint(data, pos)
    messages: list[bytes] = []
    nodes: list[bytes] = []
    for _ in range(n):
        if pos >= len(data):
            raise CompressionError("truncated message stream")
        tag = data[pos]
        pos += 1
        if tag == 0x00:
            ln, pos = _read_varint(data, pos)
            if pos + ln > len(data):
                raise CompressionError("truncated literal")
            messages.append(data[pos : pos + ln])
            pos += ln
        elif tag == 0x01:
            mid, pos = _read_varint(data, pos)
            if mid >= len(messages):
                raise CompressionError("forward message ref")
            messages.append(messages[mid])
        elif tag == 0x02:
            ln, pos = _read_varint(data, pos)
            if ln % 2 or pos + ln // 2 > len(data):
                raise CompressionError("bad hex-packed message")
            messages.append(data[pos : pos + ln // 2].hex().encode())
            pos += ln // 2
        elif tag == 0x03:
            cnt, pos = _read_varint(data, pos)
            parts = []
            for _ in range(cnt):
                if pos >= len(data):
                    raise CompressionError("truncated node stream")
                ntag = data[pos]
                pos += 1
                if ntag == 0x00:
                    if pos + 32 > len(data):
                        raise CompressionError("truncated node")
                    node = data[pos : pos + 32]
                    pos += 32
                    nodes.append(node)
                elif ntag == 0x01:
                    nid, pos = _read_varint(data, pos)
                    if nid >= len(nodes):
                        raise CompressionError("forward node ref")
                    node = nodes[nid]
                else:
                    raise CompressionError(f"bad node tag {ntag}")
                parts.append(node)
            messages.append(b"".join(parts))
        else:
            raise CompressionError(f"bad message tag {tag}")
    if pos != len(data):
        raise CompressionError("trailing bytes")
    return messages


def compressed_size(messages: list[bytes]) -> int:
    """What ``compressed_proof_size`` should have reported."""
    return len(compress_messages(messages))
