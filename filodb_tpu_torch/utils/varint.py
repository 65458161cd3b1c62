"""Base-128 varint primitives shared by the snappy codec and the protobuf
wire format (port of filodb_tpu/utils/varint.py)."""
from __future__ import annotations

from typing import Tuple


def write_uvarint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def read_uvarint(data: bytes, pos: int) -> Tuple[int, int]:
    """Returns (value, next_pos); raises ValueError on overlong or truncated
    input (IndexError from truncation is converted for uniform handling)."""
    result = 0
    shift = 0
    try:
        while True:
            b = data[pos]
            pos += 1
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                return result, pos
            shift += 7
            if shift > 70:
                raise ValueError("uvarint too long")
    except IndexError:
        raise ValueError("truncated uvarint")
