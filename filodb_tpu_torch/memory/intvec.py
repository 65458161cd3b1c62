"""Bit-packed integer vectors with automatic width selection (port of
filodb_tpu/memory/intvec.py; the same bytes).

The reference stores int columns (and the inner storage of delta-delta
vectors) bit-packed at the narrowest width that fits: 2/4/8/16/32-bit
unsigned widths plus a const vector when every value is identical, and
masked variants carrying a validity bitmap
(ref: memory/.../format/vectors/IntBinaryVector.scala:15,357-433 —
OffheapUnsignedIntVector{2,4,8,16}, const vector, masked variants).

Departure from the reference: these are *storage/wire* codecs, not random-access
readers.  Decode is one vectorized numpy pass into a dense array (the
working set the device consumes is always dense — SURVEY.md section 7
step 1); there is no per-element accessor object.  A signed `base` offset
is subtracted before packing so narrow widths apply to any contiguous
value range, not just ones near zero.

Layout (little-endian):
    u8  kind      0=const, 1=packed
    u8  bits      width in bits (const: 0)
    i64 base      value offset
    -- kind=const: nothing else (value == base)
    -- kind=packed: ceil(n*bits/8) bytes of packed codes, LSB-first
Masked variant prepends a validity bitmap of ceil(n/8) bytes.
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

_WIDTHS = (2, 4, 8, 16, 32, 64)
_HDR = struct.Struct("<BBq")


def _select_width(span: int) -> int:
    for b in _WIDTHS:
        if b == 64 or span < (1 << b):
            return b
    return 64


def _pack_bits(codes: np.ndarray, bits: int) -> bytes:
    """Pack unsigned codes (< 2**bits) at `bits` per value, LSB-first."""
    n = len(codes)
    if bits in (8, 16, 32, 64):
        return codes.astype(f"<u{bits // 8}").tobytes()
    # sub-byte widths: expand to a bit matrix, then np.packbits
    per_byte = 8 // bits
    padded = np.zeros((n + per_byte - 1) // per_byte * per_byte,
                      dtype=np.uint8)
    padded[:n] = codes.astype(np.uint8)
    out = np.zeros(len(padded) // per_byte, dtype=np.uint8)
    for k in range(per_byte):
        out |= padded[k::per_byte] << (k * bits)
    return out.tobytes()


def _unpack_bits(data: bytes, n: int, bits: int) -> np.ndarray:
    if bits in (8, 16, 32, 64):
        return np.frombuffer(data, dtype=f"<u{bits // 8}",
                             count=n).astype(np.uint64)
    per_byte = 8 // bits
    raw = np.frombuffer(data, dtype=np.uint8)
    mask = (1 << bits) - 1
    cols = [((raw >> (k * bits)) & mask) for k in range(per_byte)]
    codes = np.stack(cols, axis=1).reshape(-1)[:n]
    return codes.astype(np.uint64)


def pack_ints(values: np.ndarray) -> bytes:
    """Encode an int64 array at the narrowest width that fits its range."""
    v = np.asarray(values, dtype=np.int64)
    if len(v) == 0:
        return _HDR.pack(0, 0, 0)
    base = int(v.min())
    span = int(v.max()) - base
    if span == 0:
        return _HDR.pack(0, 0, base)
    bits = _select_width(span)
    codes = (v - base).astype(np.uint64)
    return _HDR.pack(1, bits, base) + _pack_bits(codes, bits)


def unpack_ints(data: bytes, n: int) -> np.ndarray:
    kind, bits, base = _HDR.unpack_from(data)
    if kind == 0:
        return np.full(n, base, dtype=np.int64)
    codes = _unpack_bits(data[_HDR.size:], n, bits)
    return (codes.astype(np.int64) + base)


def packed_width_bits(data: bytes) -> int:
    """Effective bits/value of an encoded vector (0 for const)."""
    _, bits, _ = _HDR.unpack_from(data)
    return bits


def pack_ints_masked(values: np.ndarray,
                     valid: Optional[np.ndarray] = None) -> bytes:
    """Masked variant: NaN-able int column as (validity bitmap, packed
    present values at positions where valid) — ref IntBinaryVector.scala
    masked variants.  `values` at invalid positions are ignored."""
    v = np.asarray(values, dtype=np.int64)
    if valid is None:
        valid = np.ones(len(v), dtype=bool)
    valid = np.asarray(valid, dtype=bool)
    bitmap = np.packbits(valid, bitorder="little").tobytes()
    body = pack_ints(v[valid])
    return struct.pack("<I", len(bitmap)) + bitmap + body


def unpack_ints_masked(data: bytes, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """-> (values int64 [n] with 0 at invalid positions, valid bool [n])."""
    (blen,) = struct.unpack_from("<I", data)
    bitmap = np.frombuffer(data, dtype=np.uint8, count=blen, offset=4)
    valid = np.unpackbits(bitmap, count=n, bitorder="little").astype(bool)
    present = unpack_ints(data[4 + blen:], int(valid.sum()))
    out = np.zeros(n, dtype=np.int64)
    out[valid] = present
    return out, valid
