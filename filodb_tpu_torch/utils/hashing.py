"""Bit-exact xxHash32/xxHash64 for partition-key and shard-key hashing.

The reference hashes partKey bytes with xxHash32 (ref:
memory/src/main/scala/filodb.memory/format/BinaryRegion.scala:14 `hasher32`) and
derives shard-key hashes from label values (ref:
core/src/main/scala/filodb.core/binaryrecord2/RecordBuilder.scala:604-619).
These hashes route every record to a shard, so gateway, ingest and query layers
must agree bit-for-bit.  The C implementation (filodb_tpu_torch/native,
built at first use) serves xxhash32 and xxhash64 when it loads; the
pure-Python ones below are the fallback and the reference for tests.
"""
from __future__ import annotations

import struct

from filodb_tpu_torch import native as _native

_PRIME32_1 = 0x9E3779B1
_PRIME32_2 = 0x85EBCA77
_PRIME32_3 = 0xC2B2AE3D
_PRIME32_4 = 0x27D4EB2F
_PRIME32_5 = 0x165667B1
_M32 = 0xFFFFFFFF

_PRIME64_1 = 0x9E3779B185EBCA87
_PRIME64_2 = 0xC2B2AE3D27D4EB4F
_PRIME64_3 = 0x165667B19E3779F9
_PRIME64_4 = 0x85EBCA77C2B2AE63
_PRIME64_5 = 0x27D4EB2F165667C5
_M64 = 0xFFFFFFFFFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round32(acc: int, lane: int) -> int:
    acc = (acc + lane * _PRIME32_2) & _M32
    return (_rotl32(acc, 13) * _PRIME32_1) & _M32


def _py_xxhash32(data: bytes, seed: int = 0) -> int:
    """XXH32 of `data`.  Returns an unsigned 32-bit int."""
    n = len(data)
    idx = 0
    if n >= 16:
        v1 = (seed + _PRIME32_1 + _PRIME32_2) & _M32
        v2 = (seed + _PRIME32_2) & _M32
        v3 = seed & _M32
        v4 = (seed - _PRIME32_1) & _M32
        limit = n - 16
        while idx <= limit:
            l1, l2, l3, l4 = struct.unpack_from("<IIII", data, idx)
            v1 = _round32(v1, l1)
            v2 = _round32(v2, l2)
            v3 = _round32(v3, l3)
            v4 = _round32(v4, l4)
            idx += 16
        h = (_rotl32(v1, 1) + _rotl32(v2, 7) + _rotl32(v3, 12) + _rotl32(v4, 18)) & _M32
    else:
        h = (seed + _PRIME32_5) & _M32
    h = (h + n) & _M32
    while idx + 4 <= n:
        (lane,) = struct.unpack_from("<I", data, idx)
        h = (h + lane * _PRIME32_3) & _M32
        h = (_rotl32(h, 17) * _PRIME32_4) & _M32
        idx += 4
    while idx < n:
        h = (h + data[idx] * _PRIME32_5) & _M32
        h = (_rotl32(h, 11) * _PRIME32_1) & _M32
        idx += 1
    h ^= h >> 15
    h = (h * _PRIME32_2) & _M32
    h ^= h >> 13
    h = (h * _PRIME32_3) & _M32
    h ^= h >> 16
    return h


def _round64(acc: int, lane: int) -> int:
    acc = (acc + lane * _PRIME64_2) & _M64
    return (_rotl64(acc, 31) * _PRIME64_1) & _M64


def _merge64(acc: int, val: int) -> int:
    acc ^= _round64(0, val)
    return (acc * _PRIME64_1 + _PRIME64_4) & _M64


def _py_xxhash64(data: bytes, seed: int = 0) -> int:
    """XXH64 of `data`.  Returns an unsigned 64-bit int."""
    n = len(data)
    idx = 0
    if n >= 32:
        v1 = (seed + _PRIME64_1 + _PRIME64_2) & _M64
        v2 = (seed + _PRIME64_2) & _M64
        v3 = seed & _M64
        v4 = (seed - _PRIME64_1) & _M64
        limit = n - 32
        while idx <= limit:
            l1, l2, l3, l4 = struct.unpack_from("<QQQQ", data, idx)
            v1 = _round64(v1, l1)
            v2 = _round64(v2, l2)
            v3 = _round64(v3, l3)
            v4 = _round64(v4, l4)
            idx += 32
        h = (_rotl64(v1, 1) + _rotl64(v2, 7) + _rotl64(v3, 12) + _rotl64(v4, 18)) & _M64
        h = _merge64(h, v1)
        h = _merge64(h, v2)
        h = _merge64(h, v3)
        h = _merge64(h, v4)
    else:
        h = (seed + _PRIME64_5) & _M64
    h = (h + n) & _M64
    while idx + 8 <= n:
        (lane,) = struct.unpack_from("<Q", data, idx)
        h ^= _round64(0, lane)
        h = (_rotl64(h, 27) * _PRIME64_1 + _PRIME64_4) & _M64
        idx += 8
    if idx + 4 <= n:
        (lane,) = struct.unpack_from("<I", data, idx)
        h ^= (lane * _PRIME64_1) & _M64
        h = (_rotl64(h, 23) * _PRIME64_2 + _PRIME64_3) & _M64
        idx += 4
    while idx < n:
        h ^= (data[idx] * _PRIME64_5) & _M64
        h = (_rotl64(h, 11) * _PRIME64_1) & _M64
        idx += 1
    h ^= h >> 33
    h = (h * _PRIME64_2) & _M64
    h ^= h >> 29
    h = (h * _PRIME64_3) & _M64
    h ^= h >> 32
    return h


def xxhash32(data: bytes, seed: int = 0) -> int:
    lib = _native.lib
    if lib is not None:
        return lib.xxhash32(data, seed)
    return _py_xxhash32(data, seed)


def xxhash64(data: bytes, seed: int = 0) -> int:
    lib = _native.lib
    if lib is not None:
        return lib.xxhash64(data, seed)
    return _py_xxhash64(data, seed)


def hash32_signed(data: bytes, seed: int = 0) -> int:
    """xxhash32 as a signed 32-bit int (the JVM reference works in Int)."""
    h = xxhash32(data, seed)
    return h - (1 << 32) if h >= (1 << 31) else h

