"""Pure-Python Snappy block-format codec (port of
filodb_tpu/utils/snappy.py; its output is the reference's to the byte).

The Prometheus remote-read/write protocol frames its protobuf payloads with
Snappy block compression (ref: http/src/main/scala/filodb/http/
PrometheusApiRoute.scala:37-62 — `Snappy.uncompress` on the request,
`Snappy.compress` on the response).  The package depends on no snappy
library, so this implements the block format
(github.com/google/snappy/format_description.txt) directly:

- decompress() handles the full format (literals + copy ops with 1/2/4-byte
  offsets, including overlapping RLE-style copies), so payloads from real
  clients decode correctly.
- compress() emits a valid literal-only stream plus greedy back-references
  for long runs found via a tiny hash table — not snappy-optimal, but
  interoperable and fast enough for the request/response sizes involved.
"""
from __future__ import annotations

from filodb_tpu_torch.utils.varint import (read_uvarint as _read_uvarint,
                                           write_uvarint as _write_uvarint)


def decompress(data: bytes) -> bytes:
    """Snappy block-format decompress (raises ValueError on malformed input)."""
    if not data:
        raise ValueError("empty snappy input")
    expected, pos = _read_uvarint(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 0x03
        if kind == 0:                       # literal
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                if pos + extra > n:
                    raise ValueError("truncated literal length")
                length = int.from_bytes(data[pos:pos + extra], "little") + 1
                pos += extra
            if pos + length > n:
                raise ValueError("truncated literal")
            out += data[pos:pos + length]
            pos += length
            continue
        if kind == 1:                       # copy, 1-byte offset
            length = 4 + ((tag >> 2) & 0x07)
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:                     # copy, 2-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
        else:                               # copy, 4-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise ValueError("invalid copy offset")
        start = len(out) - offset
        if offset >= length:
            out += out[start:start + length]
        else:                               # overlapping copy: RLE semantics
            for i in range(length):
                out.append(out[start + i])
    if len(out) != expected:
        raise ValueError(
            f"snappy length mismatch: got {len(out)}, expected {expected}")
    return bytes(out)


def _emit_literal(out: bytearray, chunk: bytes) -> None:
    length = len(chunk)
    if length == 0:
        return
    if length <= 60:
        out.append((length - 1) << 2)
    else:
        nbytes = (max(length - 1, 1).bit_length() + 7) // 8
        out.append((59 + nbytes) << 2)
        out += (length - 1).to_bytes(nbytes, "little")
    out += chunk


def compress(data: bytes) -> bytes:
    """Valid snappy block stream: greedy 4-byte-hash matcher + literals.

    Inputs past _FAST_MIN route to the vectorized large-payload encoder
    (_compress_fast below): the WAL group-commit path frames multi-MB
    record bodies per append, and the per-byte Python hash loop here
    would throttle acknowledged ingest to a crawl (measured ~2 MB/s vs
    the ~GB/s numpy path)."""
    if len(data) >= _FAST_MIN:
        return _compress_fast(data)
    out = bytearray(_write_uvarint(len(data)))
    n = len(data)
    if n == 0:
        return bytes(out)
    table = {}
    pos = 0
    lit_start = 0
    while pos + 4 <= n:
        key = data[pos:pos + 4]
        cand = table.get(key)
        table[key] = pos
        if cand is not None and pos - cand <= 0xFFFF:
            match = 4
            limit = min(n - pos, 64)
            while (match < limit
                   and data[cand + match] == data[pos + match]):
                match += 1
            _emit_literal(out, data[lit_start:pos])
            offset = pos - cand
            out.append(((match - 1) << 2) | 2)      # 2-byte-offset copy
            out += offset.to_bytes(2, "little")
            pos += match
            lit_start = pos
        else:
            pos += 1
    _emit_literal(out, data[lit_start:])
    return bytes(out)


# threshold above which compress() switches to the vectorized encoder
_FAST_MIN = 1 << 15


def _compress_fast(data: bytes) -> bytes:
    """Vectorized snappy encoder for large payloads (WAL record bodies:
    int64 timestamp grids, f64 value matrices, key tables).

    Match detection is ONE numpy compare — byte i against byte i-8 —
    which captures exactly the redundancy those payloads have (int64/f64
    lanes repeating their high bytes, zero runs, repeated text); runs of
    equality become copy ops, everything else is emitted as literals
    (memcpy-speed, always valid snappy).  Within a detected run the data
    is period-8 by construction, so offsets double 8→16→32→64 and the
    steady state is one REPEATED 3-byte non-overlapping 64-byte copy op
    — O(1) Python per run, and the decoder's fast (offset >= length)
    slice path on the way back."""
    import numpy as np
    out = bytearray(_write_uvarint(len(data)))
    a = np.frombuffer(data, dtype=np.uint8)
    n = len(a)
    eq = np.zeros(n + 1, dtype=np.int8)
    np.equal(a[8:], a[:-8], out=eq[8:n].view(bool))
    d = np.diff(eq)
    starts = np.flatnonzero(d == 1) + 1
    ends = np.flatnonzero(d == -1) + 1
    # only LONG runs are worth ops: every run costs Python-loop work at
    # emission, and the group-commit path lives on this encoder's SPEED
    # (an incompressible body must degrade to one memcpy literal, not
    # to 16k tiny copy ops)
    keep = (ends - starts) >= 256
    starts, ends = starts[keep], ends[keep]
    op64 = bytes([((64 - 1) << 2) | 2]) + (64).to_bytes(2, "little")
    pos = 0
    for s, e in zip(starts.tolist(), ends.tolist()):
        if s > pos:
            _emit_literal(out, data[pos:s])
        # [s-8, e) is period-8: copy offset==length stays valid while
        # length <= bytes already emitted since s-8 (doubling schedule)
        rem = e - s
        avail = 8
        while rem >= 8 and avail < 64:
            take = min(avail, rem) & ~7
            if take < 8:
                break
            out.append(((take - 1) << 2) | 2)
            out += take.to_bytes(2, "little")
            rem -= take
            avail += take
        if avail >= 64:
            full, tail = divmod(rem, 64)
            out += op64 * full              # O(1) per run, not per op
            rem = tail
            if rem >= 8:
                take = rem & ~7
                out.append(((take - 1) << 2) | 2)
                out += take.to_bytes(2, "little")
                rem -= take
        if rem:
            _emit_literal(out, data[e - rem:e])
        pos = e
    if pos < n:
        _emit_literal(out, data[pos:n])
    return bytes(out)
