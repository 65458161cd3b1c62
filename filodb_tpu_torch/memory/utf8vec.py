"""UTF8 string vectors and dictionary encoding (port of
filodb_tpu/memory/utf8vec.py; the same bytes).

The reference's UTF8Vector stores length-prefixed strings back to back;
DictUTF8Vector adds a sorted dictionary of unique strings plus a
bit-packed code per row, which is how low-cardinality label columns
(job, instance, namespace...) collapse to a couple of bits per entry
(ref: memory/.../format/vectors/UTF8Vector.scala:1-400,
DictUTF8Vector.scala:132, ZeroCopyBinary.scala).

Role here: strings never reach the device — labels live host-side
in the tag index and on the wire.  These codecs serve the *bulk*
surfaces: batch export bundles (jobs/batch_io.py label tables) and any
snapshot format where per-row label dicts would otherwise repeat the
same few values thousands of times.

Layouts (little-endian):
  UTF8 blob vector:   u32 n, then n x (u32 len, bytes)
  Dict vector:        u32 dict_n, UTF8-blob of dict (sorted, unique),
                      intvec-packed codes (one per row)
  Label table:        u32 nrows, u32 ncols, per col: (u32 keylen,
                      key bytes, u32 bitmaplen, presence bitmap
                      (LSB-first), u32 bodylen, dict-vector body);
                      absent keys are marked in the bitmap (their code
                      slot holds ""), so "" values round-trip exactly.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

from filodb_tpu_torch.memory import intvec

_U32 = struct.Struct("<I")


def pack_utf8(strings: List[bytes]) -> bytes:
    parts = [_U32.pack(len(strings))]
    for s in strings:
        parts.append(_U32.pack(len(s)))
        parts.append(s)
    return b"".join(parts)


def unpack_utf8(data: bytes, off: int = 0) -> Tuple[List[bytes], int]:
    """-> (strings, next offset)."""
    (n,) = _U32.unpack_from(data, off)
    off += 4
    out: List[bytes] = []
    for _ in range(n):
        (ln,) = _U32.unpack_from(data, off)
        off += 4
        out.append(data[off:off + ln])
        off += ln
    return out, off


def pack_dict_utf8(strings: List[bytes]) -> bytes:
    """Dictionary-encode: sorted unique dictionary + bit-packed codes."""
    uniq = sorted(set(strings))
    index = {s: i for i, s in enumerate(uniq)}
    codes = np.fromiter((index[s] for s in strings), dtype=np.int64,
                        count=len(strings))
    return (_U32.pack(len(strings)) + pack_utf8(uniq)
            + intvec.pack_ints(codes))


def unpack_dict_utf8(data: bytes) -> List[bytes]:
    (n,) = _U32.unpack_from(data)
    uniq, off = unpack_utf8(data, 4)
    codes = intvec.unpack_ints(data[off:], n)
    return [uniq[c] for c in codes.tolist()]


def dict_cardinality(data: bytes) -> int:
    (_,) = _U32.unpack_from(data)
    (dn,) = _U32.unpack_from(data, 4)
    return dn


def pack_label_table(rows: List[Dict[str, str]]) -> bytes:
    """Columnar dict-encoded table of label dicts.  A per-column presence
    bitmap distinguishes an absent key from an explicitly-empty value, so
    the round trip is exact."""
    keys = sorted({k for r in rows for k in r})
    parts = [_U32.pack(len(keys))]
    for k in keys:
        kb = k.encode("utf-8")
        present = np.fromiter((k in r for r in rows), dtype=bool,
                              count=len(rows))
        bitmap = np.packbits(present, bitorder="little").tobytes()
        col = [r.get(k, "").encode("utf-8") for r in rows]
        body = pack_dict_utf8(col)
        parts += [_U32.pack(len(kb)), kb,
                  _U32.pack(len(bitmap)), bitmap,
                  _U32.pack(len(body)), body]
    return _U32.pack(len(rows)) + b"".join(parts)


def unpack_label_table(data: bytes) -> List[Dict[str, str]]:
    (nrows,) = _U32.unpack_from(data)
    (ncols,) = _U32.unpack_from(data, 4)
    off = 8
    rows: List[Dict[str, str]] = [dict() for _ in range(nrows)]
    for _ in range(ncols):
        (klen,) = _U32.unpack_from(data, off)
        off += 4
        key = data[off:off + klen].decode("utf-8")
        off += klen
        (blen,) = _U32.unpack_from(data, off)
        off += 4
        bitmap = np.frombuffer(data, dtype=np.uint8, count=blen, offset=off)
        present = np.unpackbits(bitmap, count=nrows, bitorder="little")
        off += blen
        (blen,) = _U32.unpack_from(data, off)
        off += 4
        col = unpack_dict_utf8(data[off:off + blen])
        off += blen
        for r, p, v in zip(rows, present, col):
            if p:
                r[key] = v.decode("utf-8")
    return rows
