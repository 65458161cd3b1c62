"""WAL segment files: snappy-framed, CRC32-guarded append records (port
of filodb_tpu/wal/segment.py, byte-compatible).

One segment is a bounded append-only file (ref: the reference's
IngestionStream recovery over Kafka offsets, doc/ingestion.md:114-133;
Gorilla's append log, Facebook VLDB'15 §4.2).  Layout:

    header:  b"FWAL" + u16 version + u16 reserved
    record:  u32 frame_len | u32 crc32(frame) | frame = snappy(body)

The CRC covers the COMPRESSED frame, so a torn tail (crash mid-write) or
bit rot is detected before snappy/decode ever parse attacker-shaped
bytes.  `read_records` stops cleanly at the first torn/short tail frame
(the normal crash artifact — everything before it was fsynced) and
reports it, so replay can distinguish "clean end" from "mid-log
corruption" (the latter means acknowledged data after it is gone and
must be surfaced loudly, never skipped silently).

The record BODY is the columnar append itself — the same rectangular
[S, k] grid `TimeSeriesShard.ingest_columns` consumes, serialized with
whole-array tobytes (never per-sample Python):

    u64 seq | u16 shard | u8 len + schema_name utf-8
    u32 S | u32 k
    u8 table_mode | u64 table_hash
      mode 0 (inline): u32 blob_len | S x (u32 len + PartKey bytes)
      mode 1 (ref):    nothing — the table was written inline by an
                       EARLIER record of the SAME segment
    u8 ts_mode
      mode 0 (full):   ts: S*k int64
      mode 1 (shared): ts: k int64 — every series carries the SAME
                       timestamp row (the scrape-cycle shape; detected
                       free on broadcast inputs, one vectorized compare
                       otherwise) and replay re-broadcasts it
    u16 ncols, per col: u8 len + name | u32 B (0 = scalar) | f64 payload
    u16 nles + bucket_les f64

Key-table interning: a steady scrape stream appends the SAME series
table every cycle, and re-writing (and re-fsyncing, and re-decoding) a
multi-MB table per record would dominate the whole durability path —
the Prometheus WAL splits series records from sample records for the
same reason.  Here a record references a previously-inlined table by
blake2b-64 content hash, scoped WITHIN one segment so every segment
stays self-contained (pruning can never orphan a reference).
"""
from __future__ import annotations

import dataclasses
import io
import os
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.utils import snappy

MAGIC = b"FWAL"
VERSION = 1
_HEADER = MAGIC + struct.pack("<HH", VERSION, 0)
_FRAME_HDR = struct.Struct("<II")            # frame_len, crc32


class WalCorruption(ValueError):
    """Mid-log CRC/decode failure — data after this point is unrecoverable
    from this segment (a torn TAIL is not corruption; see read_records)."""


@dataclasses.dataclass
class WalRecord:
    """One group of appends for one shard, grid-shaped."""
    seq: int
    shard: int
    schema: str
    part_keys: List[PartKey]
    ts: np.ndarray                            # int64 [S, k]
    columns: Dict[str, np.ndarray]            # [S, k] f64 or [S, k, B]
    bucket_les: Optional[np.ndarray] = None

    @property
    def num_samples(self) -> int:
        return int(self.ts.size)

    def encode(self, table: Optional[tuple] = None) -> bytes:
        """`table` is (mode, blob, hash) from the writer's interning
        state; None (tests, bare callers) always inlines."""
        ts = np.asarray(self.ts)
        if ts.dtype != np.int64:
            ts = ts.astype(np.int64)
        S, k = ts.shape
        if table is None:
            blob, h = key_table_entry(self.part_keys)
            mode = TABLE_INLINE
        else:
            mode, blob, h = table
        buf = io.BytesIO()
        name = self.schema.encode("utf-8")
        buf.write(struct.pack("<QHB", self.seq, self.shard, len(name)))
        buf.write(name)
        buf.write(struct.pack("<II", S, k))
        buf.write(struct.pack("<B", mode))
        buf.write(h)
        if mode == TABLE_INLINE:
            buf.write(struct.pack("<I", len(blob)))
            buf.write(blob)
        # shared-row timestamps: a scrape cycle stamps every series with
        # one row — serializing S copies of it would double the fsync
        # payload.  Broadcast inputs (stride 0) detect free; otherwise
        # one vectorized compare decides (cheap next to the copy saved).
        shared = S > 1 and k > 0 and (
            ts.strides[0] == 0 or bool((ts[1:] == ts[0]).all()))
        buf.write(struct.pack("<B", 1 if shared else 0))
        if shared:
            buf.write(np.ascontiguousarray(ts[0]).tobytes())
        else:
            buf.write(np.ascontiguousarray(ts).tobytes())
        buf.write(struct.pack("<H", len(self.columns)))
        for cname, arr in self.columns.items():
            cb = cname.encode("utf-8")
            arr = np.ascontiguousarray(arr, dtype=np.float64)
            B = arr.shape[2] if arr.ndim == 3 else 0
            buf.write(struct.pack("<B", len(cb)))
            buf.write(cb)
            buf.write(struct.pack("<I", B))
            buf.write(arr.tobytes())
        if self.bucket_les is not None:
            les = np.ascontiguousarray(self.bucket_les, dtype=np.float64)
            buf.write(struct.pack("<H", len(les)))
            buf.write(les.tobytes())
        else:
            buf.write(struct.pack("<H", 0))
        return buf.getvalue()

    @staticmethod
    def decode(data: bytes,
               tables: Optional[Dict[bytes, list]] = None,
               key_memo: Optional[Dict[bytes, tuple]] = None
               ) -> "WalRecord":
        """`tables` is the reader's per-segment intern dict (hash ->
        part_keys); inline records register into it, ref records resolve
        from it.  None works for self-contained inline records.

        `key_memo` (hash -> (table bytes, part_keys)) is kept by a caller
        that decodes a stream of records over the same series (the
        replication door): an inline table whose bytes equal a memoized
        one reuses its decoded list, skipping the per-key decode and
        keeping the list's identity, which the shard's key resolution
        and the WAL's key-table interning are cached on."""
        try:
            return WalRecord._decode(data, tables, key_memo)
        except (struct.error, IndexError, ValueError) as e:
            if isinstance(e, WalCorruption):
                raise
            raise WalCorruption(f"undecodable WAL record body: {e}") from e

    @staticmethod
    def _decode(data: bytes, tables: Optional[Dict[bytes, list]],
                key_memo: Optional[Dict[bytes, tuple]] = None
                ) -> "WalRecord":
        off = 0
        seq, shard, nlen = struct.unpack_from("<QHB", data, off)
        off += 11
        schema = data[off:off + nlen].decode("utf-8")
        off += nlen
        S, k = struct.unpack_from("<II", data, off)
        off += 8
        (mode,) = struct.unpack_from("<B", data, off)
        off += 1
        h = data[off:off + 8]
        off += 8
        if mode == TABLE_INLINE:
            (blob_len,) = struct.unpack_from("<I", data, off)
            off += 4
            blob = data[off:off + blob_len]
            hit = key_memo.get(h) if key_memo is not None else None
            if hit is not None and len(hit[1]) == S and hit[0] == blob:
                part_keys = hit[1]
            else:
                part_keys = _decode_key_table(blob, S)
                if key_memo is not None:
                    key_memo[h] = (blob, part_keys)
            off += blob_len
            if tables is not None:
                tables[h] = part_keys
        elif mode == TABLE_REF:
            part_keys = (tables or {}).get(h)
            if part_keys is None or len(part_keys) != S:
                raise WalCorruption(
                    f"key-table ref {h.hex()} not interned earlier in "
                    "this segment")
        else:
            raise WalCorruption(f"unknown key-table mode {mode}")
        n = S * k
        (ts_mode,) = struct.unpack_from("<B", data, off)
        off += 1
        if ts_mode == 1:
            row = np.frombuffer(data, dtype=np.int64, count=k,
                                offset=off).copy()
            # read-only broadcast view: replay's ingest_columns only
            # reads the grid, so S copies never materialize
            ts = np.broadcast_to(row, (S, k))
            off += 8 * k
        elif ts_mode == 0:
            ts = np.frombuffer(data, dtype=np.int64, count=n,
                               offset=off).reshape(S, k).copy()
            off += 8 * n
        else:
            raise WalCorruption(f"unknown ts mode {ts_mode}")
        (ncols,) = struct.unpack_from("<H", data, off)
        off += 2
        columns: Dict[str, np.ndarray] = {}
        for _ in range(ncols):
            (clen,) = struct.unpack_from("<B", data, off)
            off += 1
            cname = data[off:off + clen].decode("utf-8")
            off += clen
            (B,) = struct.unpack_from("<I", data, off)
            off += 4
            cnt = n * (B or 1)
            arr = np.frombuffer(data, dtype=np.float64, count=cnt,
                                offset=off)
            columns[cname] = (arr.reshape(S, k, B) if B
                              else arr.reshape(S, k)).copy()
            off += 8 * cnt
        (nles,) = struct.unpack_from("<H", data, off)
        off += 2
        les = None
        if nles:
            les = np.frombuffer(data, dtype=np.float64, count=nles,
                                offset=off).copy()
        return WalRecord(seq, shard, schema, part_keys, ts, columns, les)


TABLE_INLINE, TABLE_REF = 0, 1

# key-table encode memo: streaming sources reuse ONE part_keys list
# across appends (the shard's _resolve_key_table pattern), so the
# per-key length-prefix loop and the content hash — the only per-series
# Python on the WAL append path — run once per table, not once per
# scrape cycle.  Keyed by list identity, validated by the pinned
# reference.
_KEY_BLOB_MEMO: Dict[int, tuple] = {}
_KEY_BLOB_MEMO_MAX = 8


def key_table_entry(part_keys) -> Tuple[bytes, bytes]:
    """-> (serialized table blob, blake2b-64 content hash)."""
    import hashlib
    ent = _KEY_BLOB_MEMO.get(id(part_keys))
    if ent is not None and ent[0] is part_keys \
            and len(part_keys) == ent[3]:
        return ent[1], ent[2]
    buf = bytearray()
    for pk in part_keys:
        kb = pk.to_bytes()
        buf += struct.pack("<I", len(kb))
        buf += kb
    blob = bytes(buf)
    h = hashlib.blake2b(blob, digest_size=8).digest()
    if isinstance(part_keys, list):
        _KEY_BLOB_MEMO[id(part_keys)] = (part_keys, blob, h,
                                         len(part_keys))
        while len(_KEY_BLOB_MEMO) > _KEY_BLOB_MEMO_MAX:
            _KEY_BLOB_MEMO.pop(next(iter(_KEY_BLOB_MEMO)))
    return blob, h


# key-table decode memo: replay re-reads the same inlined table once
# per segment; decoding S PartKeys per occurrence (65k+ Python object
# builds) would dominate replay, so decoded lists are shared by blob
# content.  Returning the SAME list object also lets the shard's
# _resolve_key_table identity cache hit across replayed records.
_KEY_DECODE_MEMO: Dict[bytes, list] = {}
_KEY_DECODE_MEMO_MAX = 8


def _decode_key_table(raw: bytes, S: int) -> list:
    got = _KEY_DECODE_MEMO.get(raw)
    if got is not None and len(got) == S:
        return got
    part_keys = []
    off = 0
    for _ in range(S):
        (ln,) = struct.unpack_from("<I", raw, off)
        off += 4
        part_keys.append(PartKey.from_bytes(raw[off:off + ln]))
        off += ln
    if off != len(raw):
        raise WalCorruption("key-table blob length mismatch")
    _KEY_DECODE_MEMO[raw] = part_keys
    while len(_KEY_DECODE_MEMO) > _KEY_DECODE_MEMO_MAX:
        _KEY_DECODE_MEMO.pop(next(iter(_KEY_DECODE_MEMO)))
    return part_keys


# --------------------------------------------------------------- framing

def frame_record(body: bytes) -> bytes:
    """body -> [len][crc][snappy(body)] — the on-disk unit."""
    frame = snappy.compress(body)
    return _FRAME_HDR.pack(len(frame), zlib.crc32(frame)) + frame


def segment_path(dir_path: str, first_seq: int) -> str:
    return os.path.join(dir_path, f"wal-{first_seq:016d}.seg")


def list_segments(dir_path: str) -> List[Tuple[int, str]]:
    """(first_seq, path) ascending for every segment in the directory."""
    out = []
    if not os.path.isdir(dir_path):
        return out
    for name in os.listdir(dir_path):
        if name.startswith("wal-") and name.endswith(".seg"):
            try:
                out.append((int(name[4:-4]), os.path.join(dir_path, name)))
            except ValueError:
                continue
    out.sort()
    return out


def write_segment_header(f) -> None:
    f.write(_HEADER)


def read_records(path: str) -> Iterator[bytes]:
    """Yield decompressed record BODIES in append order.

    A short/CRC-failed TAIL frame ends iteration cleanly (crash-torn
    final write: nothing after it was ever acknowledged).  A CRC failure
    with MORE data after it raises WalCorruption — acknowledged records
    are unreachable and the operator must know."""
    with open(path, "rb") as f:
        header = f.read(len(_HEADER))
        if len(header) < len(_HEADER) or header[:4] != MAGIC:
            raise WalCorruption(f"{path}: bad segment header")
        version = struct.unpack_from("<H", header, 4)[0]
        if version != VERSION:
            raise WalCorruption(f"{path}: unsupported WAL version {version}")
        data = f.read()
    pos, n = 0, len(data)
    while pos < n:
        if pos + _FRAME_HDR.size > n:
            return                                    # torn tail header
        frame_len, crc = _FRAME_HDR.unpack_from(data, pos)
        start = pos + _FRAME_HDR.size
        end = start + frame_len
        if end > n:
            return                                    # torn tail frame
        frame = data[start:end]
        if zlib.crc32(frame) != crc:
            if end < n:
                raise WalCorruption(
                    f"{path}: CRC mismatch at offset {pos} with "
                    f"{n - end} bytes following — mid-log corruption")
            return                                    # torn tail bytes
        try:
            yield snappy.decompress(frame)
        except ValueError as e:
            raise WalCorruption(
                f"{path}: CRC-valid frame failed snappy decode at "
                f"offset {pos}: {e}") from e
        pos = end
