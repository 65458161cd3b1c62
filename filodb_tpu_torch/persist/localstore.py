"""Local-disk persistence backend (port of
filodb_tpu/persist/localstore.py): per-shard append-only log files on
local disk behind the ColumnStore/MetaStore traits (core/store.py).

    <root>/<dataset>/shard-<N>/chunks.log         framed ChunkSets
    <root>/<dataset>/shard-<N>/chunks.log.idx     the frame index sidecar
    <root>/<dataset>/shard-<N>/partkeys.log       framed PartKeyRecord upserts
    <root>/<dataset>/checkpoints-<N>.json         group watermarks (atomic)

The file format is the reference's to the byte, so either package opens
a directory the other wrote.  Part-key upserts are last-write-wins on the
part-key bytes; the chunk frame header carries the ingestion time, so a
sequential scan filters by it without a second table; checkpoints are
written atomically (temp file + rename).

Torn tails: a crash mid-append leaves a truncated or corrupt final frame.
Every frame carries a CRC32 and a length; readers stop at the first bad
frame, which is the recovery contract: data past the last good frame is
replayed from the ingest stream through the group watermarks.
"""
from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.store import ColumnStore, MetaStore, PartKeyRecord
from filodb_tpu_torch.memory.chunks import ChunkSet, ChunkSetInfo, ColumnChunk
from filodb_tpu_torch.memory.histogram import HistogramBuckets

_MAGIC_CHUNK = 0xF1D0C401
_MAGIC_PK = 0xF1D0C402
_MAGIC_PK_DEL = 0xF1D0C403      # part-key tombstone (CardinalityBuster)
_MAGIC_IDX = 0xF1D0C404         # sidecar frame index (chunks.log.idx)
_IDX_VERSION = 1


# ---------------------------------------------------------------- frame codec

def _write_frame(f, magic: int, payload: bytes) -> None:
    header = struct.pack("<IIi", magic, len(payload), zlib.crc32(payload) & 0x7FFFFFFF)
    f.write(header + payload)


def _iter_frames(path: str, magic: int) -> Iterator[Tuple[int, bytes]]:
    """Yield (file_offset, payload) of valid frames; stop silently at a
    torn/corrupt tail."""
    if not os.path.exists(path):
        return
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    n = len(data)
    while off + 12 <= n:
        m, length, crc = struct.unpack_from("<IIi", data, off)
        if m != magic or off + 12 + length > n:
            return
        payload = data[off + 12: off + 12 + length]
        if (zlib.crc32(payload) & 0x7FFFFFFF) != crc:
            return
        yield off, payload
        off += 12 + length


# ------------------------------------------------------------- chunk (de)code

def _encode_chunkset_frame(part_key: PartKey, schema_name: str, cs: ChunkSet) -> bytes:
    pk = part_key.to_bytes()
    scheme = cs.bucket_scheme.as_array().tobytes() if cs.bucket_scheme else b""
    head = struct.pack(
        "<H", len(pk)) + pk + struct.pack(
        "<H", len(schema_name)) + schema_name.encode() + struct.pack(
        "<qqiqqH", cs.info.chunk_id, cs.info.ingestion_time_ms,
        cs.info.num_rows, cs.info.start_time_ms, cs.info.end_time_ms,
        len(scheme) // 8) + scheme + struct.pack("<H", len(cs.columns))
    parts = [head]
    for name, col in cs.columns.items():
        nb = name.encode()
        kb = col.kind.encode()
        parts.append(struct.pack("<HH", len(nb), len(kb)) + nb + kb)
        parts.append(struct.pack("<qqiI", col.base, col.slope,
                                 col.num_buckets, len(col.payload)))
        parts.append(col.payload)
    return b"".join(parts)


def _decode_chunkset_frame(data: bytes) -> Tuple[bytes, str, ChunkSet]:
    off = 0
    (pk_len,) = struct.unpack_from("<H", data, off); off += 2
    pk_bytes = data[off: off + pk_len]; off += pk_len
    (sn_len,) = struct.unpack_from("<H", data, off); off += 2
    schema_name = data[off: off + sn_len].decode(); off += sn_len
    chunk_id, ing_ms, num_rows, start_ms, end_ms, n_les = struct.unpack_from(
        "<qqiqqH", data, off); off += 38
    scheme = None
    if n_les:
        les = np.frombuffer(data[off: off + 8 * n_les], dtype=np.float64)
        scheme = HistogramBuckets(tuple(float(x) for x in les))
        off += 8 * n_les
    (n_cols,) = struct.unpack_from("<H", data, off); off += 2
    cols: Dict[str, ColumnChunk] = {}
    for _ in range(n_cols):
        nl, kl = struct.unpack_from("<HH", data, off); off += 4
        name = data[off: off + nl].decode(); off += nl
        kind = data[off: off + kl].decode(); off += kl
        base, slope, num_buckets, plen = struct.unpack_from("<qqiI", data, off)
        off += 24
        payload = data[off: off + plen]; off += plen
        cols[name] = ColumnChunk(kind, payload, base=base, slope=slope,
                                 num_buckets=num_buckets)
    info = ChunkSetInfo(chunk_id, ing_ms, num_rows, start_ms, end_ms)
    return pk_bytes, schema_name, ChunkSet(info, cols, scheme)


def _encode_pk_frame(r: PartKeyRecord) -> bytes:
    pk = r.part_key.to_bytes()
    sn = r.schema_name.encode()
    return (struct.pack("<H", len(pk)) + pk + struct.pack("<H", len(sn)) + sn
            + struct.pack("<qq", r.start_time_ms, r.end_time_ms))


def _peek_chunk_meta(data: bytes) -> Tuple[bytes, str, int, int, int, int,
                                           int]:
    """Parse only the frame header: (pk_bytes, schema_name, start_ms, end_ms,
    ingestion_ms, num_rows, chunk_id) — no column payload decode."""
    off = 0
    (pk_len,) = struct.unpack_from("<H", data, off); off += 2
    pk_bytes = data[off: off + pk_len]; off += pk_len
    (sn_len,) = struct.unpack_from("<H", data, off); off += 2
    schema_name = data[off: off + sn_len].decode(); off += sn_len
    chunk_id, ing_ms, num_rows, start_ms, end_ms, _ = struct.unpack_from(
        "<qqiqqH", data, off)
    return pk_bytes, schema_name, start_ms, end_ms, ing_ms, num_rows, chunk_id


def _read_frame_at(path: str, offset: int, magic: int) -> Optional[bytes]:
    """Read + CRC-check one frame at a known offset."""
    with open(path, "rb") as f:
        f.seek(offset)
        header = f.read(12)
        if len(header) < 12:
            return None
        m, length, crc = struct.unpack("<IIi", header)
        if m != magic:
            return None
        payload = f.read(length)
    if len(payload) < length or (zlib.crc32(payload) & 0x7FFFFFFF) != crc:
        return None
    return payload


def _decode_pk_frame(data: bytes) -> PartKeyRecord:
    off = 0
    (pk_len,) = struct.unpack_from("<H", data, off); off += 2
    pk = PartKey.from_bytes(data[off: off + pk_len]); off += pk_len
    (sn_len,) = struct.unpack_from("<H", data, off); off += 2
    sn = data[off: off + sn_len].decode(); off += sn_len
    start_ms, end_ms = struct.unpack_from("<qq", data, off)
    return PartKeyRecord(pk, sn, start_ms, end_ms)


# -------------------------------------------------------------------- stores

class _FrameRef:
    """Index entry: where a chunk frame lives + the metadata needed to filter
    reads without decoding (start/end/ingestion time).  chunk_id makes
    writes idempotent: a network client may retry a write whose reply was
    lost after the append landed (persist/netstore)."""
    __slots__ = ("offset", "start_ms", "end_ms", "ingestion_ms", "schema_name",
                 "num_rows", "chunk_id")

    def __init__(self, offset, start_ms, end_ms, ingestion_ms, schema_name,
                 num_rows, chunk_id=0):
        self.offset = offset
        self.start_ms = start_ms
        self.end_ms = end_ms
        self.ingestion_ms = ingestion_ms
        self.schema_name = schema_name
        self.num_rows = num_rows
        self.chunk_id = chunk_id


# ------------------------------------------------------- sidecar index

def _encode_idx(src_size: int, src_mtime_ns: int,
                chunks: Dict[bytes, List["_FrameRef"]]) -> bytes:
    """Sidecar frame index payload: everything _load_shard's full scan
    recovers, without reading the chunk log."""
    n = sum(len(v) for v in chunks.values())
    parts = [struct.pack("<IHQQI", _MAGIC_IDX, _IDX_VERSION, src_size,
                         src_mtime_ns, n)]
    for pk_bytes, refs in chunks.items():
        for r in refs:
            sn = r.schema_name.encode()
            parts.append(struct.pack("<QqqqiqHH", r.offset, r.start_ms,
                                     r.end_ms, r.ingestion_ms, r.num_rows,
                                     r.chunk_id, len(sn), len(pk_bytes)))
            parts.append(sn)
            parts.append(pk_bytes)
    return b"".join(parts)


def _decode_idx(data: bytes, src_size: int, src_mtime_ns: int
                ) -> Optional[Dict[bytes, List["_FrameRef"]]]:
    """-> chunk index, or None when the sidecar is stale (size/mtime
    mismatch) or malformed — callers fall back to the full scan."""
    try:
        magic, version, size, mtime, n = struct.unpack_from("<IHQQI", data,
                                                            0)
        if magic != _MAGIC_IDX or version != _IDX_VERSION \
                or size != src_size or mtime != src_mtime_ns:
            return None
        off = 26
        chunks: Dict[bytes, List[_FrameRef]] = {}
        for _ in range(n):
            (offset, start_ms, end_ms, ing_ms, nrows, cid, sn_len,
             pk_len) = struct.unpack_from("<QqqqiqHH", data, off)
            off += 48
            sn = data[off: off + sn_len].decode()
            off += sn_len
            pk_bytes = bytes(data[off: off + pk_len])
            off += pk_len
            chunks.setdefault(pk_bytes, []).append(
                _FrameRef(offset, start_ms, end_ms, ing_ms, sn, nrows, cid))
        return chunks
    except (struct.error, UnicodeDecodeError):
        return None


class LocalDiskColumnStore(ColumnStore):
    """Append-only chunk + partkey logs per shard.

    The in-memory index maps partKey bytes -> frame offsets + time metadata
    (NOT decoded chunks — a disk tier that pinned every chunk it ever read
    would defeat the memstore's eviction); reads seek + decode on demand.
    Built lazily per shard by one sequential scan on first use; appends keep
    it current.  This is the local-disk stand-in for Cassandra's
    clustering-key lookups.
    """

    def __init__(self, root: str):
        self.root = root
        self._lock = threading.Lock()
        # (dataset, shard) -> partKey bytes -> List[_FrameRef]
        self._chunk_idx: Dict[Tuple[str, int], Dict[bytes, List[_FrameRef]]] = {}
        self._pk_idx: Dict[Tuple[str, int], Dict[bytes, PartKeyRecord]] = {}
        self._files: Dict[str, object] = {}
        # durability-ordering guards (persist/objectstore.py uploader):
        # dataset -> fn(shard, cutoff_ms) -> allowed cutoff.  Every prune
        # clamps through its dataset's guard, whatever code path asked:
        # retention may only advance past windows whose covering segment
        # is upload-acked in the shared tier's manifest
        self.prune_guards: Dict[str, object] = {}

    # -- paths
    def _shard_dir(self, dataset: str, shard: int) -> str:
        return os.path.join(self.root, dataset, f"shard-{shard}")

    def _chunk_path(self, dataset: str, shard: int) -> str:
        return os.path.join(self._shard_dir(dataset, shard), "chunks.log")

    def _pk_path(self, dataset: str, shard: int) -> str:
        return os.path.join(self._shard_dir(dataset, shard), "partkeys.log")

    def _del_path(self, dataset: str, shard: int) -> str:
        return os.path.join(self._shard_dir(dataset, shard),
                            "partkeys.deleted.log")

    def _idx_path(self, dataset: str, shard: int) -> str:
        return self._chunk_path(dataset, shard) + ".idx"

    def initialize(self, dataset: str, num_shards: int) -> None:
        for s in range(num_shards):
            os.makedirs(self._shard_dir(dataset, s), exist_ok=True)

    def _append(self, path: str, magic: int, payload: bytes) -> int:
        """Append one frame; returns the frame's file offset."""
        f = self._files.get(path)
        if f is None:
            # dir creation only on first open, not per frame — a 1M-chunk
            # flush rotation was paying 1M redundant makedirs syscalls
            os.makedirs(os.path.dirname(path), exist_ok=True)
            f = open(path, "ab")
            f.seek(0, os.SEEK_END)   # 'a' mode position is unspecified pre-write
            self._files[path] = f
        offset = f.tell()
        _write_frame(f, magic, payload)
        f.flush()
        return offset

    def _load_shard(self, dataset: str, shard: int) -> None:
        key = (dataset, shard)
        if key in self._chunk_idx:
            return
        chunks = self._load_chunk_index_sidecar(dataset, shard)
        if chunks is None:
            chunks = {}
            for offset, payload in _iter_frames(
                    self._chunk_path(dataset, shard), _MAGIC_CHUNK):
                (pk_bytes, sn, start_ms, end_ms, ing_ms, nrows,
                 cid) = _peek_chunk_meta(payload)
                bucket = chunks.setdefault(pk_bytes, [])
                # duplicate appends (lost-reply write retries) index once
                if any(r.chunk_id == cid for r in bucket):
                    continue
                bucket.append(
                    _FrameRef(offset, start_ms, end_ms, ing_ms, sn, nrows,
                              cid))
        pks: Dict[bytes, PartKeyRecord] = {}
        last_upsert: Dict[bytes, int] = {}
        for off, payload in _iter_frames(self._pk_path(dataset, shard),
                                         _MAGIC_PK):
            r = _decode_pk_frame(payload)
            kb = r.part_key.to_bytes()
            pks[kb] = r                           # last write wins
            last_upsert[kb] = off
        # each tombstone carries the partkeys.log watermark at delete time:
        # a key re-upserted AFTER its deletion (offset past the watermark)
        # stays alive (the cross-file ordering the busted->reingested
        # lifecycle needs)
        for _, payload in _iter_frames(self._del_path(dataset, shard),
                                       _MAGIC_PK_DEL):
            (watermark,) = struct.unpack_from("<Q", payload, 0)
            kb = bytes(payload[8:])
            if last_upsert.get(kb, -1) < watermark:
                pks.pop(kb, None)
        self._chunk_idx[key] = chunks
        self._pk_idx[key] = pks

    def _load_chunk_index_sidecar(self, dataset: str, shard: int
                                  ) -> Optional[Dict[bytes,
                                                     List[_FrameRef]]]:
        """Trust chunks.log.idx when its recorded size/mtime match the
        chunk log; any mismatch (appends since the index was written, torn
        write, old version) falls back to the full frame scan.  Kills the
        O(log) re-scan every open paid on large shards."""
        from filodb_tpu_torch.utils.metrics import registry
        idx_path = self._idx_path(dataset, shard)
        chunk_path = self._chunk_path(dataset, shard)
        try:
            st = os.stat(chunk_path)
            with open(idx_path, "rb") as f:
                data = f.read()
        except OSError:
            return None
        chunks = _decode_idx(data, st.st_size, st.st_mtime_ns)
        registry.counter("chunk_index_sidecar",
                         verdict="hit" if chunks is not None
                         else "stale").increment()
        return chunks

    def write_frame_index(self, dataset: str, shard: int) -> bool:
        """Write the sidecar for one LOADED shard (atomic tmp+rename);
        called from close() so the next open boots from the index."""
        key = (dataset, shard)
        chunks = self._chunk_idx.get(key)
        if chunks is None:
            return False
        chunk_path = self._chunk_path(dataset, shard)
        # flush any open append handle first: the recorded size must match
        # what a fresh open will stat
        f = self._files.get(chunk_path)
        if f is not None:
            f.flush()
        try:
            st = os.stat(chunk_path)
        except OSError:
            return False
        idx_path = self._idx_path(dataset, shard)
        tmp = idx_path + ".tmp"
        with open(tmp, "wb") as out:
            out.write(_encode_idx(st.st_size, st.st_mtime_ns, chunks))
        os.replace(tmp, idx_path)
        return True

    def _fetch(self, dataset: str, shard: int, ref: _FrameRef) -> Optional[ChunkSet]:
        payload = _read_frame_at(self._chunk_path(dataset, shard), ref.offset,
                                 _MAGIC_CHUNK)
        if payload is None:
            return None
        _, _, cs = _decode_chunkset_frame(payload)
        return cs

    # -- ColumnStore API
    def write_chunks(self, dataset, shard, part_key, chunksets, schema_name) -> None:
        with self._lock:
            self._load_shard(dataset, shard)
            path = self._chunk_path(dataset, shard)
            pk_bytes = part_key.to_bytes()
            bucket = self._chunk_idx[(dataset, shard)].setdefault(pk_bytes, [])
            seen = {r.chunk_id for r in bucket}
            for cs in chunksets:
                # idempotent by chunk id: a retried write whose first
                # attempt landed (lost reply) must not double the chunk
                if cs.info.chunk_id in seen:
                    continue
                seen.add(cs.info.chunk_id)
                offset = self._append(
                    path, _MAGIC_CHUNK,
                    _encode_chunkset_frame(part_key, schema_name, cs))
                bucket.append(_FrameRef(offset, cs.info.start_time_ms,
                                        cs.info.end_time_ms,
                                        cs.info.ingestion_time_ms,
                                        schema_name, cs.info.num_rows,
                                        cs.info.chunk_id))

    def write_part_keys(self, dataset, shard, records) -> None:
        with self._lock:
            self._load_shard(dataset, shard)
            path = self._pk_path(dataset, shard)
            idx = self._pk_idx[(dataset, shard)]
            for r in records:
                self._append(path, _MAGIC_PK, _encode_pk_frame(r))
                idx[r.part_key.to_bytes()] = r

    def read_part_keys(self, dataset, shard) -> List[PartKeyRecord]:
        with self._lock:
            self._load_shard(dataset, shard)
            return list(self._pk_idx[(dataset, shard)].values())

    def delete_part_keys(self, dataset, shard, part_keys) -> int:
        """Tombstone part keys so bootstrap stops resurrecting them
        (the CardinalityBuster write path)."""
        with self._lock:
            self._load_shard(dataset, shard)
            idx = self._pk_idx[(dataset, shard)]
            pk_path = self._pk_path(dataset, shard)
            try:
                watermark = os.path.getsize(pk_path)
            except OSError:
                watermark = 0
            n = 0
            for pk in part_keys:
                kb = pk.to_bytes()
                if idx.pop(kb, None) is not None:
                    self._append(self._del_path(dataset, shard),
                                 _MAGIC_PK_DEL,
                                 struct.pack("<Q", watermark) + kb)
                    n += 1
            return n

    def read_chunks(self, dataset, shard, part_key, start_time_ms, end_time_ms):
        with self._lock:
            self._load_shard(dataset, shard)
            refs = [r for r in self._chunk_idx[(dataset, shard)].get(
                        part_key.to_bytes(), [])
                    if r.start_ms <= end_time_ms and r.end_ms >= start_time_ms]
            out = []
            for ref in refs:
                cs = self._fetch(dataset, shard, ref)
                if cs is not None:
                    out.append(cs)
            return out

    def read_chunks_multi(self, dataset, shard, requests):
        """Batched read_chunks: one lock acquisition + one index pass for
        a list of (part_key, start_ms, end_ms) requests — the replay /
        compaction read shape (and one round trip on the netstore)."""
        with self._lock:
            self._load_shard(dataset, shard)
            idx = self._chunk_idx[(dataset, shard)]
            out = []
            for part_key, t0, t1 in requests:
                refs = [r for r in idx.get(part_key.to_bytes(), [])
                        if r.start_ms <= t1 and r.end_ms >= t0]
                chunks = []
                for ref in refs:
                    cs = self._fetch(dataset, shard, ref)
                    if cs is not None:
                        chunks.append(cs)
                out.append(chunks)
            return out

    def iter_chunk_refs(self, dataset: str, shard: int):
        """(pk_bytes, frame-ref) pairs from index metadata only — the
        compactor's window-planning read (no payload decode)."""
        with self._lock:
            self._load_shard(dataset, shard)
            items = [(pk, ref)
                     for pk, lst in self._chunk_idx[(dataset, shard)].items()
                     for ref in lst]
        return items

    def prune_chunks_before(self, dataset: str, shard: int,
                            cutoff_ms: int,
                            ingested_before_ms: Optional[int] = None
                            ) -> int:
        """Retention: rewrite the chunk log keeping only frames whose data
        reaches cutoff_ms or later (end_ms >= cutoff).  With
        `ingested_before_ms`, frames ingested at/after it are kept
        regardless of data age (the compactor's late-backfill guard — a
        frame flushed after the last compaction pass may not be in any
        segment yet).  Atomic (tmp + rename); the in-memory index and the
        sidecar are rebuilt from the surviving frames.  Returns frames
        dropped."""

        guard = self.prune_guards.get(dataset)
        if guard is not None:
            # refuse to prune a window whose covering segment is not yet
            # upload-acked: a crash between prune and a future upload
            # would lose the window (the guard journals
            # retention_blocked_on_upload when it holds back)
            cutoff_ms = min(cutoff_ms, guard(shard, cutoff_ms))

        def _doomed(r) -> bool:
            return r.end_ms < cutoff_ms and (
                ingested_before_ms is None
                or r.ingestion_ms < ingested_before_ms)
        with self._lock:
            self._load_shard(dataset, shard)
            idx = self._chunk_idx[(dataset, shard)]
            doomed = sum(1 for refs in idx.values()
                         for r in refs if _doomed(r))
            if doomed == 0:
                return 0
            path = self._chunk_path(dataset, shard)
            f = self._files.pop(path, None)
            if f is not None:
                f.close()
            tmp = path + ".compact"
            new_idx: Dict[bytes, List[_FrameRef]] = {}
            with open(tmp, "wb") as out:
                for offset, payload in _iter_frames(path, _MAGIC_CHUNK):
                    (pk_bytes, sn, start_ms, end_ms, ing_ms, nrows,
                     cid) = _peek_chunk_meta(payload)
                    if end_ms < cutoff_ms and (
                            ingested_before_ms is None
                            or ing_ms < ingested_before_ms):
                        continue
                    new_off = out.tell()
                    _write_frame(out, _MAGIC_CHUNK, payload)
                    new_idx.setdefault(pk_bytes, []).append(
                        _FrameRef(new_off, start_ms, end_ms, ing_ms, sn,
                                  nrows, cid))
                out.flush()
                os.fsync(out.fileno())
            os.replace(tmp, path)
            self._chunk_idx[(dataset, shard)] = new_idx
            self.write_frame_index(dataset, shard)
            return doomed

    def scan_chunks_by_ingestion_time(
            self, dataset: str, shard: int,
            ingestion_start_ms: int, ingestion_end_ms: int,
    ) -> Iterator[Tuple[PartKey, str, ChunkSet]]:
        """Sequential scan filtered by ingestionTime — the downsampler's read
        path (ref: IngestionTimeIndexTable.scala; DownsamplerMain reads raw
        chunks by ingestion-time window)."""
        with self._lock:
            self._load_shard(dataset, shard)
            items = [(pk_bytes, ref)
                     for pk_bytes, lst in self._chunk_idx[(dataset, shard)].items()
                     for ref in lst
                     if ingestion_start_ms <= ref.ingestion_ms < ingestion_end_ms]
        for pk_bytes, ref in items:
            with self._lock:
                cs = self._fetch(dataset, shard, ref)
            if cs is not None:
                yield PartKey.from_bytes(pk_bytes), ref.schema_name, cs

    def num_chunksets(self, dataset: str, shard: int) -> int:
        with self._lock:
            self._load_shard(dataset, shard)
            return sum(len(v) for v in self._chunk_idx[(dataset, shard)].values())

    def close(self) -> None:
        with self._lock:
            # persist the frame index for every loaded shard so the next
            # open trusts it instead of re-scanning the whole chunk log
            for (dataset, shard) in list(self._chunk_idx):
                try:
                    self.write_frame_index(dataset, shard)
                except OSError:
                    pass                # index is an optimization only
            for f in self._files.values():
                f.close()
            self._files.clear()
            self._chunk_idx.clear()
            self._pk_idx.clear()


class LocalDiskMetaStore(MetaStore):
    """Atomic JSON checkpoint files, one per (dataset, shard).

    Equivalent of the C* CheckpointTable (ref: metastore/CheckpointTable.scala):
    one watermark per flush group; recovery starts at min(watermarks) and
    skips below-watermark records per group.
    """

    def __init__(self, root: str):
        self.root = root
        self._lock = threading.Lock()

    def _path(self, dataset: str, shard: int) -> str:
        return os.path.join(self.root, dataset, f"checkpoints-{shard}.json")

    def write_checkpoint(self, dataset, shard, group, offset) -> None:
        with self._lock:
            path = self._path(dataset, shard)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            cps = self._read(path)
            cps[str(group)] = offset
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(cps, f)
            os.replace(tmp, path)   # atomic on POSIX

    @staticmethod
    def _read(path: str) -> Dict[str, int]:
        if not os.path.exists(path):
            return {}
        try:
            with open(path) as f:
                return json.load(f)
        except (json.JSONDecodeError, OSError):
            return {}

    def read_checkpoints(self, dataset, shard) -> Dict[int, int]:
        with self._lock:
            return {int(g): o for g, o in self._read(self._path(dataset, shard)).items()}
