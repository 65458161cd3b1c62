"""Columnar cold segments, the historical tier's scan layout (port of
filodb_tpu/persist/segments.py).

Flushed chunkset frames (persist/localstore.py) are the write shape: one
frame per (partition, flush), decoded one series at a time.  The
compactor (persist/compactor.py) rewrites closed time windows into
segments: per (dataset, shard, schema, window) files holding one
rectangular [S, T] block per column, NibblePack-encoded as one stream
(value columns in row slabs), so a column decodes once per segment.  The
read path then serves history through the same dense [S, T] kernels as
the in-memory working set.

File layout (one CRC-framed payload, atomic tmp+rename writes), the
reference's to the byte:

    magic/version/schema | t0 t1 S T n_cols source_chunks | bucket les
    counts int32[S] | part-key table | ts (pack_i64 of ts-t0, flattened)
    per column: name, kind, base/slope/num_buckets, payload

Values are stored raw (not reset-corrected): correction and rebasing
happen at page-in (ColdBlock) with the host ops the leaf's host gather
uses, and the block's arrays are uploaded with torch in the hot
mirror's types (int32 offsets, f32 rebased values).  Histogram columns
are not segmented (hist schemas stay on the chunk-frame paging path).
"""
from __future__ import annotations

import dataclasses
import os
import struct
import threading
import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.memory import nibblepack
from filodb_tpu_torch.memory.chunks import (ColumnChunk, decode_column,
                                      encode_double_column)

_MAGIC_SEG = 0xF1D05E60
_SEG_VERSION = 1

COLD_VALUE_DTYPE = np.float32
"""The cold blocks' value type: the hot DeviceMirror's (f32), so hot and
cold columns feed the same kernels."""


@dataclasses.dataclass(frozen=True)
class SegmentMeta:
    """Cheap header peek of one segment file — enough for planning
    (coverage floors/ceilings) and cache sizing without decoding data."""
    path: str
    dataset: str
    shard: int
    schema_name: str
    start_ms: int                # window [start_ms, end_ms)
    end_ms: int
    num_series: int
    num_steps: int               # T — padded time axis length
    num_cols: int
    num_samples: int             # sum(counts) — the scan-limit estimate
    source_chunks: int           # chunk frames folded in (staleness check)
    file_bytes: int
    mtime_ns: int

    @property
    def key(self) -> tuple:
        """Cache identity: path + mtime — a rewritten segment is a new
        cold-region entry, never a stale hit."""
        return (self.path, self.mtime_ns)

    def device_bytes_estimate(self, value_itemsize: int = 4) -> int:
        """Upload estimate: int32 ts offsets + f32 value columns."""
        return self.num_series * self.num_steps * (4 + value_itemsize
                                                   * self.num_cols)


# ------------------------------------------------------------------ codec

def encode_segment(schema_name: str, start_ms: int, end_ms: int,
                   part_keys: Sequence[PartKey], counts: np.ndarray,
                   ts: np.ndarray, cols: Dict[str, np.ndarray],
                   bucket_les: Optional[np.ndarray] = None,
                   source_chunks: int = 0) -> bytes:
    """Payload bytes for one segment.  ts int64 [S, T] (cells beyond each
    row's count ignored), cols f64 [S, T]."""
    S, T = ts.shape
    sn = schema_name.encode()
    les = (np.asarray(bucket_les, np.float64).tobytes()
           if bucket_les is not None else b"")
    parts = [struct.pack("<IHH", _MAGIC_SEG, _SEG_VERSION, len(sn)), sn,
             struct.pack("<qqiiiiH", start_ms, end_ms, S, T, len(cols),
                         source_chunks, len(les) // 8), les,
             np.asarray(counts, np.int32).tobytes()]
    for pk in part_keys:
        b = pk.to_bytes()
        parts.append(struct.pack("<H", len(b)) + b)
    # ts: ONE NibblePack stream for the whole block, residual-coded
    # against each row's line `first + slope*j` (slope = the typical
    # scrape interval, row firsts stored raw [S]): on a scrape grid every
    # residual is exactly 0, so pack/unpack hit the all-zero fast paths —
    # tiny payloads and near-memcpy decode, which is what keeps cold
    # page-in at scan speed.  (A single dd line over the flattened block
    # restarts at every row boundary and blows residuals up to window
    # size — measured 26M vals/s vs effectively-memcpy here.)
    pos = np.arange(T)[None, :]
    counts_a = np.asarray(counts)
    rel = np.where(pos < counts_a[:, None],
                   np.asarray(ts, np.int64) - start_ms, 0)
    rel0 = rel[:, 0].copy() if T else np.zeros(S, np.int64)
    multi = counts_a > 1
    slope = int(np.median(rel[multi, 1] - rel[multi, 0])) \
        if multi.any() and T > 1 else 0
    res = rel - rel0[:, None] - slope * pos.astype(np.int64)
    res[pos >= counts_a[:, None]] = 0
    ts_payload = nibblepack.pack_i64(res.reshape(-1))
    parts.append(struct.pack("<qqI", 0, slope, len(ts_payload)))
    parts.append(rel0.astype(np.int64).tobytes())
    parts.append(ts_payload)
    # value columns: NibblePack streams in independent row SLABS, so the
    # read path decodes one column with the whole pool (decode wall = one
    # slab, not the column)
    slab_rows = max(256, -(-S // 8))
    for name, arr in cols.items():
        v = np.where(pos < np.asarray(counts)[:, None],
                     np.asarray(arr, np.float64), 0.0)
        nb = name.encode()
        slabs = [encode_double_column(v[r0: r0 + slab_rows].reshape(-1))
                 for r0 in range(0, S, slab_rows)] if S else []
        parts.append(struct.pack("<HHI", len(nb), len(slabs), slab_rows))
        parts.append(nb)
        for cc in slabs:
            kb = cc.kind.encode()
            parts.append(struct.pack("<H", len(kb)) + kb)
            parts.append(struct.pack("<qqiI", cc.base, cc.slope,
                                     cc.num_buckets, len(cc.payload)))
            parts.append(cc.payload)
    return b"".join(parts)


def _parse_header(data: bytes) -> Tuple[dict, int]:
    """Fixed header + part-key table -> (fields dict, offset past header)."""
    off = 0
    magic, version, sn_len = struct.unpack_from("<IHH", data, off)
    off += 8
    if magic != _MAGIC_SEG:
        raise ValueError("not a segment file")
    if version != _SEG_VERSION:
        raise ValueError(f"unsupported segment version {version}")
    schema_name = data[off: off + sn_len].decode()
    off += sn_len
    t0, t1, S, T, n_cols, source_chunks, n_les = struct.unpack_from(
        "<qqiiiiH", data, off)
    off += 34
    les = None
    if n_les:
        les = np.frombuffer(data[off: off + 8 * n_les],
                            dtype=np.float64).copy()
        off += 8 * n_les
    counts = np.frombuffer(data[off: off + 4 * S], dtype=np.int32).copy()
    off += 4 * S
    pk_bytes: List[bytes] = []
    for _ in range(S):
        (ln,) = struct.unpack_from("<H", data, off)
        off += 2
        pk_bytes.append(data[off: off + ln])
        off += ln
    return {"schema_name": schema_name, "start_ms": t0, "end_ms": t1,
            "S": S, "T": T, "n_cols": n_cols,
            "source_chunks": source_chunks, "bucket_les": les,
            "counts": counts, "pk_bytes": pk_bytes}, off


_DECODE_POOL = None
_DECODE_POOL_LOCK = threading.Lock()


def _decode_pool():
    """Shared thread pool for block decodes: NibblePack unpack is NumPy
    (releases the GIL), so a segment's columns — and concurrent segment
    page-ins at the leaf — decode in parallel."""
    global _DECODE_POOL
    if _DECODE_POOL is None:
        with _DECODE_POOL_LOCK:
            if _DECODE_POOL is None:
                import concurrent.futures
                workers = max(2, min(8, (os.cpu_count() or 2)))
                _DECODE_POOL = concurrent.futures.ThreadPoolExecutor(
                    max_workers=workers,
                    thread_name_prefix="filodb-seg-decode")
    return _DECODE_POOL


def decode_segment(data: bytes) -> Tuple[dict, np.ndarray,
                                         Dict[str, np.ndarray]]:
    """-> (header fields, ts int64 [S, T], cols f64 [S, T]).  Cells beyond
    each row's count come back as NaN (values) / 0-from-window-start (ts)
    so downstream dense-detection never mistakes padding for data.
    Columns decode in parallel on the shared pool — one unpack per COLUMN
    per segment is already the design point; overlapping them keeps the
    cold page-in wall at the widest column, not the sum."""
    hdr, off = _parse_header(data)
    S, T = hdr["S"], hdr["T"]
    _, ts_slope, ts_len = struct.unpack_from("<qqI", data, off)
    off += 20
    ts_rel0 = np.frombuffer(data[off: off + 8 * S], dtype=np.int64)
    off += 8 * S
    ts_payload = data[off: off + ts_len]
    off += ts_len
    pos = np.arange(T)[None, :]
    pad = pos >= hdr["counts"][:, None]
    col_specs = []
    for _ in range(hdr["n_cols"]):
        nl, n_slabs, slab_rows = struct.unpack_from("<HHI", data, off)
        off += 8
        name = data[off: off + nl].decode()
        off += nl
        slabs = []
        for si in range(n_slabs):
            (kl,) = struct.unpack_from("<H", data, off)
            off += 2
            kind = data[off: off + kl].decode()
            off += kl
            base, slope, num_buckets, plen = struct.unpack_from(
                "<qqiI", data, off)
            off += 24
            slabs.append((si * slab_rows,
                          min(slab_rows, S - si * slab_rows),
                          ColumnChunk(kind, data[off: off + plen],
                                      base=base, slope=slope,
                                      num_buckets=num_buckets)))
            off += plen
        col_specs.append((name, slabs))

    def _ts():
        res = nibblepack.unpack_i64(ts_payload, S * T).reshape(S, T)
        rel = (res.astype(np.int64) + ts_rel0[:, None]
               + ts_slope * np.arange(T, dtype=np.int64)[None, :])
        return rel + hdr["start_ms"]

    pool = _decode_pool()
    ts_fut = pool.submit(_ts)
    cols = {name: np.empty((S, T), np.float64) for name, _ in col_specs}

    def _slab(out, r0, rn, cc):
        out[r0: r0 + rn] = decode_column(cc, rn * T).reshape(rn, T)

    slab_futs = [pool.submit(_slab, cols[name], r0, rn, cc)
                 for name, slabs in col_specs
                 for r0, rn, cc in slabs]
    ts = ts_fut.result()
    for f in slab_futs:
        f.result()
    for name in cols:
        cols[name][pad] = np.nan
    return hdr, ts, cols


def _read_framed(path: str) -> bytes:
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12:
            raise ValueError(f"truncated segment {path}")
        magic, length, crc = struct.unpack("<IIi", head)
        if magic != _MAGIC_SEG:
            raise ValueError(f"bad segment frame magic in {path}")
        payload = f.read(length)
    if len(payload) < length or (zlib.crc32(payload) & 0x7FFFFFFF) != crc:
        raise ValueError(f"corrupt segment {path}")
    return payload


def write_segment_file(path: str, payload: bytes) -> None:
    """Atomic framed write (tmp + rename, the checkpoint-file stance)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    head = struct.pack("<IIi", _MAGIC_SEG, len(payload),
                       zlib.crc32(payload) & 0x7FFFFFFF)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(head + payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def peek_segment_meta(path: str, dataset: str, shard: int) -> SegmentMeta:
    """Header-only read: coverage + sizing without decoding columns."""
    st = os.stat(path)
    with open(path, "rb") as f:
        head = f.read(12 + 8 + 256)
    magic, _, _ = struct.unpack_from("<IIi", head, 0)
    if magic != _MAGIC_SEG:
        raise ValueError(f"bad segment frame magic in {path}")
    m2, version, sn_len = struct.unpack_from("<IHH", head, 12)
    if m2 != _MAGIC_SEG or version != _SEG_VERSION:
        raise ValueError(f"bad segment header in {path}")
    off = 12 + 8 + sn_len
    schema_name = head[off - sn_len: off].decode()
    t0, t1, S, T, n_cols, source_chunks, _ = struct.unpack_from(
        "<qqiiiiH", head, off)
    # num_samples needs counts — read just that slab
    hdr_fixed_end = off + 34
    les_n = struct.unpack_from("<H", head, off + 32)[0]
    with open(path, "rb") as f:
        f.seek(hdr_fixed_end + 8 * les_n)
        counts = np.frombuffer(f.read(4 * S), dtype=np.int32)
    return SegmentMeta(path=path, dataset=dataset, shard=shard,
                       schema_name=schema_name, start_ms=t0, end_ms=t1,
                       num_series=S, num_steps=T, num_cols=n_cols,
                       num_samples=int(counts.sum()),
                       source_chunks=source_chunks,
                       file_bytes=st.st_size, mtime_ns=st.st_mtime_ns)


# ------------------------------------------------------------------ store

class SegmentStore:
    """Directory of segments per (dataset, shard):

        <root>/<dataset>/shard-<N>/segments/<schema>-<t0>-<t1>.seg

    Listing peeks headers and caches per (path, size, mtime) so the
    planner's coverage probes stay cheap."""

    def __init__(self, root: str):
        self.root = root
        self._lock = threading.Lock()
        self._meta_cache: Dict[str, Tuple[int, int, SegmentMeta]] = {}

    def seg_dir(self, dataset: str, shard: int) -> str:
        return os.path.join(self.root, dataset, f"shard-{shard}", "segments")

    @staticmethod
    def seg_name(schema_name: str, start_ms: int, end_ms: int) -> str:
        return f"{schema_name}-{start_ms}-{end_ms}.seg"

    def write(self, dataset: str, shard: int, schema_name: str,
              start_ms: int, end_ms: int, payload: bytes) -> str:
        path = os.path.join(self.seg_dir(dataset, shard),
                            self.seg_name(schema_name, start_ms, end_ms))
        write_segment_file(path, payload)
        return path

    def list(self, dataset: str, shard: int) -> List[SegmentMeta]:
        d = self.seg_dir(dataset, shard)
        if not os.path.isdir(d):
            return []
        out: List[SegmentMeta] = []
        with self._lock:
            for entry in sorted(os.listdir(d)):
                if not entry.endswith(".seg"):
                    continue
                path = os.path.join(d, entry)
                try:
                    st = os.stat(path)
                    cached = self._meta_cache.get(path)
                    if cached is not None and cached[0] == st.st_size \
                            and cached[1] == st.st_mtime_ns:
                        out.append(cached[2])
                        continue
                    meta = peek_segment_meta(path, dataset, shard)
                    self._meta_cache[path] = (st.st_size, st.st_mtime_ns,
                                              meta)
                    out.append(meta)
                except (OSError, ValueError):
                    continue            # torn write mid-compaction: skip
        out.sort(key=lambda m: m.start_ms)
        return out

    def covering(self, dataset: str, shard: int, start_ms: int,
                 end_ms: int,
                 schema_name: Optional[str] = None) -> List[SegmentMeta]:
        return [m for m in self.list(dataset, shard)
                if m.start_ms <= end_ms and m.end_ms > start_ms
                and (schema_name is None or m.schema_name == schema_name)]

    def load(self, meta: SegmentMeta):
        return decode_segment(_read_framed(meta.path))

    def remove(self, meta: SegmentMeta) -> None:
        try:
            os.remove(meta.path)
        except OSError:
            pass
        with self._lock:
            self._meta_cache.pop(meta.path, None)


# -------------------------------------------------------------- cold block

_cold_serial_lock = threading.Lock()
_cold_serial = [0]


def _next_cold_serial() -> int:
    with _cold_serial_lock:
        _cold_serial[0] += 1
        return _cold_serial[0]


class SegmentIdentity:
    """The per-series state of one part-key table: PartKey objects, the
    filter index, and the (lazily built) RangeVectorKeys.  Segments of one
    shard share their part-key table across windows almost always, so this
    is built ONCE per distinct table and shared across ColdBlocks — the
    per-series Python loop (the dominant cold page-in cost at high
    cardinality) runs once, not once per segment."""

    def __init__(self, pk_bytes: Sequence[bytes]):
        from filodb_tpu_torch.core.index import PartKeyIndex
        self.pk_bytes = [bytes(b) for b in pk_bytes]
        self.part_keys = [PartKey.from_bytes(b) for b in pk_bytes]
        self.index = PartKeyIndex()
        for row, pk in enumerate(self.part_keys):
            # liveness 0..MAX: the covering() probe already selected the
            # segment by time — the index only answers label filters
            self.index.add_partition(row, pk, 0)
        self.keys: List[Optional[object]] = [None] * len(self.part_keys)


# process-wide interning of part-key tables: every segment of a shard
# (and every tier instance over the same files) shares ONE identity per
# distinct table, so the per-series Python loop — the dominant cold
# page-in cost at high cardinality — runs once per table, not once per
# segment.  Bounded LRU; tables are immutable so sharing is always safe.
_IDENT_CACHE: Dict[tuple, SegmentIdentity] = {}
_IDENT_LOCK = threading.Lock()
_IDENT_BUILD_LOCK = threading.Lock()


def identity_for(pk_bytes: Sequence[bytes]) -> SegmentIdentity:
    """The interned identity of one part-key table.  Builds run one at a
    time (_IDENT_BUILD_LOCK), so the segments of one shard paged in
    concurrently build their shared table once, not once a thread (the
    reference lets every thread build it and keeps the first)."""
    key = tuple(pk_bytes)

    def cached():
        with _IDENT_LOCK:
            ident = _IDENT_CACHE.get(key)
            if ident is not None:
                _IDENT_CACHE[key] = _IDENT_CACHE.pop(key)     # LRU touch
            return ident
    ident = cached()
    if ident is not None:
        return ident
    with _IDENT_BUILD_LOCK:
        ident = cached()
        if ident is not None:
            return ident
        ident = SegmentIdentity(pk_bytes)
        with _IDENT_LOCK:
            _IDENT_CACHE[key] = ident
            while len(_IDENT_CACHE) > 16:
                _IDENT_CACHE.pop(next(iter(_IDENT_CACHE)))
    return ident


class ColdBlock:
    """One decoded and (unless over the cold budget) device-resident
    segment: the unit the cold region pages and evicts.  Values are
    counter-corrected within the segment and rebased per series in f64,
    then held as f32, the hot DeviceMirror's value type; per-row first
    and last raw values and the cumulative drop let the leaf chain the
    correction across segments at query time.

    `device` is a torch.device: ts_off (int32) and the value columns
    become tensors there with torch.as_tensor, and a failed upload
    raises.  The string "host" keeps numpy arrays (the cold region's
    over-budget degrade)."""

    def __init__(self, meta: SegmentMeta, schema, hdr, ts: np.ndarray,
                 cols: Dict[str, np.ndarray], device,
                 identity: Optional[SegmentIdentity] = None):
        from filodb_tpu_torch.ops.counter import rebase_values
        from filodb_tpu_torch.ops.timewindow import to_offsets
        self.meta = meta
        self.serial = _next_cold_serial()
        self.device = device
        self.counts = hdr["counts"].astype(np.int64)
        self.identity = identity or SegmentIdentity(hdr["pk_bytes"])
        self.part_keys = self.identity.part_keys
        self.bucket_les = hdr["bucket_les"]
        self.index = self.identity.index
        self._keys = self.identity.keys
        counter_cols = {c.name for c in schema.data_columns
                        if c.detect_drops or c.counter}
        self.counter_cols = counter_cols & set(cols)
        ts_off = to_offsets(ts, self.counts, meta.start_ms)
        S = ts.shape[0]
        self.uniform = bool(
            S > 0 and (self.counts == self.counts[0]).all()
            and (ts_off == ts_off[0:1]).all())
        self.ts_row0 = ts_off[0].copy() if self.uniform else None
        self.vbase: Dict[str, np.ndarray] = {}
        self.first_raw: Dict[str, np.ndarray] = {}
        self.last_raw: Dict[str, np.ndarray] = {}
        self.cum_drop: Dict[str, np.ndarray] = {}
        self.dense: Dict[str, bool] = {}
        host_cols: Dict[str, np.ndarray] = {}
        pos = np.arange(ts.shape[1])[None, :]
        pad = pos >= self.counts[:, None]
        for name, raw in cols.items():
            is_counter = name in self.counter_cols
            rebased, vb, corrected = rebase_values(raw, is_counter,
                                                   return_corrected=True)
            self.vbase[name] = np.asarray(vb, np.float64)
            fin = np.isfinite(corrected)
            self.dense[name] = bool((fin | pad).all())
            host_cols[name] = np.asarray(rebased, COLD_VALUE_DTYPE)
            if is_counter:
                lr, cd = _row_tail_state(raw, corrected)
                self.first_raw[name] = _row_first_finite(raw)
                self.last_raw[name] = lr
                self.cum_drop[name] = cd
        self.nbytes = ts_off.nbytes + sum(a.nbytes for a in
                                          host_cols.values())
        if device == "host":
            # the over-budget degrade: numpy arrays serve the same math
            self.ts_off = ts_off
            self.cols = host_cols
        else:
            self.ts_off = torch.as_tensor(ts_off, device=device)
            self.cols = {n: torch.as_tensor(a, device=device)
                         for n, a in host_cols.items()}

    @property
    def is_host(self) -> bool:
        return isinstance(self.ts_off, np.ndarray)

    def keys_for(self, rows: np.ndarray) -> List:
        from filodb_tpu_torch.query.rangevector import RangeVectorKey
        out = []
        for r in rows.tolist():
            k = self._keys[r]
            if k is None:
                pk = self.part_keys[r]
                k = RangeVectorKey.make(
                    {**pk.tags_dict, "_metric_": pk.metric})
                self._keys[r] = k
            out.append(k)
        return out

    def match_rows(self, filters, start_ms: int, end_ms: int) -> np.ndarray:
        rows = self.index.part_ids_from_filters(filters, start_ms, end_ms)
        return np.sort(rows)


def _row_first_finite(raw: np.ndarray) -> np.ndarray:
    v = np.asarray(raw, np.float64)
    finite = np.isfinite(v)
    any_f = finite.any(axis=1)
    first = np.where(any_f, np.argmax(finite, axis=1), 0)
    out = v[np.arange(v.shape[0]), first]
    return np.where(any_f, out, np.nan)


def _row_tail_state(raw: np.ndarray, corrected: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(last_raw, cum_drop) per row — the cross-segment correction carry
    (same state the DeviceMirror keeps for incremental appends)."""
    v = np.asarray(raw, np.float64)
    c = np.asarray(corrected, np.float64)
    finite = np.isfinite(v)
    any_f = finite.any(axis=1)
    last = np.where(any_f, v.shape[1] - 1 -
                    np.argmax(finite[:, ::-1], axis=1), 0)
    rows = np.arange(v.shape[0])
    lr = np.where(any_f, v[rows, last], np.nan)
    cd = np.where(any_f, c[rows, last] - v[rows, last], 0.0)
    return lr, cd


# ------------------------------------------------------------------- tier

# process-local tier registry, keyed by dataset: the tier itself (files +
# the cold region on the node's device) is node-local and never crosses
# the wire, so a dispatched SelectPersistedSegmentsExec encodes only its
# dataset name and the decoder rebinds it to the receiving node's tier
# here (parallel/serialize.py)
_QUERY_TIERS: Dict[str, "PersistedTier"] = {}


def query_tier(dataset: str) -> Optional["PersistedTier"]:
    return _QUERY_TIERS.get(dataset)


class PersistedTier:
    """The query-side face of the historical tier: segment coverage for
    the planner, cold blocks (through the byte-budgeted LRU region) for
    the leaf exec."""

    def __init__(self, store: SegmentStore, dataset: str, num_shards: int,
                 cold_cache, schemas=None,
                 plan_split_ms: int = 2 * 24 * 3600 * 1000):
        from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
        self.store = store
        self.dataset = dataset
        self.num_shards = num_shards
        self.cold_cache = cold_cache
        self.schemas = schemas or DEFAULT_SCHEMAS
        # planner slice width: bounds each leaf's int32 offset span AND
        # the number of segments one leaf must merge
        self.plan_split_ms = plan_split_ms
        self._range_cache: Optional[Tuple[float, Optional[Tuple[int, int]]]] \
            = None
        self._range_lock = threading.Lock()
        # merged-gather cache: a repeat query over the same cold row set
        # (the dashboard-poll shape) reuses the packed multi-segment
        # arrays instead of re-running the merge — entries pin one
        # working-set-sized copy, so the LRU stays tiny
        self._merge_cache: Dict[tuple, object] = {}
        self._merge_cache_max = 2
        # the last tier constructed for a dataset serves decoded cold leaves
        _QUERY_TIERS[dataset] = self

    def covering(self, shard: int, start_ms: int, end_ms: int,
                 schema_name: Optional[str] = None) -> List[SegmentMeta]:
        return self.store.covering(self.dataset, shard, start_ms, end_ms,
                                   schema_name)

    def range(self) -> Optional[Tuple[int, int]]:
        """(floor_ms, ceil_ms) of segment coverage across shards, cached a
        few seconds (sits on the planning hot path), or None when no
        segments exist yet."""
        with self._range_lock:
            now = time.monotonic()
            if self._range_cache is not None \
                    and now - self._range_cache[0] < 5.0:
                return self._range_cache[1]
            lo = hi = None
            for s in range(self.num_shards):
                for m in self.store.list(self.dataset, s):
                    lo = m.start_ms if lo is None else min(lo, m.start_ms)
                    hi = m.end_ms if hi is None else max(hi, m.end_ms)
            out = None if lo is None else (lo, hi)
            self._range_cache = (now, out)
            return out

    def invalidate_range(self) -> None:
        with self._range_lock:
            self._range_cache = None

    def merged_get(self, key: tuple):
        with self._range_lock:
            ent = self._merge_cache.get(key)
            if ent is not None:
                self._merge_cache[key] = self._merge_cache.pop(key)
            return ent

    def merged_put(self, key: tuple, value) -> None:
        with self._range_lock:
            self._merge_cache[key] = value
            while len(self._merge_cache) > self._merge_cache_max:
                self._merge_cache.pop(next(iter(self._merge_cache)))

    def get_block(self, meta: SegmentMeta) -> Tuple[ColdBlock, str]:
        """-> (block, verdict) with verdict 'cold_hit' (region-resident) or
        'cold_paged' (decoded and uploaded now, or host-degraded)."""
        schema = self.schemas[meta.schema_name]

        def build(device):
            hdr, ts, cols = self.store.load(meta)
            return ColdBlock(meta, schema, hdr, ts, cols, device=device,
                             identity=identity_for(hdr["pk_bytes"]))

        itemsize = int(np.dtype(COLD_VALUE_DTYPE).itemsize)
        return self.cold_cache.get(meta.key,
                                   meta.device_bytes_estimate(itemsize),
                                   meta.shard, build)
