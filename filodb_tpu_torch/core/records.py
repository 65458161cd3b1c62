"""Ingest record batches (port of filodb_tpu/core/records.py: RecordBatch,
its binary wire format `to_bytes` / `from_bytes`, byte for byte the
reference's, and RecordBatchBuilder).

A RecordBatch is columnar (SoA): one numpy array per column plus interned
part keys, which the shard appends into its dense series store without
per-record object churn.
"""
from __future__ import annotations

import dataclasses
import io
import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, Schema, Schemas

_MAGIC = b"FTRB"
# v2: histogram columns ship as concatenated NibblePack'd BinaryHistogram
# blobs (memory/binhist.py) instead of raw f64 matrices; v1 frames are
# still read
_VERSION = 2


@dataclasses.dataclass
class RecordBatch:
    """A batch of samples for ONE schema.  part_idx maps each sample row to
    an entry of part_keys (interned, like container-level partKey dedup)."""
    schema: Schema
    part_keys: List[PartKey]
    part_idx: np.ndarray                    # int32 [N] -> index into part_keys
    timestamps: np.ndarray                  # int64 [N] millis
    columns: Dict[str, np.ndarray]          # per data column: [N] f64 or [N, B] hist
    bucket_les: Optional[np.ndarray] = None  # hist schemas: [B] upper bounds

    @property
    def num_records(self) -> int:
        return len(self.timestamps)

    def validate(self) -> None:
        """Raises ValueError unless every column has one entry per record
        (and a histogram column its bucket bounds)."""
        n = self.num_records
        if len(self.part_idx) != n:
            raise ValueError("part_idx length mismatch")
        for c in self.schema.data_columns:
            arr = self.columns[c.name]
            if len(arr) != n:
                raise ValueError(f"column {c.name} length mismatch")
            if c.col_type == "hist" and (arr.ndim != 2
                                         or self.bucket_les is None):
                raise ValueError(f"histogram column {c.name} needs [N, B] "
                                 f"values and bucket_les")

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        buf.write(_MAGIC)
        buf.write(struct.pack("<HH", _VERSION, self.schema.schema_id))
        buf.write(struct.pack("<I", len(self.part_keys)))
        for pk in self.part_keys:
            blob = pk.to_bytes()
            buf.write(struct.pack("<I", len(blob)))
            buf.write(blob)
        n = self.num_records
        buf.write(struct.pack("<I", n))
        buf.write(self.part_idx.astype(np.int32).tobytes())
        buf.write(self.timestamps.astype(np.int64).tobytes())
        ncols = len(self.schema.data_columns)
        buf.write(struct.pack("<H", ncols))
        for c in self.schema.data_columns:
            arr = np.asarray(self.columns[c.name])
            if c.col_type == "hist":
                from filodb_tpu_torch.memory.binhist import \
                    encode_blob_column
                blobs = encode_blob_column(arr, self.bucket_les)
                buf.write(struct.pack("<HI", arr.shape[1], len(blobs)))
                buf.write(blobs)
            else:
                buf.write(struct.pack("<HI", 0, n * 8))
                buf.write(arr.astype(np.float64).tobytes())
        if self.bucket_les is not None:
            buf.write(struct.pack("<H", len(self.bucket_les)))
            buf.write(np.asarray(self.bucket_les, dtype=np.float64).tobytes())
        else:
            buf.write(struct.pack("<H", 0))
        return buf.getvalue()

    @staticmethod
    def from_bytes(data: bytes,
                   schemas: Schemas = DEFAULT_SCHEMAS) -> "RecordBatch":
        buf = io.BytesIO(data)
        magic = buf.read(4)
        if magic != _MAGIC:
            raise ValueError("bad record batch magic")
        version, schema_id = struct.unpack("<HH", buf.read(4))
        if version not in (1, 2):
            raise ValueError(f"unsupported record batch version {version}")
        schema = schemas.by_id[schema_id]
        (npk,) = struct.unpack("<I", buf.read(4))
        part_keys: List[PartKey] = []
        for _ in range(npk):
            (pk_len,) = struct.unpack("<I", buf.read(4))
            part_keys.append(PartKey.from_bytes(buf.read(pk_len)))
        (n,) = struct.unpack("<I", buf.read(4))
        part_idx = np.frombuffer(buf.read(4 * n), dtype=np.int32).copy()
        timestamps = np.frombuffer(buf.read(8 * n), dtype=np.int64).copy()
        (ncols,) = struct.unpack("<H", buf.read(2))
        columns: Dict[str, np.ndarray] = {}
        for c in schema.data_columns[:ncols]:
            nbuckets, nbytes = struct.unpack("<HI", buf.read(6))
            if nbuckets and version >= 2:
                from filodb_tpu_torch.memory.binhist import \
                    decode_blob_column
                mat, _ = decode_blob_column(buf.read(nbytes), n)
                columns[c.name] = mat
            else:
                raw = np.frombuffer(buf.read(nbytes),
                                    dtype=np.float64).copy()
                columns[c.name] = (raw.reshape(n, nbuckets)
                                   if nbuckets else raw)
        (nles,) = struct.unpack("<H", buf.read(2))
        les = (np.frombuffer(buf.read(8 * nles), dtype=np.float64).copy()
               if nles else None)
        return RecordBatch(schema, part_keys, part_idx, timestamps, columns,
                           les)

    @classmethod
    def from_grid(cls, schema: Schema, part_keys: List[PartKey],
                  ts: np.ndarray, columns: Dict[str, np.ndarray],
                  bucket_les: Optional[np.ndarray] = None) -> "RecordBatch":
        """Build a batch from grid-shaped columnar data: ts [S, k] and each
        column [S, k] (or [S, k, B]) where row i belongs to part_keys[i] —
        the scrape-cycle shape.  The flattened part_idx is the canonical
        repeat(arange(S), k) pattern, which the shard's ingest detects and
        routes through the rectangular append path."""
        ts = np.asarray(ts, dtype=np.int64)
        if ts.ndim != 2 or ts.shape[0] != len(part_keys):
            raise ValueError("from_grid: ts must be [num_keys, k]")
        S, k = ts.shape
        cols = {}
        for c in schema.data_columns:
            v = np.asarray(columns[c.name])
            cols[c.name] = v.reshape((S * k,) + v.shape[2:])
        return cls(schema, list(part_keys),
                   np.repeat(np.arange(S, dtype=np.int32), k),
                   ts.reshape(-1), cols, bucket_les)


class RecordBatchBuilder:
    """Accumulates samples and emits RecordBatches.  Part keys are interned
    so a series appearing many times in a batch stores its key once."""

    def __init__(self, schema: Schema):
        self.schema = schema
        self._keys: Dict[PartKey, int] = {}
        self._part_keys: List[PartKey] = []
        self._part_idx: List[int] = []
        self._ts: List[int] = []
        self._cols: Dict[str, list] = {c.name: [] for c in schema.data_columns}
        self._les: Optional[np.ndarray] = None

    def _key_index(self, part_key: PartKey) -> int:
        idx = self._keys.get(part_key)
        if idx is None:
            idx = len(self._part_keys)
            self._keys[part_key] = idx
            self._part_keys.append(part_key)
        return idx

    def add(self, part_key: PartKey, ts_ms: int, **values) -> None:
        self._part_idx.append(self._key_index(part_key))
        self._ts.append(ts_ms)
        for c in self.schema.data_columns:
            self._cols[c.name].append(values[c.name])

    def add_rows(self, part_key: PartKey, ts_ms: np.ndarray,
                 columns: Dict[str, np.ndarray]) -> None:
        """Bulk append many samples of one series (columns arrive as whole
        arrays, no per-row Python dispatch)."""
        idx = self._key_index(part_key)
        n = len(ts_ms)
        self._part_idx.extend([idx] * n)
        self._ts.extend(np.asarray(ts_ms).tolist())
        for c in self.schema.data_columns:
            self._cols[c.name].extend(np.asarray(columns[c.name]))

    def set_bucket_les(self, les: Sequence[float]) -> None:
        self._les = np.asarray(les, dtype=np.float64)

    def build(self) -> RecordBatch:
        cols = {}
        for c in self.schema.data_columns:
            cols[c.name] = np.asarray(self._cols[c.name], dtype=np.float64)
            if c.col_type == "hist" and cols[c.name].ndim == 1:   # empty
                cols[c.name] = cols[c.name].reshape(0, 0)
        batch = RecordBatch(
            self.schema, self._part_keys,
            np.asarray(self._part_idx, dtype=np.int32),
            np.asarray(self._ts, dtype=np.int64), cols, self._les)
        batch.validate()
        return batch
