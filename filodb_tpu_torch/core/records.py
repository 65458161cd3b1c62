"""Ingest record batches (port of filodb_tpu/core/records.py: RecordBatch
and RecordBatchBuilder; the binary wire format, to_bytes / from_bytes,
comes with the wire).

A RecordBatch is columnar (SoA): one numpy array per column plus interned
part keys, which the shard appends into its dense series store without
per-record object churn.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.schemas import Schema


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
