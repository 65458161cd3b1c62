"""Columnar chunk format (port of filodb_tpu/memory/chunks.py).

A chunk is one partition's worth of samples between flush boundaries, encoded
per column (ref: core/.../store/ChunkSetInfo.scala:60-70 for the metadata
fields; memory/.../format/BinaryVector.scala for the per-column vector model).

As in the reference, chunks are *wire/storage* artifacts only.  The
query-hot working set is kept decoded as dense [series, time] arrays (see
core/blockstore.py) because the device wants dense vectorized math, not
branchy bit-unpacking (SURVEY.md section 7 step 1).  Encoding therefore
optimizes for storage/replay, not random access.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional

import numpy as np

from filodb_tpu_torch.memory import nibblepack
from filodb_tpu_torch.memory.histogram import (HistogramBuckets,
                                              decode_hist_matrix,
                                              encode_hist_matrix)


@dataclasses.dataclass(frozen=True)
class ChunkSetInfo:
    """Chunk metadata (ref: store/ChunkSetInfo.scala:60-70: id = timeuuid-like,
    ingestionTime, numRows, startTime, endTime)."""
    chunk_id: int
    ingestion_time_ms: int
    num_rows: int
    start_time_ms: int
    end_time_ms: int


@dataclasses.dataclass
class ColumnChunk:
    """One encoded column of a chunk."""
    kind: str        # 'ts-dd' | 'f64-xor' | 'f64-i64dd' | 'i64-dd' | 'hist-2d'
    payload: bytes
    base: int = 0             # ts-dd/i64-dd: line base
    slope: int = 0            # ts-dd/i64-dd: line slope
    num_buckets: int = 0      # hist-2d

    @property
    def nbytes(self) -> int:
        return len(self.payload)


@dataclasses.dataclass
class ChunkSet:
    info: ChunkSetInfo
    columns: Dict[str, ColumnChunk]
    bucket_scheme: Optional[HistogramBuckets] = None

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.columns.values())


def encode_ts_column(ts: np.ndarray) -> ColumnChunk:
    base, slope, payload = nibblepack.pack_timestamps(ts)
    return ColumnChunk("ts-dd", payload, base=base, slope=slope)


def encode_double_column(vals: np.ndarray) -> ColumnChunk:
    """Doubles: delta-delta-as-long when all values are integral (the
    DeltaDeltaVector trick, ref: memory/.../format/vectors/DoubleVector.scala
    delta-delta-as-long 'when integral' — real counters are integers and
    pack to ~1-2 B/sample), XOR-mantissa packing otherwise."""
    v = np.asarray(vals, dtype=np.float64)
    if (len(v) and np.isfinite(v).all() and (v == np.floor(v)).all()
            and (np.abs(v) < 2.0**53).all()):
        base, slope, deltas = nibblepack.delta_delta_encode(
            v.astype(np.int64))
        return ColumnChunk("f64-i64dd", nibblepack.pack_i64(deltas),
                           base=base, slope=slope)
    return ColumnChunk("f64-xor", nibblepack.pack_f64_xor(v))


def encode_long_column(vals: np.ndarray) -> ColumnChunk:
    base, slope, deltas = nibblepack.delta_delta_encode(vals)
    return ColumnChunk("i64-dd", nibblepack.pack_i64(deltas), base=base, slope=slope)


def encode_hist_column(mat: np.ndarray) -> ColumnChunk:
    return ColumnChunk("hist-2d", encode_hist_matrix(mat), num_buckets=mat.shape[1])


def decode_column(col: ColumnChunk, num_rows: int) -> np.ndarray:
    if col.kind == "ts-dd":
        return nibblepack.unpack_timestamps(col.base, col.slope, col.payload, num_rows)
    if col.kind == "f64-xor":
        return nibblepack.unpack_f64_xor(col.payload, num_rows)
    if col.kind == "f64-i64dd":
        return nibblepack.delta_delta_decode(
            col.base, col.slope,
            nibblepack.unpack_i64(col.payload, num_rows)).astype(np.float64)
    if col.kind == "i64-dd":
        return nibblepack.delta_delta_decode(
            col.base, col.slope, nibblepack.unpack_i64(col.payload, num_rows))
    if col.kind == "hist-2d":
        return decode_hist_matrix(col.payload, num_rows, col.num_buckets)
    raise ValueError(f"unknown column chunk kind {col.kind!r}")


# itertools.count.__next__ is atomic under the GIL — flush encoding runs on
# a thread pool, and a `x[0] += 1` load/add/store would race there
_next_chunk_id = itertools.count(1)


def make_chunk_id() -> int:
    """Monotonic chunk id (the reference uses timeuuid ordering,
    ref ChunkSetInfo 'id=timeuuid'); monotonicity is what recovery relies on."""
    return next(_next_chunk_id)


def encode_chunkset(ts: np.ndarray,
                    columns: Dict[str, np.ndarray],
                    col_types: Dict[str, str],
                    ingestion_time_ms: int,
                    bucket_scheme: Optional[HistogramBuckets] = None) -> ChunkSet:
    """Encode one sealed chunk.  `columns` excludes the timestamp column;
    `col_types` maps column name -> 'double' | 'long' | 'hist'."""
    ts = np.asarray(ts, dtype=np.int64)
    n = len(ts)
    info = ChunkSetInfo(make_chunk_id(), ingestion_time_ms, n,
                        int(ts[0]) if n else 0, int(ts[-1]) if n else 0)
    encoded: Dict[str, ColumnChunk] = {"timestamp": encode_ts_column(ts)}
    for name, vals in columns.items():
        t = col_types[name]
        if t == "double":
            encoded[name] = encode_double_column(vals)
        elif t == "long":
            encoded[name] = encode_long_column(vals)
        elif t == "hist":
            encoded[name] = encode_hist_column(vals)
        else:
            raise ValueError(f"unsupported column type {t!r}")
    return ChunkSet(info, encoded, bucket_scheme)


def decode_chunkset(cs: ChunkSet) -> Dict[str, np.ndarray]:
    return {name: decode_column(col, cs.info.num_rows)
            for name, col in cs.columns.items()}
