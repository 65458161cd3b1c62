"""Carry series state and record batches over from plain arrays.

load_reference_arrays fills one of the port's shards with the series a
reference shard holds — part-key labels, timestamps and value columns as
numpy arrays, row i of each array being series i — so both packages can
answer queries over the same state.  Series are created in the given
order, so pids and store rows come out in that order too.
record_batch_from_arrays builds the port's RecordBatch from a batch given
as plain arrays, so both packages can ingest the same batches.  Nothing
here imports the reference package: callers extract the arrays
themselves.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np

from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.records import RecordBatch
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, Schemas


def _part_key(labels: Mapping[str, str]) -> PartKey:
    return PartKey.make(labels["_metric_"],
                        {k: v for k, v in labels.items() if k != "_metric_"})


def record_batch_from_arrays(schema: str,
                             part_key_labels: Sequence[Mapping[str, str]],
                             part_idx: np.ndarray, timestamps: np.ndarray,
                             columns: Dict[str, np.ndarray],
                             bucket_les=None,
                             schemas: Schemas = DEFAULT_SCHEMAS
                             ) -> RecordBatch:
    """The port's RecordBatch of schema `schema`: part_key_labels[k] the
    labels of key k (its metric under ``_metric_``), part_idx [N] each
    record's key index, timestamps [N] int64 ms, columns {name: [N] f64,
    or [N, B] for a histogram column with `bucket_les` its B upper
    bounds}."""
    batch = RecordBatch(
        schemas[schema], [_part_key(lb) for lb in part_key_labels],
        np.asarray(part_idx, np.int32), np.asarray(timestamps, np.int64),
        {name: np.asarray(col, np.float64) for name, col in columns.items()},
        None if bucket_les is None else np.asarray(bucket_les, np.float64))
    batch.validate()
    return batch


def load_reference_arrays(memstore, dataset: str, shard: int, *,
                          part_key_labels: Sequence[Mapping[str, str]],
                          ts: np.ndarray, columns: Dict[str, np.ndarray],
                          counts: np.ndarray,
                          schema: str = "prom-counter",
                          bucket_les=None) -> int:
    """part_key_labels[i]: series i's labels, its metric under
    ``_metric_``; ts [S, T] int64 ms; columns {name: [S, T] f64, or
    [S, T, B] for a histogram column with `bucket_les` its B upper
    bounds}; counts [S] valid samples per row (a row's samples are its
    first counts[i] slots).  Returns samples loaded."""
    sh = memstore.setup(dataset, shard)
    counts = np.asarray(counts, np.int64)
    ts = np.asarray(ts, np.int64)
    if len(part_key_labels) != ts.shape[0] or counts.shape[0] != ts.shape[0]:
        raise ValueError("part_key_labels, ts and counts must agree on S")
    keys = []
    for i, labels in enumerate(part_key_labels):
        keys.append(_part_key(labels))
        sh.get_or_create_partition(keys[-1], schema,
                                   int(ts[i, 0]) if counts[i] else 0)
    total = 0
    # one rectangular slab per distinct row length
    for k in np.unique(counts[counts > 0]):
        rows = np.flatnonzero(counts == k)
        total += sh.ingest_columns(
            schema, [keys[r] for r in rows.tolist()], ts[rows, :k],
            {name: np.asarray(col, np.float64)[rows, :k]
             for name, col in columns.items()}, bucket_les=bucket_les)
    return total
