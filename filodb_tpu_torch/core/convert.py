"""Carry series state over from plain arrays.

load_reference_arrays fills one of the port's shards with the series a
reference shard holds — part-key labels, timestamps and value columns as
numpy arrays, row i of each array being series i — so both packages can
answer queries over the same state.  Series are created in the given
order, so pids and store rows come out in that order too.  Nothing here
imports the reference package: callers extract the arrays themselves.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np

from filodb_tpu_torch.core.partkey import PartKey


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
        tags = {k: v for k, v in labels.items() if k != "_metric_"}
        keys.append(PartKey.make(labels["_metric_"], tags))
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
