"""Batch import/export bridge — the Spark-connector analogue (port of
filodb_tpu/jobs/batch_io.py: the same CSV bytes and NPZ arrays).

The reference's legacy `spark/` module exposed FiloDB datasets to Spark
DataFrames for bulk load and batch analytics (ref: spark/src/main/scala/
filodb.spark/ — DataFrame read/write against a dataset).  The
equivalent here trades DataFrames for columnar NPZ bundles (numpy's portable
container — loadable by pandas/arrow/torch in one call) plus CSV for
interchange:

- export_series: filtered raw series -> one NPZ (per-series ts/column
  arrays + label table + histogram bucket boundaries).
- import_series: NPZ bundle -> RecordBatches -> shard ingest (bulk load).
- export_csv: the same data as flat CSV (label columns + timestamp +
  value); histogram columns are skipped — use the NPZ bundle for those.

Round trips are lossless, including histogram bucket schemes.
"""
from __future__ import annotations

import csv
import json
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from filodb_tpu_torch.core.index import ColumnFilter
from filodb_tpu_torch.memory import utf8vec
from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.records import RecordBatch
from filodb_tpu_torch.core.schemas import Schemas, DEFAULT_SCHEMAS


def _iter_series(memstore, dataset: str, filters: Sequence[ColumnFilter],
                 start_ms: int, end_ms: int
                 ) -> Iterator[Tuple[Dict[str, str], str, np.ndarray,
                                     Dict[str, np.ndarray],
                                     Optional[np.ndarray]]]:
    """Yield (labels, schema_name, ts_kept, cols_kept, bucket_les) for every
    matching series across all shards — the one shared gather loop (index
    lookup, demand paging, seqlock snapshot, time-range trim) both
    exporters consume."""
    for shard in memstore.shards_for(dataset):
        lookup = shard.lookup_partitions(filters, start_ms, end_ms)
        for schema_name, pids in lookup.pids_by_schema.items():
            shard.ensure_paged_pids(schema_name, pids, start_ms, end_ms)
            store = shard.stores[schema_name]
            rows = shard.rows_for(pids)
            ts, cols, counts = shard.snapshot_read(
                store, lambda: store.gather_rows(rows))
            for i, pid in enumerate(pids.tolist()):
                n = int(counts[i])
                t = ts[i, :n]
                keep = (t >= start_ms) & (t <= end_ms)
                if not keep.any():
                    continue
                info = shard.partitions[pid]
                labels = {**info.part_key.tags_dict,
                          "_metric_": info.part_key.metric}
                kept = {c: (v[i, :n][keep] if v is not None else None)
                        for c, v in cols.items()}
                yield labels, schema_name, t[keep], kept, store.bucket_les


def export_series(memstore, dataset: str, filters: Sequence[ColumnFilter],
                  start_ms: int, end_ms: int, path: str) -> int:
    """Gather matching raw series across all shards into one NPZ bundle.
    Returns the number of series exported."""
    keys: List[Dict[str, str]] = []
    schema_names: List[str] = []
    arrays: Dict[str, np.ndarray] = {}
    for labels, schema_name, t, cols, les in _iter_series(
            memstore, dataset, filters, start_ms, end_ms):
        i = len(keys)
        keys.append(labels)
        schema_names.append(schema_name)
        arrays[f"ts_{i}"] = t
        for c, v in cols.items():
            if v is not None:
                arrays[f"col_{i}_{c}"] = v
        if les is not None:
            arrays[f"les_{i}"] = np.asarray(les, np.float64)
    # Label table is dict-encoded columnar (memory/utf8vec.py) — the
    # DictUTF8Vector analogue: low-cardinality label columns collapse to a
    # few bits/row instead of repeating strings per series.
    arrays["__labels_dict__"] = np.frombuffer(
        utf8vec.pack_label_table(keys), dtype=np.uint8)
    arrays["__schemas__"] = np.frombuffer(
        json.dumps(schema_names).encode("utf-8"), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)
    return len(keys)


def load_bundle(path: str):
    """(labels, schema_names, per-series {ts, cols, les}) from a bundle."""
    with np.load(path) as z:
        if "__labels_dict__" in z.files:
            labels = utf8vec.unpack_label_table(bytes(z["__labels_dict__"]))
        else:  # bundles written before dict encoding
            labels = json.loads(bytes(z["__labels__"]).decode("utf-8"))
        schemas = json.loads(bytes(z["__schemas__"]).decode("utf-8"))
        # one pass over the archive members (NOT per-series scans: bundles
        # can hold 100k+ series and the member list is large)
        ts_names: Dict[int, str] = {}
        les_names: Dict[int, str] = {}
        col_names: Dict[int, List[Tuple[str, str]]] = {}
        for name in z.files:
            if name.startswith("ts_"):
                ts_names[int(name[3:])] = name
            elif name.startswith("les_"):
                les_names[int(name[4:])] = name
            elif name.startswith("col_"):
                idx_s, col = name[4:].split("_", 1)
                col_names.setdefault(int(idx_s), []).append((col, name))
        series = []
        for i in range(len(labels)):
            series.append({
                "ts": z[ts_names[i]],
                "cols": {c: z[n] for c, n in col_names.get(i, [])},
                "les": z[les_names[i]] if i in les_names else None,
            })
    return labels, schemas, series


def import_series(memstore, dataset: str, path: str,
                  schemas: Schemas = DEFAULT_SCHEMAS,
                  offset: int = -1) -> int:
    """Bulk-load an NPZ bundle through the normal ingest path (gateway
    routing is the caller's job — this targets shard 0 memstores or
    single-shard bulk restores).  Returns samples ingested."""
    labels, schema_names, series = load_bundle(path)
    total = 0
    by_schema: Dict[str, List[int]] = {}
    for i, sname in enumerate(schema_names):
        by_schema.setdefault(sname, []).append(i)
    for sname, idxs in by_schema.items():
        schema = schemas[sname]
        part_keys = []
        part_idx = []
        ts_all = []
        col_all: Dict[str, List[np.ndarray]] = {}
        bucket_les = None
        for j, i in enumerate(idxs):
            lab = dict(labels[i])
            metric = lab.pop("_metric_", lab.pop("__name__", ""))
            part_keys.append(PartKey.make(metric, lab, schemas.part))
            n = len(series[i]["ts"])
            part_idx.append(np.full(n, j, dtype=np.int32))
            ts_all.append(series[i]["ts"])
            for c, v in series[i]["cols"].items():
                col_all.setdefault(c, []).append(v)
            if series[i]["les"] is not None:
                bucket_les = series[i]["les"]
        batch = RecordBatch(
            schema, part_keys,
            np.concatenate(part_idx),
            np.concatenate(ts_all).astype(np.int64),
            {c: np.concatenate(vs) for c, vs in col_all.items()},
            bucket_les=bucket_les)
        for shard in memstore.shards_for(dataset):
            total += shard.ingest(batch, offset=offset)
            break                      # single-shard bulk restore
    return total


def export_csv(memstore, dataset: str, filters: Sequence[ColumnFilter],
               start_ms: int, end_ms: int, path: str,
               value_column: Optional[str] = None) -> int:
    """Flat CSV: one row per sample, label columns + timestamp + value.
    Histogram columns are skipped (use the NPZ bundle for those)."""
    rows_written = 0
    label_names: List[str] = []
    samples = []
    schemas = memstore.schemas
    for labels, schema_name, t, cols, _les in _iter_series(
            memstore, dataset, filters, start_ms, end_ms):
        schema = schemas[schema_name]
        col = value_column or schema.value_column
        if schema.column(col).col_type == "hist":
            continue
        for k in labels:
            if k not in label_names:
                label_names.append(k)
        vals = cols[col]
        for tt, vv in zip(t, vals):
            samples.append((labels, int(tt), float(vv)))
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(label_names + ["timestamp", "value"])
        for lab, tt, vv in samples:
            w.writerow([lab.get(k, "") for k in label_names] + [tt, vv])
            rows_written += 1
    return rows_written
