"""Metadata exec plans (port of filodb_tpu/query/metaexec.py): series
keys and label names/values per shard, the chunk-metadata debug scan
(SelectChunkInfosExec), and their merge across shards.  All of it is
index and chunk-header work on the host; nothing reaches the device.
"""
from __future__ import annotations

from typing import Dict, List

from filodb_tpu_torch.query.execbase import LeafExecPlan, NonLeafExecPlan
from filodb_tpu_torch.query.rangevector import QueryResult, QueryStats


class SelectChunkInfosExec(LeafExecPlan):
    """Chunk-metadata debug plan: per-partition chunk infos (id, rows,
    time range, bytes, per-column encodings) for the series a filter
    resolves to.  Covers both tiers: sealed chunks in the resident cache
    (else the column store's, for evicted or recovered partitions) and
    the unsealed tail of the dense store (encoding 'dense-unsealed')."""

    def __init__(self, ctx, dataset, shard, filters, start_ms, end_ms,
                 schema=None, col_name=None):
        super().__init__(ctx)
        self.dataset, self.shard = dataset, shard
        self.filters = list(filters)
        self.start_ms, self.end_ms = start_ms, end_ms
        self.schema = schema
        self.col_name = col_name

    def args_str(self):
        return (f"shard={self.shard}, chunkMethod=TimeRangeChunkScan("
                f"{self.start_ms},{self.end_ms}), "
                f"filters={[str(f) for f in self.filters]}, "
                f"col={self.col_name}")

    def _do_execute(self, source):
        shard = source.get_shard(self.dataset, self.shard)
        stats = QueryStats(shards_queried=1)
        if shard is None:
            return None, stats
        lookup = shard.lookup_partitions(self.filters, self.start_ms,
                                         self.end_ms)
        parts_by_schema = lookup.parts_by_schema
        rows = []
        for schema_name, parts in parts_by_schema.items():
            if self.schema and schema_name != self.schema:
                continue
            store = shard.stores[schema_name]
            for p in parts:
                labels = {**p.part_key.tags_dict,
                          "_metric_": p.part_key.metric}
                chunks = [(cs, "resident") for cs in shard.resident.read(
                    p.part_id, self.start_ms, self.end_ms)]
                if not chunks:
                    chunks = [(cs, "persisted")
                              for cs in shard.column_store.read_chunks(
                                  self.dataset, self.shard, p.part_key,
                                  self.start_ms, self.end_ms)]
                for cs, tier in chunks:
                    cols = {name: c.kind for name, c in cs.columns.items()
                            if self.col_name in (None, name)}
                    rows.append({
                        **labels, "shard": self.shard, "partId": p.part_id,
                        "chunkId": cs.info.chunk_id,
                        "numRows": cs.info.num_rows,
                        "startTime": cs.info.start_time_ms,
                        "endTime": cs.info.end_time_ms,
                        "numBytes": cs.nbytes,
                        "ingestionTime": cs.info.ingestion_time_ms,
                        "encodings": cols, "tier": tier})
                # the unsealed dense-store tail is one writable chunk
                cnt = int(store.counts[p.row])
                sealed = int(store.sealed[p.row])
                if cnt > sealed:
                    ts_row = store.ts[p.row, sealed:cnt]
                    t0, t1 = int(ts_row[0]), int(ts_row[-1])
                    if t1 >= self.start_ms and t0 <= self.end_ms:
                        per_cell = sum(
                            (arr.dtype.itemsize
                             * (arr.shape[2] if arr.ndim == 3 else 1))
                            for name, arr in store.cols.items()
                            if arr is not None
                            and self.col_name in (None, name)) + 8
                        rows.append({
                            **labels, "shard": self.shard,
                            "partId": p.part_id, "chunkId": -1,
                            "numRows": cnt - sealed,
                            "startTime": t0, "endTime": t1,
                            "numBytes": (cnt - sealed) * per_cell,
                            "ingestionTime": -1,
                            "encodings": {"*": "dense-unsealed"},
                            "tier": "dense"})
        stats.series_scanned = sum(len(v) for v in parts_by_schema.values())
        return QueryResult([], stats, data=rows), stats


class PartKeysExec(LeafExecPlan):
    """Series keys matching the filters on one shard."""

    def __init__(self, ctx, dataset, shard, filters, start_ms, end_ms):
        super().__init__(ctx)
        self.dataset, self.shard = dataset, shard
        self.filters = list(filters)
        self.start_ms, self.end_ms = start_ms, end_ms

    def args_str(self):
        return f"shard={self.shard}, filters={[str(f) for f in self.filters]}"

    def _do_execute(self, source):
        shard = source.get_shard(self.dataset, self.shard)
        stats = QueryStats(shards_queried=1)
        if shard is None:
            return None, stats
        res = shard.lookup_partitions(self.filters, self.start_ms,
                                      self.end_ms)
        keys = []
        for pids in res.pids_by_schema.values():
            for pid in pids.tolist():
                pk = shard.partitions[pid].part_key
                keys.append({**pk.tags_dict, "_metric_": pk.metric})
        stats.series_scanned = len(keys)
        return QueryResult([], stats, data=keys), stats


class LabelValuesExec(LeafExecPlan):
    """Values of each label (or, with no labels, the label names) among
    the series matching the filters on one shard."""

    def __init__(self, ctx, dataset, shard, filters, labels, start_ms,
                 end_ms):
        super().__init__(ctx)
        self.dataset, self.shard = dataset, shard
        self.filters = list(filters)
        self.labels = list(labels)
        self.start_ms, self.end_ms = start_ms, end_ms

    def args_str(self):
        return (f"shard={self.shard}, labels={self.labels}, "
                f"filters={[str(f) for f in self.filters]}")

    def _do_execute(self, source):
        shard = source.get_shard(self.dataset, self.shard)
        stats = QueryStats(shards_queried=1)
        if shard is None:
            return None, stats
        if not self.labels:                       # a LabelNames query
            return QueryResult(
                [], stats,
                data=shard.index.label_names(self.filters)), stats
        out: Dict[str, List[str]] = {}
        for lbl in self.labels:
            out[lbl] = shard.index.label_values(lbl, self.filters or None)
        return QueryResult([], stats, data=out), stats


def _canon(x):
    """Hashable canonical form for metadata dedup (str or label dict)."""
    return tuple(sorted((k, _canon(v)) for k, v in x.items())) \
        if isinstance(x, dict) else x


class MetadataMergeExec(NonLeafExecPlan):
    """Merge metadata results across shards: lists deduplicated in child
    order, label-value maps unioned and sorted."""

    # per-shard metadata leaves: dup shards (handoff window) answer once
    dedup_shard_children = True

    def compose(self, results, stats):
        merged = None
        seen = set()
        for r in results:
            if not isinstance(r, QueryResult) or r.data is None:
                continue
            if merged is None:
                merged = list(r.data) if isinstance(r.data, list) else r.data
                if isinstance(merged, list):
                    seen = {_canon(x) for x in merged}
            elif isinstance(merged, list):
                for x in r.data:
                    c = _canon(x)
                    if c not in seen:
                        seen.add(c)
                        merged.append(x)
            elif isinstance(merged, dict):
                for k, v in r.data.items():
                    merged[k] = sorted(set(merged.get(k, [])) | set(v))
        return QueryResult([], stats, data=merged, partial=stats.partial)
