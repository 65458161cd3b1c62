"""Metadata exec plans (port of filodb_tpu/query/metaexec.py): series
keys and label names/values per shard, and their merge across shards.
All of it is index work on the host; nothing reaches the device.

Not ported: SelectChunkInfosExec, the chunk-metadata debug scan, which
SingleClusterPlanner never builds.
"""
from __future__ import annotations

from typing import Dict, List

from filodb_tpu_torch.query.execbase import LeafExecPlan, NonLeafExecPlan
from filodb_tpu_torch.query.rangevector import QueryResult, QueryStats


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
    return tuple(sorted(x.items())) if isinstance(x, dict) else x


class MetadataMergeExec(NonLeafExecPlan):
    """Merge metadata results across shards: lists deduplicated in child
    order, label-value maps unioned and sorted."""

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
