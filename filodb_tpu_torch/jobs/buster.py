"""CardinalityBuster — delete runaway-cardinality part keys (port of
filodb_tpu/jobs/buster.py).

ref: spark-jobs/.../CardinalityBusterMain.scala (104) + cardbuster/ (74):
when a misbehaving tenant explodes series counts, this job deletes the
matching part-key records (and optionally their chunks) from the store so
index bootstrap stops resurrecting them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

from filodb_tpu_torch.core.store import ColumnStore


@dataclasses.dataclass
class BustStats:
    parts_scanned: int = 0
    parts_deleted: int = 0


class CardinalityBuster:
    """Delete part keys whose labels match ALL of `match_labels`
    (ref: CardinalityBusterMain filter config: bust by _ws_/_ns_/metric)."""

    def __init__(self, store: ColumnStore, dataset: str):
        self.store = store
        self.dataset = dataset

    def run(self, shards: Sequence[int], match_labels: Dict[str, str],
            start_ms: int = 0, end_ms: int = 1 << 62) -> BustStats:
        stats = BustStats()
        delete = type(self.store).delete_part_keys
        if delete is ColumnStore.delete_part_keys:
            # fail before any shard is mutated, not mid-run on shard N
            raise NotImplementedError(
                f"{type(self.store).__name__} does not support part-key "
                f"deletion")
        delete = self.store.delete_part_keys
        for shard in shards:
            doomed = []
            for rec in self.store.read_part_keys(self.dataset, shard):
                stats.parts_scanned += 1
                if rec.start_time_ms >= end_ms or rec.end_time_ms < start_ms:
                    continue
                labels = {**rec.part_key.tags_dict,
                          "_metric_": rec.part_key.metric}
                if all(labels.get(k) == v for k, v in match_labels.items()):
                    doomed.append(rec.part_key)
            if doomed:
                delete(self.dataset, shard, doomed)
                stats.parts_deleted += len(doomed)
        return stats
