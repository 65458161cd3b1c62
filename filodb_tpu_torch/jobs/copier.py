"""Cross-cluster chunk / partition-key migration jobs (port of
filodb_tpu/jobs/copier.py).

ref: spark-jobs/.../ChunkCopier.scala (210) and PartitionKeysCopier.scala
(180) — Spark batch jobs that copy a time slice of chunks / partkey records
from one Cassandra cluster to another for repair or migration.  The
jobs here run the same copy against any two ColumnStore backends;
shards are an embarrassingly parallel loop for a caller to fan out.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from filodb_tpu_torch.core.store import ColumnStore, PartKeyRecord


@dataclasses.dataclass
class CopyStats:
    parts_scanned: int = 0
    chunks_copied: int = 0
    bytes_copied: int = 0
    partkeys_copied: int = 0


class ChunkCopier:
    """Copy chunks whose time range intersects [start, end) from source to
    target (ref: ChunkCopier.scala run loop)."""

    def __init__(self, source: ColumnStore, target: ColumnStore,
                 dataset: str, target_dataset: Optional[str] = None):
        self.source = source
        self.target = target
        self.dataset = dataset
        self.target_dataset = target_dataset or dataset

    def run(self, shards: Sequence[int], start_ms: int,
            end_ms: int) -> CopyStats:
        stats = CopyStats()
        for shard in shards:
            for rec in self.source.read_part_keys(self.dataset, shard):
                if rec.start_time_ms >= end_ms or rec.end_time_ms < start_ms:
                    continue
                stats.parts_scanned += 1
                chunks = self.source.read_chunks(self.dataset, shard,
                                                 rec.part_key, start_ms,
                                                 end_ms - 1)
                if not chunks:
                    continue
                self.target.write_chunks(self.target_dataset, shard,
                                         rec.part_key, chunks,
                                         rec.schema_name)
                stats.chunks_copied += len(chunks)
                stats.bytes_copied += sum(c.nbytes for c in chunks)
        return stats


class PartitionKeysCopier:
    """Copy part-key liveness records in a time window
    (ref: PartitionKeysCopier.scala)."""

    def __init__(self, source: ColumnStore, target: ColumnStore,
                 dataset: str, target_dataset: Optional[str] = None):
        self.source = source
        self.target = target
        self.dataset = dataset
        self.target_dataset = target_dataset or dataset

    def run(self, shards: Sequence[int], start_ms: int,
            end_ms: int) -> CopyStats:
        stats = CopyStats()
        for shard in shards:
            batch = []
            for rec in self.source.read_part_keys(self.dataset, shard):
                if rec.start_time_ms >= end_ms or rec.end_time_ms < start_ms:
                    continue
                batch.append(PartKeyRecord(rec.part_key, rec.schema_name,
                                           rec.start_time_ms,
                                           rec.end_time_ms))
            if batch:
                self.target.write_part_keys(self.target_dataset, shard, batch)
                stats.partkeys_copied += len(batch)
        return stats
