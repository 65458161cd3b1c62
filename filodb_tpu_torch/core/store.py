"""Store API: ChunkSink/ChunkSource/ColumnStore + MetaStore traits (port of
filodb_tpu/core/store.py).

Mirrors the reference's pluggable persistence traits (ref:
core/.../store/ChunkSink.scala, ChunkSource.scala, MetaStore checkpoint API
cassandra/.../metastore/CheckpointTable.scala).  In-memory and null
implementations back tests and benchmarks exactly like the reference's
`NullColumnStore` (ref: store/ChunkSink.scala:116) and `InMemoryMetaStore`
(ref: store/InMemoryMetaStore.scala:89); the disk-backed implementation lives
in persist/localstore.py (the Cassandra-analogue).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterable, List, Tuple

from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.memory.chunks import ChunkSet


@dataclasses.dataclass
class PartKeyRecord:
    """Persisted series identity + liveness (ref: cassandra PartitionKeysTable)."""
    part_key: PartKey
    schema_name: str
    start_time_ms: int
    end_time_ms: int


class ColumnStore:
    """ChunkSink + ChunkSource combined (ref: store/ColumnStore trait)."""

    def initialize(self, dataset: str, num_shards: int) -> None:
        raise NotImplementedError

    def write_chunks(self, dataset: str, shard: int, part_key: PartKey,
                     chunksets: Iterable[ChunkSet], schema_name: str) -> None:
        raise NotImplementedError

    def write_part_keys(self, dataset: str, shard: int,
                        records: Iterable[PartKeyRecord]) -> None:
        raise NotImplementedError

    def read_part_keys(self, dataset: str, shard: int) -> List[PartKeyRecord]:
        raise NotImplementedError

    def read_chunks(self, dataset: str, shard: int, part_key: PartKey,
                    start_time_ms: int, end_time_ms: int) -> List[ChunkSet]:
        raise NotImplementedError

    def read_chunks_multi(self, dataset: str, shard: int,
                          requests: Iterable[Tuple[PartKey, int, int]]
                          ) -> List[List[ChunkSet]]:
        """Batched read_chunks: one result list per (part_key, start_ms,
        end_ms) request, aligned with the input.  The default loops; disk
        and network stores override (one lock pass / one round trip) —
        the demand-paging and compaction read shape."""
        return [self.read_chunks(dataset, shard, pk, t0, t1)
                for pk, t0, t1 in requests]

    def scan_chunks_by_ingestion_time(self, dataset: str, shard: int,
                                      ingestion_start_ms: int,
                                      ingestion_end_ms: int):
        """Yield (PartKey, schema_name, ChunkSet) for chunks INGESTED in the
        window — the batch downsampler's read path (ref:
        cassandra/.../IngestionTimeIndexTable.scala; DownsamplerMain reads
        raw chunks by ingestion-time range so late-arriving data is
        caught)."""
        raise NotImplementedError

    def all_part_keys(self, dataset: str, shard: int) -> List[PartKeyRecord]:
        return self.read_part_keys(dataset, shard)

    def holds_chunks(self, dataset: str, shard: int) -> bool:
        """False only when the store is known to hold no chunk of the
        shard, so demand paging has nothing to read from it.  A store
        that cannot tell cheaply answers True."""
        return True

    def delete_part_keys(self, dataset: str, shard: int,
                         part_keys: Iterable[PartKey]) -> int:
        """Remove part keys so index bootstrap stops resurrecting them
        (the CardinalityBuster write path, ref: cardbuster/)."""
        raise NotImplementedError


class MetaStore:
    """Checkpoints + dataset metadata (ref: core MetaStore trait; checkpoint
    watermark protocol doc/ingestion.md:114-133)."""

    def write_checkpoint(self, dataset: str, shard: int, group: int, offset: int) -> None:
        raise NotImplementedError

    def read_checkpoints(self, dataset: str, shard: int) -> Dict[int, int]:
        raise NotImplementedError

    def read_earliest_checkpoint(self, dataset: str, shard: int) -> int:
        cps = self.read_checkpoints(dataset, shard)
        return min(cps.values()) if cps else -1

    def read_highest_checkpoint(self, dataset: str, shard: int) -> int:
        cps = self.read_checkpoints(dataset, shard)
        return max(cps.values()) if cps else -1


class NullColumnStore(ColumnStore):
    """Swallows writes; reads return nothing (ref: ChunkSink.scala:116)."""

    def initialize(self, dataset: str, num_shards: int) -> None:
        pass

    def write_chunks(self, dataset, shard, part_key, chunksets, schema_name) -> None:
        pass

    def write_part_keys(self, dataset, shard, records) -> None:
        pass

    def read_part_keys(self, dataset, shard) -> List[PartKeyRecord]:
        return []

    def read_chunks(self, dataset, shard, part_key, start_time_ms, end_time_ms):
        return []

    def holds_chunks(self, dataset, shard) -> bool:
        return False


class InMemoryColumnStore(ColumnStore):
    """Dict-backed store for tests/recovery tests."""

    def __init__(self):
        self._chunks: Dict[Tuple[str, int, bytes], List[Tuple[str, ChunkSet]]] = {}
        self._pks: Dict[Tuple[str, int, bytes], PartKeyRecord] = {}
        # chunksets held per (dataset, shard): holds_chunks in O(1)
        self._shard_chunks: Dict[Tuple[str, int], int] = {}
        self._lock = threading.Lock()

    def initialize(self, dataset: str, num_shards: int) -> None:
        pass

    def write_chunks(self, dataset, shard, part_key, chunksets, schema_name) -> None:
        key = (dataset, shard, part_key.to_bytes())
        with self._lock:
            bucket = self._chunks.setdefault(key, [])
            seen = {c.info.chunk_id for _, c in bucket}
            n0 = len(bucket)
            # idempotent by chunk id (retried network writes, see netstore)
            bucket.extend((schema_name, cs) for cs in chunksets
                          if cs.info.chunk_id not in seen)
            self._shard_chunks[(dataset, shard)] = \
                self._shard_chunks.get((dataset, shard), 0) + len(bucket) - n0

    def holds_chunks(self, dataset, shard) -> bool:
        with self._lock:
            return self._shard_chunks.get((dataset, shard), 0) > 0

    def write_part_keys(self, dataset, shard, records) -> None:
        with self._lock:
            for r in records:
                self._pks[(dataset, shard, r.part_key.to_bytes())] = r

    def read_part_keys(self, dataset, shard) -> List[PartKeyRecord]:
        with self._lock:
            return [r for (ds, sh, _), r in self._pks.items()
                    if ds == dataset and sh == shard]

    def read_chunks(self, dataset, shard, part_key, start_time_ms, end_time_ms):
        key = (dataset, shard, part_key.to_bytes())
        with self._lock:
            out = []
            for _, cs in self._chunks.get(key, []):
                if (cs.info.start_time_ms <= end_time_ms
                        and cs.info.end_time_ms >= start_time_ms):
                    out.append(cs)
            return out

    def scan_chunks_by_ingestion_time(self, dataset, shard,
                                      ingestion_start_ms, ingestion_end_ms):
        with self._lock:
            items = [(pkb, schema_name, cs)
                     for (ds, sh, pkb), lst in self._chunks.items()
                     if ds == dataset and sh == shard
                     for schema_name, cs in lst
                     if ingestion_start_ms <= cs.info.ingestion_time_ms
                     < ingestion_end_ms]
        for pkb, schema_name, cs in items:
            yield PartKey.from_bytes(pkb), schema_name, cs

    def delete_part_keys(self, dataset, shard, part_keys) -> int:
        n = 0
        with self._lock:
            for pk in part_keys:
                if self._pks.pop((dataset, shard, pk.to_bytes()),
                                 None) is not None:
                    n += 1
        return n

    def num_chunksets(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._chunks.values())


class InMemoryMetaStore(MetaStore):

    def __init__(self):
        self._cp: Dict[Tuple[str, int], Dict[int, int]] = {}
        self._lock = threading.Lock()

    def write_checkpoint(self, dataset, shard, group, offset) -> None:
        with self._lock:
            self._cp.setdefault((dataset, shard), {})[group] = offset

    def read_checkpoints(self, dataset, shard) -> Dict[int, int]:
        with self._lock:
            return dict(self._cp.get((dataset, shard), {}))
