"""WAL replay: re-drive the columnar ingest path from the log on restart
(port of filodb_tpu/wal/replay.py).  Shards the log names are created
through the memstore's `setup`, so on the memstore's device.

The recovery contract (ref: the reference's recover_stream over broker
offsets, doc/ingestion.md:114-133; Gorilla §4.2 checkpoint+log):

  * records replay in sequence order through the SAME
    `TimeSeriesShard.ingest_columns` path live ingest uses — replay is
    not a second ingest implementation that can drift.
  * idempotence: records at or below a shard's persisted horizon (the
    min over its flush-group checkpoints — everything there is already
    in the column store) are skipped; records past it re-land in the
    dense tier, where re-replay and flush-overlap duplicates are
    harmless (chunk writes are idempotent, paging never duplicates
    below the dense floor, OOO dedup drops same-timestamp repeats).
  * a torn TAIL record (crash mid-append) ends replay cleanly — it was
    never acknowledged.  Mid-log corruption stops that segment LOUDLY
    (wal_replay_corruptions + log) and continues with the next segment:
    later acknowledged data must not be held hostage by one bad block.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Optional

from filodb_tpu_torch.utils.faults import faults
from filodb_tpu_torch.utils.metrics import registry as metrics_registry
from filodb_tpu_torch.wal.segment import (WalCorruption, WalRecord,
                                          list_segments, read_records)

_log = logging.getLogger("filodb.wal")


@dataclasses.dataclass
class ReplayStats:
    records: int = 0
    samples: int = 0
    skipped_records: int = 0          # at/below the persisted horizon
    corrupt_segments: int = 0
    last_seq: int = -1
    elapsed_s: float = 0.0
    # shard -> highest seq present in the log (replayed OR skipped):
    # the shards whose progress actually gates segment pruning
    shards: Dict[int, int] = dataclasses.field(default_factory=dict)

    @property
    def samples_per_sec(self) -> float:
        return self.samples / self.elapsed_s if self.elapsed_s > 0 else 0.0


def replay_dir(dir_path: str, memstore, dataset: str,
               restart_points: Optional[Dict[int, int]] = None,
               shard_filter: Optional[set] = None) -> ReplayStats:
    """Replay every WAL segment under `dir_path` into `memstore`'s shards
    of `dataset`.  `restart_points` maps shard -> persisted horizon seq
    (records with seq <= horizon skip); missing shards replay from the
    beginning.  `shard_filter` (replication catch-up: a replica replays
    a primary's shipped segments for only the shards it owns a copy of)
    drops foreign-shard records before any stats tracking.  Returns
    ReplayStats; the memstore's shards are created on demand (a
    restarted node re-learns its shard set from the log)."""
    stats = ReplayStats()
    restart_points = restart_points or {}
    t0 = time.perf_counter()
    shards = {}
    for first_seq, path in list_segments(dir_path):
        tables: Dict[bytes, list] = {}       # per-segment intern table
        try:
            for body in read_records(path):
                rec = WalRecord.decode(body, tables)
                faults.fire("wal.replay")
                if shard_filter is not None \
                        and rec.shard not in shard_filter:
                    continue
                stats.last_seq = max(stats.last_seq, rec.seq)
                stats.shards[rec.shard] = max(
                    stats.shards.get(rec.shard, -1), rec.seq)
                if rec.seq <= restart_points.get(rec.shard, -1):
                    stats.skipped_records += 1
                    continue
                shard = shards.get(rec.shard)
                if shard is None:
                    shard = memstore.get_shard(dataset, rec.shard) \
                        or memstore.setup(dataset, rec.shard)
                    shards[rec.shard] = shard
                shard.ingest_columns(rec.schema, rec.part_keys, rec.ts,
                                     rec.columns, offset=rec.seq,
                                     bucket_les=rec.bucket_les)
                stats.records += 1
                stats.samples += rec.num_samples
        except WalCorruption as e:
            stats.corrupt_segments += 1
            metrics_registry.counter("wal_replay_corruptions",
                                     dataset=dataset).increment()
            _log.error("WAL replay: segment %s corrupt (%s) — continuing "
                       "with the next segment; acknowledged records in "
                       "the damaged region are LOST", path, e)
    stats.elapsed_s = time.perf_counter() - t0
    metrics_registry.counter("wal_replay_records",
                             dataset=dataset).increment(stats.records)
    metrics_registry.counter("wal_replay_samples",
                             dataset=dataset).increment(stats.samples)
    if stats.records or stats.corrupt_segments:
        _log.info("WAL replay %s: %d records / %d samples in %.2fs "
                  "(%d skipped below horizon, %d corrupt segments)",
                  dataset, stats.records, stats.samples, stats.elapsed_s,
                  stats.skipped_records, stats.corrupt_segments)
    return stats
