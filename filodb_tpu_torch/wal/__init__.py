"""Write-ahead log, durability for acknowledged ingest (port of
filodb_tpu/wal/; segments, records and frames are the reference's to
the byte, so either package replays a log the other wrote).

The memstore is an in-memory serving tier: before this package, an
acknowledged sample lived only in RAM until the flush scheduler sealed
and persisted its chunk — a crash between scrape and flush silently lost
it.  The WAL closes that window with the Gorilla checkpoint+log stance
(Facebook VLDB'15 §4.2; the reference's Kafka-offset recovery protocol,
doc/ingestion.md:114-133):

    append (framed, CRC32, snappy)  ->  group commit (fsync)  ->  ACK
                                                   |
    restart:  replay segments  ->  same ingest_columns path  ->  serving

`WalManager` is the per-dataset facade the ingest doors use: it owns the
writer (wal/writer.py), tracks per-shard persisted horizons reported by
the flush scheduler, and prunes tombstoned segments.  Replay
(wal/replay.py) runs at boot before the HTTP server opens.
"""
from __future__ import annotations

import logging
import os
import threading
from typing import Dict, Optional

import numpy as np

from filodb_tpu_torch.utils.metrics import registry as metrics_registry
from filodb_tpu_torch.wal.replay import ReplayStats, replay_dir
from filodb_tpu_torch.wal.segment import WalCorruption, WalRecord
from filodb_tpu_torch.wal.writer import WalWriteError, WalWriter, \
    recover_writer_state

_log = logging.getLogger("filodb.wal")

__all__ = ["WalManager", "WalRecord", "WalWriter", "WalWriteError",
           "WalCorruption", "ReplayStats", "replay_dir"]


class WalManager:
    """One dataset's WAL: append facade + horizon-driven pruning."""

    def __init__(self, root_dir: str, dataset: str, config=None):
        from filodb_tpu_torch.config import WalConfig
        cfg = config or WalConfig()
        self.dataset = dataset
        self.dir = os.path.join(root_dir, dataset)
        next_seq, sealed = recover_writer_state(self.dir)
        self.writer = WalWriter(
            self.dir, dataset=dataset,
            commit_interval_ms=cfg.commit_interval_ms,
            commit_bytes=cfg.commit_bytes,
            segment_max_bytes=cfg.segment_max_bytes,
            fsync=cfg.fsync, start_seq=next_seq)
        # pre-restart segments are prunable once their records persist
        self.writer._sealed = sealed + self.writer._sealed
        self._lock = threading.Lock()
        self._persisted: Dict[int, int] = {}     # shard -> horizon seq
        self._shards_seen: set = set()

    # ------------------------------------------------------------- append

    def append_grid(self, shard: int, schema: str, part_keys,
                    ts: np.ndarray, columns: Dict[str, np.ndarray],
                    bucket_les=None, wait: bool = True) -> int:
        """Append one columnar slab for `shard`; returns its seq.  With
        wait=True (default) the call blocks until the group commit makes
        it durable — callers ingesting several slabs per request should
        append them all with wait=False and `commit()` once."""
        # keep the caller's list identity: streaming callers reuse one
        # key table across appends and the record encoder memoizes its
        # serialized form by that identity (wal/segment._key_table_blob)
        keys = part_keys if isinstance(part_keys, list) else list(part_keys)
        rec = WalRecord(0, shard, schema, keys,
                        np.asarray(ts, dtype=np.int64), columns, bucket_les)
        with self._lock:
            self._shards_seen.add(shard)
        if wait:
            return self.writer.append(rec)
        return self.writer.append_record(rec)

    def commit(self, seq: int) -> None:
        self.writer.wait_committed(seq)

    # ------------------------------------------------------------ horizon

    def note_persisted(self, shard: int, horizon_seq: int) -> None:
        """Flush scheduler callback: every sample of `shard` with seq <=
        horizon_seq is in the column store.  Prunes segments wholly below
        the min horizon across every shard the log has seen."""
        with self._lock:
            if horizon_seq <= self._persisted.get(shard, -1):
                prev_min = None            # no movement: skip the prune
            else:
                self._persisted[shard] = horizon_seq
                prev_min = self._min_horizon()
        if prev_min is not None and prev_min >= 0:
            self.writer.prune(prev_min)
            metrics_registry.gauge(
                "wal_persisted_horizon", dataset=self.dataset
            ).update(prev_min)
        metrics_registry.gauge("wal_segments",
                               dataset=self.dataset).update(
            self.writer.segment_count())

    def _min_horizon(self) -> int:
        """Min persisted seq over every shard that has ever appended (a
        shard the log holds records for but whose checkpoint hasn't
        advanced pins every segment past its data — correct: pruning it
        would lose acknowledged samples)."""
        if not self._shards_seen:
            return -1
        return min(self._persisted.get(s, -1) for s in self._shards_seen)

    # ------------------------------------------------------------- replay

    def replay(self, memstore,
               restart_points: Optional[Dict[int, int]] = None
               ) -> ReplayStats:
        from filodb_tpu_torch.utils.events import journal
        journal.emit("wal_replay_started", subsystem="wal",
                     dataset=self.dataset)
        stats = replay_dir(self.dir, memstore, self.dataset, restart_points)
        journal.emit("wal_replay_done", subsystem="wal",
                     dataset=self.dataset, records=stats.records,
                     samples=stats.samples,
                     skipped_records=stats.skipped_records,
                     corrupt_segments=stats.corrupt_segments,
                     elapsed_s=round(stats.elapsed_s, 3))
        restart_points = restart_points or {}
        with self._lock:
            # only shards with RECORDS in the log gate pruning — a shard
            # that never appended (idle, influx-only) must not pin the
            # horizon at -1 forever and let sealed segments fill the disk
            for shard, last in stats.shards.items():
                self._shards_seen.add(shard)
                # the restart point is persistence EVIDENCE: everything
                # at or below it is already in the column store, so a
                # shard whose log records were all skipped starts with
                # its horizon there instead of pinning segments it no
                # longer needs
                rp = restart_points.get(shard, -1)
                if rp > self._persisted.get(shard, -1):
                    self._persisted[shard] = rp
        for shard, rp in restart_points.items():
            # checkpoints must stay monotone across the restart: a shard
            # that replayed nothing still re-asserts its restart point as
            # its offset, so the next flush cannot regress the persisted
            # checkpoint to -1 (which would stall pruning until fresh
            # traffic arrives)
            sh = memstore.get_shard(self.dataset, shard)
            if sh is not None and rp > sh.ingested_offset:
                sh.ingested_offset = rp
        mh = self._min_horizon()
        if mh >= 0:
            self.writer.prune(mh)
        return stats

    def close(self) -> None:
        self.writer.close()
