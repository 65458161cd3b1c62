"""WAL-segment catch-up: a replica repairs its copy from the primary's
log, never by re-scraping (port of filodb_tpu/replication/catchup.py).

A replica that joined late, fell behind (lagging fan-out), or restarted
empty streams WAL segment FILES from the shard's primary
(service.ReplicaClient.fetch_segments), lands them in a scratch
directory, and replays them through the ordinary wal/replay.py ingest
path with a shard filter and its resume point — so catch-up is the boot
recovery path pointed at a peer instead of the local disk, not a second
ingest implementation.  Idempotence comes for free from the same
store-level OOO/dup handling replay already rides.

Every run registers a `replication_catchup` job in the job registry
(GET /admin/jobs shows progress; a failing catch-up streak feeds the
health verdict) and journals `replica_caught_up` on success.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import tempfile
import time
from typing import Dict, Iterable, Optional

from filodb_tpu_torch.utils.events import journal
from filodb_tpu_torch.utils.jobs import jobs
from filodb_tpu_torch.utils.metrics import registry as metrics_registry
from filodb_tpu_torch.wal.replay import replay_dir
from filodb_tpu_torch.wal.segment import segment_path

_log = logging.getLogger("filodb.replication")


@dataclasses.dataclass
class CatchupStats:
    segments: int = 0
    records: int = 0
    samples: int = 0
    skipped_records: int = 0
    last_seq: int = -1
    elapsed_s: float = 0.0

    @property
    def samples_per_sec(self) -> float:
        return self.samples / self.elapsed_s if self.elapsed_s > 0 else 0.0


def relay_wal(src_client, dst_client, dataset: str,
              shards: Optional[Iterable[int]] = None,
              since_seq: int = -1, restore: bool = True) -> int:
    """Coordinator-mediated catch-up: stream WAL segments from one
    peer, decode + shard-filter here, re-append through the other
    peer's ordinary replication door (so the records land in ITS WAL
    too).  Relayed records are restore-flagged by default — they are
    history, and must apply inside an open restore window instead of
    being buffered behind it.  Returns records relayed.  Used by the
    handoff WAL-tail phase and the chaos bench's respawn repair; a
    source without a WAL relays nothing."""
    from filodb_tpu_torch.replication.service import ReplicationError
    from filodb_tpu_torch.wal.segment import (WalCorruption, WalRecord,
                                              read_records, segment_path)
    shard_set = set(int(s) for s in shards) if shards is not None else None
    tmp = tempfile.mkdtemp(prefix="filodb-relay-")
    sent = 0
    # one segment in memory at a time (the source's whole log can run to
    # gigabytes); a stream left unread on failure drops its connection,
    # so the next call on it cannot read this stream's frames
    segs = iter(src_client.fetch_segments(dataset, since_seq))
    drained = False
    try:
        while True:
            try:
                first_seq, data = next(segs)
            except StopIteration:
                drained = True
                break
            except ReplicationError:
                # the source refuses only before its first segment: it
                # holds no WAL for the dataset
                drained = True
                return sent
            path = segment_path(tmp, first_seq)
            with open(path, "wb") as f:
                f.write(data)
            del data
            tables: dict = {}
            try:
                for body in read_records(path):
                    rec = WalRecord.decode(body, tables)
                    if shard_set is not None \
                            and rec.shard not in shard_set:
                        continue
                    if rec.seq <= since_seq:
                        continue
                    dst_client.append_record(dataset, rec.encode(),
                                             seq=rec.seq,
                                             restore=restore)
                    sent += 1
            except WalCorruption as e:
                _log.warning("WAL relay: segment %s corrupt (%s) — "
                             "continuing", path, e)
            finally:
                os.unlink(path)
    finally:
        if not drained:
            getattr(segs, "close", lambda: None)()
            reset = getattr(src_client, "reset", None)
            if reset is not None:
                reset()
        shutil.rmtree(tmp, ignore_errors=True)
    return sent


def catchup_shards(client, dataset: str, memstore,
                   shards: Optional[Iterable[int]] = None,
                   since: Optional[Dict[int, int]] = None,
                   node: str = "local",
                   scratch_dir: Optional[str] = None) -> CatchupStats:
    """Stream WAL segments from `client`'s peer and replay the shards in
    `shards` (None = every shard in the log) into `memstore`.  `since`
    maps shard -> resume seq (records at or below it skip — typically
    the replica's horizon from ReplicationServer.horizon).  Returns
    CatchupStats; raises on transport failure (the caller's job streak
    then feeds the health verdict)."""
    t0 = time.perf_counter()
    since = dict(since or {})
    shard_set = set(int(s) for s in shards) if shards is not None else None
    job = jobs.register("replication_catchup", dataset=dataset)
    stats = CatchupStats()
    with job.tick() as tick:
        # fetch horizon: the MIN resume point over the TARGET shards,
        # where a shard absent from `since` replays from the beginning
        # (-1) — min(since.values()) alone would let one caught-up
        # shard's horizon skip segments a brand-new shard still needs
        if shard_set is not None:
            min_since = min((since.get(s, -1) for s in shard_set),
                            default=-1)
        else:
            # unknown target set: the log may hold shards `since` never
            # mapped, so nothing can safely bound the fetch — stream
            # everything; replay's restart_points still skip per shard
            min_since = -1
        tmp = scratch_dir or tempfile.mkdtemp(prefix="filodb-catchup-")
        own_tmp = scratch_dir is None
        try:
            os.makedirs(tmp, exist_ok=True)
            job.set_progress("streaming segments")
            for first_seq, data in client.fetch_segments(dataset,
                                                         min_since):
                path = segment_path(tmp, first_seq)
                with open(path, "wb") as f:
                    f.write(data)
                stats.segments += 1
            job.set_progress(
                f"replaying {stats.segments} segment(s)")
            rstats = replay_dir(tmp, memstore, dataset,
                                restart_points=since,
                                shard_filter=shard_set)
            stats.records = rstats.records
            stats.samples = rstats.samples
            stats.skipped_records = rstats.skipped_records
            stats.last_seq = rstats.last_seq
            if rstats.corrupt_segments:
                # acknowledged data on the PRIMARY was unreadable — the
                # copy may still be short; surface it as a failed run
                tick.handle.note_error(
                    f"{rstats.corrupt_segments} corrupt segment(s) "
                    "during catch-up")
        finally:
            if own_tmp:
                shutil.rmtree(tmp, ignore_errors=True)
    stats.elapsed_s = time.perf_counter() - t0
    metrics_registry.counter("replication_catchup_samples",
                             dataset=dataset).increment(stats.samples)
    journal.emit("replica_caught_up", subsystem="replication",
                 dataset=dataset, peer=client.where, node=node,
                 records=stats.records, samples=stats.samples,
                 last_seq=stats.last_seq,
                 elapsed_s=round(stats.elapsed_s, 3))
    job.set_progress(f"caught up to seq {stats.last_seq}")
    return stats


def rebuild_node(object_store, segment_store, client, dataset: str,
                 memstore, num_shards: int,
                 shards: Optional[Iterable[int]] = None,
                 since: Optional[Dict[int, int]] = None,
                 node: str = "local",
                 scratch_dir: Optional[str] = None):
    """Disk-loss rebuild: the replacement node recovers its COLD tier
    from the shared object store (manifest-driven,
    persist/objectstore.restore_from_objectstore) and its RAW edge from
    a live peer's WAL through the ordinary catch-up path — nothing but
    manifests + WAL tail, which is the whole durability claim of the
    disaggregated tier.  `client` may be None (single-node deployments
    restore the tail from their own surviving WAL via boot replay).
    Returns (RestoreStats, CatchupStats)."""
    from filodb_tpu_torch.persist.objectstore import restore_from_objectstore
    rstats = restore_from_objectstore(object_store, segment_store,
                                      dataset, num_shards, node=node)
    cstats = CatchupStats()
    if client is not None:
        cstats = catchup_shards(client, dataset, memstore, shards=shards,
                                since=since, node=node,
                                scratch_dir=scratch_dir)
    journal.emit("node_rebuilt", subsystem="replication", dataset=dataset,
                 node=node, segments_fetched=rstats.segments_fetched,
                 wal_records=cstats.records, wal_samples=cstats.samples)
    return rstats, cstats
