"""Ingest fan-out — the distributor half of the replication layer (port
of filodb_tpu/replication/replicator.py).

Every columnar slab is shipped to ALL live owners of its shard (the
ShardMapper's ordered assignment list), encoded ONCE as a WalRecord body
(the WAL's own wire format) and appended through each peer's replication
door (service.py).  Ack semantics (`replication.ack_mode`):

  primary  the caller's own primary-durability claim (local WAL commit,
           or the first owner's ack in distributor mode) is the ack;
           replica appends ride an ordered per-peer async queue with lag
           tracked — catch-up (catchup.py) repairs anything dropped.
  quorum   primary-durable AND every LIVE replica acked before the call
           returns.  A replica that fails its append is marked lagging
           (journal `replica_lagging`, skipped until it acks again) so
           one corpse cannot wedge ingest — availability through a
           replica death, durability repaired by catch-up.

Per-replica lag is observable three ways: the `replica_lag_records`
gauge, `replica_lagging` / `replica_caught_up` journal events (edge-
triggered, never flooding), and the /admin/shards table.
"""
from __future__ import annotations

import dataclasses
import logging
import queue
import threading
from typing import Callable, Dict, List, Optional, Tuple

import time

from filodb_tpu_torch.utils.events import journal
from filodb_tpu_torch.utils.metrics import (collector, current_trace_id,
                                            registry as metrics_registry,
                                            span as metrics_span)
from filodb_tpu_torch.wal.segment import WalRecord

_log = logging.getLogger("filodb.replication")


class ReplicationSendError(IOError):
    """No owner of the shard acknowledged the slab — nothing durable."""


# a lagging replica gets one real append attempt per this many slabs (a
# cheap liveness probe); the rest are skipped and left to catch-up
_LAG_PROBE_EVERY = 16


def _restitch_spans(trace, reply) -> None:
    """Re-record the replica-side span events that rode back in the ack
    (service.py drains them per reply, like the query transport) so the
    coordinator's collector holds ONE stitched write-path trace."""
    if not trace:
        return
    for ev in reply.get("spans") or ():
        if isinstance(ev, dict):
            collector.record(trace, ev)


@dataclasses.dataclass
class ReplicateResult:
    """One slab's fan-out outcome."""
    shard: int
    acked: List[str] = dataclasses.field(default_factory=list)
    failed: List[Tuple[str, str]] = dataclasses.field(default_factory=list)
    queued: List[str] = dataclasses.field(default_factory=list)
    # per-acking-node samples actually ingested (the peer's
    # OOO/dup/quota drops subtract here; buffered-behind-a-restore
    # appends report 0 until the window drains)
    ingested: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def ack_count(self) -> int:
        return len(self.acked)


class _PeerState:
    """Per-peer replication bookkeeping: ordered async queue (primary
    ack mode), pending-record lag, and the lagging edge detector."""

    def __init__(self, node: str, client, dataset: str,
                 lag_threshold: int, queue_max: int):
        self.node = node
        self.client = client
        self.dataset = dataset
        self.lag_threshold = max(int(lag_threshold), 1)
        self.lock = threading.Lock()
        self.sent = 0
        self.acked = 0
        self.failed = 0
        self.skipped = 0
        self.lagging = False
        # records this peer's copy is MISSING (failed + skipped since it
        # last held everything): a probe ack drains `pending` but cannot
        # un-lose these — only a catch-up (mark_repaired) clears them,
        # so `lagging` never self-clears into a silently-short replica
        self.lost = 0
        self.last_error = ""
        # unix time this peer's copy FIRST fell behind (pending or lost
        # records outstanding); 0 = fully caught up.  Exported as the
        # replica_lag_seconds gauge — the newest-unreplicated-record AGE
        # complementing the records-count gauge (a replica 10 records
        # behind for an hour is a worse story than 1000 behind for 2 s).
        self.behind_since = 0.0
        self.q: "queue.Queue" = queue.Queue(maxsize=max(queue_max, 1))
        # manager hook fired once at the ok->lagging edge (demotes the
        # peer's replica copies out of the query-ready set)
        self.on_lagging = None
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------- lag

    @property
    def pending(self) -> int:
        """Records this manager still owes the peer: queued + in-flight.
        Failed appends are NOT pending (they will never ack from here —
        catch-up repairs them; `failed` counts them separately)."""
        with self.lock:
            return self.pending_locked()

    def _export_lag(self) -> None:
        with self.lock:
            behind = self.pending_locked() > 0 or self.lost > 0
            if behind and not self.behind_since:
                self.behind_since = time.time()
            elif not behind:
                self.behind_since = 0.0
            since = self.behind_since
            pending = self.pending_locked()
        metrics_registry.gauge("replica_lag_records", dataset=self.dataset,
                               peer=self.node).update(pending)
        metrics_registry.gauge("replica_lag_seconds", dataset=self.dataset,
                               peer=self.node).update(
            max(time.time() - since, 0.0) if since else 0.0)

    def note_ack(self) -> None:
        with self.lock:
            self.acked += 1
            was = self.lagging
            # a probe ack alone never clears the lag: records already
            # failed/skipped exist only on other owners until a
            # catch-up repairs this peer (mark_repaired)
            if self.lagging and self.lost == 0 \
                    and self.pending_locked() < self.lag_threshold:
                self.lagging = False
        self._export_lag()
        if was and not self.lagging:
            journal.emit("replica_caught_up", subsystem="replication",
                         dataset=self.dataset, peer=self.node)

    def note_repaired(self) -> None:
        """A catch-up completed for this peer: its copy holds everything
        again — clear the lag and the lost-record debt."""
        with self.lock:
            was = self.lagging
            self.lost = 0
            self.lagging = False
        self._export_lag()
        if was:
            journal.emit("replica_caught_up", subsystem="replication",
                         dataset=self.dataset, peer=self.node,
                         repaired=True)

    def pending_locked(self) -> int:
        return max(self.sent - self.acked - self.failed, 0) + self.q.qsize()

    def note_failure(self, err: str) -> None:
        with self.lock:
            self.failed += 1
            self.lost += 1
            self.last_error = str(err)[:300]
            newly = not self.lagging
            self.lagging = True
        metrics_registry.counter("replication_append_failures",
                                 dataset=self.dataset,
                                 peer=self.node).increment()
        self._export_lag()
        if newly:
            journal.emit("replica_lagging", subsystem="replication",
                         dataset=self.dataset, peer=self.node,
                         error=str(err)[:200])
            if self.on_lagging is not None:
                self.on_lagging(self.node)

    def note_overflow(self) -> None:
        with self.lock:
            self.lost += 1
            newly = not self.lagging
            self.lagging = True
        metrics_registry.counter("replication_queue_overflow",
                                 dataset=self.dataset,
                                 peer=self.node).increment()
        if newly:
            journal.emit("replica_lagging", subsystem="replication",
                         dataset=self.dataset, peer=self.node,
                         error="send queue overflow")
            if self.on_lagging is not None:
                self.on_lagging(self.node)

    # ----------------------------------------------------------- worker

    def ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._drain, daemon=True,
                name=f"repl-send-{self.dataset}-{self.node}")
            self._worker.start()

    def _drain(self) -> None:
        while not self._stop.is_set():
            try:
                body, seq, trace = self.q.get(timeout=0.2)
            except queue.Empty:
                continue
            with self.lock:
                self.sent += 1
            try:
                reply = self.client.append_record(self.dataset, body,
                                                  seq=seq, trace=trace)
                _restitch_spans(trace, reply)
                self.note_ack()
            except Exception as e:  # noqa: BLE001 — peer death is data
                self.note_failure(e)

    def stop(self) -> None:
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=2)

    def snapshot(self) -> dict:
        with self.lock:
            since = self.behind_since
            return {"peer": self.node, "sent": self.sent,
                    "acked": self.acked, "failed": self.failed,
                    "skipped": self.skipped, "lostRecords": self.lost,
                    "pendingRecords": self.pending_locked(),
                    "lagging": self.lagging,
                    "lagSeconds": round(time.time() - since, 3)
                    if since else 0.0,
                    "lastError": self.last_error}


class ReplicationManager:
    """One dataset's fan-out state.  `client_factory(node)` dials a
    peer's replication door; `local_node` names the node this manager
    runs on (its own copy ingests locally — never through the wire).
    Runs in two shapes: node-resident (primary ingests locally, fans to
    owners[1:]) and distributor (a gateway that owns nothing fans to
    every owner, primary ack = owners[0]'s append)."""

    def __init__(self, dataset: str, mapper, client_factory: Callable,
                 config=None, local_node: Optional[str] = None):
        from filodb_tpu_torch.config import ReplicationConfig
        self.dataset = dataset
        self.mapper = mapper
        self.client_factory = client_factory
        self.cfg = config or ReplicationConfig()
        self.local_node = local_node
        self._peers: Dict[str, _PeerState] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------- peers

    def _peer(self, node: str) -> _PeerState:
        with self._lock:
            st = self._peers.get(node)
            if st is None:
                st = _PeerState(node, self.client_factory(node),
                                self.dataset,
                                self.cfg.lag_records_threshold,
                                self.cfg.send_queue_max)
                st.on_lagging = self._demote_replicas
                self._peers[node] = st
            return st

    def _demote_replicas(self, node: str) -> None:
        """A peer went lagging: its REPLICA copies leave the query-ready
        set (status -> Assigned) so failover can never serve its
        silently-short copy as a full result; primary copies are not
        touched (primary death is the promotion path).  mark_repaired
        restores them after a catch-up."""
        from filodb_tpu_torch.parallel.shardmapper import ShardStatus
        try:
            for s in self.mapper.replica_shards_for_node(node):
                self.mapper.replica_statuses[(s, node)] = \
                    ShardStatus.ASSIGNED
        except Exception:  # noqa: BLE001 — bookkeeping must not sink
            _log.exception("replica demotion for %s failed", node)

    def mark_repaired(self, node: str) -> None:
        """A catch-up completed for `node`: clear its lost-record debt
        and flip its replica copies back to query-ready ACTIVE."""
        from filodb_tpu_torch.parallel.shardmapper import ShardStatus
        with self._lock:
            st = self._peers.get(node)
        if st is not None:
            st.note_repaired()
        for s in self.mapper.replica_shards_for_node(node):
            self.mapper.replica_statuses[(s, node)] = ShardStatus.ACTIVE

    def snapshot(self) -> List[dict]:
        with self._lock:
            peers = list(self._peers.values())
        return sorted((p.snapshot() for p in peers),
                      key=lambda d: d["peer"])

    def lag_for(self, node: str) -> Optional[dict]:
        with self._lock:
            st = self._peers.get(node)
        return st.snapshot() if st is not None else None

    def stop(self) -> None:
        with self._lock:
            peers = list(self._peers.values())
        for p in peers:
            p.stop()

    # ------------------------------------------------------------ fan-out

    def replicate(self, shard: int, schema: str, part_keys, ts, columns,
                  bucket_les=None, seq: int = -1,
                  require_primary: bool = False) -> ReplicateResult:
        """Fan one slab to every remote owner of `shard`.  `seq` is the
        primary's WAL seq (replica horizon bookkeeping; -1 = none).
        `require_primary` (distributor mode) raises
        ReplicationSendError unless at least one owner acked — the
        caller must NOT ack its client when nothing is durable
        anywhere."""
        import numpy as np
        owners = [n for n in self.mapper.owners(shard)
                  if n != self.local_node]
        res = ReplicateResult(shard)
        if not owners:
            if require_primary:
                raise ReplicationSendError(
                    f"shard {shard} of {self.dataset!r} has no owners")
            return res
        # keep the caller's list identity: a caller streaming slabs over
        # one series set reuses its key list, and the record encoder
        # memoizes the serialized key table by that identity
        keys = part_keys if isinstance(part_keys, list) else list(part_keys)
        rec = WalRecord(max(seq, 0), shard, schema, keys,
                        np.asarray(ts, dtype=np.int64), columns,
                        bucket_les)
        body = rec.encode()
        sync_quorum = self.cfg.ack_mode == "quorum"
        primary_owner = self.mapper.node_for_shard(shard)
        # the write-path trace id rides the door frames: the replica
        # executes its WAL append + ingest under it and ships its span
        # events back in the ack, stitching into ONE trace (the same
        # shape the query transport's remote_exec spans use)
        trace = current_trace_id()
        with metrics_span("replication_fanout", dataset=self.dataset):
            for node in owners:
                st = self._peer(node)
                is_primary_target = node == primary_owner
                if st.lagging and not is_primary_target:
                    # a LAGGING replica is skipped (probed every Nth slab
                    # so recovery is noticed without an operator): paying
                    # a connect failure per slab would collapse ingest
                    # throughput behind one corpse — catch-up repairs it
                    with st.lock:
                        st.skipped += 1
                        probe = st.skipped % _LAG_PROBE_EVERY == 0
                        if not probe:
                            # the skipped slab exists only on other
                            # owners until a catch-up repairs this peer
                            st.lost += 1
                    if not probe:
                        res.failed.append((node, "skipped: lagging"))
                        continue
                if sync_quorum or is_primary_target:
                    with st.lock:
                        st.sent += 1
                    try:
                        with metrics_span("replica_append", peer=node):
                            reply = st.client.append_record(
                                self.dataset, body, seq=seq, trace=trace)
                        _restitch_spans(trace, reply)
                        st.note_ack()
                        res.acked.append(node)
                        res.ingested[node] = int(reply.get("ingested", 0))
                    except Exception as e:  # noqa: BLE001 — a dead owner is data
                        st.note_failure(e)
                        res.failed.append((node,
                                           f"{type(e).__name__}: {e}"))
                else:
                    st.ensure_worker()
                    try:
                        st.q.put_nowait((body, seq, trace))
                        res.queued.append(node)
                    except queue.Full:
                        st.note_overflow()
                        res.failed.append((node, "send queue overflow"))
        metrics_registry.counter("replication_slabs",
                                 dataset=self.dataset).increment()
        if require_primary and not res.acked:
            raise ReplicationSendError(
                f"no owner of shard {shard} acknowledged the slab "
                f"(failed: {res.failed})")
        return res
