"""Live shard handoff — move a shard without anyone noticing (port of
filodb_tpu/replication/handoff.py: the same states and journal events).

The admin-triggered state machine behind
`POST /admin/shards/{s}/handoff` (and the rolling-restart drain
runbook, doc/operations.md):

    pending
      -> register          the target opens a RESTORE WINDOW (live
                           appends ack-and-buffer behind it) and joins
                           the shard's assignment list as an ASSIGNED
                           (NOT query-ready) replica, so live ingest
                           fan-out (replicator.py) starts including it —
                           everything appended from here on lands on
                           both owners, without a fresh sample ever
                           OOO-dropping older history still in flight
      -> stream_snapshot   the old owner's working set streams over as
                           WalRecord grids (service.py `snapshot`);
                           the new owner's index builds as a side
                           effect of the ordinary ingest path
      -> stream_wal_tail   the old owner's WAL tail ships as segments
                           and replays shard-filtered (catchup.py) —
                           covers anything a non-replicated door
                           ingested before registration; the restore
                           window then closes, draining buffered live
                           slabs in arrival order
      -> cutover           ShardMapper.promote_replica: ATOMIC — the
                           next query materializes against the new
                           primary; the old owner stays a replica (and
                           keeps serving stragglers) until...
      -> tombstone         ...the grace elapses: old owner leaves the
                           assignment list and drops its copy
      -> done              (any step) -> failed: journaled, the new
                           owner is unregistered, nothing cut over

Every transition lands in the event journal
(`shard_handoff_started/done/failed` + a `state` field per step), and
each run ticks a `shard_handoff` job in the job registry.  Draining a
node for a rolling restart is this machine in a loop plus
`health.draining` flipping `/ready` to 503 once its shards are gone.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional

from filodb_tpu_torch.utils.events import journal
from filodb_tpu_torch.utils.jobs import jobs
from filodb_tpu_torch.utils.metrics import registry as metrics_registry

_log = logging.getLogger("filodb.replication")

PENDING = "pending"
REGISTER = "register"
STREAM_SNAPSHOT = "stream_snapshot"
STREAM_WAL_TAIL = "stream_wal_tail"
CUTOVER = "cutover"
TOMBSTONE = "tombstone"
DONE = "done"
FAILED = "failed"


class HandoffError(RuntimeError):
    """A handoff step failed; the journal holds the state it died in."""


class HandoffCoordinator:
    """Drives handoffs for one dataset.  `client_for(node)` dials a
    node's replication door (service.ReplicaClient); the mapper is the
    replica-aware ShardMapper this deployment plans queries from, so
    the cutover here IS the cutover queries see."""

    def __init__(self, dataset: str, mapper,
                 client_for: Callable[[str], object],
                 tombstone_grace_s: float = 0.0,
                 health=None,
                 on_cutover: Optional[Callable[[int, str, str], None]] = None):
        self.dataset = dataset
        self.mapper = mapper
        self.client_for = client_for
        self.grace_s = float(tombstone_grace_s)
        self.health = health
        # deployment hook fired at the cutover edge (shard, old, new) —
        # e.g. re-point a node-resident flush scheduler
        self.on_cutover = on_cutover
        self._history: List[Dict] = []

    # ------------------------------------------------------------- history

    @property
    def history(self) -> List[Dict]:
        return list(self._history)

    # -------------------------------------------------------------- drive

    def handoff(self, shard: int, to_node: str,
                skip_wal_tail: bool = False) -> Dict:
        """Move `shard`'s primary copy to `to_node`.  Returns a summary
        dict; raises HandoffError (after journaling + rollback) on any
        step failure.  `skip_wal_tail` is for deployments whose every
        ingest door already fans out through the replicator — the
        registration in step 1 then closes the gap by itself."""
        from filodb_tpu_torch.parallel.shardmapper import ShardStatus
        t0 = time.perf_counter()
        from_node = self.mapper.node_for_shard(shard)
        if from_node is None:
            raise HandoffError(f"shard {shard} has no primary to hand off")
        if to_node == from_node:
            raise HandoffError(
                f"shard {shard} is already owned by {to_node!r}")
        job = jobs.register("shard_handoff", dataset=self.dataset)
        summary: Dict = {"dataset": self.dataset, "shard": shard,
                         "from": from_node, "to": to_node,
                         "states": []}
        state = PENDING
        journal.emit("shard_handoff_started", subsystem="replication",
                     dataset=self.dataset, shard=shard,
                     frm=from_node, to=to_node)
        registered = False

        def step(new_state: str, **fields) -> None:
            nonlocal state
            state = new_state
            summary["states"].append(new_state)
            journal.emit("shard_handoff", subsystem="replication",
                         dataset=self.dataset, shard=shard,
                         state=new_state, frm=from_node, to=to_node,
                         **fields)

        try:
            with job.tick():
                job.set_progress(f"shard {shard} -> {to_node}: register")
                # 1. open the restore window on the target, THEN join
                # the assignment list (RECOVERY: not yet query-ready —
                # failover must not route to a copy that is still
                # filling).  Live fan-out slabs arriving from here on
                # are acked-and-buffered behind the window, so a fresh
                # sample can never land before its series' older
                # snapshot history and OOO-drop it.
                src = self.client_for(from_node)
                dst = self.client_for(to_node)
                step(REGISTER)
                dst.begin_restore(self.dataset, shard)
                # ASSIGNED, not RECOVERY: RECOVERY counts as
                # query_ready (a recovering primary still serves), but
                # a copy that is still FILLING must be invisible to
                # failover and to the promotion path until the restore
                # window closes
                self.mapper.register_replica(shard, to_node,
                                             status=ShardStatus.ASSIGNED)
                registered = True

                # 2. bulk copy: old owner's working set streams through
                # the new owner's ordinary ingest path (restore-flagged:
                # applied through the open window)
                job.set_progress(f"shard {shard} -> {to_node}: snapshot")
                records = 0
                for body in src.snapshot_shard(self.dataset, shard):
                    dst.append_record(self.dataset, body, restore=True)
                    records += 1
                step(STREAM_SNAPSHOT, records=records)

                # 3. WAL tail: anything the log holds that predates the
                # registration (non-replicated doors) replays shard-
                # filtered on the new owner
                if not skip_wal_tail:
                    job.set_progress(
                        f"shard {shard} -> {to_node}: wal tail")
                    tail = self._stream_wal_tail(src, dst, shard)
                    step(STREAM_WAL_TAIL, records=tail)
                # close the restore window: live slabs buffered behind
                # the copy apply in arrival order — the new owner is
                # gap-free AND ordered, so now it is query-ready
                dst.end_restore(self.dataset, shard)
                self.mapper.register_replica(shard, to_node,
                                             status=ShardStatus.ACTIVE)

                # 4. ATOMIC cutover: the next query plans against the
                # new primary; the old owner stays a (serving) replica
                # until the tombstone grace drains stragglers
                job.set_progress(f"shard {shard} -> {to_node}: cutover")
                self.mapper.promote_replica(shard, to_node,
                                            demote_old=True)
                step(CUTOVER)
                if self.on_cutover is not None:
                    self.on_cutover(shard, from_node, to_node)

                # 5. tombstone the old copy
                if self.grace_s > 0:
                    time.sleep(self.grace_s)
                job.set_progress(f"shard {shard} -> {to_node}: tombstone")
                self.mapper.unassign_replica(shard, from_node)
                try:
                    src.drop_shard(self.dataset, shard)
                except Exception as e:  # noqa: BLE001 — the old copy
                    # lingering is benign (it left the assignment list);
                    # surface, don't fail the completed move
                    _log.warning("handoff tombstone of shard %d on %s "
                                 "failed: %s", shard, from_node, e)
                    summary["tombstoneError"] = f"{e}"
                step(TOMBSTONE)
                step(DONE)
        except Exception as e:  # noqa: BLE001 — every failure journals
            journal.emit("shard_handoff_failed", subsystem="replication",
                         dataset=self.dataset, shard=shard,
                         state=state, frm=from_node, to=to_node,
                         error=f"{type(e).__name__}: {e}")
            metrics_registry.counter("shard_handoffs",
                                     dataset=self.dataset,
                                     outcome="failed").increment()
            # roll back: the half-filled new copy must not be routable
            if registered and state in (REGISTER, STREAM_SNAPSHOT,
                                        STREAM_WAL_TAIL):
                self.mapper.unassign_replica(shard, to_node)
                try:
                    self.client_for(to_node).abort_restore(self.dataset,
                                                           shard)
                except Exception:  # noqa: BLE001 — best-effort cleanup
                    pass
                try:
                    self.client_for(to_node).drop_shard(self.dataset,
                                                        shard)
                except Exception:  # noqa: BLE001 — best-effort cleanup
                    pass
            summary["error"] = f"{type(e).__name__}: {e}"
            self._history.append(summary)
            raise HandoffError(
                f"handoff of shard {shard} to {to_node!r} failed in "
                f"{state}: {e}") from e
        summary["elapsedSeconds"] = round(time.perf_counter() - t0, 3)
        metrics_registry.counter("shard_handoffs", dataset=self.dataset,
                                 outcome="done").increment()
        journal.emit("shard_handoff_done", subsystem="replication",
                     dataset=self.dataset, shard=shard, frm=from_node,
                     to=to_node,
                     elapsed_s=summary["elapsedSeconds"])
        self._history.append(summary)
        return summary

    def _stream_wal_tail(self, src, dst, shard: int) -> int:
        """Relay the old owner's WAL records for `shard` to the new
        owner through its ordinary door (catchup.relay_wal).  A source
        without a WAL contributes nothing — its memory snapshot already
        streamed."""
        from filodb_tpu_torch.replication.catchup import relay_wal
        return relay_wal(src, dst, self.dataset, shards=[shard])

    # --------------------------------------------------------------- drain

    def drain_node(self, node: str,
                   target_for: Callable[[int], Optional[str]] = None
                   ) -> Dict:
        """Rolling-restart drain: hand every shard whose primary is
        `node` to another owner, then flip `/ready` to 503 via
        health.draining.  `target_for(shard)` picks the destination
        (default: the shard's first query-ready replica)."""
        shards = self.mapper.shards_for_node(node)
        moved, failed = [], []
        for s in shards:
            to = target_for(s) if target_for is not None else None
            if to is None:
                live = [n for n in self.mapper.replicas[s]
                        if self.mapper.owner_status(s, n).query_ready]
                to = live[0] if live else None
            if to is None:
                failed.append({"shard": s, "error": "no target replica"})
                continue
            try:
                # the target already holds a live replica copy — the
                # snapshot stream is incremental dedup on top of it
                moved.append(self.handoff(s, to))
            except HandoffError as e:
                failed.append({"shard": s, "error": str(e)})
        if self.health is not None and not failed:
            self.health.draining = f"drained {len(moved)} shard(s) " \
                                   f"off {node}"
        return {"node": node, "moved": [m["shard"] for m in moved],
                "failed": failed}
