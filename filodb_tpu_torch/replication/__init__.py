"""Replication layer — RF-2 ingest, WAL-segment catch-up, query-time
replica failover, live shard handoff (port of filodb_tpu/replication;
doc/replication.md).  The door's frames, the handoff journal and the
admin payloads are the reference's byte for byte, so a port node and a
JAX node replicate to each other.

The partial-results path makes node failures degrade into FLAGGED
partial results; a production time-series store serves FULL results
through a node kill by owning every shard twice (ref: FiloDB's
ShardMapper/coordinator layer, PAPER.md §1; the Cortex distributor /
Monarch replica-set stance).  The four pieces, each its own module:

  placement   parallel/shardmapper.py + shardmanager.py grew ordered
              per-shard assignment lists (primary + replicas, never
              co-located) — this package consumes them.
  service.py  the node-side replication door: framed-TCP server
              accepting slab appends, WAL-segment fetches, working-set
              snapshot streams, and shard drops; `ReplicaClient` is the
              pooled client every other module dials peers with.
  replicator.py  ingest fan-out (the distributor): every columnar slab
              goes to all live owners of its shard, acked
              primary-durable (+ replica-acked under
              `replication.ack_mode = quorum`), with per-replica lag
              tracked as metrics and `replica_lagging` /
              `replica_caught_up` journal events.
  catchup.py  a replica joining or falling behind streams WAL segments
              from the primary (never re-scrapes) and replays them
              through the ordinary wal/replay.py ingest path, as a
              `replication_catchup` job in the job registry.
  failover.py the query-time half: `ReplicaFailoverDispatcher` prefers
              the primary and fails over to replicas on
              shard_unavailable / breaker-open BEFORE the partial-results
              path engages — partials only when ALL owners are dead.
  handoff.py  admin-triggered live shard handoff: stream working set +
              WAL tail to the new owner while the old one keeps
              serving, cut the ShardMapper over atomically, then
              tombstone — every transition journaled; rolling restarts
              drain through it (`/ready` flips 503).
"""
from filodb_tpu_torch.replication.service import (  # noqa: F401
    ReplicaClient, ReplicationServer, ReplicationError)
from filodb_tpu_torch.replication.replicator import (  # noqa: F401
    ReplicationManager, ReplicateResult)
from filodb_tpu_torch.replication.catchup import (  # noqa: F401
    CatchupStats, catchup_shards, rebuild_node)
from filodb_tpu_torch.replication.failover import (  # noqa: F401
    ReplicaFailoverDispatcher, cold_dispatcher_factory,
    failover_dispatcher_factory)
from filodb_tpu_torch.replication.handoff import (  # noqa: F401
    HandoffCoordinator, HandoffError)

__all__ = ["ReplicaClient", "ReplicationServer", "ReplicationError",
           "ReplicationManager", "ReplicateResult", "CatchupStats",
           "catchup_shards", "rebuild_node",
           "ReplicaFailoverDispatcher", "cold_dispatcher_factory",
           "failover_dispatcher_factory", "HandoffCoordinator",
           "HandoffError"]
