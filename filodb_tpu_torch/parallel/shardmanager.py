"""ShardManager — the cluster-singleton shard coordinator (port of
filodb_tpu/parallel/shardmanager.py).

Mirrors the reference's NodeClusterActor + ShardManager pair (ref:
coordinator/.../NodeClusterActor.scala:469 area, ShardManager.scala:621,
doc/sharding.md:57-189):

  - owns the authoritative ShardMapper for every dataset
  - assigns shards to nodes via a stateless even-spread strategy, in
    reverse deploy order so rolling upgrades drain the oldest nodes last
    (ref: ShardAssignmentStrategy.scala:113, doc/sharding.md:87-103)
  - reacts to node join/leave: reassigns a downed node's shards to
    remaining capacity, rate-limited per shard by
    `reassignment-min-interval` (ref: filodb-defaults.conf:208-211,
    doc/sharding.md:158-167)
  - publishes ShardEvents to subscribers, who first receive a full
    CurrentShardSnapshot (ref: ShardSubscriptions.scala:59)
  - recovers its state after singleton failover by replaying dataset
    configs from the MetaStore-analogue plus node-local snapshots
    (ref: doc/sharding.md:177-189)

The TPU-native control plane is an in-process state machine with pluggable
node handles (strings); cross-host transports (gRPC/HTTP) call these same
entry points.  Time is injectable for deterministic failover tests.
"""
from __future__ import annotations

import dataclasses
import math
import time as _time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from filodb_tpu_torch.parallel.shardmapper import (ShardEvent, ShardMapper,
                                                   ShardStatus)


@dataclasses.dataclass(frozen=True)
class DatasetResourceSpec:
    """ref: NodeClusterActor.SetupDataset resources."""
    num_shards: int
    min_num_nodes: int


@dataclasses.dataclass
class ShardSnapshot:
    """ref: CurrentShardSnapshot sent to new subscribers."""
    dataset: str
    nodes: List[Optional[str]]
    statuses: List[str]


class ShardAssignmentStrategy:
    """ref: ShardAssignmentStrategy.scala trait.  `exclude` removes shards
    from the candidate pool BEFORE capacity truncation, so an ineligible
    shard (rate-limited, error-pinned) never occupies a proposal slot."""

    def shards_for_node(self, node: str, dataset: str,
                        resources: DatasetResourceSpec,
                        mapper: ShardMapper,
                        exclude: frozenset = frozenset()) -> List[int]:
        raise NotImplementedError


class DefaultShardAssignmentStrategy(ShardAssignmentStrategy):
    """Stateless even spread: each node takes up to
    ceil(numShards / minNumNodes) shards from the unassigned pool
    (ref: DefaultShardAssignmentStrategy, doc/sharding.md:87-103)."""

    def shards_for_node(self, node, dataset, resources, mapper,
                        exclude=frozenset()):
        assigned_to_node = mapper.shards_for_node(node)
        capacity = math.ceil(resources.num_shards / resources.min_num_nodes)
        room = capacity - len(assigned_to_node)
        if room <= 0:
            return []
        unassigned = [s for s in range(mapper.num_shards)
                      if mapper.node_for_shard(s) is None
                      and s not in exclude]
        return unassigned[:room]


Subscriber = Callable[[object], None]       # receives ShardSnapshot | ShardEvent


class ShardManager:

    def __init__(self,
                 strategy: Optional[ShardAssignmentStrategy] = None,
                 reassignment_min_interval_s: float = 2 * 3600.0,
                 clock: Callable[[], float] = _time.time,
                 replication_factor: int = 1):
        self.strategy = strategy or DefaultShardAssignmentStrategy()
        self.reassignment_min_interval_s = reassignment_min_interval_s
        self.clock = clock
        # owners per shard (primary + replicas); 1 = replication off —
        # everything below then behaves exactly as before the
        # replication layer (doc/replication.md)
        self.replication_factor = max(int(replication_factor), 1)
        # deploy order: index = join order (reverse-deploy assignment walks
        # from the most recently joined, ref: ShardManager.addMember)
        self._members: List[str] = []
        self._datasets: Dict[str, DatasetResourceSpec] = {}
        self._mappers: Dict[str, ShardMapper] = {}
        self._subscribers: Dict[str, List[Subscriber]] = {}
        # (dataset, shard) -> last reassignment time; only shards that have
        # been assigned before are rate-limited — first assignment is free
        self._last_reassign: Dict[Tuple[str, int], float] = {}
        self._ever_assigned: set = set()
        # (dataset, shard) -> node the shard last errored on, to keep an
        # erroring shard from flapping straight back
        self._error_node: Dict[Tuple[str, int], str] = {}

    # ------------------------------------------------------------ accessors

    @property
    def members(self) -> List[str]:
        return list(self._members)

    def mapper(self, dataset: str) -> ShardMapper:
        return self._mappers[dataset]

    def datasets(self) -> List[str]:
        return list(self._datasets)

    def snapshot(self, dataset: str) -> ShardSnapshot:
        m = self._mappers[dataset]
        return ShardSnapshot(dataset, list(m.nodes),
                             [s.value for s in m.statuses])

    # --------------------------------------------------------- subscriptions

    def subscribe(self, dataset: str, sub: Subscriber) -> None:
        """New subscribers first get the full snapshot
        (ref: ShardSubscriptions.subscribe)."""
        self._subscribers.setdefault(dataset, []).append(sub)
        if dataset in self._mappers:
            sub(self.snapshot(dataset))

    def _publish(self, ev: ShardEvent) -> None:
        for sub in self._subscribers.get(ev.dataset, []):
            sub(ev)

    # ------------------------------------------------------------- datasets

    def setup_dataset(self, dataset: str, resources: DatasetResourceSpec,
                      ) -> ShardMapper:
        """ref: NodeClusterActor.SetupDataset → ShardManager.addDataset."""
        if dataset in self._datasets:
            return self._mappers[dataset]
        self._datasets[dataset] = resources
        mapper = ShardMapper(resources.num_shards,
                             replication_factor=self.replication_factor)
        self._mappers[dataset] = mapper
        for node in reversed(self._members):
            self._assign_to(node, dataset)
        self._assign_replicas(dataset)
        return mapper

    # --------------------------------------------------------------- members

    def add_member(self, node: str) -> Dict[str, List[int]]:
        """Node joined: give it unassigned shards of every dataset
        (ref: ShardManager.addMember)."""
        if node in self._members:
            return {}
        self._members.append(node)
        out = {}
        for dataset in self._datasets:
            got = self._assign_to(node, dataset)
            if got:
                out[dataset] = got
            self._assign_replicas(dataset)
        return out

    def remove_member(self, node: str) -> Dict[str, List[int]]:
        """Node left/died: mark its shards Down, then reassign to surviving
        capacity subject to the per-shard rate limit
        (ref: ShardManager.removeMember + rate limit doc/sharding.md:158-167)."""
        if node not in self._members:
            return {}
        self._members.remove(node)
        affected: Dict[str, List[int]] = {}
        for dataset, mapper in self._mappers.items():
            shards = mapper.shards_for_node(node)
            replica_shards = mapper.replica_shards_for_node(node)
            if shards:
                affected[dataset] = list(shards)
            for s in shards:
                # RF >= 2: a live replica is promoted IN PLACE of the
                # dead primary — the shard never goes Down, queries fail
                # over without a gap (the point of the replication
                # layer); the dead node leaves the owner list entirely
                live = [n for n in mapper.replicas[s]
                        if mapper.owner_status(s, n).query_ready]
                if live:
                    mapper.promote_replica(s, live[0], demote_old=False)
                    ev = ShardEvent("ReplicaPromoted", dataset, s, live[0])
                    self._publish(ev)
                    continue
                mapper.update_from_event(
                    ShardEvent("ShardDown", dataset, s, node))
                self._publish(ShardEvent("ShardDown", dataset, s, node))
            for s in replica_shards:
                mapper.unassign_replica(s, node)
                self._publish(ShardEvent("ReplicaDown", dataset, s, node))
            self._reassign_down_shards(dataset)
            self._assign_replicas(dataset)
        return affected

    # ------------------------------------------------------------ assignment

    def _assign_to(self, node: str, dataset: str) -> List[int]:
        """Assign unassigned shards to `node` up to its capacity, skipping
        shards that moved within the rate-limit interval or that last errored
        on this very node."""
        resources = self._datasets[dataset]
        mapper = self._mappers[dataset]
        now = self.clock()
        assigned: List[int] = []
        skipped: set = set()
        # re-ask the strategy after every assignment/skip so an ineligible
        # proposal (rate-limited / error-pinned) is replaced by the next
        # eligible shard instead of wasting the node's capacity slot
        while True:
            proposals = self.strategy.shards_for_node(
                node, dataset, resources, mapper, exclude=frozenset(skipped))
            if not proposals:
                break
            s = proposals[0]
            key = (dataset, s)
            if self._error_node.get(key) == node:
                skipped.add(s)
                continue
            if key in self._ever_assigned:
                last = self._last_reassign.get(key)
                if last is not None and \
                        now - last < self.reassignment_min_interval_s:
                    skipped.add(s)
                    continue
                self._last_reassign[key] = now
            self._ever_assigned.add(key)
            self._error_node.pop(key, None)
            mapper.register_node([s], node)
            ev = ShardEvent("ShardAssignmentStarted", dataset, s, node)
            mapper.update_from_event(ev)
            self._publish(ev)
            assigned.append(s)
        return assigned

    def _reassign_down_shards(self, dataset: str) -> List[int]:
        """Give Down/Unassigned shards to nodes with spare capacity, newest
        member first."""
        moved = []
        for node in reversed(self._members):
            moved.extend(self._assign_to(node, dataset))
        return moved

    # -------------------------------------------------------------- replicas

    def _assign_replicas(self, dataset: str) -> List[Tuple[int, str]]:
        """Fill every shard's assignment list to `replication_factor`
        owners: replicas are never co-located with the primary (or each
        other), and spread by current replica load, least-loaded node
        first.  No-op at RF 1.  Returns [(shard, node)] newly assigned."""
        rf = self.replication_factor
        if rf <= 1 or len(self._members) < 2:
            return []
        mapper = self._mappers[dataset]
        load = {n: len(mapper.shards_for_node(n))
                + len(mapper.replica_shards_for_node(n))
                for n in self._members}
        added: List[Tuple[int, str]] = []
        for s in range(mapper.num_shards):
            primary = mapper.node_for_shard(s)
            if primary is None:
                continue            # replicas follow a placed primary
            while len(mapper.owners(s)) < rf:
                taken = set(mapper.owners(s))
                candidates = sorted(
                    (n for n in self._members if n not in taken),
                    key=lambda n: (load[n], self._members.index(n)))
                if not candidates:
                    break           # not enough nodes for full RF
                node = candidates[0]
                mapper.register_replica(s, node)
                load[node] += 1
                ev = ShardEvent("ReplicaAssigned", dataset, s, node)
                self._publish(ev)
                added.append((s, node))
        return added

    # -------------------------------------------------------- ingest events

    def on_shard_event(self, ev: ShardEvent) -> None:
        """Node-local ingestion lifecycle events flow up to the singleton and
        fan out to subscribers (ref: ShardManager.updateFromShardEvent)."""
        mapper = self._mappers.get(ev.dataset)
        if mapper is None:
            return
        mapper.update_from_event(ev)
        self._publish(ev)
        if ev.kind in ("IngestionStopped", "IngestionError"):
            # stopped/errored shards go back to the pool for reassignment;
            # an errored shard avoids the node it just failed on
            if ev.kind == "IngestionError" and ev.node is not None:
                self._error_node[(ev.dataset, ev.shard)] = ev.node
            mapper.unassign(ev.shard)
            self._reassign_down_shards(ev.dataset)

    # --------------------------------------------------------------- recovery

    def recover(self, datasets: Dict[str, DatasetResourceSpec],
                members: Sequence[str],
                snapshots: Dict[str, ShardSnapshot]) -> None:
        """Rebuild singleton state after failover: dataset configs from the
        metastore-analogue, member list from the cluster, shard maps from
        node-local snapshots (ref: doc/sharding.md:177-189 recovery protocol)."""
        self._members = list(members)
        for name, res in datasets.items():
            self._datasets[name] = res
            mapper = ShardMapper(res.num_shards)
            snap = snapshots.get(name)
            if snap is not None:
                for s, (node, status) in enumerate(zip(snap.nodes,
                                                       snap.statuses)):
                    if node is not None:
                        mapper.register_node([s], node)
                    mapper.statuses[s] = ShardStatus(status)
            self._mappers[name] = mapper
            # anything left unassigned gets assigned now
            for node in reversed(self._members):
                self._assign_to(node, name)
