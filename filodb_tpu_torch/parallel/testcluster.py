"""Shared cluster fixtures for tests AND benchmarks (port of
filodb_tpu/parallel/testcluster.py: `make_fanout_cluster`,
`make_two_node_cluster`, `make_replicated_cluster`,
`make_cold_read_cluster` and `make_federated_pair`, each store on
`device`).

Lives in the main package on purpose, like the reference keeping
TestTimeseriesProducer in src/main so jmh/stress reuse it (ref:
gateway/src/main/scala/filodb/timeseries/TestTimeseriesProducer.scala;
SURVEY §4 'shared fixtures').  One wiring of the cross-node transport
means the transport tests and the dispatch benchmark cannot drift.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.gateway.router import split_batch_by_shard
from filodb_tpu_torch.parallel.shardmapper import (ShardEvent, ShardMapper,
                                                   SpreadProvider)
from filodb_tpu_torch.parallel.transport import (NodeQueryServer,
                                                 RemoteNodeDispatcher)
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.query.planner import SingleClusterPlanner


@dataclasses.dataclass
class TwoNodeCluster:
    """Coordinator engine dispatching over TCP to two data nodes."""
    engine: QueryEngine
    mapper: ShardMapper
    stores: Dict[str, TimeSeriesMemStore]
    owner: Dict[int, str]
    servers: Dict[str, NodeQueryServer]
    truth: Optional[TimeSeriesMemStore]   # single store with ALL data

    def stop(self) -> None:
        for srv in self.servers.values():
            srv.stop()


@dataclasses.dataclass
class ReplicatedCluster:
    """N in-process nodes, every shard owned RF times: query servers on
    the real cross-node transport, replication doors on the real framed
    protocol, ingest fanned out by a ReplicationManager (distributor
    mode), queries planned through ReplicaFailoverDispatchers.  The
    shared fixture of the replication tests AND `bench.py replication`."""
    dataset: str
    engine: QueryEngine
    mapper: ShardMapper
    manager: "object"                     # ReplicationManager
    stores: Dict[str, TimeSeriesMemStore]
    query_servers: Dict[str, "NodeQueryServer"]
    repl_servers: Dict[str, "object"]     # ReplicationServer per node
    repl_clients: Dict[str, "object"]     # ReplicaClient per node
    truth: Optional[TimeSeriesMemStore]
    sm: "object"                          # ShardManager

    def ingest_grid(self, shard: int, schema: str, keys, ts, columns,
                    require_primary: bool = True):
        """One slab through the replicated ingest path (all owners) +
        the truth store when present."""
        res = self.manager.replicate(shard, schema, keys, ts, columns,
                                     require_primary=require_primary)
        if self.truth is not None:
            self.truth.get_shard(self.dataset, shard).ingest_columns(
                schema, keys, ts, columns)
        return res

    def kill(self, node: str) -> None:
        """In-process node death with the SIGKILL signature: live
        transport connections sever, new connects refuse."""
        self.query_servers[node].stop()
        self.repl_servers[node].stop()

    def stop(self) -> None:
        self.manager.stop()
        for srv in self.query_servers.values():
            try:
                srv.stop()
            except OSError:
                pass
        for srv in self.repl_servers.values():
            try:
                srv.stop()
            except OSError:
                pass


def make_replicated_cluster(nodes=("A", "B", "C"), num_shards: int = 4,
                            dataset: str = "prometheus",
                            replication_factor: int = 2,
                            ack_mode: str = "quorum",
                            with_truth: bool = False,
                            wal_root: Optional[str] = None,
                            append_timeout_s: Optional[float] = None,
                            device="cuda") -> ReplicatedCluster:
    """N nodes on loopback (query server + replication door each), every
    shard owned `replication_factor` times; every store, the truth store
    and the coordinator's engine live on `device`.  `wal_root` gives each
    node a WalManager under `<wal_root>/<node>` (the catch-up source).
    `append_timeout_s` sets `replication.append_timeout_s` and every door
    client's timeout with it (default: the clients' own 10 s)."""
    from filodb_tpu_torch.config import ReplicationConfig
    from filodb_tpu_torch.parallel.shardmanager import (DatasetResourceSpec,
                                                        ShardManager)
    from filodb_tpu_torch.replication import (ReplicaClient,
                                              ReplicationManager,
                                              ReplicationServer,
                                              failover_dispatcher_factory)
    sm = ShardManager(replication_factor=replication_factor)
    for n in nodes:
        sm.add_member(n)
    mapper = sm.setup_dataset(
        dataset, DatasetResourceSpec(num_shards, len(nodes)))
    stores = {n: TimeSeriesMemStore(device=device) for n in nodes}
    wals: Dict[str, Dict] = {n: {} for n in nodes}
    if wal_root is not None:
        import os

        from filodb_tpu_torch.wal import WalManager
        for n in nodes:
            wals[n] = {dataset: WalManager(
                os.path.join(wal_root, n), dataset)}
    for s in range(num_shards):
        for n in mapper.owners(s):
            stores[n].setup(dataset, s)
    # every owner copy is live from the start (in-process fixture — the
    # cluster path flips these through heartbeats)
    for s in range(num_shards):
        primary = mapper.node_for_shard(s)
        mapper.update_from_event(
            ShardEvent("IngestionStarted", dataset, s, primary))
        for n in list(mapper.replicas[s]):
            mapper.update_from_event(
                ShardEvent("ReplicaActive", dataset, s, n))
    query_servers = {n: NodeQueryServer(st).start()
                     for n, st in stores.items()}
    repl_servers = {n: ReplicationServer(stores[n], node=n,
                                         wals=wals[n]).start()
                    for n in nodes}
    cfg = ReplicationConfig(enabled=True, factor=replication_factor,
                            ack_mode=ack_mode)
    timeout = {}
    if append_timeout_s is not None:
        cfg.append_timeout_s = timeout["timeout_s"] = float(append_timeout_s)
    repl_clients = {n: ReplicaClient(*srv.address, **timeout)
                    for n, srv in repl_servers.items()}
    manager = ReplicationManager(dataset, mapper,
                                 lambda n: repl_clients[n], config=cfg)
    dispatchers: Dict[str, RemoteNodeDispatcher] = {}

    def dispatcher_for(node: str) -> RemoteNodeDispatcher:
        d = dispatchers.get(node)
        if d is None:
            dispatchers[node] = d = RemoteNodeDispatcher(
                *query_servers[node].address)
        return d

    planner = SingleClusterPlanner(
        dataset, mapper, SpreadProvider(default_spread=1),
        dispatcher_factory=failover_dispatcher_factory(mapper,
                                                       dispatcher_for))
    engine = QueryEngine(dataset, TimeSeriesMemStore(device=device), mapper,
                         planner=planner, device=device)
    truth = None
    if with_truth:
        truth = TimeSeriesMemStore(device=device)
        for s in range(num_shards):
            truth.setup(dataset, s)
    return ReplicatedCluster(dataset, engine, mapper, manager, stores,
                             query_servers, repl_servers, repl_clients,
                             truth, sm)


def make_fanout_cluster(batches: Iterable = (), num_shards: int = 4,
                        dataset: str = "prometheus",
                        default_spread: int = 1,
                        with_truth: bool = False,
                        nodes: Iterable = ("nodeA", "nodeB"),
                        device="cuda") -> TwoNodeCluster:
    """N node processes (in-process servers), shards round-split across
    them, coordinator holding NO data with remote dispatchers — the
    multi-JVM IngestionAndRecoverySpec shape generalized for the
    distributed-execution fan-out bench (`bench.py distexec` drives a
    4-node shape through exactly this wiring).  Every store, the truth
    store and the coordinator's engine live on `device`."""
    nodes = list(nodes)
    mapper = ShardMapper(num_shards)
    spread = SpreadProvider(default_spread=default_spread)
    stores = {n: TimeSeriesMemStore(device=device) for n in nodes}
    per = max(1, -(-num_shards // len(nodes)))      # ceil split, in order
    owner = {s: nodes[min(s // per, len(nodes) - 1)]
             for s in range(num_shards)}
    for s, node in owner.items():
        stores[node].setup(dataset, s)
        mapper.update_from_event(
            ShardEvent("IngestionStarted", dataset, s, node))
    truth = TimeSeriesMemStore(device=device) if with_truth else None
    truth_shards = ({s: truth.setup(dataset, s) for s in range(num_shards)}
                    if truth is not None else {})
    for batch in batches:
        for s, sub in split_batch_by_shard(batch, mapper, spread).items():
            stores[owner[s]].get_shard(dataset, s).ingest(sub)
            if truth is not None:
                truth_shards[s].ingest(sub)
    servers = {n: NodeQueryServer(st).start() for n, st in stores.items()}
    dispatchers = {n: RemoteNodeDispatcher(*srv.address)
                   for n, srv in servers.items()}
    planner = SingleClusterPlanner(
        dataset, mapper, spread,
        dispatcher_factory=lambda s: dispatchers[owner[s]])
    engine = QueryEngine(dataset, TimeSeriesMemStore(device=device), mapper,
                         planner=planner, device=device)
    return TwoNodeCluster(engine, mapper, stores, owner, servers, truth)


@dataclasses.dataclass
class ColdReadCluster:
    """Coordinator + N query-capable nodes over ONE shared object store
    (persist/objectstore.py): the data node nominally owns every shard,
    query-only nodes own NOTHING — all of them serve cold leaves from
    the shared tier, walked round-robin by the cold dispatcher.  The
    shared fixture of the query-only-node tests AND the `bench.py
    objectstore` elastic-read gate."""
    dataset: str
    engine: QueryEngine
    mapper: ShardMapper
    object_store: "object"
    tier: "object"                        # object-store-backed query tier
    remote_store: "object"                # RemoteSegmentStore behind it
    servers: Dict[str, NodeQueryServer]
    query_nodes: tuple

    def stop(self) -> None:
        for srv in self.servers.values():
            try:
                srv.stop()
            except OSError:
                pass


def make_cold_read_cluster(object_store, num_shards: int = 4,
                           dataset: str = "prometheus",
                           data_nodes: Iterable = ("data0",),
                           query_nodes: Iterable = (),
                           schemas=None, device="cuda") -> ColdReadCluster:
    """Cold-read cluster over a pre-populated shared object store: call
    after segments + manifests are uploaded.  Every node (data-owning or
    query-only) is an in-process NodeQueryServer with an EMPTY memstore;
    decoded cold leaves rebind to the object-store query tier through
    the per-process tier registry, so this models N stateless readers
    paging one shared tier.  Query-only nodes register on the mapper
    (`register_query_node`) and the persisted planner routes through
    `cold_dispatcher_factory` — round-robin across all of them.  The
    shared tier's cold region on `device` holds the settings'
    `store.device_mirror_cold_limit_bytes`, as a FiloServer's does."""
    from filodb_tpu_torch.config import settings
    from filodb_tpu_torch.persist.objectstore import make_query_tier
    from filodb_tpu_torch.query.planners import PersistedClusterPlanner
    from filodb_tpu_torch.replication.failover import cold_dispatcher_factory
    data_nodes = list(data_nodes)
    query_nodes = tuple(query_nodes)
    mapper = ShardMapper(num_shards)
    spread = SpreadProvider(default_spread=1)
    for s in range(num_shards):
        mapper.update_from_event(ShardEvent(
            "IngestionStarted", dataset, s,
            data_nodes[s % len(data_nodes)]))
    for q in query_nodes:
        mapper.register_query_node(q)
    stores = {n: TimeSeriesMemStore(device=device)
              for n in list(data_nodes) + list(query_nodes)}
    servers = {n: NodeQueryServer(st).start() for n, st in stores.items()}
    dispatchers: Dict[str, RemoteNodeDispatcher] = {}

    def dispatcher_for(node: str) -> RemoteNodeDispatcher:
        d = dispatchers.get(node)
        if d is None:
            dispatchers[node] = d = RemoteNodeDispatcher(
                *servers[node].address)
        return d

    # built LAST on purpose: the per-process tier registry resolves
    # decoded cold leaves to the most recent tier for the dataset, and
    # this in-process fixture wants that to be the object-store one
    tier, remote = make_query_tier(object_store, dataset, num_shards,
                                   cold_limit_bytes=settings().store
                                   .device_mirror_cold_limit_bytes,
                                   schemas=schemas, device=device)
    planner = PersistedClusterPlanner(
        dataset, mapper, tier, spread_provider=spread,
        dispatcher_factory=cold_dispatcher_factory(mapper, dispatcher_for))
    engine = QueryEngine(dataset, TimeSeriesMemStore(device=device), mapper,
                         planner=planner, device=device)
    return ColdReadCluster(dataset, engine, mapper, object_store, tier,
                           remote, servers, query_nodes)


@dataclasses.dataclass
class FederatedPair:
    """Two FULL FiloServer clusters federated over their doors, plus a
    single-store ground truth holding every series — the shared fixture
    of tests/test_federation.py AND `bench.py federation`.

    `east` owns region="east" series and is the coordinator the tests
    query; `west` owns region="west".  Each cluster's config declares
    the other via `federation.clusters` label matchers, so a query
    without a region selector fans out to both (west replying cluster
    partials for mergeable aggregates) and `{region="west"}` routes
    whole expressions across."""
    dataset: str
    metric: str
    east: "object"                        # FiloServer (coordinator)
    west: "object"                        # FiloServer (remote)
    truth: QueryEngine                    # all series in ONE store
    truth_store: TimeSeriesMemStore

    @property
    def engine(self) -> QueryEngine:
        return self.east.engines[self.dataset]

    @property
    def frontend(self):
        return self.east.api.frontends[self.dataset]

    def kill_west(self) -> None:
        """Cluster death with the SIGKILL signature, as east sees it:
        west's federation door severs live connections and refuses new
        ones.  (west's own engines keep running — a dead DOOR is what a
        dead cluster looks like from across the boundary.)"""
        self.west.federation_door.stop()

    def revive_west(self) -> None:
        """Bring west's door back on its ORIGINAL configured port
        (half-open breaker recovery needs the declared endpoint to
        answer again)."""
        self.west.federation_door.start()

    def stop(self) -> None:
        for srv in (self.east, self.west):
            try:
                srv.shutdown()
            except OSError:
                pass


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def make_federated_pair(num_series: int = 8, num_samples: int = 120,
                        num_shards: int = 2, dataset: str = "prometheus",
                        start_ms: int = 1_600_000_020_000,
                        step_ms: int = 10_000, metric: str = "fed_gauge",
                        push_partials: bool = True,
                        probe_interval_s: float = 0.2,
                        start: bool = True,
                        device="cuda") -> FederatedPair:
    """Boot the two-cluster federation testbench: `num_series` integer-
    valued series per region, split by the `region` ownership label;
    the truth engine answers the same queries from one store holding
    everything (bit-identity oracle).  Both servers and the truth store
    live on `device`; `num_series=0` boots them empty (the caller
    ingests its own data)."""
    from filodb_tpu_torch.config import FilodbSettings
    from filodb_tpu_torch.ingest.generator import region_gauge_batch
    from filodb_tpu_torch.standalone import DatasetConfig, FiloServer
    ports = {"east": _free_port(), "west": _free_port()}

    def cfg(me: str, peer: str) -> FilodbSettings:
        c = FilodbSettings()
        f = c.federation
        f.enabled = True
        f.cluster_name = me
        f.door_port = ports[me]
        f.probe_interval_s = probe_interval_s
        f.probe_timeout_s = 1.0
        f.push_partials = push_partials
        f.clusters = {
            peer: {"host": "127.0.0.1", "port": ports[peer],
                   "match": {"region": peer}},
            me: {"local": True, "match": {"region": me}},
        }
        return c

    servers = {}
    batches = {}
    for i, (me, peer) in enumerate((("east", "west"), ("west", "east"))):
        srv = FiloServer([DatasetConfig(dataset, num_shards=num_shards)],
                         config=cfg(me, peer), http_port=0, node_name=me,
                         device=device)
        servers[me] = srv
        if num_series <= 0:
            continue
        batches[me] = region_gauge_batch(
            num_series, num_samples, region=me, start_ms=start_ms,
            step_ms=step_ms, metric=metric, seed=i + 1)
        spread = srv.spreads[dataset]
        for s, sub in split_batch_by_shard(batches[me],
                                           srv.mappers[dataset],
                                           spread).items():
            srv.memstore.get_shard(dataset, s).ingest(sub)
    truth_store = TimeSeriesMemStore(device=device)
    truth_mapper = ShardMapper(num_shards)
    truth_spread = SpreadProvider(default_spread=1)
    for s in range(num_shards):
        truth_store.setup(dataset, s)
        truth_mapper.update_from_event(
            ShardEvent("IngestionStarted", dataset, s, "truth"))
    for batch in batches.values():
        for s, sub in split_batch_by_shard(batch, truth_mapper,
                                           truth_spread).items():
            truth_store.get_shard(dataset, s).ingest(sub)
    truth = QueryEngine(dataset, truth_store, truth_mapper,
                        planner=SingleClusterPlanner(dataset, truth_mapper,
                                                     truth_spread),
                        device=device)
    if start:
        for srv in servers.values():
            srv.start()
    return FederatedPair(dataset, metric, servers["east"],
                         servers["west"], truth, truth_store)


def make_two_node_cluster(batches: Iterable = (), num_shards: int = 4,
                          dataset: str = "prometheus",
                          default_spread: int = 1,
                          with_truth: bool = False,
                          device="cuda") -> TwoNodeCluster:
    """Two node processes, shards split half/half — the original
    fixture shape, now a 2-node `make_fanout_cluster`."""
    return make_fanout_cluster(batches, num_shards, dataset,
                               default_spread, with_truth,
                               nodes=("nodeA", "nodeB"), device=device)
