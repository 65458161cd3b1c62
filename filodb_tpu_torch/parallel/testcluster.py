"""Shared two-node cluster builder for tests AND benchmarks (port of
filodb_tpu/parallel/testcluster.py: `TwoNodeCluster`, `make_fanout_cluster`
and `make_two_node_cluster`, each store on `device`).

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
