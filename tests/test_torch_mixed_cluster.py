"""One cluster, two packages: a port node and a JAX node serve one query.

The shards are split between a data node of the port (its memstore on
`device="cpu"` behind the port's NodeQueryServer) and a data node of the
JAX package (behind the reference's NodeQueryServer), both on loopback
TCP.  A port coordinator (the port's QueryEngine with the port's
RemoteNodeDispatchers) and a JAX coordinator each query both nodes over
the same frames.  Each must answer as its own package's single store
holding every series: within rtol 2e-4 / atol 1e-3, exactly on
integer-valued data; with node-level pushdown on and off.
"""
import numpy as np
import pytest

from filodb_tpu.core.memstore import TimeSeriesMemStore as JStore
from filodb_tpu.gateway.router import split_batch_by_shard as jsplit
from filodb_tpu.ingest import generator as jgen
from filodb_tpu.parallel.shardmapper import ShardEvent as JEvent
from filodb_tpu.parallel.shardmapper import ShardMapper as JMapper
from filodb_tpu.parallel.shardmapper import SpreadProvider as JSpread
from filodb_tpu.parallel.transport import NodeQueryServer as JServer
from filodb_tpu.parallel.transport import RemoteNodeDispatcher as JDispatcher
from filodb_tpu.query.engine import QueryEngine as JEngine
from filodb_tpu.query.planner import SingleClusterPlanner as JPlanner
from filodb_tpu.query.rangevector import PlannerParams as JParams

from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.gateway.router import split_batch_by_shard
from filodb_tpu_torch.ingest import generator as tgen
from filodb_tpu_torch.parallel.shardmapper import (ShardEvent, ShardMapper,
                                                   SpreadProvider)
from filodb_tpu_torch.parallel.transport import (NodeQueryServer,
                                                 RemoteNodeDispatcher)
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.query.planner import SingleClusterPlanner
from filodb_tpu_torch.query.rangevector import PlannerParams

START = 1_600_000_020_000
S = START // 1000
SHARDS = 4


@pytest.fixture(autouse=True, scope="module")
def _clear_compile_journal():
    """The JAX engine journals jit compiles under its queries' trace ids,
    which the reference's health model reads as a compile storm for the
    next 120 s: clear it after this file."""
    yield
    from filodb_tpu.utils.events import journal
    journal.clear()


def _batches(gen):
    ig = gen.gauge_batch(96, 180, start_ms=START, metric="int_gauge")
    ig.columns["value"] = np.floor(ig.columns["value"])
    return [gen.gauge_batch(96, 180, start_ms=START), ig,
            gen.counter_batch(64, 180, start_ms=START)]


def _fill(store, split, mapper, spread, batches, shards):
    for s in shards:
        store.setup("prometheus", s)
    for b in batches:
        for s, sub in split(b, mapper, spread).items():
            if s in shards:
                store.get_shard("prometheus", s).ingest(sub)


@pytest.fixture(scope="module")
def mixed():
    """Shards 0-1 on a port node, 2-3 on a JAX node; both packages'
    single stores of everything; a coordinator of each package."""
    owner = {0: "port", 1: "port", 2: "jax", 3: "jax"}
    tm, jm = ShardMapper(SHARDS), JMapper(SHARDS)
    for s, n in owner.items():
        tm.update_from_event(ShardEvent("IngestionStarted", "prometheus", s,
                                        n))
        jm.update_from_event(JEvent("IngestionStarted", "prometheus", s, n))
    tsp, jsp = SpreadProvider(default_spread=1), JSpread(default_spread=1)
    tb, jb = _batches(tgen), _batches(jgen)
    port_node = TimeSeriesMemStore(device="cpu")
    _fill(port_node, split_batch_by_shard, tm, tsp, tb, {0, 1})
    jax_node = JStore()
    _fill(jax_node, jsplit, jm, jsp, jb, {2, 3})
    servers = {"port": NodeQueryServer(port_node).start(),
               "jax": JServer(jax_node).start()}
    addr = {n: srv.address for n, srv in servers.items()}
    t_truth = TimeSeriesMemStore(device="cpu")
    _fill(t_truth, split_batch_by_shard, tm, tsp, tb, set(range(SHARDS)))
    j_truth = JStore()
    _fill(j_truth, jsplit, jm, jsp, jb, set(range(SHARDS)))
    t_disp = {n: RemoteNodeDispatcher(*a) for n, a in addr.items()}
    j_disp = {n: JDispatcher(*a) for n, a in addr.items()}
    t_coord = QueryEngine("prometheus", TimeSeriesMemStore(device="cpu"), tm,
                          planner=SingleClusterPlanner(
                              "prometheus", tm, tsp,
                              dispatcher_factory=lambda s: t_disp[owner[s]]),
                          device="cpu")
    j_coord = JEngine("prometheus", JStore(), jm,
                      planner=JPlanner("prometheus", jm, jsp,
                                       dispatcher_factory=lambda s:
                                       j_disp[owner[s]]))
    yield {"port": (t_coord, QueryEngine("prometheus", t_truth, tm, tsp,
                                         device="cpu"), PlannerParams),
           "jax": (j_coord, JEngine("prometheus", j_truth, jm, jsp),
                   JParams)}
    for srv in servers.values():
        srv.stop()


QUERIES = [
    ('sum by (dc)(int_gauge)', True),
    ('count by (_ns_)(int_gauge)', True),
    ('max by (_ns_)(int_gauge)', True),
    ('sum by (_ns_)(rate(request_total[5m]))', False),
    ('avg by (_ns_)(heap_usage)', False),
    ('quantile by (_ns_)(0.9, heap_usage)', False),
    ('topk(3, int_gauge)', True),
    ('heap_usage', False),
]


def _series(res):
    assert res.error is None, res.error
    return {k.labels: np.asarray(v, np.float64) for k, _, v in res.series()}


@pytest.mark.parametrize("coordinator", ["port", "jax"])
@pytest.mark.parametrize("pushdown", [True, False])
@pytest.mark.parametrize("q, integral", QUERIES)
def test_mixed_cluster_answers_as_single_store(mixed, coordinator, pushdown,
                                               q, integral):
    coord, truth, params = mixed[coordinator]
    res = coord.query_range(q, S + 600, 60, S + 1700,
                            params(aggregation_pushdown=pushdown))
    got = _series(res)
    want = _series(truth.query_range(q, S + 600, 60, S + 1700))
    assert set(got) == set(want) and got
    if pushdown and q != 'heap_usage':
        assert res.stats.pushdown_pushed == 2       # one group per node
    for k in want:
        if integral:
            np.testing.assert_array_equal(got[k], want[k], err_msg=q)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-3,
                                       equal_nan=True, err_msg=q)
