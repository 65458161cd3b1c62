"""The port's wire and cluster query path against the JAX package's.

Both packages build the same fan-out cluster (four in-process data nodes
behind NodeQueryServers on loopback TCP, two shards each, a coordinator
QueryEngine over an empty memstore with RemoteNodeDispatchers;
`parallel/testcluster.make_fanout_cluster`, the port's on
`device="cpu"`) over the same seeded gauges, integer gauges, counters and
histograms.  Node-level aggregation pushdown on and off must answer the
same bits and equal the single store; the port's answers must agree
with the reference cluster's within rtol 2e-4 / atol 1e-3 (exactly on
integer-valued data).  Streamed replies, a kill mid-stream, torn and
corrupt streams, partial results on a dead node, the breakers and the
deadline share are held to the reference's contract
(tests/test_distexec.py, tests/test_partial_results.py).
"""
import socket
import threading
import time

import numpy as np
import pytest

from filodb_tpu.ingest import generator as jgen
from filodb_tpu.parallel.testcluster import \
    make_fanout_cluster as j_make_fanout_cluster
from filodb_tpu.query.rangevector import PlannerParams as JPlannerParams

from filodb_tpu_torch.config import settings
from filodb_tpu_torch.core.index import Equals
from filodb_tpu_torch.ingest.generator import (counter_batch, gauge_batch,
                                               histogram_batch)
from filodb_tpu_torch.parallel import transport as tr
from filodb_tpu_torch.parallel.breaker import breakers
from filodb_tpu_torch.parallel.shardmapper import SpreadProvider
from filodb_tpu_torch.parallel.testcluster import (make_fanout_cluster,
                                                   make_two_node_cluster)
from filodb_tpu_torch.query.activequeries import active_queries
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.query.exec import (AggPartial, AggregateMapReduce,
                                         MultiSchemaPartitionsExec,
                                         PeriodicSamplesMapper,
                                         RemoteAggregateExec)
from filodb_tpu_torch.query.execbase import QueryError
from filodb_tpu_torch.query.pushdown import (PushdownDispatcher,
                                             plan_aggregate_pushdown)
from filodb_tpu_torch.query.rangevector import PlannerParams, QueryContext

START = 1_600_000_020_000
S = START // 1000


@pytest.fixture(autouse=True, scope="module")
def _clear_compile_journal():
    """The JAX engine journals jit compiles under its queries' trace ids,
    which the reference's health model reads as a compile storm for the
    next 120 s in whatever file this process runs next: clear it after
    this file."""
    yield
    from filodb_tpu.utils.events import journal
    journal.clear()


def _batches(gen):
    int_gauge = gen.gauge_batch(192, 180, start_ms=START, metric="int_gauge")
    int_gauge.columns["value"] = np.floor(int_gauge.columns["value"])
    return [gen.gauge_batch(192, 180, start_ms=START), int_gauge,
            gen.counter_batch(64, 180, start_ms=START),
            gen.histogram_batch(48, 180, start_ms=START)]


class _PortGen:
    gauge_batch = staticmethod(gauge_batch)
    counter_batch = staticmethod(counter_batch)
    histogram_batch = staticmethod(histogram_batch)


@pytest.fixture(scope="module")
def cluster():
    """4 data nodes x 2 shards each in both packages; integer gauges make
    every partial sum exact, so the bitwise on/off contract holds however
    the merge tree associates."""
    c = make_fanout_cluster(_batches(_PortGen), num_shards=8,
                            nodes=("n1", "n2", "n3", "n4"), with_truth=True,
                            device="cpu")
    truth = QueryEngine("prometheus", c.truth, c.mapper,
                        SpreadProvider(default_spread=1), device="cpu")
    j = j_make_fanout_cluster(_batches(jgen), num_shards=8,
                              nodes=("n1", "n2", "n3", "n4"))
    yield c, truth, j
    c.stop()
    j.stop()


def _as_map(res):
    out = {}
    for b in res.blocks:
        vals = np.asarray(b.values)
        for i, k in enumerate(b.keys):
            out[k.labels] = (tuple(np.asarray(b.wends).tolist()),
                             vals[i].tobytes())
    return out


def _as_arrays(res):
    return {k.labels: np.asarray(v, np.float64) for k, _, v in res.series()}


def _range(eng, q, params_cls=PlannerParams, **kw):
    pp = params_cls(**kw) if kw else None
    return eng.query_range(q, S + 600, 60, S + 3600, pp)


QUERIES = [
    ('sum by (_ns_)(heap_usage)', False),
    ('sum by (dc)(int_gauge)', True),
    ('avg by (dc)(int_gauge)', False),
    ('stddev by (dc)(int_gauge)', False),
    ('min(heap_usage)', False),
    ('max by (_ns_)(heap_usage)', False),
    ('count by (_ns_)(heap_usage)', True),
    ('group by (dc)(heap_usage)', True),
    ('sum by (_ns_)(rate(request_total[5m]))', False),
    ('sum by (_ns_)(http_latency)', False),
    ('topk(3, heap_usage)', False),
    ('bottomk(2, heap_usage)', False),
    ('quantile(0.9, heap_usage)', False),
    ('quantile by (_ns_)(0.5, int_gauge)', True),
    ('count_values("v", int_gauge)', True),
]


@pytest.mark.parametrize("q, integral", QUERIES)
def test_pushdown_on_off_bit_identical(cluster, q, integral):
    """Pushdown on and off answer the same bits and equal the single
    store; pushdown moves fewer wire bytes than the per-shard path."""
    c, truth, _ = cluster
    on = _range(c.engine, q, aggregation_pushdown=True)
    off = _range(c.engine, q, aggregation_pushdown=False)
    want = _range(truth, q)
    assert on.error is None and off.error is None and want.error is None
    assert on.num_series > 0
    assert on.stats.pushdown_pushed == 4            # one group per node
    assert on.stats.pushdown_not_pushable == 0
    assert off.stats.pushdown_pushed == 0
    assert _as_map(on) == _as_map(off)
    assert _as_map(on) == _as_map(want)


@pytest.mark.parametrize("q, integral", QUERIES)
def test_port_cluster_agrees_with_reference_cluster(cluster, q, integral):
    """The same query over the same data through both packages' clusters:
    within rtol 2e-4 / atol 1e-3, exactly on integer-valued data."""
    c, _, j = cluster
    got = _as_arrays(_range(c.engine, q))
    want_res = _range(j.engine, q, JPlannerParams)
    assert want_res.error is None, want_res.error
    want = _as_arrays(want_res)
    assert set(got) == set(want) and got
    for k in want:
        if integral:
            np.testing.assert_array_equal(got[k], want[k], err_msg=q)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-3,
                                       equal_nan=True, err_msg=q)


def test_ship_everything_answers_as_pushed_with_more_wire_bytes(cluster):
    c, truth, _ = cluster
    q = 'sum by (dc)(int_gauge)'
    on = _range(c.engine, q)
    # ship-raw children carry no map phase, so even with pushdown on the
    # aggregation stays on the per-shard path
    raw = _range(c.engine, q, aggregation_pushdown=True,
                 ship_raw_series=True)
    assert raw.error is None and raw.stats.pushdown_pushed == 0
    assert raw.stats.pushdown_not_pushable == 8     # one per remote shard
    assert raw.stats.to_dict()["pushdown"]["notPushable"] == 8
    assert _as_map(raw) == _as_map(on) == _as_map(_range(truth, q))
    assert raw.stats.wire_bytes > on.stats.wire_bytes > 0
    assert on.stats.wire_bytes <= on.stats.bytes_transferred


def _leaf(ctx, shard, with_agg=True, metric="heap_usage"):
    leaf = MultiSchemaPartitionsExec(
        ctx, "prometheus", shard, [Equals("_metric_", metric)],
        START, START + 3_600_000)
    leaf.add_transformer(PeriodicSamplesMapper(
        START + 600_000, 60_000, START + 3_600_000, None, None, ()))
    if with_agg:
        leaf.add_transformer(AggregateMapReduce("sum", (), ("_ns_",), ()))
    return leaf


def test_fallback_when_node_group_unreachable(cluster):
    """A dead node group degrades to the per-shard path, counted as a
    fallback verdict."""
    c, _, _ = cluster
    ctx = QueryContext(device=c.engine.device)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead_addr = s.getsockname()
    s.close()
    live = tr.RemoteNodeDispatcher(*c.servers[c.owner[0]].address)
    kids = [_leaf(ctx, 0), _leaf(ctx, 1)]
    for k in kids:
        k.dispatcher = live
    group = RemoteAggregateExec(ctx, kids, "sum", ())
    group.dispatcher = PushdownDispatcher(
        tr.RemoteNodeDispatcher(*dead_addr, timeout_s=0.5))
    data, stats = group.dispatcher.dispatch(group, None)
    assert isinstance(data, AggPartial) and data.group_keys
    assert stats.pushdown_fallback == 1 and stats.pushdown_pushed == 0


def test_duplicate_shards_never_grouped(cluster):
    c, _, _ = cluster
    ctx = QueryContext()
    rd = tr.RemoteNodeDispatcher(*list(c.servers.values())[0].address)
    kids = [_leaf(ctx, 0), _leaf(ctx, 0), _leaf(ctx, 1)]
    for k in kids:
        k.dispatcher = rd
    out, _ = plan_aggregate_pushdown(kids, "sum", (), ctx)
    dups = [p for p in out if isinstance(p, MultiSchemaPartitionsExec)]
    groups = [p for p in out if isinstance(p, RemoteAggregateExec)]
    assert len(dups) == 2 and all(p.shard == 0 for p in dups)
    assert len(groups) == 1 and [k.shard for k in groups[0].children] == [1]


# ------------------------------------------------- streamed replies


@pytest.mark.parametrize("frame_bytes", [0, 4096])
def test_streamed_reply_identical(cluster, monkeypatch, frame_bytes):
    """Small frames force a many-frame stream of a raw selector; the
    result equals the single store's, and the frame count lands in
    stats (none with streaming off)."""
    c, truth, _ = cluster
    monkeypatch.setattr(settings().query, "stream_frame_bytes", frame_bytes)
    res = _range(c.engine, 'heap_usage')
    assert res.error is None
    assert (res.stats.streamed_frames > 8) == (frame_bytes > 0)
    assert _as_map(res) == _as_map(_range(truth, 'heap_usage'))


def test_streamed_shipeverything_fold_identical(cluster, monkeypatch):
    """ship_raw_series + tiny frames: ReduceAggregateExec folds every
    slice through map+reduce as it arrives, answering as the unstreamed
    ship-everything path and the single store."""
    c, truth, _ = cluster
    q = 'sum by (dc)(int_gauge)'
    monkeypatch.setattr(settings().query, "stream_frame_bytes", 0)
    plain = _range(c.engine, q, aggregation_pushdown=False,
                   ship_raw_series=True)
    monkeypatch.setattr(settings().query, "stream_frame_bytes", 4096)
    folded = _range(c.engine, q, aggregation_pushdown=False,
                    ship_raw_series=True)
    assert plain.error is None and folded.error is None
    assert folded.stats.streamed_frames > 8
    assert _as_map(folded) == _as_map(plain) == _as_map(_range(truth, q))


def test_fold_cardinality_limit_across_slices(cluster, monkeypatch):
    """Each slice stays under the group-by limit but the merged partial
    exceeds it: the streamed fold raises the real error."""
    c, _, _ = cluster
    monkeypatch.setattr(settings().query, "stream_frame_bytes", 4096)
    res = c.engine.query_range(
        'sum by (instance)(heap_usage)', S + 600, 60, S + 3600,
        PlannerParams(aggregation_pushdown=False, ship_raw_series=True,
                      group_by_cardinality_limit=20))
    assert res.error is not None and "cardinality limit" in res.error
    assert "remote_failure" not in res.error


def _sabotaged(monkeypatch, c, qid, action):
    monkeypatch.setattr(settings().query, "stream_frame_bytes", 2048)
    real_pack = tr._pack_stream_frame
    state = {"n": 0}

    def pack(seq, body, last):
        state["n"] += 1
        return action(state["n"], real_pack, seq, body, last)

    monkeypatch.setattr(tr, "_pack_stream_frame", pack)
    rd = tr.RemoteNodeDispatcher(*c.servers[c.owner[0]].address,
                                 timeout_s=5.0)
    plan = _leaf(QueryContext(query_id=qid), 0, with_agg=False)
    plan.dispatcher = rd
    with pytest.raises(QueryError) as ei:
        rd.dispatch(plan, None)
    return ei.value


def test_torn_stream_is_typed_remote_failure(cluster, monkeypatch):
    def tear(n, pack, seq, body, last):
        if n == 3:
            raise ConnectionResetError("server died mid-stream")
        return pack(seq, body, last)
    err = _sabotaged(monkeypatch, cluster[0], "torn1", tear)
    assert err.code == "remote_failure"
    assert "torn" in str(err) or "corrupt" in str(err)


def test_corrupt_stream_frame_crc_rejected(cluster, monkeypatch):
    def flip(n, pack, seq, body, last):
        raw = pack(seq, body, last)
        return raw[:-1] + bytes([raw[-1] ^ 0xFF]) if n == 2 else raw
    err = _sabotaged(monkeypatch, cluster[0], "crc1", flip)
    assert err.code == "remote_failure" and "CRC" in str(err)


def test_kill_mid_stream_is_structured_cancel(cluster, monkeypatch):
    """A kill landing between stream frames stops the stream with the
    typed query_canceled: the server checks the token per frame."""
    def kill(n, pack, seq, body, last):
        if n == 3:
            active_queries.kill("killmid1", reason="admin",
                                detail="test kill mid-stream")
        return pack(seq, body, last)
    err = _sabotaged(monkeypatch, cluster[0], "killmid1", kill)
    assert err.code == "query_canceled"


def test_remote_failure_keeps_its_typed_code(cluster):
    """A QueryError raised on the node crosses the wire with its code."""
    c, _, _ = cluster
    rd = tr.RemoteNodeDispatcher(*c.servers[c.owner[0]].address,
                                 timeout_s=5.0)
    plan = _leaf(QueryContext(query_id="dl1",
                              deadline_unix_s=time.time() + 0.2), 0)
    plan.dispatcher = rd
    time.sleep(0.3)
    with pytest.raises(QueryError) as ei:
        rd.dispatch(plan, None)
    assert ei.value.code == "query_timeout"


# ------------------------------------------------- a node's death


@pytest.fixture
def small_cluster():
    c = make_two_node_cluster([gauge_batch(32, 120, start_ms=START)],
                              with_truth=True, device="cpu")
    yield c
    c.stop()


def test_dead_node_typed_error_then_flagged_partial(small_cluster):
    """Without partial results a dead owner fails the query with the
    typed shard_unavailable; with them the survivors' groups come back
    flagged partial, equal to a query of their shards alone."""
    c = small_cluster
    q = 'sum by (_ns_, instance)(heap_usage)'
    full = _range(c.engine, q)
    assert full.error is None and not full.partial
    c.servers["nodeB"].stop()
    res = _range(c.engine, q)
    assert res.error is not None and res.error.startswith("shard_unavailable")
    part = _range(c.engine, q, allow_partial_results=True)
    assert part.error is None and part.partial is True
    assert part.stats.warnings
    payload = QueryEngine.to_prom_matrix(part)
    assert payload["partial"] is True and payload["warnings"]
    # each group is one series: the survivors' groups are the full
    # answer's, bit for bit
    got = _as_map(part)
    full_map = _as_map(full)
    assert 0 < len(got) < len(full_map)
    for k, v in got.items():
        assert full_map[k] == v


def test_breaker_fails_fast_after_repeated_failures():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = s.getsockname()
    s.close()
    breakers.reset()
    rd = tr.RemoteNodeDispatcher(*dead, timeout_s=0.5)
    plan = _leaf(QueryContext(query_id="br1"), 0)
    codes = []
    for _ in range(8):
        try:
            rd.dispatch(plan, None)
        except QueryError as e:
            codes.append((e.code, "circuit open" in str(e)))
    assert all(code == "shard_unavailable" for code, _ in codes)
    assert codes[-1][1], "the breaker never opened"
    breakers.reset()


def test_wedged_peer_deadline_share_is_droppable_dispatch_timeout():
    """A peer that accepts and never answers may spend only its deadline
    share under partial results: a dispatch_timeout well inside the
    query's budget."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)
    conns = []
    stop = threading.Event()

    def accept():
        srv.settimeout(0.2)
        while not stop.is_set():
            try:
                conns.append(srv.accept()[0])
            except OSError:
                pass
    t = threading.Thread(target=accept, daemon=True)
    t.start()
    try:
        rd = tr.RemoteNodeDispatcher(*srv.getsockname(), timeout_s=30.0)
        ctx = QueryContext(query_id="wedge1",
                           deadline_unix_s=time.time() + 2.0,
                           planner_params=PlannerParams(
                               allow_partial_results=True))
        plan = _leaf(ctx, 0)
        t0 = time.time()
        with pytest.raises(QueryError) as ei:
            rd.dispatch(plan, None)
        assert ei.value.code == "dispatch_timeout"
        assert time.time() - t0 < 1.8
    finally:
        stop.set()
        t.join(timeout=2)
        for cn in conns:
            cn.close()
        srv.close()
