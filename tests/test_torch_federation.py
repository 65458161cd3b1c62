"""The port's cross-cluster federation (filodb_tpu_torch/federation)
against the JAX package's: every case of tests/test_federation.py on a
port federated pair (ownership routing, exactly-mergeable cluster
partials, bit-identity vs a single-cluster ground truth, degradation
naming the dead cluster, one trace / one kill across the boundary,
result-cache safety), each server on `device="cpu"`.

Beside them: the port pair answers as the reference pair on the same
integer data; FederatedLeafExec frames are the reference's byte for
byte; a mixed pair (a port east federating a JAX west, and the reverse)
answers as the reference pair does.
"""
import threading
import time

import numpy as np
import pytest

from filodb_tpu_torch.config import ConfigError, FilodbSettings
from filodb_tpu_torch.federation.registry import ClusterDef, FederationRegistry
from filodb_tpu_torch.core.index import Equals
from filodb_tpu_torch.parallel.breaker import breakers
from filodb_tpu_torch.parallel.testcluster import make_federated_pair
from filodb_tpu_torch.query.planutils import TimeRange
from filodb_tpu_torch.query.rangevector import PlannerParams, QueryContext
from filodb_tpu_torch.utils.metrics import collector

S = 1_600_000_020            # first sample (seconds); data spans 1200 s


def _series_dict(res):
    assert res.error is None, res.error
    return {str(k): np.asarray(v) for k, _, v in res.series()}


def _assert_identical(got_res, want_res):
    got, want = _series_dict(got_res), _series_dict(want_res)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k], equal_nan=True), k


# ------------------------------------------------- registry unit tests


def test_cluster_def_label_ownership_is_conservative():
    cd = ClusterDef("west", host="h", port=1, match={"region": "west"})
    # provably excluded: every group's equality rejects the matcher
    assert not cd.may_own([[Equals("region", "east")]])
    assert cd.may_own([[Equals("region", "west")]])
    # unconstrained label / no region filter at all: stays in
    assert cd.may_own([[Equals("job", "api")]])
    # one group of several matching keeps the cluster in
    assert cd.may_own([[Equals("region", "east")],
                       [Equals("region", "west")]])
    # an entry with no matchers and no window owns nothing (inert)
    assert not ClusterDef("x", host="h", port=1).may_own(
        [[Equals("region", "west")]])


def test_cluster_def_time_overlap():
    cd = ClusterDef("cold", host="h", port=1,
                    time_start_ms=1000, time_end_ms=2000)
    assert cd.windowed
    eff = cd.time_overlap(TimeRange(0, 5000))
    assert (eff.start_ms, eff.end_ms) == (1000, 2000)
    assert cd.time_overlap(TimeRange(3000, 5000)) is None


def test_registry_rejects_unknown_keys_and_missing_endpoint():
    cfg = FilodbSettings().federation
    cfg.clusters = {"w": {"host": "h", "port": 1, "matchers": {}}}
    with pytest.raises(ConfigError, match="unknown keys"):
        FederationRegistry(cfg)
    cfg.clusters = {"w": {"match": {"region": "w"}}}    # no host/port
    with pytest.raises(ConfigError, match="host and port"):
        FederationRegistry(cfg)


def test_registry_owners_for_local_exclusion():
    cfg = FilodbSettings().federation
    cfg.clusters = {
        "west": {"host": "h", "port": 1, "match": {"region": "west"}},
        "east": {"local": True, "match": {"region": "east"}},
    }
    reg = FederationRegistry(cfg, local_name="east")
    tr = TimeRange(0, 1000)
    local, remotes = reg.owners_for([[Equals("region", "west")]], tr)
    assert not local and [cd.name for cd, _ in remotes] == ["west"]
    local, remotes = reg.owners_for([[Equals("region", "east")]], tr)
    assert local and remotes == []
    local, remotes = reg.owners_for([[Equals("job", "api")]], tr)
    assert local and [cd.name for cd, _ in remotes] == ["west"]


def test_overlapping_time_windows_raise():
    from filodb_tpu_torch.federation.planner import FederationPlanner
    from filodb_tpu_torch.promql.parser import (TimeStepParams,
                                                query_range_to_logical_plan)
    cfg = FilodbSettings().federation
    cfg.clusters = {
        "a": {"host": "h", "port": 1, "time_end_ms": 2_000_000_000_000},
        "b": {"host": "h", "port": 2,
              "time_start_ms": 1_500_000_000_000},
    }
    planner = FederationPlanner(None, FederationRegistry(cfg))
    plan = query_range_to_logical_plan(
        "sum(foo)", TimeStepParams(S + 60, 60, S + 600))
    with pytest.raises(ValueError, match="overlap"):
        planner.materialize(plan, QueryContext())


def test_federated_leaf_serialization_roundtrip():
    from filodb_tpu_torch.federation.exec import FederatedLeafExec
    from filodb_tpu_torch.parallel import serialize
    from filodb_tpu_torch.promql.parser import (TimeStepParams,
                                                query_range_to_logical_plan)
    from filodb_tpu_torch.query import planutils as pu
    plan = query_range_to_logical_plan(
        "sum by (_ns_) (fed_gauge)", TimeStepParams(S + 60, 60, S + 600))
    leaf = FederatedLeafExec(
        QueryContext(), dataset="prometheus", plan=plan, mode="partial",
        cluster="west", promql="sum by (_ns_) (fed_gauge)",
        traceparent="00-" + "ab" * 16 + "-" + "cd" * 8 + "-01")
    back = serialize.loads(serialize.dumps(leaf))
    assert (back.dataset, back.mode, back.cluster) == \
        ("prometheus", "partial", "west")
    assert back.traceparent == leaf.traceparent
    # the logical subtree survived byte-for-byte (grid included)
    assert pu.unparse(back.plan) == pu.unparse(plan)
    assert back.plan.start_ms == plan.start_ms
    assert back.plan.step_ms == plan.step_ms


# ------------------------------------- bit-identity vs the truth engine


@pytest.fixture(scope="module")
def pair():
    p = make_federated_pair(start=False, device="cpu")
    yield p
    p.stop()
    breakers.reset()


def test_pushed_aggregate_bit_identical(pair):
    q, args = "sum by (_ns_) (fed_gauge)", (S + 60, 60, S + 600)
    res = pair.engine.query_range(q, *args)
    _assert_identical(res, pair.truth.query_range(q, *args))
    # the west hop crossed as ONE [G, W] cluster partial
    assert res.stats.pushdown_pushed >= 1
    assert res.stats.wire_bytes > 0


def test_avg_pushes_exact_partials(pair):
    q, args = "avg by (_ns_) (fed_gauge)", (S + 60, 60, S + 600)
    res = pair.engine.query_range(q, *args)
    _assert_identical(res, pair.truth.query_range(q, *args))
    assert res.stats.pushdown_pushed >= 1


def test_routed_selector_whole_expression(pair):
    """{region="west"} provably excludes east: the whole expression
    routes to west and east's local stack never runs."""
    q = 'fed_gauge{region="west"}'
    args = (S + 60, 60, S + 600)
    res = pair.engine.query_range(q, *args)
    _assert_identical(res, pair.truth.query_range(q, *args))
    assert res.stats.pushdown_fallback >= 1        # series-mode hop
    assert len(_series_dict(res)) == 8             # all of west's series


def test_non_mergeable_shape_ships_series(pair):
    """A per-series expression has no mergeable partial: each cluster
    evaluates its own series and the union is exact."""
    q = "avg_over_time(fed_gauge[2m])"
    args = (S + 180, 60, S + 600)
    res = pair.engine.query_range(q, *args)
    _assert_identical(res, pair.truth.query_range(q, *args))
    assert res.stats.pushdown_fallback >= 1
    assert res.stats.pushdown_pushed == 0


def test_cross_cluster_join_bit_identical(pair):
    q = ('sum by (_ns_) (fed_gauge{region="west"}) '
         '+ sum by (_ns_) (fed_gauge{region="east"})')
    args = (S + 60, 60, S + 600)
    res = pair.engine.query_range(q, *args)
    _assert_identical(res, pair.truth.query_range(q, *args))
    assert res.stats.pushdown_pushed >= 1


def test_unsupported_shape_is_a_typed_error(pair):
    """A non-per-series, non-top-level-aggregate expression spanning
    clusters is a planning error naming the workaround, never silently
    wrong data."""
    res = pair.engine.query_range(
        "topk(2, sum by (_ns_) (fed_gauge)) / 2", S + 60, 60, S + 600)
    assert res.error is not None
    assert "federate" in res.error


def test_at_pinned_expressions_refuse_federation(pair):
    res = pair.engine.query_range(
        f"fed_gauge @ {S + 300}", S + 60, 60, S + 600)
    assert res.error is not None and "@-pinned" in res.error


# ---------------------------------------- one trace, one killable query


def test_one_trace_stitches_across_clusters(pair):
    res = pair.engine.query_range("sum by (_ns_) (fed_gauge)",
                                  S + 60, 60, S + 600)
    assert res.error is None and res.trace_id
    evs = collector.trace(res.trace_id)
    remotes = [e for e in evs if e["span"].startswith("remote_exec")]
    # west's spans came back over the wire under the SAME trace id
    assert remotes, [e["span"] for e in evs]


def test_one_query_id_spans_both_clusters(pair):
    """The federated child registers on west under the COORDINATOR's
    query id: /admin/queries shows one id, and one kill reaches the
    remote scan."""
    from filodb_tpu_torch.query.activequeries import active_queries
    qids = []
    orig = active_queries.register
    lock = threading.Lock()

    def spy(qid, **kw):
        if kw.get("role") == "remote":
            with lock:
                qids.append(qid)
        return orig(qid, **kw)

    active_queries.register = spy
    try:
        res = pair.engine.query_range("sum by (_ns_) (fed_gauge)",
                                      S + 60, 60, S + 600)
    finally:
        active_queries.register = orig
    assert res.error is None
    assert qids and all(q == qids[0] for q in qids)


def test_kill_frame_crosses_the_door(pair):
    from filodb_tpu_torch.parallel.transport import send_kill
    from filodb_tpu_torch.query.activequeries import active_queries
    ent = active_queries.register("fed-kill-1", promql="[remote] leaf",
                                  origin="remote", role="remote")
    try:
        out = send_kill("127.0.0.1", pair.west.federation_door.port,
                        "fed-kill-1")
        assert out["killed"] is True and ent.token.cancelled
    finally:
        active_queries.deregister(ent, "killed")


def test_kill_mid_stream_ends_killed_on_both_sides(pair):
    """A series-mode query killed while west streams its reply: the
    coordinator answers query_canceled, and both registry entries under
    the query id (east's frontend, west's door) end with verdict
    `killed`."""
    from filodb_tpu_torch.config import settings
    from filodb_tpu_torch.parallel import transport as tr
    from filodb_tpu_torch.query.activequeries import active_queries
    flowing, release = threading.Event(), threading.Event()
    real_pack = tr._pack_stream_frame

    def pack(seq, body, last):
        if seq >= 2:
            flowing.set()
            release.wait(30)
        return real_pack(seq, body, last)
    q = settings().query
    frame_bytes = q.stream_frame_bytes
    q.stream_frame_bytes = 256
    tr._pack_stream_frame = pack
    box = {}
    try:
        th = threading.Thread(target=lambda: box.update(
            res=pair.frontend.query_range(
                "fed_gauge", S + 60, 60, S + 600,
                planner_params=PlannerParams(aggregation_pushdown=False))),
            daemon=True)
        th.start()
        assert flowing.wait(30)
        remote = [e for e in active_queries.entries() if e.role == "remote"]
        qid = remote[0].query_id
        ents = active_queries.get(qid)
        assert sorted(e.role for e in ents) == ["frontend", "remote"]
        assert active_queries.kill(qid, reason="admin")["killed"]
        release.set()
        th.join(30)
        deadline = time.monotonic() + 10
        while active_queries.get(qid) and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        release.set()
        tr._pack_stream_frame = real_pack
        q.stream_frame_bytes = frame_bytes
    assert box["res"].error.startswith("query_canceled")
    assert [(e.role, e.verdict) for e in sorted(ents, key=lambda e: e.role)
            ] == [("frontend", "killed"), ("remote", "killed")]


# ----------------------------------------------- admin + health surface


def test_admin_federation_route(pair):
    pair.east.federation_registry.probe_once()
    st, payload = pair.east.api.handle("GET", "/admin/federation", {}, b"")
    assert st == 200
    rows = payload["data"]["clusters"]
    assert payload["data"]["cluster"] == "east"
    assert [r["cluster"] for r in rows] == ["west"]
    assert rows[0]["healthy"] and rows[0]["probed"]
    assert rows[0]["remoteCluster"] == "west"
    # after dispatches the breaker table carries the cluster row
    pair.engine.query_range("sum by (_ns_) (fed_gauge)",
                            S + 60, 60, S + 600)
    st, payload = pair.east.api.handle("GET", "/admin/breakers", {}, b"")
    assert st == 200
    assert any(r["peer"] == "cluster:west"
               for r in payload["data"]["breakers"])


def test_health_probe_degrades_on_dead_cluster(pair):
    reg = pair.east.federation_registry
    reg.probe_once()
    assert reg.health_probe()["status"] == "ok"
    pair.kill_west()
    try:
        reg.probe_once()
        verdict = reg.health_probe()
        assert verdict["status"] == "degraded"
        assert "west" in verdict["reason"]
    finally:
        pair.revive_west()
        reg.probe_once()
        breakers.reset()
    assert reg.health_probe()["status"] == "ok"


# -------------------------- degradation: flagged partial, breaker, recovery


def test_dead_cluster_degrades_breaker_opens_then_recovers():
    breakers.configure(failure_threshold=3, open_base_s=0.2,
                       open_max_s=0.5, jitter=0.0)
    breakers.reset()
    p = make_federated_pair(start=False, device="cpu")
    try:
        q, args = "sum by (_ns_) (fed_gauge)", (S + 60, 60, S + 600)
        pp = PlannerParams(allow_partial_results=True, timeout_s=10.0)
        truth = p.truth.query_range(q, *args)
        full = p.engine.query_range(q, *args, planner_params=pp)
        _assert_identical(full, truth)
        assert not full.partial
        p.kill_west()
        # never a hang, never silent short data: a flagged partial that
        # NAMES the dead cluster
        res = p.engine.query_range(q, *args, planner_params=pp)
        assert res.error is None and res.partial
        assert any("cluster:west" in w for w in res.stats.warnings), \
            res.stats.warnings
        # consecutive failures open the cluster breaker -> fail fast
        for _ in range(3):
            p.engine.query_range(q, *args, planner_params=pp)
        snap = {b["peer"]: b for b in breakers.snapshot()}
        assert snap["cluster:west"]["state"] == "open"
        t0 = time.monotonic()
        res = p.engine.query_range(q, *args, planner_params=pp)
        fast_s = time.monotonic() - t0
        assert res.partial and fast_s < 1.0, fast_s
        assert any("circuit open" in w for w in res.stats.warnings), \
            res.stats.warnings
        # half-open probe recovery: the door answers again -> full results
        p.revive_west()
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            res = p.engine.query_range(q, *args, planner_params=pp)
            if res.error is None and not res.partial:
                break
            time.sleep(0.2)
        assert res.error is None and not res.partial, \
            (res.error, res.stats.warnings)
        _assert_identical(res, truth)
    finally:
        p.stop()
        breakers.configure()
        breakers.reset()


# ----------------------------------------------------- result-cache safety


def test_federated_cache_hits_tokens_and_degraded_answers():
    """Federated answers cache on the cluster set + per-cluster data
    tokens: a remote's token change invalidates, and a degraded partial
    is NEVER served from cache."""
    breakers.configure(failure_threshold=3, open_base_s=0.2,
                       open_max_s=0.5, jitter=0.0)
    breakers.reset()
    p = make_federated_pair(start=False, device="cpu")
    try:
        fe = p.frontend
        reg = p.east.federation_registry
        reg.probe_once()                 # tokens populated before caching
        q, args = "sum by (_ns_) (fed_gauge)", (S + 60, 60, S + 600)
        pp = PlannerParams(allow_partial_results=True, timeout_s=10.0)
        r1 = fe.query_range(q, *args, planner_params=pp)
        assert r1.error is None and not r1.partial
        r2 = fe.query_range(q, *args, planner_params=pp)
        assert r2.stats.result_cache == "hit"
        _assert_identical(r2, r1)
        # a probe transition (west dies) changes the federation token:
        # the cached full answer can no longer be served
        p.kill_west()
        reg.probe_once()
        r3 = fe.query_range(q, *args, planner_params=pp)
        assert r3.partial and r3.stats.result_cache != "hit"
        # and the partial itself is never stored: the re-poll recomputes
        r4 = fe.query_range(q, *args, planner_params=pp)
        assert r4.stats.result_cache != "hit"
        assert r4.partial
        # recovery: full answers cache again under the new token
        p.revive_west()
        reg.probe_once()
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            r5 = fe.query_range(q, *args, planner_params=pp)
            if r5.error is None and not r5.partial:
                break
            time.sleep(0.2)
        assert not r5.partial, (r5.error, r5.stats.warnings)
        r6 = fe.query_range(q, *args, planner_params=pp)
        assert r6.stats.result_cache == "hit"
        _assert_identical(r6, r1)
    finally:
        p.stop()
        breakers.configure()
        breakers.reset()


def test_remote_ingest_invalidates_federated_cache():
    """West gaining NEW series changes its door's data token (rides the
    FPING reply): east's cached federated entries drop, exactly like
    local series-set changes invalidate.  (Appends strictly after the
    cached window stay a legitimate hit — the append-horizon contract —
    so the invalidation trigger here is a series-set change.)"""
    from filodb_tpu_torch.ingest.generator import region_gauge_batch
    from filodb_tpu_torch.gateway.router import split_batch_by_shard
    p = make_federated_pair(start=False, device="cpu")
    try:
        fe = p.frontend
        reg = p.east.federation_registry
        reg.probe_once()
        q, args = ('sum by (_ns_) (fed_gauge{region="west"})',
                   (S + 60, 60, S + 600))
        fe.query_range(q, *args)
        assert fe.query_range(q, *args).stats.result_cache == "hit"
        # new SERIES land on WEST only (12 > the 8 existing instances)
        batch = region_gauge_batch(12, 10, region="west", seed=9,
                                   start_ms=(S + 2000) * 1000)
        for s, sub in split_batch_by_shard(
                batch, p.west.mappers[p.dataset],
                p.west.spreads[p.dataset]).items():
            p.west.memstore.get_shard(p.dataset, s).ingest(sub)
        reg.probe_once()                 # token refresh
        assert fe.query_range(q, *args).stats.result_cache != "hit"
    finally:
        p.stop()
        breakers.reset()


# ------------------------------------------------- against the reference


@pytest.fixture(autouse=True, scope="module")
def _clear_compile_journal():
    """The JAX engine journals jit compiles under its queries' trace ids,
    which the reference's health model reads as a compile storm for the
    next 120 s: clear it after this file."""
    yield
    from filodb_tpu.utils.events import journal as jjournal
    jjournal.clear()


# (query, range, exact): the port sums a window's samples in f32, so an
# over-time average of integers agrees with the reference's f64 to f32's
# rounding; every other answer here is exact on integer data
PAIR_QUERIES = [
    ("sum by (_ns_) (fed_gauge)", (S + 60, 60, S + 600), True),
    ("avg by (_ns_) (fed_gauge)", (S + 60, 60, S + 600), True),
    ("count by (_ns_) (fed_gauge)", (S + 60, 60, S + 600), True),
    ("max by (_ns_) (fed_gauge)", (S + 60, 60, S + 600), True),
    ('fed_gauge{region="west"}', (S + 60, 60, S + 600), True),
    ("avg_over_time(fed_gauge[2m])", (S + 180, 60, S + 600), False),
    ('sum by (_ns_) (fed_gauge{region="west"}) '
     '+ sum by (_ns_) (fed_gauge{region="east"})', (S + 60, 60, S + 600),
     True),
]


def _assert_matches(got_res, want_res, exact):
    if exact:
        _assert_identical(got_res, want_res)
        return
    got, want = _series_dict(got_res), _series_dict(want_res)
    assert set(got) == set(want) and got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def ref_pair():
    from filodb_tpu.parallel.breaker import breakers as jbreakers
    from filodb_tpu.parallel.testcluster import make_federated_pair as jmake
    p = jmake(start=False)
    yield p
    p.stop()
    jbreakers.reset()


@pytest.mark.parametrize("q, args, exact", PAIR_QUERIES)
def test_pair_answers_equal_reference_pair(pair, ref_pair, q, args, exact):
    got = pair.engine.query_range(q, *args)
    want = ref_pair.engine.query_range(q, *args)
    _assert_matches(got, want, exact)
    assert (got.stats.pushdown_pushed, got.stats.pushdown_fallback) == \
        (want.stats.pushdown_pushed, want.stats.pushdown_fallback)


def test_federated_leaf_frames_equal_reference():
    """The same federated leaf, built in each package from the same
    logical plan, encodes to the same frame, and each package decodes
    the other's."""
    from filodb_tpu.federation.exec import FederatedLeafExec as JLeaf
    from filodb_tpu.parallel import serialize as jser
    from filodb_tpu.promql.parser import (
        TimeStepParams as JTsp, query_range_to_logical_plan as jparse)
    from filodb_tpu.query.rangevector import QueryContext as JCtx
    from filodb_tpu_torch.federation.exec import FederatedLeafExec
    from filodb_tpu_torch.parallel import serialize
    from filodb_tpu_torch.promql.parser import (TimeStepParams,
                                                query_range_to_logical_plan)
    tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    for promql, mode in (("sum by (_ns_) (fed_gauge)", "partial"),
                         ('rate(fed_gauge{region="west"}[2m]) > 3',
                          "series")):
        leaf = FederatedLeafExec(
            QueryContext(query_id="q-1"), dataset="prometheus",
            plan=query_range_to_logical_plan(
                promql, TimeStepParams(S + 60, 60, S + 600)),
            mode=mode, cluster="west", promql=promql, traceparent=tp)
        jleaf = JLeaf(
            JCtx(query_id="q-1"), dataset="prometheus",
            plan=jparse(promql, JTsp(S + 60, 60, S + 600)),
            mode=mode, cluster="west", promql=promql, traceparent=tp)
        frame = serialize.dumps(leaf)
        assert frame == jser.dumps(jleaf)
        back = jser.loads(frame)
        assert type(back).__name__ == "FederatedLeafExec"
        assert (back.mode, back.cluster, back.traceparent) == \
            (mode, "west", tp)
        assert serialize.dumps(serialize.loads(jser.dumps(jleaf))) == frame


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _cluster_server(pkg, me, peer, ports, seed):
    """One package's FiloServer for cluster `me`, federated with `peer`
    (make_federated_pair's configuration), holding its region's gauges."""
    if pkg == "jax":
        from filodb_tpu.config import FilodbSettings as Cfg
        from filodb_tpu.gateway.router import split_batch_by_shard as split
        from filodb_tpu.ingest.generator import region_gauge_batch as gen
        from filodb_tpu.standalone import DatasetConfig, FiloServer
        kw = {}
    else:
        from filodb_tpu_torch.config import FilodbSettings as Cfg
        from filodb_tpu_torch.gateway.router import \
            split_batch_by_shard as split
        from filodb_tpu_torch.ingest.generator import \
            region_gauge_batch as gen
        from filodb_tpu_torch.standalone import DatasetConfig, FiloServer
        kw = {"device": "cpu"}
    c = Cfg()
    f = c.federation
    f.enabled = True
    f.cluster_name = me
    f.door_port = ports[me]
    f.probe_timeout_s = 1.0
    f.clusters = {
        peer: {"host": "127.0.0.1", "port": ports[peer],
               "match": {"region": peer}},
        me: {"local": True, "match": {"region": me}},
    }
    srv = FiloServer([DatasetConfig("prometheus", num_shards=2)],
                     config=c, http_port=0, node_name=me, **kw)
    batch = gen(8, 120, region=me, start_ms=S * 1000, step_ms=10_000,
                metric="fed_gauge", seed=seed)
    for s, sub in split(batch, srv.mappers["prometheus"],
                        srv.spreads["prometheus"]).items():
        srv.memstore.get_shard("prometheus", s).ingest(sub)
    return srv


@pytest.mark.parametrize("east_pkg, west_pkg",
                         [("port", "jax"), ("jax", "port")])
def test_mixed_pair_answers_as_reference_pair(ref_pair, east_pkg,
                                              west_pkg):
    """A port east federating a JAX west, and the reverse: pushed
    partials and shipped series cross between the packages and answer
    as the reference pair does, bit for bit on integer data."""
    ports = {"east": _free_port(), "west": _free_port()}
    east = _cluster_server(east_pkg, "east", "west", ports, seed=1)
    west = _cluster_server(west_pkg, "west", "east", ports, seed=2)
    try:
        for q, args, exact in PAIR_QUERIES:
            got = east.engines["prometheus"].query_range(q, *args)
            want = ref_pair.engine.query_range(q, *args)
            _assert_matches(got, want, exact)
            if q.startswith("sum by (_ns_) (fed_gauge)"):
                assert got.stats.pushdown_pushed >= 1
    finally:
        for srv in (east, west):
            try:
                srv.shutdown()
            except OSError:
                pass


def test_admin_federation_payload_equals_reference():
    """GET /admin/federation of a fresh pair after one probe: the
    reference's payload, but for the endpoints' ephemeral ports and the
    probe's wall clock."""
    from filodb_tpu.parallel.testcluster import make_federated_pair as jmake
    payloads = []
    for make, kw in ((make_federated_pair, {"device": "cpu"}),
                     (jmake, {})):
        p = make(start=False, **kw)
        try:
            p.east.federation_registry.probe_once()
            st, payload = p.east.api.handle("GET", "/admin/federation", {},
                                            b"")
        finally:
            p.stop()
        assert st == 200
        for row in payload["data"]["clusters"]:
            assert row.pop("endpoint").startswith("127.0.0.1:")
            assert row.pop("lastProbeUnix") > 0
        payloads.append(payload)
    assert payloads[0] == payloads[1]
    assert payloads[0]["data"]["clusters"][0]["remoteCluster"] == "west"
