"""The composed planners of the port (filodb_tpu_torch.query.planners) and
the plan-layer pieces under them (planutils, StitchRvsExec,
MultiPartitionReduceAggregateExec, PromQlRemoteExec, EmptyResultExec,
the in-process dispatcher), held against the JAX package.

Every case of tests/test_planners.py runs through both packages on the
same PromQL and the same providers: the plan trees must print the same
(`print_tree`), the sub-plans each planner hands on must cover the same
time ranges, and the PromQL a remote child sends must be the same
string.  The downsample planner is a recording stub, as the reference's
test_ltr_all_downsample uses one.  StitchRvsExec and
MultiPartitionReduceAggregateExec compose the same blocks to the bit.

Then the composed engines over one small port store: HA (a local
failure window routed to a "remote" that is the same store answering
Prometheus JSON through the transport), multi-partition by time,
shard-key regex fan-out and single-partition selection each answer
bit-identically to the local-only query.
"""
import json
import types

import numpy as np
import pytest

import filodb_tpu.core.index as jindex
import filodb_tpu.promql.parser as jparser
import filodb_tpu.query.exec as jexec
import filodb_tpu.query.logical as jlp
import filodb_tpu.query.planner as jplanner
import filodb_tpu.query.planners as jplanners
import filodb_tpu.query.planutils as jpu
import filodb_tpu.query.rangevector as jrv
import filodb_tpu_torch.core.index as pindex
import filodb_tpu_torch.promql.parser as pparser
import filodb_tpu_torch.query.exec as pexec
import filodb_tpu_torch.query.logical as plp
import filodb_tpu_torch.query.planner as pplanner
import filodb_tpu_torch.query.planners as pplanners
import filodb_tpu_torch.query.planutils as ppu
import filodb_tpu_torch.query.rangevector as prv
from filodb_tpu.ingest.generator import counter_batch
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.parallel.shardmapper import ShardEvent, ShardMapper
from filodb_tpu_torch.query.engine import QueryEngine

from test_torch_ingest import to_port

START_S = 1_600_000_000


def _pkg(port):
    ns = types.SimpleNamespace(
        port=port,
        idx=pindex if port else jindex,
        parser=pparser if port else jparser,
        exec=pexec if port else jexec,
        lp=plp if port else jlp,
        planner=pplanner if port else jplanner,
        pl=pplanners if port else jplanners,
        pu=ppu if port else jpu,
        rv=prv if port else jrv)

    class Dummy(ns.exec.ExecPlan):
        def __init__(self, tag, plan=None):
            super().__init__(ns.rv.QueryContext())
            self.tag, self.plan = tag, plan

        def args_str(self):
            return self.tag

        def _do_execute(self, source):
            return None, ns.rv.QueryStats()

    class Recording(ns.planner.QueryPlanner):
        def __init__(self, tag):
            self.tag = tag
            self.materialized = []

        def materialize(self, plan, ctx):
            self.materialized.append(plan)
            return Dummy(self.tag, plan)

    class FP(ns.pl.FailureProvider):
        def __init__(self, failures):
            self.failures = failures

        def get_failures(self, dataset, tr):
            return [f for f in self.failures
                    if f.time_range.end_ms >= tr.start_ms
                    and f.time_range.start_ms <= tr.end_ms]

    class Provider(ns.pl.PartitionLocationProvider):
        def __init__(self, assignments):
            self.assignments = assignments

        def get_partitions(self, filters, tr):
            return self.assignments

    ns.Dummy, ns.Recording, ns.FP, ns.Provider = Dummy, Recording, FP, \
        Provider
    ns.ctx = ns.rv.QueryContext

    def plan(q, start_s=START_S, step_s=60, end_s=START_S + 3600):
        return ns.parser.query_range_to_logical_plan(
            q, ns.parser.TimeStepParams(start_s, step_s, end_s))
    ns.plan = plan
    return ns


PORT, JAX = _pkg(True), _pkg(False)


def _ranges(recorder):
    return [(p.start_ms, p.step_ms, p.end_ms) for p in recorder.materialized]


def _remotes(out, ns):
    kids = out.children if out.children else [out]
    return [(c.endpoint, c.promql, c.start_ms, c.step_ms, c.end_ms)
            for c in kids if isinstance(c, ns.pl.PromQlRemoteExec)]


# ------------------------------------------------------------- planutils

@pytest.mark.parametrize("q", [
    'sum(rate(http_requests_total{job="api"}[5m]))',
    'sum by (job,instance)(rate(foo{_ws_="demo",_ns_="app"}[1m]))',
    'histogram_quantile(0.9,sum by (le)(rate(req_bucket{job="a"}[1m])))',
    'foo{job="x"}',
    'foo{job!="x",mode=~"user|sys"}',
    '(foo{a="1"} + bar{b="2"})',
    '(foo{a="1"} * on (host) group_left () bar{b="2"})',
    '(foo{a="1"} > bool 10)',
    'topk(5,foo{job="j"})',
    'quantile(0.5,foo{job="j"})',
    'abs(foo{job="j"})',
    'clamp_max(foo{job="j"},100)',
    'label_replace(foo{job="j"},"dst","$1","src","(.*)")',
    'sort_desc(foo{job="j"})',
    'avg_over_time(foo{job="j"}[10m])',
    'min_over_time((rate(foo{job="j"}[5m]))[30m:1m])',
    'rate(foo::count{job="x"}[5m] offset 10m)',
    'max_over_time(foo[10m:1m] offset 5m @ 1600000000)',
])
def test_unparse_round_trip_as_the_reference(q):
    p1 = PORT.plan(q)
    s = PORT.pu.unparse(p1)
    assert s == JAX.pu.unparse(JAX.plan(q))
    assert PORT.plan(s) == p1, f"{q!r} -> {s!r} did not round-trip"


def test_time_range_utilities_as_the_reference():
    for ns in (PORT, JAX):
        p = ns.plan('sum(rate(foo{job="x"}[5m]))')
        tr = ns.pu.TimeRange(START_S * 1000 + 600_000,
                             START_S * 1000 + 1_200_000)
        p2 = ns.pu.copy_with_time_range(p, tr)
        assert (p2.start_ms, p2.end_ms) == (tr.start_ms, tr.end_ms)
        assert p2.vectors.series.range_selector.from_ms == \
            tr.start_ms - 300_000
        day = ns.plan('foo{job="x"}', START_S, 60, START_S + 86_400)
        parts = ns.pu.split_plans(day, 6 * 3600 * 1000)
        assert len(parts) == 4
        assert [(a.start_ms, a.end_ms) for a in parts] == \
            [(a.start_ms, a.end_ms) for a in
             jpu.split_plans(JAX.plan('foo{job="x"}', START_S, 60,
                                      START_S + 86_400), 6 * 3600 * 1000)]
        assert ns.pu.get_lookback_ms(ns.plan('sum(rate(foo[15m]))'),
                                     300_000) == 900_000


# ------------------------------------------------- routing, both packages

def _ltr_case(ns, case):
    start_ms = START_S * 1000
    raw, ds = ns.Recording("raw"), ns.Recording("downsample")
    earliest, latest = {
        "all_raw": (start_ms - 7 * 86_400_000, start_ms - 6 * 3600_000),
        "all_downsample": (start_ms + 2 * 3600_000 + 600_000,
                           start_ms + 40_000_000),
        "straddle": (start_ms + 20 * 60_000, start_ms + 86_400_000)}[case]
    out = ns.pl.LongTimeRangePlanner(
        raw, ds, lambda: earliest, lambda: latest).materialize(
        ns.plan('rate(foo[5m])'), ns.ctx())
    return out, (_ranges(raw), _ranges(ds))


def _ha_case(ns, case):
    start_ms = START_S * 1000
    local = ns.Recording("local")
    fails = {
        "none": [],
        "local": [ns.pl.FailureTimeRange(
            "local", ns.pu.TimeRange(start_ms + 1_200_000,
                                     start_ms + 1_500_000))],
        "remote_ignored": [ns.pl.FailureTimeRange(
            "remote", ns.pu.TimeRange(start_ms, start_ms + 600_000),
            is_remote=True)]}[case]
    out = ns.pl.HighAvailabilityPlanner(
        "ds", local, ns.FP(fails), "http://remote/api").materialize(
        ns.plan('sum(rate(foo{job="x"}[5m]))'), ns.ctx())
    return out, (_ranges(local), _remotes(out, ns))


def _mp_case(ns, case):
    start_ms = START_S * 1000
    mid = start_ms + 1800_000
    A, TR = ns.pl.PartitionAssignment, ns.pu.TimeRange
    assignments = {
        "all_local": [A("local", "", TR(0, (START_S + 3600) * 2000))],
        "split": [A("remote-p", "http://p2/api", TR(0, mid - 1)),
                  A("local", "", TR(mid, start_ms + 10**9))],
        "two_windows": [
            A("remote-p", "http://p2/api",
              TR(start_ms, start_ms + 1_200_000)),
            A("local", "", TR(start_ms + 1_260_000, start_ms + 2_400_000)),
            A("remote-p", "http://p2/api",
              TR(start_ms + 2_460_000, start_ms + 10**9))]}[case]
    local = ns.Recording("local")
    out = ns.pl.MultiPartitionPlanner(
        ns.Provider(assignments), "local", local).materialize(
        ns.plan('rate(foo{job="x"}[5m])'), ns.ctx())
    return out, (_ranges(local), _remotes(out, ns))


def _sp_case(ns, case):
    a, b = ns.Recording("a"), ns.Recording("b")
    sp = ns.pl.SinglePartitionPlanner(
        {"a": a, "b": b},
        planner_selector=lambda m: "b" if m.startswith("agg_") else "a")
    q = {"plain": 'rate(foo{job="x"}[5m])',
         "agg": 'rate(agg_foo{job="x"}[5m])'}[case]
    out = sp.materialize(ns.plan(q), ns.ctx())
    return out, (_ranges(a), _ranges(b))


def _skr_case(ns, case):
    inner = ns.Recording("in")
    E = ns.idx.Equals

    def matcher(fs):
        return [(E("_ws_", "demo"), E("_ns_", "app1")),
                (E("_ws_", "demo"), E("_ns_", "app2"))]
    q = {"fan_out": 'sum(rate(foo{_ws_="demo",_ns_=~"app.*"}[5m]))',
         "equals": 'sum(rate(foo{_ws_="demo",_ns_="app1"}[5m]))',
         "join": '(sum(rate(foo{_ws_="demo",_ns_=~"app.*"}[5m]))'
                 ' + sum(rate(bar{_ws_="demo",_ns_="other"}[5m])))',
         "topk": 'topk(2, rate(foo{_ws_="demo",_ns_=~"app.*"}[5m]))',
         "concat": 'rate(foo{_ws_="demo",_ns_=~"app.*"}[5m])'}[case]
    out = ns.pl.ShardKeyRegexPlanner(inner, matcher).materialize(
        ns.plan(q), ns.ctx())
    return out, [ns.pu.unparse(p) for p in inner.materialized]


def _pinned_case(ns, case):
    start_ms = START_S * 1000
    A, TR = ns.pl.PartitionAssignment, ns.pu.TimeRange
    local = ns.Recording("local")
    if case == "ha_pinned_failure":
        at_ms = 1_600_000_000_000
        fail = ns.pl.FailureTimeRange(
            "local", TR(at_ms - 600_000, at_ms + 600_000))
        planner = ns.pl.HighAvailabilityPlanner(
            "prometheus", local, ns.FP([fail]), "http://replica")
        outs = [planner.materialize(ns.plan(q, START_S + 7200, 60,
                                            START_S + 10800), ns.ctx())
                for q in ("foo @ 1600000000",
                          f"foo @ {at_ms // 1000 + 7200}")]
        return outs[0], ([_remotes(o, ns) for o in outs], _ranges(local))
    if case == "mp_pinned_single_remote":
        prov = ns.Provider([A("remote-p", "http://p2/api",
                              TR(0, start_ms + 10**9))])
        out = ns.pl.MultiPartitionPlanner(prov, "local", local).materialize(
            ns.plan(f'rate(foo[5m] @ {START_S + 600})'), ns.ctx())
        return out, _remotes(out, ns)
    calls = []

    class P(ns.planner.QueryPlanner):
        def __init__(self, name):
            self.name = name

        def materialize(self, plan, ctx):
            calls.append(self.name)
            return ns.Dummy(self.name, plan)
    earliest = 1_600_010_000_000
    ltr = ns.pl.LongTimeRangePlanner(P("raw"), P("ds"), lambda: earliest,
                                     lambda: earliest + 3_600_000)
    for q in ("foo @ 1600000000", f"foo @ {earliest // 1000 + 600}",
              "sum(foo @ 1600000000)"):
        out = ltr.materialize(ns.plan(q, 1_600_020_000, 60, 1_600_023_000),
                              ns.ctx())
    return out, calls


CASES = [(_ltr_case, c) for c in ("all_raw", "all_downsample", "straddle")] \
    + [(_ha_case, c) for c in ("none", "local", "remote_ignored")] \
    + [(_mp_case, c) for c in ("all_local", "split", "two_windows")] \
    + [(_sp_case, c) for c in ("plain", "agg")] \
    + [(_skr_case, c) for c in ("fan_out", "equals", "join", "topk",
                                "concat")] \
    + [(_pinned_case, c) for c in ("ha_pinned_failure",
                                   "mp_pinned_single_remote", "ltr_pinned")]


@pytest.mark.parametrize("fn,case", CASES,
                         ids=[f"{f.__name__[1:-5]}-{c}" for f, c in CASES])
def test_plans_route_and_print_as_the_reference(fn, case):
    got, got_rec = fn(PORT, case)
    want, want_rec = fn(JAX, case)
    assert got.print_tree() == want.print_tree()
    assert got_rec == want_rec
    assert type(got).__name__ == type(want).__name__


def test_routing_properties():
    """The reference's assertions on the routed plans, on the port."""
    out, ((raw,), (ds,)) = _ltr_case(PORT, "straddle")
    assert isinstance(out, pexec.StitchRvsExec)
    p = PORT.plan('rate(foo[5m])')
    assert raw[0] >= START_S * 1000 + 20 * 60_000 + 300_000
    assert (raw[0] - p.start_ms) % p.step_ms == 0 and raw[2] == p.end_ms
    assert ds[0] == p.start_ms and ds[2] == raw[0] - p.step_ms
    out, (_, remotes) = _ha_case(PORT, "local")
    assert isinstance(out, pexec.StitchRvsExec) and len(remotes) == 1
    endpoint, promql, r0, _, r1 = remotes[0]
    assert endpoint == "http://remote/api"
    assert "rate" in promql and 'job="x"' in promql
    assert r0 <= START_S * 1000 + 1_500_000 and r1 >= START_S * 1000 \
        + 1_200_000
    out, (local, remotes) = _mp_case(PORT, "two_windows")
    assert len(remotes) == 2 and remotes[1][4] == p.end_ms
    out, _ = _skr_case(PORT, "fan_out")
    assert isinstance(out, pplanners.MultiPartitionReduceAggregateExec)
    _, subs = _skr_case(PORT, "join")
    assert any('_ns_="other"' in s and "bar" in s for s in subs)
    assert _pinned_case(PORT, "ltr_pinned")[1] == ["ds", "raw", "ds"]


def test_plan_routes_as_the_reference():
    for ns in (PORT, JAX):
        assert ns.pl.plan_routes(0, 60, 600, [], 300) == [ns.pl.LocalRoute()]
    start, step, end = 1_000_000, 60_000, 4_000_000
    routes = pplanners.plan_routes(
        start, step, end, [ppu.TimeRange(2_000_000, 2_100_000)], 300_000)
    want = jplanners.plan_routes(
        start, step, end, [jpu.TimeRange(2_000_000, 2_100_000)], 300_000)
    assert [(type(r).__name__, r.time_range.start_ms, r.time_range.end_ms)
            for r in routes] == \
        [(type(r).__name__, r.time_range.start_ms, r.time_range.end_ms)
         for r in want]
    assert [type(r).__name__ for r in routes] == \
        ["LocalRoute", "RemoteRoute", "LocalRoute"]
    assert routes[0].time_range.end_ms < 2_000_000
    assert routes[2].time_range.start_ms - 300_000 >= 2_100_000


def test_pinned_read_spanning_partitions_errors_in_both():
    for ns in (PORT, JAX):
        start_ms = START_S * 1000
        mid = start_ms + 1800_000
        A, TR = ns.pl.PartitionAssignment, ns.pu.TimeRange
        prov = ns.Provider([A("remote-p", "http://p2/api", TR(0, mid - 1)),
                            A("local", "", TR(mid, start_ms + 10**9))])
        mp = ns.pl.MultiPartitionPlanner(prov, "local",
                                         ns.Recording("local"))
        with pytest.raises(ValueError, match="pinned"):
            mp.materialize(ns.plan(f'rate(foo[5m] @ {START_S + 600})'),
                           ns.ctx())


def test_default_shard_key_matcher_as_the_reference():
    values = {"_ws_": ["demo", "prod"], "_ns_": ["app1", "app2", "db"]}
    for ns in (PORT, JAX):
        m = ns.pl.default_shard_key_matcher(values.get, ("_ws_", "_ns_"))
        E = ns.idx.Equals
        combos = m([E("_ws_", "demo"), ns.idx.EqualsRegex("_ns_", "app.*"),
                    E("job", "x")])
        assert [[(f.column, f.value) for f in c] for c in combos] == \
            [[("_ws_", "demo"), ("_ns_", "app1")],
             [("_ws_", "demo"), ("_ns_", "app2")]]
        combos = m([ns.idx.NotEquals("_ns_", "db")])
        assert [c[0].value for c in combos] == ["app1", "app2"]


# ----------------------------------------------------------- exec nodes

def _blocks(ns, hist=False):
    k1 = ns.rv.RangeVectorKey.make({"job": "x"})
    k2 = ns.rv.RangeVectorKey.make({"job": "y"})
    extra = (3,) if hist else ()
    rng = np.random.default_rng(7)
    a = rng.normal(size=(2, 3) + extra)
    a[1, 0] = np.nan
    b = rng.normal(size=(1, 3) + extra)
    b[0, 2] = np.nan
    les = np.asarray([1.0, 2.0, np.inf]) if hist else None
    b1 = ns.rv.ResultBlock([k1, k2], np.asarray([1000, 2000, 3000]), a, les)
    b2 = ns.rv.ResultBlock([k1], np.asarray([3000, 4000, 5000]), b, les)
    return b1, b2


def _as_map(block):
    vals = np.asarray(prv.host_values(block.values), np.float64)
    return {tuple(sorted(k.labels_dict.items())): vals[i]
            for i, k in enumerate(block.keys)}, np.asarray(block.wends)


@pytest.mark.parametrize("hist", [False, True])
def test_stitch_compose_equals_the_reference_to_the_bit(hist):
    got = pexec.StitchRvsExec(prv.QueryContext(device="cpu"), []).compose(
        list(_blocks(PORT, hist)), prv.QueryStats())
    want = jexec.StitchRvsExec(jrv.QueryContext(), []).compose(
        list(_blocks(JAX, hist)), jrv.QueryStats())
    (gm, gw), (wm, ww) = _as_map(got), _as_map(want)
    np.testing.assert_array_equal(gw, ww)
    assert set(gm) == set(wm)
    for k in gm:
        np.testing.assert_array_equal(gm[k], wm[k])
    if hist:
        np.testing.assert_array_equal(got.bucket_les, want.bucket_les)


@pytest.mark.parametrize("op", ["sum", "min", "max", "count", "group"])
def test_multi_partition_reduce_compose_equals_the_reference(op):
    def blocks(ns):
        b1, b2 = _blocks(ns)
        return [b1, ns.rv.ResultBlock(b2.keys, b1.wends, b2.values)]
    got = pplanners.MultiPartitionReduceAggregateExec(
        prv.QueryContext(), [], op).compose(blocks(PORT), prv.QueryStats())
    want = jplanners.MultiPartitionReduceAggregateExec(
        jrv.QueryContext(), [], op).compose(blocks(JAX), jrv.QueryStats())
    (gm, _), (wm, _) = _as_map(got), _as_map(want)
    assert gm.keys() == wm.keys()
    for k in gm:
        np.testing.assert_array_equal(gm[k], wm[k])
    assert pplanners.MultiPartitionReduceAggregateExec(
        prv.QueryContext(), [], op).args_str() == f"aggrOp={op}"


def test_matrix_json_and_remote_exec_with_fake_transport():
    payload = {"status": "success", "data": {"resultType": "matrix",
               "result": [
                   {"metric": {"job": "x"}, "values": [[START_S, "1.5"],
                                                       [START_S + 60, "2.5"]]},
                   {"metric": {"job": "y"}, "values": [[START_S + 60, "7"]]}]}}
    got = pplanners._matrix_json_to_block(payload)
    want = jplanners._matrix_json_to_block(payload)
    np.testing.assert_array_equal(got.wends, want.wends)
    np.testing.assert_array_equal(got.values, want.values)
    assert [k.labels_dict for k in got.keys] == \
        [k.labels_dict for k in want.keys]
    calls = []

    def transport(endpoint, params):
        calls.append((endpoint, params))
        return {"data": {"result": [{"metric": {"a": "b"},
                                     "values": [[START_S, "4"]]}]}}
    e = pplanners.PromQlRemoteExec(
        prv.QueryContext(device="cpu"), "http://r/api", "up",
        START_S * 1000, 60_000, (START_S + 600) * 1000, transport=transport)
    res = e.execute(None)
    assert res.error is None and res.num_series == 1
    assert calls == [("http://r/api", {"query": "up", "start": START_S,
                                       "step": 60, "end": START_S + 600})]
    assert e.print_tree() == jplanners.PromQlRemoteExec(
        jrv.QueryContext(), "http://r/api", "up", START_S * 1000, 60_000,
        (START_S + 600) * 1000, transport=transport).print_tree()
    assert pplanners.PromQlRemoteExec(
        prv.QueryContext(), "e", "up", 0, 1, 2).transport is \
        pplanners._http_transport


def test_empty_result_and_in_process_dispatcher():
    ctx = prv.QueryContext(device="cpu")
    empty = pexec.EmptyResultExec(ctx)
    assert isinstance(empty.dispatcher, pexec.InProcessPlanDispatcher)
    assert empty.dispatcher.dispatch(empty, None)[0] is None
    res = empty.execute(None)
    assert res.error is None and res.num_series == 0
    assert empty.print_tree() == jexec.EmptyResultExec(
        jrv.QueryContext()).print_tree()
    seen = []

    class Spy(pexec.PlanDispatcher):
        def dispatch(self, plan, source):
            seen.append(type(plan).__name__)
            return pexec.InProcessPlanDispatcher().dispatch(plan, source)
    child = pexec.EmptyResultExec(ctx)
    child.dispatcher = Spy()
    assert pexec.StitchRvsExec(ctx, [child]).execute(None).num_series == 0
    assert seen == ["EmptyResultExec"]
    with pytest.raises(NotImplementedError):
        pexec.PlanDispatcher().dispatch(child, None)


def test_dispatcher_factory_reaches_every_leaf():
    mapper = ShardMapper(2)
    for s in range(2):
        mapper.update_from_event(ShardEvent("IngestionStarted", "p", s, "n"))
    marks = {}

    class Mark(pexec.InProcessPlanDispatcher):
        def __init__(self, shard):
            self.shard = shard
    planner = pplanner.SingleClusterPlanner(
        "p", mapper, dispatcher_factory=lambda s: marks.setdefault(
            s, Mark(s)))
    ep = planner.materialize(PORT.plan("sum(rate(foo[5m]))"),
                             prv.QueryContext())
    from filodb_tpu_torch.query.engine import _walk_plan
    leaves = [n for n in _walk_plan(ep)
              if isinstance(n, pexec.MultiSchemaPartitionsExec)]
    assert sorted(n.dispatcher.shard for n in leaves) == [0, 1]
    assert all(n.dispatcher is marks[n.shard] for n in leaves)


# ---------------------------------------- composed engines, one port store

NUM = 60


@pytest.fixture(scope="module")
def store():
    ms = TimeSeriesMemStore(device="cpu")
    shard = ms.setup("prometheus", 0)
    shard.ingest(to_port(counter_batch(NUM, 360, start_ms=START_S * 1000,
                                       resets=True, num_apps=30)), offset=1)
    return ms


def _engine(ms, planner):
    return QueryEngine("prometheus", ms, planner=planner, device="cpu")


def _remote_transport(ms, calls):
    """A 'remote' cluster: the same store answering Prometheus JSON, as
    an HTTP server would, through a JSON round trip."""
    eng = _engine(ms, None)

    def transport(endpoint, params):
        calls.append(params)
        res = eng.query_range(params["query"], params["start"],
                              params["step"], params["end"])
        return json.loads(json.dumps(QueryEngine.to_prom_matrix(res)))
    return transport


def _local(ms):
    mapper = ShardMapper(1)
    mapper.update_from_event(ShardEvent("IngestionStarted", "prometheus", 0,
                                        "n"))
    return pplanner.SingleClusterPlanner("prometheus", mapper)


RANGE = (START_S + 600, 60, START_S + 3590)
PANEL = "sum by (_ns_) (rate(request_total[5m]))"


def _same_answer(got, want):
    assert got.error is None and want.error is None, (got.error, want.error)
    g = {k: (w, np.asarray(v, np.float64)) for k, w, v in got.series()}
    w = {k: (w, np.asarray(v, np.float64)) for k, w, v in want.series()}
    assert set(g) == set(w)
    for k in g:
        np.testing.assert_array_equal(g[k][0], w[k][0])
        np.testing.assert_array_equal(g[k][1], w[k][1])


def test_ha_engine_answers_as_the_local_one(store):
    calls = []
    start_ms = RANGE[0] * 1000
    fail = pplanners.FailureTimeRange(
        "local", ppu.TimeRange(start_ms + 1_200_000, start_ms + 1_500_000))

    class FP(pplanners.FailureProvider):
        def get_failures(self, dataset, tr):
            return [fail]
    ha = pplanners.HighAvailabilityPlanner(
        "prometheus", _local(store), FP(), "http://replica/api/v1/query_range",
        transport=_remote_transport(store, calls))
    got = _engine(store, ha).query_range(PANEL, *RANGE)
    _same_answer(got, _engine(store, None).query_range(PANEL, *RANGE))
    assert len(calls) == 1 and calls[0]["start"] > RANGE[0]


def test_multi_partition_engine_answers_as_the_local_one(store):
    calls = []
    mid = (RANGE[0] + 1800) * 1000

    class Prov(pplanners.PartitionLocationProvider):
        def get_partitions(self, filters, tr):
            return [pplanners.PartitionAssignment(
                        "remote", "http://p2", ppu.TimeRange(0, mid - 1)),
                    pplanners.PartitionAssignment(
                        "local", "", ppu.TimeRange(mid, 1 << 62))]
    mp = pplanners.MultiPartitionPlanner(
        Prov(), "local", _local(store),
        transport=_remote_transport(store, calls))
    got = _engine(store, mp).query_range(PANEL, *RANGE)
    _same_answer(got, _engine(store, None).query_range(PANEL, *RANGE))
    assert len(calls) == 1


def test_shard_key_regex_engine_answers_as_the_local_one(store):
    from filodb_tpu_torch.utils.counters import counters
    shard = store.get_shard("prometheus", 0)
    matcher = pplanners.default_shard_key_matcher(
        lambda col: shard.index.label_values(col), ("_ws_", "_ns_"))
    skr = pplanners.ShardKeyRegexPlanner(_local(store), matcher)
    q = 'sum by (_ns_) (rate(request_total{_ns_=~"App-1[0-9]"}[5m]))'
    eng = _engine(store, skr)
    plan = eng.planner.materialize(PORT.plan(q, *RANGE), prv.QueryContext())
    assert isinstance(plan, pplanners.MultiPartitionReduceAggregateExec)
    assert len(plan.children) == 10
    before = counters.get("leaf_fused_kernel")
    got = eng.query_range(q, *RANGE)
    assert counters.get("leaf_fused_kernel") > before
    _same_answer(got, _engine(store, None).query_range(q, *RANGE))
    assert got.num_series == 10


def test_single_partition_engine_selects_by_metric(store):
    sp = pplanners.SinglePartitionPlanner(
        {"raw": _local(store), "other": pplanners.ShardKeyRegexPlanner(
            _local(store), lambda fs: [])},
        planner_selector=lambda m: "raw" if m == "request_total"
        else "other")
    got = _engine(store, sp).query_range(PANEL, *RANGE)
    _same_answer(got, _engine(store, None).query_range(PANEL, *RANGE))
