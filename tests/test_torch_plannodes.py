"""The plan nodes through the port: filodb_tpu_torch's QueryEngine against
the JAX package's over tests/test_query_engine.py's engine data (100
counters and 100 gauges x 720 samples, _ns_ = App-0..9), carried into
the port's memstore as tests/test_torch_hist_native.py carries several
schemas, on one and two shards.

sort/sort_desc (the order compared exactly), limitk, absent and
absent_over_time, label_replace and label_join (the collision error, the
disjoint merge, a ±Inf collision), scalar() and vector(), top-level and
windowed subqueries, `@` with a literal, start() and end(), the three
metadata plans, query_instant with to_prom_vector, and a raw range
vector at the root.  Tolerances: rtol 2e-4 / atol 1e-3
(__graft_entry__.py:221) for the rate family, rtol 5e-4 / atol 5e-3
(tests/test_tpu_conformance.py:122) for the others; NaN placement must
agree exactly.
"""
import numpy as np
import pytest

from filodb_tpu.core.index import Equals
from filodb_tpu.core.partkey import PartKey
from filodb_tpu.core.records import RecordBatchBuilder
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS
from filodb_tpu.ingest.generator import counter_batch, gauge_batch
from filodb_tpu.query import logical as jlp
from filodb_tpu_torch.core.index import Equals as TEquals
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.parallel.shardmapper import ShardEvent, ShardMapper
from filodb_tpu_torch.query import logical as tlp
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.query.execbase import RawBlock

from test_query_engine import NUM_SAMPLES, START_MS, START_S, _mk_engine
from test_torch_hist_native import _carry
from test_torch_ingest import _clear_compile_journal  # noqa: F401

END_S = START_S + 7200
RATE_TOL = (2e-4, 1e-3)
OTHER_TOL = (5e-4, 5e-3)
SCHEMAS = ("prom-counter", "gauge")

_ENGINES = {}


def _port(je, num_shards, schemas=SCHEMAS):
    ms = TimeSeriesMemStore(device="cpu")
    mapper = ShardMapper(num_shards)
    for s in range(num_shards):
        mapper.update_from_event(
            ShardEvent("IngestionStarted", "prometheus", s, "local"))
    _carry(je, ms, num_shards, schemas)
    return QueryEngine("prometheus", ms, mapper, device="cpu")


def _engines(num_shards=1):
    if num_shards not in _ENGINES:
        je = _mk_engine([counter_batch(100, NUM_SAMPLES, start_ms=START_MS),
                         gauge_batch(100, NUM_SAMPLES, start_ms=START_MS)],
                        num_shards=num_shards)
        _ENGINES[num_shards] = (je, _port(je, num_shards))
    return _ENGINES[num_shards]


def _rows(res):
    assert res.error is None, res.error
    return [(k.labels, np.asarray(v)) for k, _, v in res.series()]


def _agree(want, got, tol=OTHER_TOL, ordered=False):
    """Same series (in the same order when `ordered`), values within
    `tol`, NaN placement equal -> the number of series."""
    w, g = _rows(want), _rows(got)
    if not ordered:
        w, g = sorted(w, key=lambda x: x[0]), sorted(g, key=lambda x: x[0])
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, wv), (_, gv) in zip(w, g):
        assert gv.shape == wv.shape, k
        assert (np.isnan(gv) == np.isnan(wv)).all(), k
        np.testing.assert_allclose(gv, wv, rtol=tol[0], atol=tol[1],
                                   equal_nan=True, err_msg=str(k))
    return len(w)


def _both(promql, num_shards=1, start=START_S + 600, step=60, end=END_S):
    je, pe = _engines(num_shards)
    return (je.query_range(promql, start, step, end),
            pe.query_range(promql, start, step, end))


@pytest.mark.parametrize("num_shards", [1, 2])
@pytest.mark.parametrize("promql, tol, n", [
    ("sort(sum by (_ns_) (rate(request_total[5m])))", RATE_TOL, 10),
    ("sort_desc(sum by (_ns_) (rate(request_total[5m])))", RATE_TOL, 10),
    ('sort(heap_usage{_ns_="App-3"})', OTHER_TOL, 10),
    ("sort_desc(max_over_time(heap_usage[5m]))", OTHER_TOL, 100),
])
def test_sort_order_matches_jax_engine(promql, tol, n, num_shards):
    want, got = _both(promql, num_shards)
    assert _agree(want, got, tol, ordered=True) == n


def test_sort_ranks_near_ties_by_f64_means():
    """Two series whose f32 means tie but whose f64 means do not: the
    port ranks by the f64 mean with a stable sort, as the reference's
    np.nanmean over its f64 partials does."""
    from filodb_tpu_torch.query.rangevector import RangeVectorKey, ResultBlock
    from filodb_tpu_torch.query.transformers import SortFunctionMapper
    vals = np.array([[1.0 + 2e-9, 1.0], [1.0, 1.0 + 1e-9], [np.nan] * 2])
    keys = [RangeVectorKey.make({"s": str(i)}) for i in range(3)]
    block = ResultBlock(keys, np.array([0, 1]), vals)
    # a series with no sample ranks first either way, as in the reference
    for desc, order in ((False, ["2", "1", "0"]), (True, ["2", "0", "1"])):
        out = SortFunctionMapper(desc).apply(block, None, None)
        assert [k.labels_dict["s"] for k in out.keys] == order


@pytest.mark.parametrize("promql", [
    "limitk(3, sum by (_ns_) (rate(request_total[5m])))",
    'limitk(4, heap_usage{_ns_="App-1"})',
])
def test_limitk_matches_jax_engine(promql):
    want, got = _both(promql)
    assert _agree(want, got, RATE_TOL, ordered=True) in (3, 4)


@pytest.mark.parametrize("num_shards", [1, 2])
@pytest.mark.parametrize("promql, n", [
    ('absent(heap_usage{_ns_="App-1"})', 0),
    ('absent(nonexistent_metric{_ns_="App-1", job="x"})', 1),
    ('absent(sum(rate(nonexistent_total[5m])))', 1),
    ('absent_over_time(heap_usage{_ns_="App-1"}[5m])', 0),
    ('absent_over_time(nonexistent_metric{_ns_="App-2"}[5m])', 1),
])
def test_absent_matches_jax_engine(promql, n, num_shards):
    want, got = _both(promql, num_shards)
    assert _agree(want, got) == n
    if n:
        (_, vals), = _rows(got)
        assert (vals == 1.0).all()


def test_absent_carries_the_equality_matchers():
    _, got = _both('absent(nonexistent_metric{_ns_="App-1", job=~"x.*"})')
    (key, _), = _rows(got)
    assert dict(key) == {"_ns_": "App-1"}


@pytest.mark.parametrize("num_shards", [1, 2])
@pytest.mark.parametrize("promql", [
    'label_replace(heap_usage{_ns_="App-1"}, "dst", "v$1", "_ns_", '
    '"App-(.*)")',
    'label_replace(sum by (_ns_) (rate(request_total[5m])), "app", "$1", '
    '"_ns_", "App-(.*)")',
    'label_replace(heap_usage{_ns_="App-2"}, "_ns_", "", "_ns_", "(.*)")',
    'label_join(heap_usage{_ns_="App-1"}, "dst", "-", "_ns_", "instance")',
    'label_join(sum by (_ns_) (heap_usage), "x", ",", "_ns_", "_ns_")',
])
def test_label_functions_match_jax_engine(promql, num_shards):
    want, got = _both(promql, num_shards)
    assert _agree(want, got, RATE_TOL) > 0


@pytest.mark.parametrize("promql", [
    'label_replace(heap_usage{_ws_="demo"}, "instance", "same", '
    '"instance", "(.*)")',
    'label_join(heap_usage{_ns_="App-1"}, "instance", "", "nothing")',
])
def test_label_collision_is_the_reference_error(promql):
    """tests/test_query_engine.py::test_label_replace_collision_is_clean_
    error through both engines: the same error text."""
    want, got = _both(promql, start=START_S + 600, end=START_S + 1200)
    assert want.error is not None and "same labelset" in want.error
    assert got.error == want.error


def _disjoint_engines():
    """tests/test_query_engine.py::test_label_replace_merges_disjoint_
    series' data: two pods whose samples never share a step."""
    b = RecordBatchBuilder(DEFAULT_SCHEMAS["gauge"])
    half = 60
    for j in range(half):
        b.add(PartKey.make("up", {"_ws_": "demo", "_ns_": "a",
                                  "pod": "old"}),
              START_MS + j * 10_000, value=1.0)
    for j in range(half, 2 * half):
        b.add(PartKey.make("up", {"_ws_": "demo", "_ns_": "a",
                                  "pod": "new"}),
              START_MS + 400_000 + j * 10_000, value=2.0)
    je = _mk_engine([b.build()])
    return je, _port(je, 1, ("gauge",))


def test_label_replace_merges_disjoint_series():
    je, pe = _disjoint_engines()
    q = 'label_replace(up{_ws_="demo"}, "pod", "x", "pod", "(.*)")'
    end = START_S + 400 + 2 * 60 * 10 - 10
    want = je.query_range(q, START_S + 60, 60, end)
    got = pe.query_range(q, START_S + 60, 60, end)
    assert _agree(want, got) == 1
    (_, vals), = _rows(got)
    assert set(np.unique(vals[np.isfinite(vals)])) == {1.0, 2.0}


def test_label_collision_with_inf_samples_is_an_error():
    """Presence is NaN-only in the reference's _merge_relabeled: a ±Inf
    sample is a sample, so two series holding ±Inf at one step collide
    and the query fails, in both engines (as Prometheus does)."""
    b = RecordBatchBuilder(DEFAULT_SCHEMAS["gauge"])
    for j in range(60):
        for pod, v in (("a", np.inf), ("b", -np.inf)):
            b.add(PartKey.make("up", {"_ws_": "demo", "_ns_": "n",
                                      "pod": pod}),
                  START_MS + j * 10_000, value=v)
    je = _mk_engine([b.build()])
    pe = _port(je, 1, ("gauge",))
    q = 'label_replace(up, "pod", "x", "pod", "(.*)")'
    want = je.query_range(q, START_S + 300, 60, START_S + 590)
    got = pe.query_range(q, START_S + 300, 60, START_S + 590)
    assert want.error is not None and "same labelset" in want.error
    assert got.error == want.error
    # one ±Inf series alone is an answer, not a collision
    ok = 'label_replace(up{pod="a"}, "pod", "x", "pod", "(.*)")'
    _agree(je.query_range(ok, START_S + 300, 60, START_S + 590),
           pe.query_range(ok, START_S + 300, 60, START_S + 590))


@pytest.mark.parametrize("num_shards", [1, 2])
@pytest.mark.parametrize("promql, tol", [
    ("sum by (_ns_) (rate(request_total[5m])) / "
     "scalar(sum(rate(request_total[5m])))", RATE_TOL),
    ('heap_usage{_ns_="App-1"} - scalar(avg(heap_usage))', OTHER_TOL),
    ("scalar(heap_usage)", OTHER_TOL),                # many series: NaN
    ('scalar(sum(heap_usage{_ns_="App-4"}))', OTHER_TOL),
    ("vector(3)", OTHER_TOL),
    ("vector(time())", OTHER_TOL),
    ('sum(heap_usage{_ns_="App-1"}) + vector(1)', OTHER_TOL),
])
def test_scalar_and_vector_match_jax_engine(promql, tol, num_shards):
    want, got = _both(promql, num_shards)
    _agree(want, got, tol)


def test_scalar_ratio_groups_sum_to_one():
    _, got = _both("sum by (_ns_) (rate(request_total[5m])) / "
                   "scalar(sum(rate(request_total[5m])))")
    total = np.sum([v for _, v in _rows(got)], axis=0)
    np.testing.assert_allclose(total, 1.0, rtol=1e-4)


@pytest.mark.parametrize("num_shards", [1, 2])
@pytest.mark.parametrize("promql, tol", [
    ("max_over_time(sum by (_ns_) (rate(request_total[5m]))[30m:1m])",
     RATE_TOL),
    ('avg_over_time(heap_usage{_ns_="App-1"}[10m:1m])', OTHER_TOL),
    ("rate(sum(request_total)[10m:2m])", RATE_TOL),
    ('min_over_time(heap_usage{_ns_="App-2"}[10m:1m] offset 5m)',
     OTHER_TOL),
    ('heap_usage{_ns_="App-1"}[10m:1m]', OTHER_TOL),
    ('absent_over_time(nonexistent_metric[10m:1m])', OTHER_TOL),
])
def test_subqueries_match_jax_engine(promql, tol, num_shards):
    want, got = _both(promql, num_shards)
    _agree(want, got, tol)


@pytest.mark.parametrize("num_shards", [1, 2])
@pytest.mark.parametrize("promql, tol", [
    (f'heap_usage{{_ns_="App-1"}} @ {START_S + 1200}', OTHER_TOL),
    ('sum(rate(request_total{_ws_="demo"}[5m] @ end()))', RATE_TOL),
    ('heap_usage{_ws_="demo"} @ start()', OTHER_TOL),
    (f'sum by (_ns_) (rate(request_total[5m] @ {START_S + 3000}))',
     RATE_TOL),
    (f'max_over_time(heap_usage{{_ns_="App-1"}}[10m:1m] @ '
     f'{START_S + 2400})', OTHER_TOL),
])
def test_at_modifier_matches_jax_engine(promql, tol, num_shards):
    want, got = _both(promql, num_shards)
    assert _agree(want, got, tol) > 0
    for _, v in _rows(got):
        fin = v[~np.isnan(v)]
        assert (fin == fin[0]).all()          # pinned: one value repeated


def test_at_end_equals_the_instant_evaluation():
    """tests/test_query_engine.py::test_at_modifier_pins_evaluation_time's
    identity, through the port: rate at a pinned end() equals the
    instant evaluation at end (the pinned leaf takes the general path,
    the instant one the fused leaf: within the rate tolerance), at every
    step the same bits."""
    _, pe = _engines()
    r = pe.query_range('sum(rate(request_total{_ws_="demo"}[5m] @ end()))',
                       START_S + 600, 60, START_S + 2400)
    inst = pe.query_instant('sum(rate(request_total{_ws_="demo"}[5m]))',
                            START_S + 2400)
    (_, got), = _rows(r)
    (_, want), = _rows(inst)
    assert (got == got[0]).all()
    np.testing.assert_allclose(got, want[0], rtol=RATE_TOL[0],
                               atol=RATE_TOL[1])


@pytest.mark.parametrize("num_shards", [1, 2])
def test_metadata_plans_match_jax_engine(num_shards):
    je, pe = _engines(num_shards)
    end_ms = END_S * 1000
    want = je.exec_logical_plan(jlp.LabelValues(("_ns_",), (), START_MS,
                                                end_ms))
    got = pe.exec_logical_plan(tlp.LabelValues(("_ns_",), (), START_MS,
                                               end_ms))
    assert got.error is None and got.data == want.data
    assert sorted(got.data["_ns_"]) == [f"App-{i}" for i in range(10)]
    want = je.exec_logical_plan(jlp.SeriesKeysByFilters(
        (Equals("_ns_", "App-1"),), START_MS, end_ms))
    got = pe.exec_logical_plan(tlp.SeriesKeysByFilters(
        (TEquals("_ns_", "App-1"),), START_MS, end_ms))
    assert len(got.data) == 20                # 10 gauges + 10 counters
    assert sorted(map(sorted, (d.items() for d in got.data))) == \
        sorted(map(sorted, (d.items() for d in want.data)))
    want = je.exec_logical_plan(jlp.LabelNames((), START_MS, end_ms))
    got = pe.exec_logical_plan(tlp.LabelNames((), START_MS, end_ms))
    assert got.data == want.data
    assert "_ns_" in got.data and "instance" in got.data
    want = je.exec_logical_plan(jlp.LabelNames(
        (Equals("_metric_", "heap_usage"),), START_MS, end_ms))
    got = pe.exec_logical_plan(tlp.LabelNames(
        (TEquals("_metric_", "heap_usage"),), START_MS, end_ms))
    assert got.data == want.data


@pytest.mark.parametrize("promql", [
    "sum by (_ns_) (rate(request_total[5m]))",
    "sum by (_ns_) (resets(request_total[5m]))",
    'sort_desc(heap_usage{_ns_="App-5"})',
    'absent(nothing{_ns_="App-1"})',
])
def test_query_instant_and_vector_envelope_match_jax_engine(promql):
    je, pe = _engines()
    t = START_S + 3600
    want, got = je.query_instant(promql, t), pe.query_instant(promql, t)
    _agree(want, got, RATE_TOL, ordered=promql.startswith("sort"))
    wv, gv = je.to_prom_vector(want), pe.to_prom_vector(got)
    assert gv["status"] == wv["status"] == "success"
    assert gv["data"]["resultType"] == "vector"
    assert [r["metric"] for r in gv["data"]["result"]] == \
        [r["metric"] for r in wv["data"]["result"]]
    for a, b in zip(gv["data"]["result"], wv["data"]["result"]):
        assert a["value"][0] == b["value"][0] == float(t)
        assert float(a["value"][1]) == pytest.approx(float(b["value"][1]),
                                                     rel=2e-4, abs=1e-3)


def test_vector_envelope_of_an_error():
    _, pe = _engines()
    res = pe.query_instant("sum(", START_S + 600)
    payload = QueryEngine.to_prom_vector(res)
    assert payload["status"] == "error" and "parse error" in payload["error"]


@pytest.mark.parametrize("num_shards", [1, 2])
@pytest.mark.parametrize("metric, col", [("request_total", "count"),
                                         ("heap_usage", "value")])
def test_raw_range_vector_at_the_root_is_the_reference_block(metric, col,
                                                             num_shards):
    """A RawSeries plan answers, in both engines, with the gathered block
    itself (the shards' blocks concatenated): the rebased raw values
    (counters uncorrected), int32 offsets from the chunk start.  Its
    serialisation to the Prometheus envelopes fails in both the same way,
    and so does a raw range vector in a binary operation: no series."""
    je, pe = _engines(num_shards)
    lo, hi = START_MS + 600_000, START_MS + 900_000
    want = je.exec_logical_plan(jlp.RawSeries(
        jlp.IntervalSelector(lo, hi), (Equals("_metric_", metric),)))
    got = pe.exec_logical_plan(tlp.RawSeries(
        tlp.IntervalSelector(lo, hi), (TEquals("_metric_", metric),)))
    assert want.error is None and got.error is None
    (wb,), (gb,) = want.blocks, got.blocks
    assert isinstance(gb, RawBlock) and isinstance(gb.values, np.ndarray)
    assert [k.labels for k in gb.keys] == [k.labels for k in wb.keys]
    assert gb.base_ms == wb.base_ms and not gb.precorrected
    w_abs = np.asarray(wb.values) + np.asarray(wb.vbase)[:, None]
    g_abs = gb.values + gb.vbase[:, None]
    w_ts = np.asarray(wb.ts_off)
    # both hold the same samples at the same absolute times
    np.testing.assert_array_equal(
        gb.ts_off[:, :w_ts.shape[1]].astype(np.int64) + gb.base_ms,
        w_ts.astype(np.int64) + wb.base_ms)
    np.testing.assert_allclose(g_abs[:, :w_ts.shape[1]], w_abs,
                               rtol=1e-6, equal_nan=True)
    for env in ("to_prom_vector", "to_prom_matrix"):
        with pytest.raises(AttributeError):
            getattr(je, env)(want)
        with pytest.raises(AttributeError):
            getattr(pe, env)(got)
    sel = jlp.RawSeries(jlp.IntervalSelector(lo, hi),
                        (Equals("_metric_", metric),))
    tsel = tlp.RawSeries(tlp.IntervalSelector(lo, hi),
                         (TEquals("_metric_", metric),))
    wj = je.exec_logical_plan(jlp.BinaryJoin(sel, "+", sel))
    gj = pe.exec_logical_plan(tlp.BinaryJoin(tsel, "+", tsel))
    assert wj.error is None and gj.error is None
    assert wj.blocks == [] and gj.blocks == []


@pytest.mark.parametrize("op", ["sum", "avg", "max"])
def test_at_pinned_aggregate_takes_the_fused_leaf(op):
    """`op by (_ns_) (rate(m[5m] @ t))`: the pin commutes with the
    per-step aggregate, so the leaf evaluates the pinned step through the
    fused path and repeats its partial across the grid; the answer
    agrees with the JAX engine's general path."""
    from filodb_tpu_torch.utils.counters import counters
    q = f"{op} by (_ns_) (rate(request_total[5m] @ {START_S + 3000}))"
    je, pe = _engines()
    want = je.query_range(q, START_S + 600, 60, END_S)
    before = counters.get("leaf_fused_kernel")
    got = pe.query_range(q, START_S + 600, 60, END_S)
    assert counters.get("leaf_fused_kernel") == before + 1
    assert _agree(want, got, RATE_TOL) == 10
