"""Batched and compiled expressions through the port: filodb_tpu_torch's
QueryEngine.query_range_batch and query/exprfuse.py against the JAX
package's, over the same seeded series (tests/test_exprfuse.py's four
working sets on two shards, tests/test_query_batch.py's counters on one
and two shards), carried into the port's memstore as
tests/test_torch_hist_native.py carries them.

Within the port a batch must be BIT-identical to the same queries run
one at a time with the compiler off (query.exprfuse_enabled=False), as
the reference requires of itself.  Across the packages the answers agree
within the reference's tolerance, rtol 2e-4 / atol 1e-3
(__graft_entry__.py:221), with NaN placement equal: the JAX battery runs
as tests/test_exprfuse.py runs it (host-routed, no device mirror), the
dashboard panels of tests/test_query_batch.py with the JAX Pallas kernel
in interpret mode.  Also: the batch gather memo, the join index-map
cache (hit and miss), a degraded leaf counted, and a killed query that
answers query_canceled with no launch.
"""
import numpy as np
import pytest

from filodb_tpu.config import settings as jax_settings
from filodb_tpu.core.records import RecordBatch
from filodb_tpu.ingest.generator import counter_batch, histogram_batch
from filodb_tpu_torch.config import settings
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.ops import fused
from filodb_tpu_torch.parallel.shardmapper import ShardEvent, ShardMapper
from filodb_tpu_torch.promql.parser import (TimeStepParams,
                                            query_range_to_logical_plan)
from filodb_tpu_torch.query import exprfuse
from filodb_tpu_torch.query.activequeries import CancellationToken
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.query.rangevector import QueryContext
from filodb_tpu_torch.utils.metrics import registry

import test_query_batch as qb
from test_exprfuse import ARGS, FIXED_PANELS, _batches, _fuzz_panels
from test_query_engine import _mk_engine
from test_torch_hist_native import _carry

RTOL, ATOL = 2e-4, 1e-3
SCHEMAS = ("prom-counter", "gauge", "prom-histogram")
QB_ARGS = (qb.START_S + 600, 60, qb.END_S)


@pytest.fixture(autouse=True, scope="module")
def _clear_compile_journal():
    """The JAX engine's queries journal a jit compile per new shape under
    their query's trace id, which the reference's health model reads as
    a compile storm for the next 120 s in whatever test file this
    process runs next; clear the journal after this file."""
    yield
    from filodb_tpu.utils.events import journal
    journal.clear()


def _port(je, num_shards, schemas=SCHEMAS):
    ms = TimeSeriesMemStore(device="cpu")
    mapper = ShardMapper(num_shards)
    for s in range(num_shards):
        mapper.update_from_event(
            ShardEvent("IngestionStarted", "prometheus", s, "local"))
    _carry(je, ms, num_shards, schemas)
    return QueryEngine("prometheus", ms, mapper, device="cpu")


_ENGINES = {}


def _engines():
    """tests/test_exprfuse.py's engine (two shards, so every aggregation
    tree holds two leaves) and the port's over the same series."""
    if "battery" not in _ENGINES:
        je = _mk_engine(_batches(), num_shards=2)
        _ENGINES["battery"] = (je, _port(je, 2))
    return _ENGINES["battery"]


@pytest.fixture()
def jax_host_routed(monkeypatch):
    """tests/test_exprfuse.py's comparison config for the JAX engine: no
    device mirror, host-routed fused leaves."""
    monkeypatch.setattr(jax_settings().query, "host_route_max_samples",
                        1 << 60)
    monkeypatch.setattr(jax_settings().store, "device_mirror_enabled",
                        False)
    monkeypatch.setenv("FILODB_TPU_FORCE_HOST_ROUTE", "1")


@pytest.fixture()
def port_host_routed(monkeypatch):
    """The port's router on: small working sets take the windowed host
    gather (where the batch gather memo engages)."""
    monkeypatch.setenv("FILODB_TPU_FORCE_HOST_ROUTE", "1")


def _exact_map(res):
    """key -> (wends bytes, value bytes): equality means bit-identical."""
    assert res.error is None, res.error
    return {tuple(sorted(k.labels_dict.items())):
            (np.asarray(w).tobytes(), np.asarray(v, np.float64).tobytes())
            for k, w, v in res.series()}


def _values(res):
    assert res.error is None, res.error
    return {tuple(sorted(k.labels_dict.items())): np.asarray(v, np.float64)
            for k, _, v in res.series()}


def _agree(got, want, what):
    g, w = _values(got), _values(want)
    assert set(g) == set(w) and w, what
    for k in w:
        assert g[k].shape == w[k].shape, (what, k)
        assert (np.isnan(g[k]) == np.isnan(w[k])).all(), (what, k)
        np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                   equal_nan=True, err_msg=f"{what} {k}")


def _off(engine, queries, args, monkeypatch):
    """The queries one at a time with the compiler off."""
    with monkeypatch.context() as m:
        m.setattr(settings().query, "exprfuse_enabled", False)
        return [_exact_map(engine.query_range(q, *args)) for q in queries]


@pytest.mark.parametrize("routed", [False, True], ids=["mirror", "routed"])
def test_battery_bit_identical_to_compiler_off(routed, monkeypatch):
    """The battery (fixed shapes and the seeded fuzz) as ONE port batch
    equals the port's compiler-off sequential run bitwise, over the
    device mirror and over the router's host gather."""
    if routed:
        monkeypatch.setenv("FILODB_TPU_FORCE_HOST_ROUTE", "1")
    _, pe = _engines()
    queries = FIXED_PANELS + _fuzz_panels()
    want = _off(pe, queries, ARGS, monkeypatch)
    fused0 = registry.counter("query_exprfuse", verdict="fused").value
    got = pe.query_range_batch(queries, *ARGS)
    assert registry.counter("query_exprfuse", verdict="fused").value \
        > fused0, "no leaf compiled"
    for q, w, g in zip(queries, want, got):
        assert _exact_map(g) == w, f"not bit-identical: {q}"


def test_battery_matches_jax_batch(jax_host_routed):
    """The same battery through both engines' query_range_batch."""
    je, pe = _engines()
    queries = FIXED_PANELS + _fuzz_panels()
    want = je.query_range_batch(queries, *ARGS)
    got = pe.query_range_batch(queries, *ARGS)
    for q, w, g in zip(queries, want, got):
        _agree(g, w, q)
        assert g.stats.exprfuse_fused + g.stats.exprfuse_degraded \
            == w.stats.exprfuse_fused + w.stats.exprfuse_degraded, q


def _qb_engines(ragged=False, num_shards=1):
    key = ("qb", ragged, num_shards)
    if key not in _ENGINES:
        batch = counter_batch(60 if not ragged else 48, qb.T,
                              start_ms=qb.START_MS, resets=not ragged)
        if ragged:
            vals = batch.columns["count"].copy()
            vals[np.random.default_rng(11).random(vals.shape) < 0.1] = np.nan
            batch = RecordBatch(batch.schema, batch.part_keys,
                                batch.part_idx, batch.timestamps,
                                {"count": vals}, batch.bucket_les)
        je = _mk_engine([batch], num_shards=num_shards)
        _ENGINES[key] = (je, _port(je, num_shards, ("prom-counter",)))
    return _ENGINES[key]


@pytest.mark.parametrize("ragged, num_shards", [(False, 1), (True, 1),
                                                (False, 2)])
def test_dashboard_panels_merge_and_match_jax(ragged, num_shards,
                                              monkeypatch):
    """tests/test_query_batch.py's six panels: the sum/avg/count panels
    share one group-mode launch (min/max one per-series launch) on each
    shard, the batch equals the port's compiler-off run bitwise, and both
    agree with the JAX engine's batch (its kernel in interpret mode)."""
    monkeypatch.setenv("FILODB_TPU_FUSED_INTERPRET", "1")
    je, pe = _qb_engines(ragged, num_shards)
    want_bits = _off(pe, qb.PANELS, QB_ARGS, monkeypatch)
    d0 = registry.counter("fused_batch_dispatches").value
    m0 = registry.counter("fused_batch_merged_panels").value
    got = pe.query_range_batch(qb.PANELS, *QB_ARGS)
    assert registry.counter("fused_batch_merged_panels").value - m0 \
        >= 4 * num_shards, "sum/avg/count panels did not merge"
    assert registry.counter("fused_batch_dispatches").value - d0 \
        <= 2 * num_shards
    want = je.query_range_batch(qb.PANELS, *QB_ARGS)
    for q, wb, w, g in zip(qb.PANELS, want_bits, want, got):
        assert _exact_map(g) == wb, f"not bit-identical: {q}"
        _agree(g, w, q)


def test_mixed_eligibility_rides_along(monkeypatch):
    """Non-fusable and failing queries take their normal paths inside a
    batch: the same answers as alone, the same error as the JAX engine."""
    monkeypatch.setenv("FILODB_TPU_FUSED_INTERPRET", "1")
    je, pe = _qb_engines()
    queries = [qb.PANELS[0],
               'rate(request_total{_ws_="demo"}[5m])',
               'sum(nosuch_metric[5m])',
               'topk(2, rate(request_total{_ws_="demo"}[5m]))',
               qb.PANELS[1]]
    got = pe.query_range_batch(queries, *QB_ARGS)
    want = je.query_range_batch(queries, *QB_ARGS)
    assert got[2].error is not None and want[2].error is not None
    assert got[2].error.split(":", 1)[0] == want[2].error.split(":", 1)[0]
    alone = _off(pe, [queries[i] for i in (0, 1, 3, 4)], QB_ARGS,
                 monkeypatch)
    for j, i in enumerate((0, 1, 3, 4)):
        assert _exact_map(got[i]) == alone[j], queries[i]
        _agree(got[i], want[i], queries[i])


def test_histogram_quantile_panels_dedup(monkeypatch):
    """p50/p90/p99 over one bucket metric differ only above the leaf: their
    leaf calls dedup to one run, and every panel equals its run alone and
    the JAX engine's batch."""
    monkeypatch.setenv("FILODB_TPU_FUSED_INTERPRET", "1")
    if "hist" not in _ENGINES:
        je = _mk_engine([histogram_batch(24, qb.T, start_ms=qb.START_MS)])
        _ENGINES["hist"] = (je, _port(je, 1, ("prom-histogram",)))
    je, pe = _ENGINES["hist"]
    panels = [
        'histogram_quantile(0.5, sum(rate(http_latency{_ws_="demo"}[5m])))',
        'histogram_quantile(0.9, sum(rate(http_latency{_ws_="demo"}[5m])))',
        'histogram_quantile(0.99, sum(rate(http_latency{_ws_="demo"}[5m])))',
        'histogram_quantile(0.9, '
        'sum(rate(http_latency{_ws_="demo"}[5m])) by (_ns_))',
    ]
    alone = _off(pe, panels, QB_ARGS, monkeypatch)
    dedup0 = registry.counter("fused_batch_deduped").value
    got = pe.query_range_batch(panels, *QB_ARGS)
    assert registry.counter("fused_batch_deduped").value - dedup0 >= 2
    want = je.query_range_batch(panels, *QB_ARGS)
    for q, a, w, g in zip(panels, alone, want, got):
        assert _exact_map(g) == a, q
        _agree(g, w, q)


def test_single_query_tree_compiles_bit_identical(monkeypatch):
    """min_leaves=2: a two-shard join compiles through exec_logical_plan
    and still equals the compiler-off run bitwise."""
    _, pe = _engines()
    q = ('sum by (_ns_)(rate(request_total[5m]))'
         ' / on (_ns_) count by (_ns_)(rate(request_total[5m]))')
    want = _off(pe, [q], ARGS, monkeypatch)[0]
    fused0 = registry.counter("query_exprfuse", verdict="fused").value
    res = pe.query_range(q, *ARGS)
    assert registry.counter("query_exprfuse", verdict="fused").value > fused0
    assert res.stats.exprfuse_fused >= 2
    assert _exact_map(res) == want


def test_degraded_leaf_counted():
    """A leaf whose shape the fused path does not take (a non-counter
    function over a counter column, a quantile) is counted degraded, in
    the registry and in the result's stats, and still answers."""
    _, pe = _engines()
    queries = ['max by (_ns_)(max_over_time(request_total[5m]))',
               'quantile(0.9, rate(request_total[5m]))']
    d0 = registry.counter("query_exprfuse", verdict="degraded").value
    res = pe.query_range_batch(queries, *ARGS)
    assert registry.counter("query_exprfuse", verdict="degraded").value \
        - d0 >= 4                         # two leaves a query (2 shards)
    for r in res:
        assert r.error is None and r.stats.exprfuse_degraded == 2
        assert r.stats.to_dict()["exprfuse"]["degraded"] == 2


def test_disabled_config_never_engages(monkeypatch):
    _, pe = _engines()
    monkeypatch.setattr(settings().query, "exprfuse_enabled", False)
    f0 = registry.counter("query_exprfuse", verdict="fused").value
    d0 = registry.counter("query_exprfuse", verdict="degraded").value
    res = pe.query_range_batch(FIXED_PANELS[:3], *ARGS)
    assert all(r.error is None for r in res)
    assert registry.counter("query_exprfuse", verdict="fused").value == f0
    assert registry.counter("query_exprfuse", verdict="degraded").value == d0


def test_killed_query_is_canceled_before_any_launch(monkeypatch):
    """A query killed between prepare and finish is filtered out of the
    merged launch; its leaves raise query_canceled before launching."""
    _, pe = _engines()
    launched = []
    real = fused.fused_leaf_agg_batch

    def spy(*a, **k):
        launched.append(a[3])
        return real(*a, **k)

    monkeypatch.setattr(fused, "fused_leaf_agg_batch", spy)
    plan = query_range_to_logical_plan(FIXED_PANELS[0], TimeStepParams(*ARGS))
    ctx = QueryContext(query_id="kill-drill", device=pe.device)
    ctx.cancel = CancellationToken()
    ep = pe.planner.materialize(plan, ctx)
    comp = exprfuse.compile_tree(ep, pe.source)
    assert comp is not None and len(comp.calls) == 2
    ctx.cancel.cancel("admin", "kill drill")
    exprfuse.finish_prepared(comp.calls)
    res = ep.execute(pe.source)
    assert launched == []
    assert res.error is not None and res.error.startswith("query_canceled")
    assert QueryEngine.to_prom_matrix(res)["errorType"] == "canceled"
    # the same leaves parked, then finished alone when not killed
    ctx2 = QueryContext(query_id="live", device=pe.device)
    ep2 = pe.planner.materialize(plan, ctx2)
    comp2 = exprfuse.compile_tree(ep2, pe.source)
    assert ep2.execute(pe.source).error is None
    assert len(launched) == len(comp2.calls) == 2


def test_batch_gather_memo_shares_scans(port_host_routed):
    """Panels over one working set share the windowed host gather under
    the batch's memo scope; outside a batch the memo is inert."""
    _, pe = _engines()
    queries = ['sum by (_ns_)(rate(request_total[5m]))',
               'avg by (dc)(rate(request_total[5m]))',
               'count by (_ns_)(rate(request_total[5m]))',
               'max by (_ns_)(rate(request_total[5m]))',
               'max by (_ns_)(max_over_time(request_total[5m]))',
               'sum by (_ns_)(rate(request_total[5m])) > 1']
    h0 = registry.counter("leaf_gather_memo_hits").value
    res = pe.query_range_batch(queries, *ARGS)
    assert all(r.error is None for r in res)
    assert registry.counter("leaf_gather_memo_hits").value - h0 >= 8, \
        "the shared working set was gathered again per panel"
    h1 = registry.counter("leaf_gather_memo_hits").value
    assert pe.query_range(queries[0], *ARGS).error is None
    assert registry.counter("leaf_gather_memo_hits").value == h1, \
        "the memo engaged outside a batch"


def test_join_index_map_cache_miss_then_hit(monkeypatch):
    """The resolved label match of a join is memoized on its operands'
    working-set identity: the first run misses, a re-poll hits and gives
    the same bits; another grouping misses again."""
    _, pe = _engines()
    q = ('max by (_ns_)(rate(request_total[5m]))'
         ' - on (_ns_) min by (_ns_)(rate(request_total[5m]))')
    exprfuse._JOIN_CACHE.clear()
    miss0 = registry.counter("exprfuse_join_cache", verdict="miss").value
    hit0 = registry.counter("exprfuse_join_cache", verdict="hit").value
    first = _exact_map(pe.query_range(q, *ARGS))
    assert registry.counter("exprfuse_join_cache", verdict="miss").value \
        == miss0 + 1
    second = _exact_map(pe.query_range(q, *ARGS))
    assert registry.counter("exprfuse_join_cache", verdict="hit").value \
        == hit0 + 1
    assert second == first
    q2 = q.replace("on (_ns_)", "on (_ns_, dc)").replace(
        "by (_ns_)", "by (_ns_, dc)")
    assert pe.query_range(q2, *ARGS).error is None
    assert registry.counter("exprfuse_join_cache", verdict="miss").value \
        == miss0 + 2
