"""The port's query slices end to end: filodb_tpu_torch's QueryEngine vs
the JAX package's over the same seeded counters and gauges.

The JAX memstore ingests the counters (routed to 1 or 2 shards by the
reference shard math); each shard's arrays are then handed to the port's
memstore through load_reference_arrays, so both hold the same series
state.  `sum by (_ns_) (rate(request_total[5m]))` must agree within the
reference's tolerance against the general path (rtol 2e-4, atol 1e-3,
__graft_entry__.py:221), with the JAX engine run once with its Pallas
kernel in interpret mode and once on its general XLA path, dense and
ragged (NaN scrape gaps).  The gauge and min/max panels (last_over_time
via the instant selector, sum/avg/count/min/max_over_time, min/max
aggregates) are held against the JAX engine with its Pallas kernel in
interpret mode and against the f64 oracle tests/oracle.py, dense (rtol
2e-4, atol 1e-3) and ragged (rtol 5e-4, atol 1e-4).
"""
import numpy as np
import pytest

from filodb_tpu.core.records import RecordBatch
from filodb_tpu.ingest.generator import counter_batch, gauge_batch
from filodb_tpu_torch.core.convert import load_reference_arrays
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.parallel.shardmapper import ShardEvent, ShardMapper
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.utils.counters import counters

from test_query_engine import _mk_engine

START_MS = 1_600_000_000_000
START_S = START_MS // 1000
T = 240
END_S = START_S + T * 10
HEADLINE = "sum by (_ns_) (rate(request_total[5m]))"


@pytest.fixture(autouse=True, scope="module")
def _clear_compile_journal():
    """The JAX engine's interpret-mode queries journal a jit compile per
    new shape under their query's trace id, which the reference's health
    model reads as a compile storm for the next 120 s — in whatever test
    file this process runs next.  Clear the journal after this file, as
    tests/test_devicetelem.py does after its own storm."""
    yield
    from filodb_tpu.utils.events import journal
    journal.clear()


def _batch(ragged: bool):
    batch = counter_batch(48, T, start_ms=START_MS, resets=True, seed=7)
    if not ragged:
        return batch
    vals = batch.columns["count"].copy()
    vals[np.random.default_rng(3).random(vals.shape) < 0.1] = np.nan
    return RecordBatch(batch.schema, batch.part_keys, batch.part_idx,
                       batch.timestamps, {"count": vals}, batch.bucket_les)


def _gauges(ragged: bool, shift: float = 0.0):
    batch = gauge_batch(48, T, start_ms=START_MS, seed=5)
    vals = batch.columns["value"] + shift
    if ragged:
        vals = vals.copy()
        vals[np.random.default_rng(4).random(vals.shape) < 0.1] = np.nan
    return RecordBatch(batch.schema, batch.part_keys, batch.part_idx,
                       batch.timestamps, {"value": vals}, batch.bucket_les)


def _port_engine(jax_engine, num_shards, schema="prom-counter",
                 col="count"):
    """A port engine over the same per-shard series as the JAX engine."""
    ms = TimeSeriesMemStore(device="cpu")
    mapper = ShardMapper(num_shards)
    for s in range(num_shards):
        mapper.update_from_event(
            ShardEvent("IngestionStarted", "prometheus", s, "local"))
        sh = jax_engine.source.get_shard("prometheus", s)
        store = sh.stores.get(schema)
        if store is None:
            ms.setup("prometheus", s)
            continue
        t = store.time_used
        parts = [p for p in sh.partitions if p is not None]
        rows = np.array([p.row for p in parts])
        load_reference_arrays(
            ms, "prometheus", s,
            part_key_labels=[{**p.part_key.tags_dict,
                              "_metric_": p.part_key.metric} for p in parts],
            ts=store.ts[rows, :t],
            columns={col: store.cols[col][rows, :t]},
            counts=store.counts[rows], schema=schema)
    return QueryEngine("prometheus", ms, mapper, device="cpu")


def _series(res):
    assert res.error is None, res.error
    return {k.labels: np.asarray(v) for k, _, v in res.series()}


@pytest.fixture(params=["interpret", "general"])
def jax_mode(request, monkeypatch):
    if request.param == "interpret":
        monkeypatch.setenv("FILODB_TPU_FUSED_INTERPRET", "1")
    else:
        monkeypatch.delenv("FILODB_TPU_FUSED_INTERPRET", raising=False)
    return request.param


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("num_shards", [1, 2])
def test_headline_query_matches_jax_engine(num_shards, ragged, jax_mode):
    je = _mk_engine([_batch(ragged)], num_shards=num_shards)
    pe = _port_engine(je, num_shards)
    want = _series(je.query_range(HEADLINE, START_S + 600, 60, END_S))
    before = counters.get("leaf_fused_kernel")
    res = pe.query_range(HEADLINE, START_S + 600, 60, END_S)
    got = _series(res)
    assert counters.get("leaf_fused_kernel") > before
    assert set(got) == set(want) and len(got) == 10
    for k in want:
        assert (np.isnan(got[k]) == np.isnan(want[k])).all()
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-3,
                                   equal_nan=True)
    # the Prometheus envelope carries every group and every present step
    payload = QueryEngine.to_prom_matrix(res)
    assert payload["status"] == "success"
    assert len(payload["data"]["result"]) == len(want)
    # a warm repeat gives the same bits
    again = _series(pe.query_range(HEADLINE, START_S + 600, 60, END_S))
    for k in got:
        np.testing.assert_array_equal(again[k], got[k])


@pytest.mark.parametrize("promql", [
    # a non-counter function over a counter column (the host route)
    "sum by (_ns_) (max_over_time(request_total[5m]))",
    "sum by (_ns_) (request_total)",
    # plan nodes: sort, absent, a top-level subquery
    "sort(rate(request_total[5m]))",
    "absent(rate(request_total[5m]))",
    "rate(request_total[5m:1m])",
])
def test_out_of_slice_query_raises_not_ported(promql):
    """These queries once raised not_ported (the name is kept from then);
    the port now answers each as the JAX engine does: the same series in
    the same order, values within rtol 2e-4 / atol 1e-3, NaN placement
    equal."""
    je = _mk_engine([_batch(False)])
    pe = _port_engine(je, 1)
    want = je.query_range(promql, START_S + 600, 60, END_S)
    got = pe.query_range(promql, START_S + 600, 60, END_S)
    assert want.error is None and got.error is None, (want.error, got.error)
    wk = [k.labels for k, _, _ in want.series()]
    assert [k.labels for k, _, _ in got.series()] == wk
    # absent() over present series answers nothing, in both
    assert len(wk) == (0 if promql.startswith("absent") else
                       10 if "_ns_" in promql else 48)
    for (_, _, w), (_, _, g) in zip(want.series(), got.series()):
        assert (np.isnan(np.asarray(g)) == np.isnan(np.asarray(w))).all()
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=1e-3,
                                   equal_nan=True)


def test_query_over_no_series_is_empty():
    je = _mk_engine([_batch(False)])
    pe = _port_engine(je, 1)
    res = pe.query_range('sum by (_ns_) (rate(nothing_total[5m]))',
                         START_S + 600, 60, END_S)
    assert res.error is None and res.num_series == 0


def test_load_reference_arrays_keeps_order_and_ragged_lengths():
    """Series come out in input order (pid i = input row i) and rows of
    different lengths keep exactly their own samples."""
    rng = np.random.default_rng(9)
    S, T = 7, 12
    ts = START_MS + np.arange(T, dtype=np.int64)[None, :] * 10_000 \
        + np.zeros((S, 1), np.int64)
    vals = rng.random((S, T))
    counts = np.array([12, 5, 12, 0, 9, 5, 1])
    labels = [{"_metric_": "m_total", "_ws_": "w", "i": str(i)}
              for i in range(S)]
    ms = TimeSeriesMemStore(device="cpu")
    n = load_reference_arrays(ms, "ds", 0, part_key_labels=labels, ts=ts,
                              columns={"count": vals}, counts=counts)
    assert n == counts.sum()
    sh = ms.get_shard("ds", 0)
    store = sh.stores["prom-counter"]
    for pid, info in enumerate(sh.partitions):
        assert info.part_key.tags_dict["i"] == str(pid)
        k = counts[pid]
        assert store.counts[info.row] == k
        np.testing.assert_array_equal(store.ts[info.row, :k], ts[pid, :k])
        np.testing.assert_array_equal(store.cols["count"][info.row, :k],
                                      vals[pid, :k])


# ---------------------------------------------------------------- gauges

# query -> (range function, range ms, aggregate, grouped by _ns_) for the
# oracle; the instant selector is last_over_time over the 5 m lookback
GAUGE_QUERIES = {
    "sum by (_ns_) (heap_usage)": ("last_over_time", 300_000, "sum", True),
    "sum(sum_over_time(heap_usage[5m]))":
        ("sum_over_time", 300_000, "sum", False),
    "avg by (_ns_) (avg_over_time(heap_usage[5m]))":
        ("avg_over_time", 300_000, "avg", True),
    "sum(count_over_time(heap_usage[5m]))":
        ("count_over_time", 300_000, "sum", False),
    "min by (_ns_) (min_over_time(heap_usage[5m]))":
        ("min_over_time", 300_000, "min", True),
    "max(max_over_time(heap_usage[5m]))":
        ("max_over_time", 300_000, "max", False),
    "max by (_ns_) (avg_over_time(heap_usage[5m]))":
        ("avg_over_time", 300_000, "max", True),
}

_ENGINES = {}


def _gauge_engines(ragged, num_shards, shift=0.0):
    """(JAX engine, port engine, batch), built once per data set."""
    key = (ragged, num_shards, shift)
    if key not in _ENGINES:
        batch = _gauges(ragged, shift)
        je = _mk_engine([batch], num_shards=num_shards)
        _ENGINES[key] = (je, _port_engine(je, num_shards, "gauge", "value"),
                         batch)
    return _ENGINES[key]


def _oracle(batch, fn, range_ms, op, by_ns):
    """{labels: [W] f64} per tests/oracle.py, NaN = absent."""
    from oracle import eval_series
    S = len(batch.part_keys)
    ts_row = batch.timestamps[:T]
    vals = batch.columns["value"].reshape(S, T)
    wends = np.arange(START_MS + 600_000, END_S * 1000 + 1, 60_000)
    per = np.stack([eval_series(ts_row, vals[s], wends, range_ms, fn)
                    for s in range(S)])
    groups = {}
    for s, pk in enumerate(batch.part_keys):
        labels = ((("_ns_", pk.tags_dict["_ns_"]),) if by_ns else ())
        groups.setdefault(labels, []).append(s)
    out = {}
    reduce = {"sum": np.nansum, "avg": np.nanmean, "min": np.nanmin,
              "max": np.nanmax}[op]
    for labels, rows in groups.items():
        x = per[rows]
        present = (~np.isnan(x)).any(axis=0)
        with np.errstate(all="ignore"):
            import warnings
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                out[labels] = np.where(present, reduce(x, axis=0), np.nan)
    return out


def _assert_close(got, want, ragged):
    rtol, atol = (5e-4, 1e-4) if ragged else (2e-4, 1e-3)
    assert set(got) == set(want)
    for k in want:
        assert (np.isnan(got[k]) == np.isnan(want[k])).all(), k
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   equal_nan=True, err_msg=str(k))


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("num_shards", [1, 2])
@pytest.mark.parametrize("promql", list(GAUGE_QUERIES))
def test_gauge_panel_matches_jax_engine_and_oracle(promql, num_shards,
                                                   ragged, monkeypatch):
    monkeypatch.setenv("FILODB_TPU_FUSED_INTERPRET", "1")
    je, pe, batch = _gauge_engines(ragged, num_shards)
    want = _series(je.query_range(promql, START_S + 600, 60, END_S))
    res = pe.query_range(promql, START_S + 600, 60, END_S)
    got = _series(res)
    assert got
    _assert_close(got, want, ragged)
    _assert_close(got, {k: v for k, v in
                        _oracle(batch, *GAUGE_QUERIES[promql]).items()
                        if not np.isnan(v).all()}, ragged)
    again = _series(pe.query_range(promql, START_S + 600, 60, END_S))
    for k in got:
        np.testing.assert_array_equal(again[k], got[k])


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("num_shards", [1, 2])
def test_max_by_rate_matches_jax_engine(num_shards, ragged, monkeypatch):
    """max by (_ns_) (rate(...)): the rate kernels' per-series mode (K6
    over K1 and K3) under the min/max aggregate."""
    monkeypatch.setenv("FILODB_TPU_FUSED_INTERPRET", "1")
    q = "max by (_ns_) (rate(request_total[5m]))"
    je = _mk_engine([_batch(ragged)], num_shards=num_shards)
    pe = _port_engine(je, num_shards)
    want = _series(je.query_range(q, START_S + 600, 60, END_S))
    got = _series(pe.query_range(q, START_S + 600, 60, END_S))
    assert len(got) == 10
    _assert_close(got, want, ragged)


def test_count_agg_counts_single_sample_windows():
    """Trap 2: the dense count aggregate counts a series present in a
    window of ONE sample for the over_time kinds (minsamp 1; only the
    rate family needs two)."""
    je, pe, _ = _gauge_engines(False, 1)
    q = "count by (_ns_) (sum_over_time(heap_usage[10s]))"
    before = counters.get("leaf_fused_count_host")
    got = _series(pe.query_range(q, START_S + 600, 60, END_S))
    assert counters.get("leaf_fused_count_host") > before
    want = _series(je.query_range(q, START_S + 600, 60, END_S))
    assert len(got) == 10
    _assert_close(got, want, False)
    # every window but the last (past the final sample) holds one sample
    for v in got.values():
        assert not np.isnan(v[:-1]).any() and (v[:-1] >= 4).all()


def test_max_by_over_negative_gauges_across_two_shards(monkeypatch):
    """Trap 3: the inter-shard merge of a max over negative values starts
    from -inf, so the answer is the largest negative value, not 0."""
    monkeypatch.setenv("FILODB_TPU_FUSED_INTERPRET", "1")
    je, pe, _ = _gauge_engines(False, 2, shift=-1000.0)
    q = "max by (_ns_) (avg_over_time(heap_usage[5m]))"
    got = _series(pe.query_range(q, START_S + 600, 60, END_S))
    want = _series(je.query_range(q, START_S + 600, 60, END_S))
    assert len(got) == 10 and all((v < -800).all() for v in got.values())
    _assert_close(got, want, False)


@pytest.mark.parametrize("promql", [
    "stddev by (_ns_) (rate(request_total[5m]))",
    "rate(request_total[5m])",
    "sum by (_ns_) (rate(request_total[5m])) / 2",
    "topk(2, sum by (_ns_) (rate(request_total[5m])))",
])
def test_general_path_query_matches_jax_engine(promql):
    """Queries the fused leaf does not take run the general path
    (ops/rangefns.py, ops/agg.py, the binary operators) and agree with
    the JAX engine's."""
    je = _mk_engine([_batch(False)])
    pe = _port_engine(je, 1)
    want = _series(je.query_range(promql, START_S + 600, 60, END_S))
    got = _series(pe.query_range(promql, START_S + 600, 60, END_S))
    assert want and set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-3,
                                   equal_nan=True)


def test_histogram_quantile_over_series_without_le_is_empty():
    """Classic histogram_quantile groups series by their `le` label; a
    grouping that drops it leaves no bucket ladder, so no series, as in
    the JAX engine."""
    je = _mk_engine([_batch(False)])
    pe = _port_engine(je, 1)
    q = "histogram_quantile(0.9, sum by (le) (rate(request_total[5m])))"
    want = je.query_range(q, START_S + 600, 60, END_S)
    got = pe.query_range(q, START_S + 600, 60, END_S)
    assert want.error is None and got.error is None
    assert want.num_series == got.num_series == 0


def test_rate_over_values_not_reset_corrected_takes_the_general_path():
    """rate over a gauge column (values the mirror did not reset-correct)
    goes to the general path in the reference leaf, which corrects resets
    on the device, not to the in-kernel drops variant; the port does the
    same and launches no fused kernel."""
    je, pe, _ = _gauge_engines(False, 1)
    q = "sum by (_ns_) (rate(heap_usage[5m]))"
    before = counters.get("leaf_fused_kernel")
    got = _series(pe.query_range(q, START_S + 600, 60, END_S))
    assert counters.get("leaf_fused_kernel") == before
    want = _series(je.query_range(q, START_S + 600, 60, END_S))
    assert len(got) == 10
    _assert_close(got, want, False)
