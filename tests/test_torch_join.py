"""The port's general query path end to end: filodb_tpu_torch's
QueryEngine against the JAX package's over the same seeded counters,
gauges and classic `le` histograms, on one and two shards.  The query
shapes are chip_smoke.py's G1-G6 at a small size, plus the binary
joins, set operators, scalar operations and instant functions the
planner now builds.  Tolerances: rtol 2e-4 / atol 1e-3 for the rate
family (__graft_entry__.py:221), rtol 5e-4 / atol 5e-3 for the others
(tests/test_tpu_conformance.py:122); NaN placement must agree, and two
warm answers must have the same bits.
"""
import numpy as np
import pytest

from filodb_tpu.core.partkey import PartKey
from filodb_tpu.core.records import RecordBatch
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.utils.counters import counters

from test_query_engine import _mk_engine
from test_torch_engine import (END_S, START_MS, START_S, T, _batch, _gauges,
                               _port_engine, _series)
from test_torch_ingest import _clear_compile_journal  # noqa: F401

RATE_TOL = (2e-4, 1e-3)
OTHER_TOL = (5e-4, 5e-3)
LES = ["0.005", "0.01", "0.025", "0.05", "0.1", "0.25", "0.5", "1", "2.5",
       "5", "10", "25", "50", "100", "250", "+Inf"]


def _hist_batch(ragged, num_hist=24, seed=13):
    """num_hist classic histograms x 16 cumulative `le` buckets as
    http_latency_bucket counters, _ns_ = App-{h % 10}; ragged: 10% of the
    samples missing (scrape gaps, bucket by bucket)."""
    rng = np.random.default_rng(seed)
    inc = rng.poisson(2.0, (num_hist, T, len(LES))).astype(np.float64)
    cum = np.cumsum(np.cumsum(inc, axis=1), axis=2)      # time, then le
    if ragged:
        cum[rng.random(cum.shape) < 0.1] = np.nan
    keys, rows = [], []
    for h in range(num_hist):
        for b, le in enumerate(LES):
            keys.append(PartKey.make("http_latency_bucket", {
                "_ws_": "demo", "_ns_": f"App-{h % 10}",
                "instance": f"Instance-{h}", "le": le}))
            rows.append(cum[h, :, b])
    S = len(keys)
    ts = np.tile(START_MS + np.arange(T, dtype=np.int64) * 10_000, S)
    return RecordBatch(DEFAULT_SCHEMAS["prom-counter"], keys,
                       np.repeat(np.arange(S, dtype=np.int32), T), ts,
                       {"count": np.concatenate(rows)})


_ENGINES = {}


def _engines(kind, num_shards, ragged=False):
    key = (kind, num_shards, ragged)
    if key not in _ENGINES:
        if kind == "counter":
            je = _mk_engine([_batch(ragged)], num_shards=num_shards)
            pe = _port_engine(je, num_shards)
        elif kind == "gauge":
            je = _mk_engine([_gauges(ragged)], num_shards=num_shards)
            pe = _port_engine(je, num_shards, "gauge", "value")
        else:
            je = _mk_engine([_hist_batch(ragged)], num_shards=num_shards)
            pe = _port_engine(je, num_shards)
        _ENGINES[key] = (je, pe)
    return _ENGINES[key]


def _check(kind, q, num_shards, ragged=False, tol=OTHER_TOL):
    je, pe = _engines(kind, num_shards, ragged)
    want = _series(je.query_range(q, START_S + 600, 60, END_S))
    got = _series(pe.query_range(q, START_S + 600, 60, END_S))
    assert want and set(got) == set(want), q
    for k in want:
        assert (np.isnan(got[k]) == np.isnan(want[k])).all(), (q, k)
        np.testing.assert_allclose(got[k], want[k], rtol=tol[0],
                                   atol=tol[1], equal_nan=True,
                                   err_msg=f"{q} {k}")
    again = _series(pe.query_range(q, START_S + 600, 60, END_S))
    for k in got:
        np.testing.assert_array_equal(again[k], got[k])
    return got


G_QUERIES = {
    "G1": ("counter", "sum by (_ns_) (irate(request_total[5m]))", RATE_TOL),
    "G2": ("gauge", "avg by (_ns_) (deriv(heap_usage[5m]))", OTHER_TOL),
    "G3": ("gauge", "stddev by (_ns_) (heap_usage)", OTHER_TOL),
    "G4": ("gauge", "max by (_ns_) (quantile_over_time(0.9, "
                    "heap_usage[5m]))", OTHER_TOL),
    "G5": ("counter", "sum by (_ns_) (increase(request_total[5m])) / on "
                      "(_ns_) sum by (_ns_) (rate(request_total[5m]))",
           RATE_TOL),
    "G6": ("hist", "histogram_quantile(0.9, sum by (le, _ns_) "
                   "(rate(http_latency_bucket[5m])))", OTHER_TOL),
}


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("num_shards", [1, 2])
@pytest.mark.parametrize("g", sorted(G_QUERIES))
def test_g_query_matches_jax_engine(g, num_shards, ragged):
    kind, q, tol = G_QUERIES[g]
    before = counters.get("leaf_fused_kernel")
    got = _check(kind, q, num_shards, ragged, tol)
    assert len(got) == 10
    if g in ("G5", "G6"):
        # both sides of G5 and G6's bucket rates are fused rate leaves
        assert counters.get("leaf_fused_kernel") > before
    if g == "G5":
        # increase / rate over the same 5 m windows is the range, 300 s
        for v in got.values():
            np.testing.assert_allclose(v[~np.isnan(v)], 300.0, rtol=1e-4)


def test_classic_buckets_load_with_their_le_labels():
    """load_reference_arrays carries le-labelled _bucket series as they
    are: every bucket series keeps its le, and the two stores hold the
    same series."""
    je, pe = _engines("hist", 2)
    n_jax = n_port = 0
    for s in range(2):
        jsh = je.source.get_shard("prometheus", s)
        psh = pe.source.get_shard("prometheus", s)
        jkeys = {p.part_key for p in jsh.partitions if p is not None}
        pkeys = {p.part_key for p in psh.partitions if p is not None}
        assert {(k.metric, k.tags) for k in jkeys} == \
            {(k.metric, k.tags) for k in pkeys}
        assert all("le" in k.tags_dict for k in pkeys)
        n_jax += len(jkeys)
        n_port += len(pkeys)
    assert n_jax == n_port == 24 * len(LES)


JOIN_QUERIES = [
    ("counter", "rate(request_total[5m]) * 60", RATE_TOL),
    ("counter", "2 * sum by (_ns_) (rate(request_total[5m])) - 1", RATE_TOL),
    ("counter", "sum by (_ns_) (rate(request_total[5m])) > bool 40",
     RATE_TOL),
    ("counter", "rate(request_total[5m]) / on (_ns_) group_left "
                "sum by (_ns_) (rate(request_total[5m]))", RATE_TOL),
    ("counter", "sum by (_ns_) (rate(request_total[5m])) / on (_ns_) "
                "group_right rate(request_total[5m])", RATE_TOL),
    ("counter", "topk(2, sum by (_ns_) (rate(request_total[5m])))",
     RATE_TOL),
    ("counter", "bottomk(3, rate(request_total[5m]))", RATE_TOL),
    ("counter", "quantile by (_ns_) (0.9, rate(request_total[5m]))",
     RATE_TOL),
    ("counter", "stdvar(rate(request_total[5m]))", RATE_TOL),
    ("gauge", "heap_usage > 120", OTHER_TOL),
    ("gauge", "abs(heap_usage - 100)", OTHER_TOL),
    ("gauge", "round(heap_usage, 5) + minute(heap_usage)", OTHER_TOL),
    ("gauge", "heap_usage and on (_ns_) (heap_usage > 140)", OTHER_TOL),
    ("gauge", "heap_usage unless on (instance) (heap_usage > 140)",
     OTHER_TOL),
    ("gauge", "heap_usage or on (instance) delta(heap_usage[1m])",
     OTHER_TOL),
    ("gauge", "group by (_ns_) (heap_usage)", OTHER_TOL),
    ("gauge", "count_values by (_ns_) (\"v\", round(heap_usage / 50))",
     OTHER_TOL),
    ("gauge", "sum by (_ns_) (rate(heap_usage[5m]))", RATE_TOL),
    ("gauge", "max by (_ns_) (holt_winters(heap_usage[2m], 0.5, 0.5))",
     OTHER_TOL),
]


@pytest.mark.parametrize("num_shards", [1, 2])
@pytest.mark.parametrize("kind,q,tol", JOIN_QUERIES,
                         ids=[q for _, q, _ in JOIN_QUERIES])
def test_general_query_matches_jax_engine(kind, q, tol, num_shards):
    _check(kind, q, num_shards, tol=tol)


@pytest.mark.parametrize("q", [
    "rate(request_total[5m]) + on (_ns_) rate(request_total[5m])",
    "rate(request_total[5m]) + on (_ns_) group_left "
    "rate(request_total[5m])",
])
def test_join_cardinality_errors_come_back_in_the_result(q):
    """Many-to-many and one-to-one-with-many matches are query errors, as
    in the reference: in the result, not raised."""
    je, pe = _engines("counter", 1)
    want = je.query_range(q, START_S + 600, 60, END_S)
    got = pe.query_range(q, START_S + 600, 60, END_S)
    assert want.error and got.error
    assert got.error.split(":")[0] == want.error.split(":")[0]


def test_scalar_arithmetic_and_time():
    """Scalar leaves: literals, scalar arithmetic and time() as the
    scalar side of a vector operation."""
    ms = TimeSeriesMemStore(device="cpu")
    ms.setup("prometheus", 0)
    from filodb_tpu_torch.query.engine import QueryEngine
    eng = QueryEngine("prometheus", ms, device="cpu")
    res = eng.query_range("2 * 3 + 1", START_S, 60, START_S + 120)
    assert res.error is None
    np.testing.assert_array_equal(_series(res)[()], [7.0, 7.0, 7.0])
    je, pe = _engines("gauge", 1)
    got = _check("gauge", "heap_usage - time()", 1)
    assert all((v[~np.isnan(v)] < -1.5e9).all() for v in got.values())
    want = _series(je.query_range("time()", START_S, 60, START_S + 120))
    got = _series(pe.query_range("time()", START_S, 60, START_S + 120))
    np.testing.assert_array_equal(got[()], want[()])


@pytest.mark.parametrize("promql", [
    "sort(heap_usage)",
    "absent(heap_usage)",
    "label_replace(heap_usage, \"a\", \"$1\", \"_ns_\", \"(.*)\")",
    "max_over_time(heap_usage[10m:1m])",
    "heap_usage @ 1600001000",
    "heap_usage * scalar(sum(heap_usage))",
    "vector(1)",
])
def test_out_of_slice_general_query_raises_not_ported(promql):
    """These plan nodes once raised not_ported (the name is kept from
    then); the port now answers each as the JAX engine does: the same
    series in the same order (sort ranks by f64 means), values within
    rtol 5e-4 / atol 5e-3, NaN placement equal."""
    je, pe = _engines("gauge", 1)
    want = je.query_range(promql, START_S + 600, 60, END_S)
    got = pe.query_range(promql, START_S + 600, 60, END_S)
    assert want.error is None and got.error is None, (want.error, got.error)
    wk = [k.labels for k, _, _ in want.series()]
    assert [k.labels for k, _, _ in got.series()] == wk
    assert wk or promql.startswith("absent")
    for (_, _, w), (_, _, g) in zip(want.series(), got.series()):
        assert (np.isnan(np.asarray(g)) == np.isnan(np.asarray(w))).all()
        np.testing.assert_allclose(g, w, rtol=OTHER_TOL[0],
                                   atol=OTHER_TOL[1], equal_nan=True)
