"""Native histogram columns through the port: filodb_tpu_torch's
QueryEngine vs the JAX package's over the same seeded [S, T, B] bucket
columns (prom-histogram schema, column `h`, with `bucket_les`).

The JAX memstore ingests the histograms (routed to 1 or 2 shards by the
reference shard math); each shard's arrays are carried into the port's
memstore through load_reference_arrays, as tests/test_torch_engine.py
does, so both hold the same state.  The JAX engine runs once with its
fused leaf in interpret mode (FILODB_TPU_FUSED_INTERPRET=1) and once on
its general path.  Tolerances are the rate family's, rtol 2e-4 / atol
1e-3 (__graft_entry__.py:221), unless a test states a tighter one.

Also here: the mirror's 3-d upload against the reference's arrays, the
port's memory/histogram.py against the reference's on the cases of
tests/test_hist_scheme.py, bucket-scheme changes (in one store and
across shards), histograms.test replayed through the native schema, and
bench.py's 13 dashboard panels (COVERAGE_QUERIES) through both engines.
"""
import numpy as np
import pytest
import torch

from filodb_tpu.core.blockstore import DenseSeriesStore as JStore
from filodb_tpu.core.devicecache import DeviceMirror as JMirror
from filodb_tpu.core.records import RecordBatch
from filodb_tpu.core.schemas import PROM_HISTOGRAM as JHIST
from filodb_tpu.ingest.generator import (counter_batch, gauge_batch,
                                         gauge_part_keys, histogram_batch)
from filodb_tpu.memory import histogram as jh
from filodb_tpu_torch.core.blockstore import DenseSeriesStore as TStore
from filodb_tpu_torch.core.convert import load_reference_arrays
from filodb_tpu_torch.core.devicecache import DeviceMirror, store_nbytes
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.core.schemas import PROM_HISTOGRAM as THIST
from filodb_tpu_torch.memory import histogram as th
from filodb_tpu_torch.parallel.shardmapper import ShardEvent, ShardMapper
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.utils.counters import counters

from test_query_engine import _mk_engine

START_MS = 1_600_000_000_000
START_S = START_MS // 1000
T = 120
END_S = START_S + (T - 1) * 10
PANEL = "histogram_quantile(0.9, sum(rate(http_latency[5m])) by (_ns_))"
RTOL, ATOL = 2e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _clear_compile_journal():
    """The JAX engine's interpret-mode queries journal a jit compile per
    new shape, which the reference's health model reads as a compile
    storm in whatever test file runs next; clear it after this file."""
    yield
    from filodb_tpu.utils.events import journal
    journal.clear()


@pytest.fixture(params=["interpret", "general"])
def jax_mode(request, monkeypatch):
    if request.param == "interpret":
        monkeypatch.setenv("FILODB_TPU_FUSED_INTERPRET", "1")
    else:
        monkeypatch.delenv("FILODB_TPU_FUSED_INTERPRET", raising=False)
    return request.param


def _hist(ragged: bool, S=40, B=8, seed=11):
    """histogram_batch; ragged drops ~8% of whole scrapes (every bucket
    and sum/count of a series at that sample)."""
    b = histogram_batch(S, T, num_buckets=B, start_ms=START_MS, seed=seed)
    les = np.asarray(b.bucket_les, np.float64).copy()
    les[-1] = np.inf
    cols = {k: v.copy() for k, v in b.columns.items()}
    if ragged:
        hole = np.random.default_rng(seed + 1).random(S * T) < 0.08
        for v in cols.values():
            v[hole] = np.nan
    return RecordBatch(b.schema, b.part_keys, b.part_idx, b.timestamps,
                       cols, les)


def _carry(jax_engine, ms, num_shards, schemas):
    """Load each JAX shard's stores of `schemas` into the port memstore."""
    for s in range(num_shards):
        sh = jax_engine.source.get_shard("prometheus", s)
        ms.setup("prometheus", s)
        for schema in schemas:
            store = sh.stores.get(schema)
            if store is None:
                continue
            t = store.time_used
            parts = [p for p in sh.partitions
                     if p is not None and p.schema_name == schema]
            rows = np.array([p.row for p in parts])
            load_reference_arrays(
                ms, "prometheus", s,
                part_key_labels=[{**p.part_key.tags_dict,
                                  "_metric_": p.part_key.metric}
                                 for p in parts],
                ts=store.ts[rows, :t],
                columns={name: col[rows, :t]
                         for name, col in store.cols.items()
                         if col is not None},
                counts=store.counts[rows], schema=schema,
                bucket_les=store.bucket_les)


def _port_engine(jax_engine, num_shards, schemas=("prom-histogram",)):
    ms = TimeSeriesMemStore(device="cpu")
    mapper = ShardMapper(num_shards)
    for s in range(num_shards):
        mapper.update_from_event(
            ShardEvent("IngestionStarted", "prometheus", s, "local"))
    _carry(jax_engine, ms, num_shards, schemas)
    return QueryEngine("prometheus", ms, mapper, device="cpu")


def _series(res):
    assert res.error is None, res.error
    return {k.labels: np.asarray(v, np.float64) for k, _, v in res.series()}


def _agree(got, want, rtol=RTOL, atol=ATOL):
    assert set(got) == set(want) and want
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert (np.isnan(got[k]) == np.isnan(want[k])).all(), k
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   equal_nan=True, err_msg=str(k))


def _q(engine, promql, start=START_S + 600, end=END_S):
    return engine.query_range(promql, start, 60, end)


_ENGINES = {}


def _engines(ragged, num_shards):
    key = (ragged, num_shards)
    if key not in _ENGINES:
        je = _mk_engine([_hist(ragged)], num_shards=num_shards)
        _ENGINES[key] = (je, _port_engine(je, num_shards))
    return _ENGINES[key]


# ------------------------------------------------- the fused histogram leaf

@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("num_shards", [1, 2])
@pytest.mark.parametrize("promql", [
    "sum(rate(http_latency[5m])) by (_ns_)",
    PANEL,
    "histogram_quantile(0.5, sum(increase(http_latency[5m])))",
])
def test_native_sum_rate_and_quantile_match_jax_engine(promql, num_shards,
                                                       ragged, jax_mode):
    je, pe = _engines(ragged, num_shards)
    want = _series(_q(je, promql))
    before = counters.get("leaf_fused_kernel")
    got = _series(_q(pe, promql))
    assert counters.get("leaf_fused_kernel") >= before + num_shards
    _agree(got, want)
    # a warm repeat (cached plan, padded values and slots) gives the bits
    again = _series(_q(pe, promql))
    for k in got:
        np.testing.assert_array_equal(again[k], got[k])


def test_native_sum_rate_block_is_g_w_b_and_skipped_by_the_matrix():
    """sum(rate(h)) leaves a [G, W, B] block with the store's bounds; the
    Prometheus matrix envelope skips 3-d blocks, as the reference's."""
    _, pe = _engines(False, 1)
    res = _q(pe, "sum(rate(http_latency[5m])) by (_ns_)")
    (block,) = res.blocks
    les = pe.source.get_shard("prometheus", 0) \
        .stores["prom-histogram"].bucket_les
    assert block.is_histogram and block.values.shape[2] == les.size
    np.testing.assert_array_equal(block.bucket_les, les)
    payload = QueryEngine.to_prom_matrix(res)
    assert payload["status"] == "success"
    assert payload["data"]["result"] == []
    # ... while the quantile over it is an ordinary matrix
    q = QueryEngine.to_prom_matrix(_q(pe, PANEL))
    assert len(q["data"]["result"]) == block.num_series


def test_fused_leaf_matches_the_port_general_path():
    """The fused leaf (group slots gid * B + b) and the general path
    (flatten, rate, reshape, hist_sum in CSR order) agree: the layouts of
    the flatten, the slot ids and the presenter's reshape are the same."""
    _, pe = _engines(True, 1)
    fused_ans = _series(_q(pe, PANEL))
    shard = pe.source.get_shard("prometheus", 0)
    mirror = shard.stores["prom-histogram"].device_mirror
    snap = mirror._snap
    # the same store with its grid marked unshared takes the general path
    mirror._snap = type(snap)(**{**snap.__dict__, "uniform_grid": False,
                                 "ts_row0": None})
    try:
        before = counters.get("leaf_fused_kernel")
        general = _series(_q(pe, PANEL))
        assert counters.get("leaf_fused_kernel") == before
    finally:
        mirror._snap = snap
    _agree(general, fused_ans, rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------- general path

@pytest.mark.parametrize("num_shards", [1, 2])
@pytest.mark.parametrize("promql", [
    "histogram_quantile(0.9, rate(http_latency[5m]))",
    "histogram_max_quantile(0.5, rate(http_latency[5m]))",
    "histogram_bucket(16, rate(http_latency[5m]))",
    "histogram_bucket(+Inf, increase(http_latency[5m]))",
    "histogram_quantile(0.9, abs(rate(http_latency[5m])))",
    "histogram_quantile(0.9, sum by (_ns_) "
    "(rate(http_latency{_ns_=~\"App-[01]\"}[5m])))",
])
def test_general_histogram_path_matches_jax_engine(promql, num_shards):
    je, pe = _engines(False, num_shards)
    _agree(_series(_q(pe, promql)), _series(_q(je, promql)))


def test_histogram_bucket_without_such_bound_is_empty():
    """No bucket has le 3: every value NaN, so no series, in both."""
    je, pe = _engines(False, 1)
    promql = "histogram_bucket(3, rate(http_latency[5m]))"
    assert _series(_q(pe, promql)) == {} == _series(_q(je, promql))


def test_histogram_quantile_general_path_on_ragged_rows():
    je, pe = _engines(True, 2)
    promql = "histogram_quantile(0.75, rate(http_latency[5m]))"
    _agree(_series(_q(pe, promql)), _series(_q(je, promql)))


def test_hist_sum_over_general_path_is_deterministic():
    """sum over [S, W, B] blocks sums in the fixed CSR order: two runs,
    the same bits."""
    _, pe = _engines(True, 1)
    promql = "histogram_quantile(0.9, sum by (_ns_) (abs(rate(" \
        "http_latency[5m]))))"
    a, b = _series(_q(pe, promql)), _series(_q(pe, promql))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("op", ["max", "avg", "count", "min", "group",
                                "stddev", "topk", "quantile"])
def test_other_aggregates_over_histogram_blocks_are_errors(op):
    """Only sum aggregates buckets; the reference answers the others with
    an error in the result too."""
    je, pe = _engines(False, 1)
    arg = "2, " if op in ("topk", "quantile") else ""
    promql = f"{op}({arg}rate(http_latency[5m]))"
    assert _q(je, promql).error is not None
    assert "only sum aggregates buckets" in _q(pe, promql).error


@pytest.mark.parametrize("promql", [
    "histogram_quantile(0.9, http_latency)",        # the host route
    "sum(max_over_time(http_latency[5m]))",
])
def test_native_histogram_instant_selector_takes_the_host_route(promql):
    """A non-counter function over the counter column `h` needs its raw
    values: the windowed host gather, [S, T, B], as in the reference.
    The answers agree with the JAX engine's (rtol 2e-4 / atol 1e-3)."""
    je, pe = _engines(False, 1)
    want, got = _q(je, promql), _q(pe, promql)
    assert want.error is None and got.error is None, (want.error, got.error)
    w = {k.labels: np.asarray(v) for k, _, v in want.series()}
    g = {k.labels: np.asarray(v) for k, _, v in got.series()}
    assert w and set(g) == set(w)
    for k in w:
        assert (np.isnan(g[k]) == np.isnan(w[k])).all()
        np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                   equal_nan=True)


# ----------------------------------------------------------- scheme changes

LES_A = [2.0, 4.0, 8.0, 16.0, float("inf")]
LES_B = [1.0, 4.0, 16.0, 64.0, float("inf")]


def _scheme_batch(S, n, les, t0, seed, keys=None):
    """tests/test_hist_scheme.py's _hist_batch: explicit bounds."""
    rng = np.random.default_rng(seed)
    keys = keys or gauge_part_keys(S, "http_latency")
    B = len(les)
    part_idx = np.repeat(np.arange(S, dtype=np.int32), n)
    ts = np.tile(t0 + np.arange(n, dtype=np.int64) * 10_000, S)
    inc = rng.poisson(3.0, size=(S, n, B))
    hist = np.cumsum(np.cumsum(inc, axis=1), axis=2).astype(np.float64)
    count = hist[:, :, -1]
    return RecordBatch(JHIST, keys, part_idx, ts,
                       {"sum": (count * 7.0).ravel(), "count": count.ravel(),
                        "h": hist.reshape(S * n, B)},
                       bucket_les=np.asarray(les, np.float64))


def test_scheme_change_between_two_ingests_matches_jax_engine():
    """The store widens to the union scheme mid-retention (the port's
    blockstore, now with memory/histogram.py) and the queries over both
    halves agree with the reference."""
    half = 60
    batches = [_scheme_batch(6, half, LES_A, START_MS, 1),
               _scheme_batch(6, half, LES_B, START_MS + half * 10_000, 2)]
    je = _mk_engine(batches)
    pe = _port_engine(je, 1)
    # the port's own ingest of the same two batches widens the same way
    ms = TimeSeriesMemStore(device="cpu")
    sh = ms.setup("prometheus", 0)
    from filodb_tpu_torch.core.partkey import PartKey
    keys = [PartKey.make(k.metric, k.tags_dict)
            for k in batches[0].part_keys]
    for b in batches:
        S = len(b.part_keys)
        sh.ingest_columns("prom-histogram", keys,
                          b.timestamps.reshape(S, -1),
                          {c: v.reshape((S, -1) + v.shape[1:])
                           for c, v in b.columns.items()},
                          bucket_les=b.bucket_les)
    store = sh.stores["prom-histogram"]
    np.testing.assert_array_equal(store.bucket_les,
                                  th.union_les(LES_A, LES_B))
    jstore = je.source.get_shard("prometheus", 0).stores["prom-histogram"]
    np.testing.assert_array_equal(
        store.cols["h"][:6, :2 * half], jstore.cols["h"][:6, :2 * half])
    own = QueryEngine("prometheus", ms, device="cpu")
    for promql in (PANEL.replace("by (_ns_)", ""),
                   "histogram_quantile(0.5, rate(http_latency[5m]))"):
        want = _series(_q(je, promql, START_S + 350, START_S + 1190))
        _agree(_series(_q(pe, promql, START_S + 350, START_S + 1190)), want)
        _agree(_series(_q(own, promql, START_S + 350, START_S + 1190)), want)


@pytest.fixture
def two_scheme_shards():
    """Two shards whose series carry different bucket schemes."""
    keys = gauge_part_keys(8, "http_latency")
    mapper = ShardMapper(2)
    shard_of = np.asarray([mapper.ingestion_shard(
        k.shard_key_hash(), k.partition_hash(), 0) for k in keys])
    assert set(shard_of) == {0, 1}
    je = _mk_engine([], num_shards=2)
    for s, les in ((0, LES_A), (1, LES_B)):
        sk = [k for k, o in zip(keys, shard_of) if o == s]
        je.source.get_shard("prometheus", s).ingest(
            _scheme_batch(len(sk), T, les, START_MS, 3 + s, keys=sk))
    return je, _port_engine(je, 2)


@pytest.mark.parametrize("promql", [
    "histogram_quantile(0.9, sum(rate(http_latency[5m])))",
    "histogram_quantile(0.5, sum by (_ns_) (rate(http_latency[5m])))",
    "sum(rate(http_latency[5m]))",
])
def test_two_shards_with_different_schemes_merge_on_the_union(
        two_scheme_shards, promql, jax_mode):
    je, pe = two_scheme_shards
    got, want = _series(_q(pe, promql)), _series(_q(je, promql))
    _agree(got, want)
    res = _q(pe, promql)
    if "quantile" not in promql:
        np.testing.assert_array_equal(res.blocks[0].bucket_les,
                                      th.union_les(LES_A, LES_B))


def test_hist_sum_partials_without_bounds_refuse_to_merge():
    """One partial with bounds and one without, of different widths:
    the reference's ValueError."""
    from filodb_tpu_torch.query.execbase import AggPartial, reduce_partials
    from filodb_tpu_torch.query.rangevector import RangeVectorKey
    k = [RangeVectorKey(())]
    w = np.arange(3)
    a = AggPartial("hist_sum", k, w, comp=np.ones((1, 3, 6)),
                   bucket_les=np.asarray(LES_A))
    b = AggPartial("hist_sum", k, w, comp=np.ones((1, 3, 5)))
    with pytest.raises(ValueError, match="no bucket boundaries"):
        reduce_partials([a, b])
    # the same width and no known disagreement merges by index
    c = AggPartial("hist_sum", k, w, comp=np.ones((1, 3, 6)))
    np.testing.assert_array_equal(reduce_partials([a, c]).comp,
                                  np.full((1, 3, 6), 2.0))


def test_raw_concat_rebuckets_shards_onto_the_union(two_scheme_shards):
    """Raw blocks of two shards with different schemes concatenate on
    the union scheme (rebucketed values and bases) and count it.  No
    query reaches this yet: a raw leaf over the counter column `h` needs
    the host route, so the blocks come from the leaves' mirror gathers."""
    from filodb_tpu_torch.core.index import Equals
    from filodb_tpu_torch.query.leafexec import MultiSchemaPartitionsExec
    from filodb_tpu_torch.query.nonleaf import DistConcatExec
    from filodb_tpu_torch.query.rangevector import QueryContext, QueryStats
    from filodb_tpu_torch.query.transformers import PeriodicSamplesMapper
    _, pe = two_scheme_shards
    ctx = QueryContext(device=torch.device("cpu"))
    parts = []
    for s in (0, 1):
        leaf = MultiSchemaPartitionsExec(
            ctx, "prometheus", s, [Equals("_metric_", "http_latency")],
            START_MS, START_MS + T * 10_000)
        leaf.add_transformer(PeriodicSamplesMapper(
            START_MS + 600_000, 60_000, END_S * 1000, 300_000, "rate"))
        parts.append(leaf._do_execute(pe.source)[0])
    before = counters.get("hist_concat_rebuckets")
    raw = DistConcatExec(ctx, []).compose(parts, QueryStats())
    assert counters.get("hist_concat_rebuckets") == before + 1
    union = th.union_les(LES_A, LES_B)
    np.testing.assert_array_equal(raw.bucket_les, union)
    assert raw.values.shape[2] == union.size
    assert raw.vbase.shape == (raw.values.shape[0], union.size)
    row = 0
    for p in parts:
        idx = th.rebucket(np.arange(len(p.bucket_les)), p.bucket_les, union)
        n = p.values.shape[0]
        np.testing.assert_array_equal(
            raw.values[row:row + n].numpy(), p.values[..., idx].numpy())
        np.testing.assert_array_equal(
            raw.vbase[row:row + n].numpy(), p.vbase[..., idx].numpy())
        row += n
    assert len(raw.keys) == row
    # a shard with no bounds beside one with them: the reference's error
    bare = type(parts[1])(**{**parts[1].__dict__, "bucket_les": None})
    with pytest.raises(ValueError, match="no bucket boundaries"):
        DistConcatExec(ctx, []).compose([parts[0], bare], QueryStats())


# ------------------------------------------------------- the 3-d mirror

def test_mirror_3d_refresh_matches_the_reference_arrays():
    """_refresh of a [S, T, B] column: int32 offsets exactly, rebased f32
    values within f32 rounding of the reference's f64, vbase [S, B]
    exactly, col_finite and vbase_valid as the reference's; with resets,
    whole-scrape holes, a +Inf bucket sample and an all-NaN series."""
    rng = np.random.default_rng(5)
    S, n, B = 9, 50, 4
    ts = START_MS + np.arange(n, dtype=np.int64) * 10_000
    inc = rng.poisson(4.0, size=(S, n, B)).astype(np.float64)
    h = np.cumsum(np.cumsum(inc, axis=1), axis=2) + 1e6
    h[2, 30:] -= h[2, 29] * 0.5                       # a counter reset
    h[rng.random((S, n)) < 0.1] = np.nan               # whole scrapes
    h[4, 7, 1] = np.inf
    h[S - 1] = np.nan
    les = np.array([1.0, 5.0, 25.0, np.inf])
    cols = {"sum": h[..., -1] * 3.0, "count": h[..., -1], "h": h}
    stores = []
    for cls, schema in ((JStore, JHIST), (TStore, THIST)):
        st = cls(schema)
        rows = np.array([st.new_row() for _ in range(S)])
        st.append_grid(rows, np.tile(ts, (S, 1)), cols, bucket_les=les)
        stores.append(st)
    js, ts_ = stores
    jm = JMirror()
    jm._refresh(js)
    tm = DeviceMirror(device="cpu")
    tm._refresh(ts_)
    jsnap, tsnap = jm._snap, tm._snap
    assert store_nbytes(ts_) == (S * n * 4 + 2 * (S * n * 4 + S * 8)
                                 + B * (S * n * 4 + S * 8))
    np.testing.assert_array_equal(tsnap.ts_off.numpy(),
                                  np.asarray(jsnap.ts_off))
    for name in ("sum", "count", "h"):
        want = np.asarray(jsnap.cols[name], np.float64)
        got = tsnap.cols[name].double().numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                   equal_nan=True)
        np.testing.assert_array_equal(tsnap.vbases[name].numpy(),
                                      np.asarray(jsnap.vbases[name]))
        np.testing.assert_array_equal(tsnap.vbase_valid[name],
                                      jsnap.vbase_valid[name])
        assert tsnap.col_finite[name] == jsnap.col_finite[name]
    assert tsnap.vbases["h"].shape == (S, B)
    assert tsnap.col_finite["h"] is False
    # the gather keeps the bucket axis
    _, cols_g, vb_g, _ = tm.gather_cached(np.array([3, 1]))
    np.testing.assert_array_equal(cols_g["h"].numpy(),
                                  tsnap.cols["h"][[3, 1]].numpy())
    assert vb_g["h"].shape == (2, B)


def test_mirror_3d_refresh_finite_store_is_dense():
    b = _hist(False, S=5, B=3)
    stores = []
    for cls, schema in ((JStore, JHIST), (TStore, THIST)):
        st = cls(schema)
        rows = np.array([st.new_row() for _ in range(5)])
        st.append_grid(rows, b.timestamps.reshape(5, T),
                       {c: v.reshape((5, T) + v.shape[1:])
                        for c, v in b.columns.items()},
                       bucket_les=b.bucket_les)
        stores.append(st)
    jm, tm = JMirror(), DeviceMirror(device="cpu")
    jm._refresh(stores[0])
    tm._refresh(stores[1])
    assert tm._snap.col_finite["h"] is True is jm._snap.col_finite["h"]
    assert tm._snap.uniform_grid and jm._snap.uniform_grid


@pytest.mark.parametrize("as_tensor", [False, True])
def test_bucket_row_layout_round_trips(as_tensor):
    """ops/hist's one bucket-row layout: row s * B + b is bucket b of
    series s, slot g * B + b bucket b of group g, and from_bucket_rows
    undoes bucket_rows, for arrays and tensors alike."""
    from filodb_tpu_torch.ops import hist as thist
    x = np.arange(3 * 5 * 4, dtype=np.float64).reshape(3, 5, 4)
    xx = torch.from_numpy(x) if as_tensor else x
    rows = thist.bucket_rows(xx)
    assert tuple(rows.shape) == (12, 5)
    np.testing.assert_array_equal(np.asarray(rows[2 * 4 + 3]), x[2, :, 3])
    np.testing.assert_array_equal(np.asarray(thist.from_bucket_rows(rows, 4)),
                                  x)
    np.testing.assert_array_equal(thist.bucket_slots([0, 2, 1], 4),
                                  [0, 1, 2, 3, 8, 9, 10, 11, 4, 5, 6, 7])


# ------------------------------------------- memory/histogram.py itself

@pytest.mark.parametrize("src,dst", [
    (LES_A, LES_B), (LES_B, LES_A), (LES_A, jh.union_les(LES_A, LES_B)),
    ([3.0, 6.0, 12.0, 24.0, 48.0, np.inf], LES_A),
    ([1.0, 2.0], [0.5, 1.0, 1.5, 2.0, 3.0]),
])
def test_port_histogram_module_matches_the_reference(src, dst):
    rng = np.random.default_rng(len(src) * 7 + len(dst))
    mat = np.cumsum(rng.poisson(2.0, size=(3, 4, len(src))), axis=-1) \
        .astype(np.float64)
    np.testing.assert_array_equal(th.union_les(src, dst),
                                  jh.union_les(src, dst))
    np.testing.assert_array_equal(th.rebucket(mat, src, dst),
                                  jh.rebucket(mat, src, dst))


def test_rebucket_exact_at_shared_boundaries_as_the_reference():
    """tests/test_hist_scheme.py::test_rebucket_exact_at_shared_boundaries
    on the port's module."""
    src = np.array([1.0, 3.0, 6.0, 10.0, 12.0])
    union = th.union_les(LES_A, LES_B)
    out = th.rebucket(src, LES_A, union)
    for le, v in zip(LES_A, src):
        assert out[list(union).index(le)] == v
    assert (np.diff(out) >= 0).all()


def test_port_bucket_schemes_match_the_reference():
    for args in ((2.0, 2.0, 8, True), (0.5, 10.0, 5, False)):
        assert th.HistogramBuckets.geometric(*args).les == \
            jh.HistogramBuckets.geometric(*args).les
    assert th.default_buckets(6).les == jh.default_buckets(6).les
    c = th.HistogramBuckets.custom([1, 2, np.inf])
    assert c.num_buckets == 3
    np.testing.assert_array_equal(
        c.as_array(), jh.HistogramBuckets.custom([1, 2, np.inf]).as_array())


# --------------------------------------- the dashboard mix, both engines

# bench.py:889-911 COVERAGE_QUERIES: (name, promql, ragged_ok)
COVERAGE_QUERIES = [
    ("sum_rate", 'sum(rate(request_total[5m]))', True),
    ("sum_by_rate", 'sum by (_ns_)(rate(request_total[5m]))', True),
    ("avg_rate", 'avg by (_ns_)(rate(request_total[5m]))', True),
    ("max_rate", 'max by (_ns_)(rate(request_total[5m]))', True),
    ("count_rate", 'count by (_ns_)(rate(request_total[5m]))', True),
    ("sum_increase", 'sum(increase(request_total[5m]))', True),
    ("instant_sum", 'sum by (_ns_)(heap_usage)', True),
    ("sum_over_time", 'sum(sum_over_time(heap_usage[5m]))', True),
    ("avg_over_time", 'avg by (_ns_)(avg_over_time(heap_usage[5m]))',
     True),
    ("count_over_time", 'sum(count_over_time(heap_usage[5m]))', True),
    ("min_over_time", 'min by (_ns_)(min_over_time(heap_usage[5m]))',
     True),
    ("max_over_time", 'max(max_over_time(heap_usage[5m]))', True),
    ("hist_quantile",
     'histogram_quantile(0.9, sum(rate(http_latency[5m])) by (_ns_))',
     False),
]

_MIX = {}


def _mix_engines(num_shards):
    """Counters, gauges and native histograms in one store, as the bench's
    dashboard reads them."""
    if num_shards not in _MIX:
        je = _mk_engine([counter_batch(30, T, start_ms=START_MS, seed=7),
                         gauge_batch(30, T, start_ms=START_MS, seed=5),
                         _hist(False, S=30)], num_shards=num_shards)
        _MIX[num_shards] = (je, _port_engine(
            je, num_shards, ("prom-counter", "gauge", "prom-histogram")))
    return _MIX[num_shards]


@pytest.mark.parametrize("num_shards", [1, 2])
@pytest.mark.parametrize("name,promql,ragged_ok", COVERAGE_QUERIES,
                         ids=[q[0] for q in COVERAGE_QUERIES])
def test_every_dashboard_panel_agrees_with_jax_engine(name, promql,
                                                      ragged_ok, num_shards,
                                                      jax_mode):
    je, pe = _mix_engines(num_shards)
    want = _series(_q(je, promql))
    res = _q(pe, promql)
    _agree(_series(res), want)
    assert len(QueryEngine.to_prom_matrix(res)["data"]["result"]) \
        == len(want)
