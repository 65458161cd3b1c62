"""The leaf's host route and scan cap through the port: filodb_tpu_torch's
QueryEngine against the JAX package's over the same seeded data, carried
into the port's memstore as tests/test_torch_engine.py does.

- A non-counter function over a counter column (changes, resets, delta,
  idelta, max_over_time, the instant selector) reads the raw values
  through the windowed host gather: dense and ragged counters with
  resets, on one and two shards.
- Native histogram instant forms ([S, T, B] host gathers).
- The router, forced with FILODB_TPU_FORCE_HOST_ROUTE=1 on both engines,
  for sum/avg/count/min/max over rate, increase and the *_over_time
  family; the port's leaf_host_routed counter must rise wherever the
  reference's host route takes the leaf.
- The scan cap: tests/test_query_engine.py's cases through both engines,
  with the same error text.

Tolerances: rtol 2e-4 / atol 1e-3 (__graft_entry__.py:221); NaN
placement must agree exactly.
"""
import numpy as np
import pytest

from filodb_tpu.ingest.generator import counter_batch
from filodb_tpu_torch.config import settings
from filodb_tpu_torch.query import leafexec
from filodb_tpu_torch.query.rangevector import PlannerParams
from filodb_tpu_torch.utils.counters import counters

from test_query_engine import _mk_engine
from test_torch_engine import (END_S, START_MS, START_S, _batch, _gauges,
                               _port_engine)
import test_torch_hist_native as hn
from test_torch_ingest import _clear_compile_journal  # noqa: F401

RTOL, ATOL = 2e-4, 1e-3

_ENGINES = {}


def _engines(kind, num_shards, ragged=False):
    key = (kind, num_shards, ragged)
    if key not in _ENGINES:
        if kind == "counter":
            je = _mk_engine([_batch(ragged)], num_shards=num_shards)
            pe = _port_engine(je, num_shards)
        else:
            je = _mk_engine([_gauges(ragged)], num_shards=num_shards)
            pe = _port_engine(je, num_shards, "gauge", "value")
        _ENGINES[key] = (je, pe)
    return _ENGINES[key]


def _agree(want, got, ordered=False):
    assert want.error is None and got.error is None, (want.error, got.error)
    w = [(k.labels, np.asarray(v)) for k, _, v in want.series()]
    g = [(k.labels, np.asarray(v)) for k, _, v in got.series()]
    if not ordered:
        w, g = sorted(w, key=lambda x: x[0]), sorted(g, key=lambda x: x[0])
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, wv), (_, gv) in zip(w, g):
        assert (np.isnan(gv) == np.isnan(wv)).all(), k
        np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=ATOL,
                                   equal_nan=True, err_msg=str(k))
    return len(w)


RAW_QUERIES = [
    "sum by (_ns_) (changes(request_total[5m]))",
    "sum by (_ns_) (resets(request_total[5m]))",
    "sum by (_ns_) (delta(request_total[5m]))",
    "avg by (_ns_) (idelta(request_total[5m]))",
    "max_over_time(request_total[5m])",
    "sum by (_ns_) (request_total)",
]


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("num_shards", [1, 2])
@pytest.mark.parametrize("promql", RAW_QUERIES)
def test_non_counter_function_over_counter_reads_raw_values(promql,
                                                            num_shards,
                                                            ragged):
    je, pe = _engines("counter", num_shards, ragged)
    want = je.query_range(promql, START_S + 600, 60, END_S)
    got = pe.query_range(promql, START_S + 600, 60, END_S)
    assert _agree(want, got) == (48 if "by" not in promql else 10)


def test_max_over_time_is_the_raw_maximum_across_a_reset():
    """The mirror holds counters reset-corrected; max_over_time must read
    the raw values, so a window holding a reset answers the raw maximum,
    below the corrected one."""
    je, pe = _engines("counter", 1)
    res = pe.query_range("max_over_time(request_total[5m])",
                         START_S + 600, 60, END_S)
    assert res.error is None
    raw = _batch(False).columns["count"]
    assert res.num_series == 48
    top = max(float(np.asarray(v)[~np.isnan(v)].max())
              for _, _, v in res.series())
    assert top <= float(np.nanmax(raw)) + 1e-6


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("num_shards", [1, 2])
@pytest.mark.parametrize("promql", [
    "histogram_quantile(0.9, http_latency)",
    "histogram_quantile(0.5, sum by (_ns_) (http_latency))",
    "histogram_bucket(4, http_latency)",
])
def test_native_histogram_instant_forms(promql, num_shards, ragged):
    je, pe = hn._engines(ragged, num_shards)
    want = je.query_range(promql, hn.START_S + 600, 60, hn.END_S)
    got = pe.query_range(promql, hn.START_S + 600, 60, hn.END_S)
    assert _agree(want, got) > 0


ROUTED_FNS = {
    "rate": "counter", "increase": "counter",
    "sum_over_time": "gauge", "avg_over_time": "gauge",
    "count_over_time": "gauge", "last_over_time": "gauge",
    "min_over_time": "gauge", "max_over_time": "gauge",
}


@pytest.mark.parametrize("op", ["sum", "avg", "count", "min", "max"])
@pytest.mark.parametrize("fn", sorted(ROUTED_FNS))
def test_forced_router_matches_jax_engine(fn, op, monkeypatch):
    """Both engines route the small working set to the host; the port
    evaluates it with ops/hostleaf.py wherever the reference does (the
    count aggregate and count_over_time are host math before the router,
    in both)."""
    kind = ROUTED_FNS[fn]
    metric = "request_total" if kind == "counter" else "heap_usage"
    promql = f"{op} by (_ns_) ({fn}({metric}[5m]))"
    je, pe = _engines(kind, 1)
    monkeypatch.setenv("FILODB_TPU_FORCE_HOST_ROUTE", "1")
    want = je.query_range(promql, START_S + 600, 60, END_S)
    before = counters.get("leaf_host_routed")
    got = pe.query_range(promql, START_S + 600, 60, END_S)
    routed = counters.get("leaf_host_routed") - before
    assert _agree(want, got) == 10
    host_math = op == "count" or fn == "count_over_time"
    assert routed == (0 if host_math else 1)


def test_router_threshold_and_switch(monkeypatch):
    """At the default threshold the small set routes; over it (threshold
    below the estimate) or with the threshold at 0 it stays on the
    device paths, with the same answer."""
    je, pe = _engines("counter", 1)
    q = "sum by (_ns_) (rate(request_total[5m]))"
    monkeypatch.setenv("FILODB_TPU_FORCE_HOST_ROUTE", "1")
    want = je.query_range(q, START_S + 600, 60, END_S)
    for cap, routes in ((settings().query.host_route_max_samples, 1),
                        (100, 0), (0, 0)):
        monkeypatch.setattr(settings().query, "host_route_max_samples", cap)
        r0, k0 = (counters.get("leaf_host_routed"),
                  counters.get("leaf_fused_kernel"))
        _agree(want, pe.query_range(q, START_S + 600, 60, END_S))
        assert counters.get("leaf_host_routed") - r0 == routes
        assert counters.get("leaf_fused_kernel") - k0 == 1 - routes


def test_router_is_off_on_the_cpu_without_the_switch(monkeypatch):
    monkeypatch.delenv("FILODB_TPU_FORCE_HOST_ROUTE", raising=False)
    _, pe = _engines("counter", 1)
    before = counters.get("leaf_host_routed")
    res = pe.query_range("sum by (_ns_) (rate(request_total[5m]))",
                         START_S + 600, 60, END_S)
    assert res.error is None and res.num_series == 10
    assert counters.get("leaf_host_routed") == before


def _scan_engines():
    """tests/test_query_engine.py::test_scan_time_sample_limit_fails_fast's
    store: 50 counters x 100 samples on one shard."""
    je = _mk_engine([counter_batch(50, 100, start_ms=START_MS)])
    return je, _port_engine(je, 1)


@pytest.mark.parametrize("limit, promql, start, step, end, refused", [
    (1000, "sum(rate(request_total[5m]))", 600, 60, 900, True),
    (50 * 100 + 1, "sum(rate(request_total[5m]))", 600, 60, 900, False),
    (2000, "sum(rate(request_total[30s]))", 900, 30, 960, False),
    (1000, "max_over_time(request_total[5m])", 600, 60, 900, True),
    (1000, "sum(request_total)", 600, 60, 900, True),
])
def test_scan_cap_matches_reference(limit, promql, start, step, end,
                                    refused):
    je, pe = _scan_engines()
    pp = PlannerParams(scan_limit=limit)
    want = je.query_range(promql, START_S + start, step, START_S + end, pp)
    got = pe.query_range(promql, START_S + start, step, START_S + end, pp)
    assert (want.error is not None) == refused, want.error
    assert got.error == want.error
    if refused:
        assert "over the scan limit" in got.error
        assert got.error.startswith("ValueError: shard 0: query would scan")
    else:
        _agree(want, got)


def test_scan_cap_not_enforced_when_limits_are_off():
    je, pe = _scan_engines()
    pp = PlannerParams(scan_limit=1000, enforced_limits=False)
    q = "sum(rate(request_total[5m]))"
    _agree(je.query_range(q, START_S + 600, 60, START_S + 900, pp),
           pe.query_range(q, START_S + 600, 60, START_S + 900, pp))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("precorrected", [False, True])
def test_block_host_gather_matches_one_pass_gather(monkeypatch, precorrected,
                                                   dtype):
    """The leaf's host gather runs row blocks on worker threads; with
    blocks of 7 rows it must give the bits of one serial pass of the
    reference's steps (gather_rows over the span, to_offsets, the reset
    correction carried in from each row's history before the span,
    rebase_values), ragged rows and NaN holes included."""
    from filodb_tpu_torch.ops import counter
    from filodb_tpu_torch.ops.timewindow import to_offsets
    _, pe = _engines("counter", 1, ragged=True)
    shard = pe.source.get_shard("prometheus", 0)
    store = shard.stores["prom-counter"]
    rows = np.arange(store.num_series)[::-1].copy()
    lo, hi = START_MS + 300_000, START_MS + 1_800_000
    leaf = leafexec.MultiSchemaPartitionsExec(
        None, "prometheus", 0, [], lo, hi)
    monkeypatch.setattr(leafexec, "HOST_GATHER_BLOCK_ROWS", 7)
    ts_off, vals, vbase, counts, dense = leaf._host_gather(
        shard, store, rows, "count", precorrected, dtype)
    ts, cols, cnt = store.gather_rows(rows, lo, hi)
    v = cols["count"]
    if precorrected:
        p_lo = store.window_positions(lo, hi)[0]
        v = counter.host_counter_correct_after(
            store.cols["count"][rows, :p_lo], v)
    want_v, want_vb = counter.rebase_values(v, False)
    np.testing.assert_array_equal(ts_off, to_offsets(ts, cnt, lo))
    np.testing.assert_array_equal(vals, want_v.astype(dtype))
    np.testing.assert_array_equal(vbase, want_vb)
    np.testing.assert_array_equal(counts, cnt)
    assert vals.dtype == dtype and dense == (not np.isnan(want_v).any())
    assert not dense


@pytest.mark.parametrize("buckets", [None, 3])
def test_correction_carried_in_equals_the_whole_row_correction(buckets):
    """host_counter_correct_after(prefix, tail) is host_counter_correct
    of the whole rows, restricted to the tail: resets inside the prefix,
    at the seam and inside the tail, NaN holes, rows whose prefix is all
    NaN, and a prefix of no columns."""
    from filodb_tpu_torch.ops import counter
    rng = np.random.default_rng(11)
    shape = (40, 60) + ((buckets,) if buckets else ())
    v = np.cumsum(rng.exponential(5.0, shape), axis=1)
    v[rng.random(shape) < 0.05] = 0.5                   # resets
    v[rng.random(shape) < 0.1] = np.nan                 # holes
    v[:3, :30] = np.nan                                 # no history
    whole = counter.host_counter_correct(v)
    for p in (0, 1, 29, 30, 59):
        got = counter.host_counter_correct_after(v[:, :p], v[:, p:])
        assert got.shape == v[:, p:].shape
        np.testing.assert_allclose(got, whole[:, p:], rtol=1e-12,
                                   atol=0, equal_nan=True)


def test_router_counts_the_history_a_routed_rate_reads(monkeypatch):
    """A routed rate also reads each row's history before its window (the
    carried reset correction), so the router counts every sample up to
    the window's end; a raw-value function reads only its window.  At a
    threshold between the two only the latter routes."""
    je, pe, end_s = _reset_at_window_start_engines()
    monkeypatch.setenv("FILODB_TPU_FORCE_HOST_ROUTE", "1")
    monkeypatch.setattr(settings().query, "host_route_max_samples", 1000)
    for q, routes in (("sum by (_ns_) (rate(request_total[5m]))", 0),
                      ("sum by (_ns_) (max_over_time(request_total[5m]))",
                       1)):
        r0 = counters.get("leaf_host_routed")
        got = pe.query_instant(q, end_s)
        assert counters.get("leaf_host_routed") - r0 == routes, q
        assert _agree(je.query_instant(q, end_s), got) == 10


def test_concat_joins_a_host_block_with_a_mirrored_one():
    """On the card a routed shard's host block (numpy) can meet a mirrored
    shard's (tensors) in one DistConcatExec: they join on the host, each
    in its own value type, padded to the wider grid."""
    import torch
    from filodb_tpu_torch.ops.timewindow import PAD_TS
    from filodb_tpu_torch.query.execbase import RawBlock
    from filodb_tpu_torch.query.nonleaf import _concat_raw
    rng = np.random.default_rng(5)
    mirrored = RawBlock(
        ["a", "b"], torch.arange(6, dtype=torch.int32).reshape(2, 3),
        torch.from_numpy(rng.random((2, 3)).astype(np.float32)), 1000,
        vbase=torch.tensor([1.0, 2.0], dtype=torch.float64),
        precorrected=True)
    host = RawBlock(["c"], np.arange(4, dtype=np.int32)[None],
                    rng.random((1, 4)), 1000, vbase=np.array([3.0]))
    out = _concat_raw([mirrored, host])
    assert list(out.keys) == ["a", "b", "c"] and not out.precorrected
    assert isinstance(out.values, np.ndarray)
    np.testing.assert_array_equal(out.ts_off[:2, :3], mirrored.ts_off)
    assert (out.ts_off[:2, 3] == PAD_TS).all()
    np.testing.assert_array_equal(out.ts_off[2], host.ts_off[0])
    np.testing.assert_array_equal(out.values[:2, :3], mirrored.values)
    assert np.isnan(out.values[:2, 3]).all()
    np.testing.assert_array_equal(out.values[2], host.values[0])
    np.testing.assert_array_equal(out.vbase, [1.0, 2.0, 3.0])


def test_scan_estimate_follows_ingest():
    """The leaf memoizes its scan estimate with the shard's lookup, per
    store generation: samples appended inside the query's range raise
    the estimate at the next query, and the cap then refuses it."""
    _, pe = _scan_engines()
    shard = pe.source.get_shard("prometheus", 0)
    q = "sum(rate(request_total[5m]))"
    pp = PlannerParams(scan_limit=5000)
    first = pe.query_range(q, START_S + 600, 60, START_S + 1800, pp)
    assert first.error is None, first.error
    parts = [p for p in shard.partitions if p is not None]
    ts = START_MS + 1_000_000 + np.arange(80, dtype=np.int64) * 10_000
    shard.ingest_columns(
        "prom-counter", [p.part_key for p in parts],
        np.broadcast_to(ts, (len(parts), 80)),
        {"count": np.full((len(parts), 80), 1e6)})
    second = pe.query_range(q, START_S + 600, 60, START_S + 1800, pp)
    assert second.error is not None and "over the scan limit 5000" in \
        second.error


def test_window_positions_cover_every_cell_after_grid_appends():
    """tests/test_core.py's bounds fuzz for the port's store, driven
    through append_grid too: a shared-grid slab at one position books
    each slot's own timestamp (an exact bound, so the host gather copies
    only the slots a window reaches); mixed positions, per-row grids,
    appends, evictions and prepends must still leave window_positions
    covering every live cell with lo <= ts <= hi."""
    from filodb_tpu_torch.core.blockstore import DenseSeriesStore
    from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
    rng = np.random.default_rng(42)
    st = DenseSeriesStore(DEFAULT_SCHEMAS["gauge"], initial_series=4,
                          initial_time=8, max_time_cap=96)
    rows = np.array([st.new_row() for _ in range(3)])
    next_ts = {int(r): 100 + 10 * int(r) for r in rows}
    oldest = {int(r): next_ts[int(r)] for r in rows}

    def check():
        live = np.concatenate([st.ts[r, :int(st.counts[r])] for r in rows])
        windows = [(0, 10**9), (500, 900), (1, 400), (700, 701)]
        # windows that start or end exactly on live samples
        for t in rng.choice(live, size=min(4, live.size), replace=False):
            t = int(t)
            windows += [(t, t), (t - 5, t), (t, t + 5)]
        for lo, hi in windows:
            p_lo, p_hi = st.window_positions(lo, hi)
            for r in rows:
                c = int(st.counts[r])
                ts_r = st.ts[r, :c]
                inside = np.flatnonzero((ts_r >= lo) & (ts_r <= hi))
                if inside.size:
                    assert p_lo <= inside.min() and inside.max() < p_hi

    for step in range(160):
        op = rng.integers(0, 12)
        n = int(rng.integers(1, 4))
        if op < 3:                                   # shared-grid slab
            t0 = max(next_ts.values())
            ts = np.arange(t0, t0 + n, dtype=np.int64)
            st.append_grid(rows, np.broadcast_to(ts, (len(rows), n)),
                           {"value": np.ones((len(rows), n))})
            for r in rows:
                next_ts[int(r)] = t0 + n
        elif op < 5:                                 # a grid per row
            ts = np.stack([np.arange(next_ts[int(r)], next_ts[int(r)] + n,
                                     dtype=np.int64) for r in rows])
            st.append_grid(rows, ts, {"value": ts.astype(float)})
            for r in rows:
                next_ts[int(r)] += n
        elif op < 8:                                 # per-sample appends
            for r in rows:
                t0 = next_ts[int(r)]
                ts = np.arange(t0, t0 + n)
                st.append_batch(np.full(n, r), ts,
                                {"value": ts.astype(float)})
                next_ts[int(r)] = t0 + n
        elif op < 10:                                # seal + evict
            for r in rows:
                st.mark_sealed(int(r), int(st.counts[r]) // 2)
            st.evict_oldest(int(rng.integers(1, 5)))
            for r in rows:
                c = int(st.counts[r])
                if c:
                    oldest[int(r)] = int(st.ts[r, 0])
        else:                                        # page older history
            r = int(rng.choice(rows))
            lo = oldest[r] - int(rng.integers(1, 4))
            hist = np.arange(lo, oldest[r], dtype=np.int64)
            if hist.size and hist[0] > 0:
                st.prepend_row(r, hist, {"value": hist.astype(float)})
                oldest[r] = int(hist[0])
        check()


def _reset_at_window_start_engines():
    """20 counters x 240 samples rising 10 a scrape, each restarting at 0
    two slots before the last 5 m window (slot 208) and at 0.5 on its
    first sample (slot 210): a rate there extrapolates towards zero from
    the raw restart, not from the value corrected over the row's
    history, if the correction starts after the reset."""
    from filodb_tpu.core.partkey import PartKey
    from filodb_tpu.core.records import RecordBatch
    from filodb_tpu.core.schemas import DEFAULT_SCHEMAS
    S, n = 20, 240
    vals = np.tile(10.0 * np.arange(1, n + 1), (S, 1))
    vals[:, n - 32:n - 30] = 0.0
    vals[:, n - 30:] = 0.5 + 10.0 * np.arange(30)
    keys = [PartKey.make("request_total", {"_ws_": "demo",
                                           "_ns_": f"App-{i % 10}",
                                           "instance": f"Instance-{i}"})
            for i in range(S)]
    grid = START_MS + np.arange(n, dtype=np.int64) * 10_000
    je = _mk_engine([RecordBatch(
        DEFAULT_SCHEMAS["prom-counter"], keys,
        np.repeat(np.arange(S, dtype=np.int32), n), np.tile(grid, S),
        {"count": vals.reshape(-1)})])
    # the port's store ingests one shared grid (a broadcast row), which
    # books exact slot bounds: its host gather of the last window copies
    # only the last slots of each row
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.core.partkey import PartKey as TPartKey
    from filodb_tpu_torch.query.engine import QueryEngine
    ms = TimeSeriesMemStore(device="cpu")
    ms.setup("prometheus", 0).ingest_columns(
        "prom-counter", [TPartKey.make(k.metric, k.tags_dict) for k in keys],
        np.broadcast_to(grid, (S, n)), {"count": vals})
    return je, QueryEngine("prometheus", ms, device="cpu"), \
        START_S + (n - 1) * 10


def test_routed_rate_corrects_resets_before_its_window(monkeypatch):
    """An instant rate at the end of the data gathers only the last slots
    of each row, but the counters reset at the window's first sample:
    the routed host gather copies only the window's slots and carries in
    the correction of each row's history before them, as the mirror
    corrects from each row's first sample; the routed answer agrees with
    the router off and with the JAX engine."""
    je, pe, END_S = _reset_at_window_start_engines()
    q = "sum by (_ns_) (rate(request_total[5m]))"
    want = je.query_instant(q, END_S)
    monkeypatch.setenv("FILODB_TPU_FORCE_HOST_ROUTE", "1")
    r0 = counters.get("leaf_host_routed")
    routed = pe.query_instant(q, END_S)
    assert counters.get("leaf_host_routed") == r0 + 1
    # 20 rows x 240 samples resident; the window holds about 31 a row
    assert routed.stats.samples_scanned <= 20 * 40
    monkeypatch.setattr(settings().query, "host_route_max_samples", 0)
    device = pe.query_instant(q, END_S)
    assert _agree(want, routed) == _agree(want, device) == 10
    _agree(device, routed)
