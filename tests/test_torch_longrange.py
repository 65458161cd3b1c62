"""The tier-stitched planner in the port (filodb_tpu_torch.query.planners
LongTimeRangePlanner and PersistedClusterPlanner, the persisted-segment
leaf SelectPersistedSegmentsExec, StitchRvsExec) against the JAX package.

The reference's `tiered` fixture (tests/test_longrange_tiers.py) is built
in both packages from the same numpy inputs: every window compacted into
segments on disk, the live memstore holding the last window, and a
single-tier store holding everything in memory.  Checks:

- every query of the reference's test_stitched_matches_single_tier
  answers bit-identically to the port's own single-tier store, and
  within rtol 2e-4 / atol 1e-3 of the JAX package's tiered answer (f32
  against the reference's f64, __graft_entry__.py:221);
- the raw-retention edge and a query entirely before raw;
- the plan trees print as the reference's;
- the persisted scan cap counts only the matched rows;
- plan_split_ms splits long ranges into stitched slices;
- the planner-level routing cases (three-way split, no segments, all in
  raw, the head older than the segments) with recording planners, the
  downsample planner injected as a stub;
- a counter reset placed exactly on a segment boundary, held to the JAX
  package and to tests/oracle.py (rtol 2e-4, atol 1e-3).
"""
import numpy as np
import pytest

from filodb_tpu.core.devicecache import ColdSegmentCache as JColdCache
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.partkey import PartKey as JPartKey
from filodb_tpu.parallel.shardmapper import ShardEvent as JShardEvent
from filodb_tpu.parallel.shardmapper import ShardMapper as JShardMapper
from filodb_tpu.persist.compactor import SegmentCompactor as JCompactor
from filodb_tpu.persist.localstore import LocalDiskColumnStore as JDiskStore
from filodb_tpu.persist.segments import PersistedTier as JTier
from filodb_tpu.persist.segments import SegmentStore as JSegStore
from filodb_tpu.query.engine import QueryEngine as JEngine
from filodb_tpu.query.planner import SingleClusterPlanner as JSingle
from filodb_tpu.query.planners import LongTimeRangePlanner as JLTR
from filodb_tpu.query.planners import PersistedClusterPlanner as JPersisted
from filodb_tpu.query.rangevector import PlannerParams as JParams
from filodb_tpu.query.rangevector import QueryContext as JContext
from filodb_tpu_torch.core.devicecache import ColdSegmentCache
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.parallel.shardmapper import ShardEvent, ShardMapper
from filodb_tpu_torch.persist.compactor import SegmentCompactor
from filodb_tpu_torch.persist.localstore import LocalDiskColumnStore
from filodb_tpu_torch.persist.segments import PersistedTier, SegmentStore
from filodb_tpu_torch.promql.parser import (TimeStepParams,
                                            query_range_to_logical_plan)
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.query.exec import (ExecPlan,
                                         SelectPersistedSegmentsExec,
                                         StitchRvsExec)
from filodb_tpu_torch.query.planner import SingleClusterPlanner
from filodb_tpu_torch.query.planners import (LongTimeRangePlanner,
                                             PersistedClusterPlanner)
from filodb_tpu_torch.query.rangevector import (PlannerParams, QueryContext,
                                                QueryStats)

from test_torch_ingest import _clear_compile_journal  # noqa: F401

DS = "ltr-test"
WINDOW = 3600 * 1000
T0 = 1_600_000_000_000 - (1_600_000_000_000 % WINDOW)
INTERVAL = 60_000
N_WINDOWS = 4
NS = N_WINDOWS * WINDOW // INTERVAL
S = 6
RTOL, ATOL = 2e-4, 1e-3


def _grid():
    return T0 + np.arange(NS, dtype=np.int64) * INTERVAL


def _labels():
    return [(("inst", f"i{i}"), ("_ws_", "w"), ("_ns_", "n"))
            for i in range(S)]


def _vals():
    # small integers: every arithmetic step is exact in f32, so hot and
    # cold paths agree to the bit
    return (np.arange(S)[:, None] * 50.0 + (np.arange(NS) % 11)[None, :])


class _Src:
    def __init__(self, store):
        self.store = store

    def get_shard(self, dataset, shard_num):
        return self.store.get_shard(dataset, shard_num)

    def shards_for(self, dataset):
        return self.store.shards_for(dataset)


class _Pkg:
    """One package's classes, so one helper builds for both."""

    def __init__(self, port):
        self.port = port
        if port:
            self.PartKey, self.Disk, self.Seg = (PartKey, LocalDiskColumnStore,
                                                 SegmentStore)
            self.Comp, self.Tier, self.Single = (SegmentCompactor,
                                                 PersistedTier,
                                                 SingleClusterPlanner)
            self.LTR, self.Persisted = LongTimeRangePlanner, \
                PersistedClusterPlanner
            self.Mapper, self.Event = ShardMapper, ShardEvent
        else:
            self.PartKey, self.Disk, self.Seg = JPartKey, JDiskStore, JSegStore
            self.Comp, self.Tier, self.Single = JCompactor, JTier, JSingle
            self.LTR, self.Persisted = JLTR, JPersisted
            self.Mapper, self.Event = JShardMapper, JShardEvent

    def memstore(self, **kw):
        if self.port:
            return TimeSeriesMemStore(device="cpu", **kw)
        return JMemStore(**kw)

    def cold_cache(self, limit=256 << 20):
        if self.port:
            return ColdSegmentCache(limit, device="cpu")
        return JColdCache(limit, use_placer=False)

    def engine(self, store, mapper, planner):
        if self.port:
            return QueryEngine(DS, _Src(store), mapper, planner=planner,
                               device="cpu")
        return JEngine(DS, _Src(store), mapper, planner=planner)

    def mapper(self):
        m = self.Mapper(1)
        m.update_from_event(self.Event("IngestionStarted", DS, 0, "n"))
        return m

    def pks(self, metric="m"):
        return [self.PartKey(metric, lb) for lb in _labels()]


def build_tiered(pkg, root, vals=None, schema="gauge", metric="m",
                 column="value"):
    """The reference's `tiered` fixture in one package: segments hold all
    of history, the live memstore the last window, a single-tier store
    everything.  -> (tiered engine, single-tier engine, earliest raw ms,
    tier)."""
    ts_grid, pks = _grid(), pkg.pks(metric)
    vals = _vals() if vals is None else vals
    cs = pkg.Disk(str(root))
    sh = pkg.memstore(column_store=cs).setup(DS, 0)
    sh.ingest_columns(schema, pks, np.broadcast_to(ts_grid, (S, NS)),
                      {column: vals})
    sh.flush_all_groups()
    seg_store = pkg.Seg(str(root))
    comp = pkg.Comp(cs, seg_store, DS, 1, window_ms=WINDOW, closed_lag_ms=0)
    assert comp.compact_all(now_ms=int(ts_grid[-1]) + 10 * WINDOW) \
        == N_WINDOWS
    tier = pkg.Tier(seg_store, DS, 1, pkg.cold_cache())
    tail_from = NS - WINDOW // INTERVAL
    ms_live = pkg.memstore()
    ms_live.setup(DS, 0).ingest_columns(
        schema, pks, np.broadcast_to(ts_grid[tail_from:], (S, NS - tail_from)),
        {column: vals[:, tail_from:]})
    ms_ref = pkg.memstore()
    ms_ref.setup(DS, 0).ingest_columns(
        schema, pks, np.broadcast_to(ts_grid, (S, NS)), {column: vals})
    mapper = pkg.mapper()
    earliest_raw = int(ts_grid[tail_from])
    ltr = pkg.LTR(pkg.Single(DS, mapper), None,
                  earliest_raw_time_fn=lambda: earliest_raw,
                  latest_downsample_time_fn=lambda: 1 << 62,
                  persisted_planner=pkg.Persisted(DS, mapper, tier),
                  persisted_range_fn=tier.range)
    return (pkg.engine(ms_live, mapper, ltr),
            pkg.engine(ms_ref, mapper, pkg.Single(DS, mapper)),
            earliest_raw, tier)


@pytest.fixture()
def tiered(tmp_path):
    port = build_tiered(_Pkg(True), tmp_path / "port")
    ref = build_tiered(_Pkg(False), tmp_path / "jax")
    return port, ref


def _series(res):
    assert res.error is None, res.error
    return {k: (np.asarray(w), np.asarray(v, np.float64))
            for k, w, v in res.series()}


def _keyed(res):
    return {tuple(sorted(k.labels_dict.items())): wv
            for k, wv in _series(res).items()}


def assert_identical(res_a, res_b, q):
    a, b = _series(res_a), _series(res_b)
    assert set(a) == set(b), q
    for k in a:
        assert np.array_equal(a[k][0], b[k][0]), q
        va, vb = a[k][1], b[k][1]
        both_nan = np.isnan(va) & np.isnan(vb)
        assert np.array_equal(va[~both_nan], vb[~both_nan]), \
            (q, va[:8], vb[:8])


def assert_close(res_port, res_jax, q, rtol=RTOL, atol=ATOL):
    a, b = _keyed(res_port), _keyed(res_jax)
    assert set(a) == set(b), q
    for k in a:
        assert np.array_equal(a[k][0], b[k][0]), q
        np.testing.assert_array_equal(np.isnan(a[k][1]), np.isnan(b[k][1]))
        np.testing.assert_allclose(a[k][1], b[k][1], rtol=rtol, atol=atol,
                                   err_msg=q)


QUERIES = [
    "m",
    "sum(m)",
    "sum(rate(m[10m]))",            # lookback straddles the tier split
    "avg_over_time(m[30m])",        # wide window across the boundary
    "max by (inst) (m)",
]


@pytest.mark.parametrize("q", QUERIES)
def test_stitched_matches_single_tier(tiered, q):
    (p_tiered, p_ref, _, _), (j_tiered, _, _, _) = tiered
    start_s = T0 // 1000 + 1800
    end_s = int(_grid()[-1]) // 1000
    res_t = p_tiered.query_range(q, start_s, 300, end_s)
    res_r = p_ref.query_range(q, start_s, 300, end_s)
    assert_identical(res_t, res_r, q)
    assert res_t.stats.cold_tier in ("cold_hit", "cold_paged")
    assert_close(res_t, j_tiered.query_range(q, start_s, 300, end_s), q)


def test_plan_trees_print_as_the_reference(tiered):
    (p_tiered, _, _, _), (j_tiered, _, _, _) = tiered
    start_s = T0 // 1000 + 1800
    end_s = int(_grid()[-1]) // 1000
    for q in QUERIES:
        plan = query_range_to_logical_plan(
            q, TimeStepParams(start_s, 300, end_s))
        from filodb_tpu.promql.parser import (
            TimeStepParams as JStep, query_range_to_logical_plan as jparse)
        jplan = jparse(q, JStep(start_s, 300, end_s))
        got = p_tiered.planner.materialize(plan, QueryContext()).print_tree()
        want = j_tiered.planner.materialize(jplan, JContext()).print_tree()
        assert got == want, q
        assert "StitchRvsExec" in got and "tier=cold" in got


def test_query_exactly_at_raw_retention_edge(tiered):
    """The raw tier serves only instants whose whole lookback is in
    memory; the instant straddling the edge comes from the segments."""
    (p_tiered, p_ref, earliest_raw, _), (j_tiered, _, _, _) = tiered
    start_s = earliest_raw // 1000 - 1200
    end_s = earliest_raw // 1000 + 1200
    for q in ("sum(rate(m[10m]))", "m"):
        res_t = p_tiered.query_range(q, start_s, 300, end_s)
        assert_identical(res_t, p_ref.query_range(q, start_s, 300, end_s), q)
        assert_close(res_t, j_tiered.query_range(q, start_s, 300, end_s), q)


def test_query_entirely_before_raw(tiered):
    (p_tiered, p_ref, earliest_raw, _), (j_tiered, _, _, _) = tiered
    start_s = T0 // 1000 + 1800
    end_s = earliest_raw // 1000 - 3600
    q = "sum(rate(m[10m]))"
    res_t = p_tiered.query_range(q, start_s, 300, end_s)
    assert_identical(res_t, p_ref.query_range(q, start_s, 300, end_s), q)
    assert_close(res_t, j_tiered.query_range(q, start_s, 300, end_s), q)


def test_warm_cold_query_hits_the_cold_region(tiered):
    """The second run of a persisted panel finds its blocks resident:
    verdict cold_hit, the same bits."""
    (p_tiered, _, earliest_raw, tier), _ = tiered
    start_s = T0 // 1000 + 1800
    end_s = earliest_raw // 1000 - 3600
    q = "sum(rate(m[10m]))"
    first = p_tiered.query_range(q, start_s, 300, end_s)
    assert first.stats.cold_tier == "cold_paged"
    second = p_tiered.query_range(q, start_s, 300, end_s)
    assert second.stats.cold_tier == "cold_hit"
    assert_identical(first, second, q)
    booked = sum(b.nbytes for b in tier.cold_cache.blocks())
    assert tier.cold_cache.bytes_booked == booked > 0


def _engines_over(pkg, root, vals=None, limit=256 << 20):
    ts_grid, pks = _grid(), pkg.pks()
    vals = _vals() if vals is None else vals
    cs = pkg.Disk(str(root))
    ms = pkg.memstore(column_store=cs)
    ms.setup(DS, 0).ingest_columns("gauge", pks,
                                   np.broadcast_to(ts_grid, (S, NS)),
                                   {"value": vals})
    ms.get_shard(DS, 0).flush_all_groups()
    seg_store = pkg.Seg(str(root))
    pkg.Comp(cs, seg_store, DS, 1, window_ms=WINDOW,
             closed_lag_ms=0).compact_all(
        now_ms=int(ts_grid[-1]) + 10 * WINDOW)
    tier = pkg.Tier(seg_store, DS, 1, pkg.cold_cache(limit))
    mapper = pkg.mapper()
    return pkg.engine(ms, mapper, pkg.Persisted(DS, mapper, tier))


def test_persisted_scan_cap_counts_matched_rows_only(tmp_path):
    """The cold scan cap reflects the filtered working set, not the
    shard's segment volume, in both packages."""
    start_s = T0 // 1000 + 1800
    end_s = int(_grid()[-1]) // 1000
    for port, Params in ((True, PlannerParams), (False, JParams)):
        eng = _engines_over(_Pkg(port), tmp_path / str(port))
        params = Params(scan_limit=NS + NS // 2, enforced_limits=True)
        res = eng.query_range('m{inst="i1"}', start_s, 300, end_s,
                              planner_params=params)
        assert res.error is None, res.error
        assert res.num_series == 1
        res = eng.query_range("m", start_s, 300, end_s,
                              planner_params=params)
        assert res.error is not None and "scan limit" in res.error


class _FakeTier:
    plan_split_ms = 24 * 3600 * 1000
    schemas = None

    def covering(self, *a, **k):
        return []


def _plan(q, start_s, end_s, step_s=60):
    return query_range_to_logical_plan(
        q, TimeStepParams(start_s, step_s, end_s))


def test_persisted_planner_splits_long_ranges():
    from filodb_tpu.promql.parser import (
        TimeStepParams as JStep, query_range_to_logical_plan as jparse)
    start_s = 1_600_000_000
    q = 'sum(rate(m[5m]))'
    out = PersistedClusterPlanner(DS, _Pkg(True).mapper(), _FakeTier()
                                  ).materialize(
        _plan(q, start_s, start_s + 5 * 86_400, step_s=300), QueryContext())
    assert isinstance(out, StitchRvsExec)
    assert len(out.children) >= 5
    leaf = out.children[0]
    while getattr(leaf, "children", None):
        leaf = leaf.children[0]
    assert isinstance(leaf, SelectPersistedSegmentsExec)
    want = JPersisted(DS, _Pkg(False).mapper(), _FakeTier()).materialize(
        jparse(q, JStep(start_s, 300, start_s + 5 * 86_400)), JContext())
    assert out.print_tree() == want.print_tree()


class _RecordingPlanner:
    def __init__(self, tag):
        self.tag = tag
        self.materialized = []

    def materialize(self, plan, ctx):
        class _D(ExecPlan):
            def __init__(self, tag, plan):
                super().__init__(QueryContext())
                self.tag, self.plan = tag, plan

            def _do_execute(self, source):
                return None, QueryStats()
        self.materialized.append(plan)
        return _D(self.tag, plan)


def _recorders(ds=True):
    return (_RecordingPlanner("raw"),
            _RecordingPlanner("ds") if ds else None,
            _RecordingPlanner("pers"))


START_MS = 1_600_000_000_000


@pytest.mark.parametrize("case", ["three_way", "no_segments", "all_raw",
                                  "head_before_segments"])
def test_ltr_routing(case):
    """The reference's planner-level cases (test_longrange_tiers.py): the
    downsample planner is a recording stub where the case has one."""
    raw, ds, pers = _recorders(ds=case != "head_before_segments")
    if case == "three_way":
        earliest, p_range, hours = (START_MS + 3 * 3600_000,
                                    (START_MS + 3600_000,
                                     START_MS + 10 * 86_400_000), 6)
    elif case == "no_segments":
        earliest, p_range, hours = START_MS + 10 * 3600_000, None, 1
    elif case == "all_raw":
        earliest, p_range, hours = START_MS - 86_400_000, (0, START_MS), 1
    else:
        earliest, p_range, hours = (START_MS + 5 * 3600_000,
                                    (START_MS + 2 * 3600_000,
                                     START_MS + 10 * 86_400_000), 8)
    ltr = LongTimeRangePlanner(
        raw, ds, lambda: earliest, lambda: 1 << 62,
        persisted_planner=pers, persisted_range_fn=lambda: p_range)
    p = _plan("rate(foo[5m])", START_MS // 1000,
              (START_MS + hours * 3600_000) // 1000)
    out = ltr.materialize(p, QueryContext())
    if case == "three_way":
        assert isinstance(out, StitchRvsExec)
        (dsp,), (pp,), (rp,) = (ds.materialized, pers.materialized,
                                raw.materialized)
        assert rp.start_ms >= earliest + 300_000
        assert (rp.start_ms - p.start_ms) % p.step_ms == 0
        assert pp.end_ms == rp.start_ms - p.step_ms
        assert pp.start_ms >= p_range[0] + 300_000
        assert dsp.end_ms == pp.start_ms - p.step_ms
        assert dsp.start_ms == p.start_ms
    elif case == "no_segments":
        assert not pers.materialized and len(ds.materialized) == 1
    elif case == "all_raw":
        assert len(raw.materialized) == 1
        assert not ds.materialized and not pers.materialized
    else:
        assert isinstance(out, StitchRvsExec)
        assert len(pers.materialized) == 1 and len(raw.materialized) == 2
        head = min(raw.materialized, key=lambda pl: pl.start_ms)
        assert head.start_ms == p.start_ms
        assert head.end_ms == pers.materialized[0].start_ms - p.step_ms


def test_counter_reset_on_a_segment_boundary(tmp_path):
    """A counter whose first sample of window 2 is below its last sample
    of window 1 (a reset exactly on the segment boundary), and one more
    reset inside window 1: the persisted rate, merged across segments,
    against the JAX package and the f64 oracle."""
    from oracle import eval_series
    steps = WINDOW // INTERVAL
    base = np.cumsum(np.full((S, NS), 3.0), axis=1) \
        + np.arange(S)[:, None] * 7.0
    vals = base.copy()
    vals[:, steps:] -= vals[:, steps:steps + 1] - 1.0   # boundary reset
    vals[:, 20:steps] -= vals[:, 20:21] - 2.0           # reset in window 1
    assert (vals[:, steps] < vals[:, steps - 1]).all()
    q = "rate(m[10m])"
    start_s = T0 // 1000 + 600
    end_s = int(_grid()[-1]) // 1000
    p_tiered, _, _, _ = build_tiered(_Pkg(True), tmp_path / "port",
                                     vals=vals, schema="prom-counter",
                                     column="count")
    j_tiered, _, _, _ = build_tiered(_Pkg(False), tmp_path / "jax",
                                     vals=vals, schema="prom-counter",
                                     column="count")
    got = p_tiered.query_range(q, start_s, 60, end_s)
    assert got.stats.cold_tier in ("cold_hit", "cold_paged")
    assert_close(got, j_tiered.query_range(q, start_s, 60, end_s), q)
    wends = np.arange(start_s * 1000, end_s * 1000 + 1, 60_000)
    for k, (w, v) in _series(got).items():
        i = int(k.labels_dict["inst"][1:])
        want = eval_series(_grid(), vals[i], wends, 600_000, "rate")
        np.testing.assert_array_equal(w, wends)
        np.testing.assert_allclose(v, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("q", ["sum(rate(m[10m]))", "max(rate(m[10m]))",
                               "sum by (inst) (increase(m[30m]))"])
def test_counter_panels_fuse_over_cold_blocks(tmp_path, q):
    """Counter panels over the tiers take the fused kernels' path (the
    persisted child over the merged cold block, the raw child over the
    hot tail): bit-identical to the single-tier store, within tolerance
    of the JAX package."""
    from filodb_tpu_torch.utils.counters import counters
    vals = np.cumsum(np.full((S, NS), 3.0), axis=1) \
        + np.arange(S)[:, None] * 5.0
    kw = dict(vals=vals, schema="prom-counter", column="count")
    p_tiered, p_ref, _, _ = build_tiered(_Pkg(True), tmp_path / "port", **kw)
    j_tiered, _, _, _ = build_tiered(_Pkg(False), tmp_path / "jax", **kw)
    start_s = T0 // 1000 + 1800
    end_s = int(_grid()[-1]) // 1000
    before = counters.get("leaf_fused_kernel")
    res_t = p_tiered.query_range(q, start_s, 300, end_s)
    assert counters.get("leaf_fused_kernel") - before >= 2
    assert res_t.stats.cold_tier == "cold_paged"
    assert_identical(res_t, p_ref.query_range(q, start_s, 300, end_s), q)
    assert_close(res_t, j_tiered.query_range(q, start_s, 300, end_s), q)
