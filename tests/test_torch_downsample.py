"""The downsample runtime of the port (filodb_tpu_torch/downsample/, the
shard's downsampler hook, the leaf's ds-gauge substitution) against the
JAX package's (filodb_tpu/downsample/), modelled on
tests/test_downsample.py.

Inputs are numpy arrays from a seed (or the two packages' generators,
which give the same batches), ingested into both packages' CPU shards.
Held: period boundaries and chunk rollups exactly; the shard hook's drain
to the byte (RecordBatch.to_bytes per resolution and schema), emitted
exactly once across flushes; the batch job's downsample column store on a
LocalDiskColumnStore to the byte; query answers of the stream and batch
downsample stores, the ds-gauge substitution and the LongTimeRangePlanner
stitch at rtol 2e-4 / atol 1e-3 against the reference's (the reference's
fused kernels in interpret mode).
"""
import itertools
import os

import numpy as np
import pytest

START = 1_600_000_000_000
RES = 60_000
ALIGNED = (START // RES) * RES
ALIGNED_S = ALIGNED // 1000
RANGE = (ALIGNED_S + 1260, 300, ALIGNED_S + 7080)
RTOL, ATOL = 2e-4, 1e-3
PKGS = ("jax", "port")
GAUGE_FNS = ("min_over_time", "max_over_time", "sum_over_time",
             "count_over_time", "avg_over_time", "last_over_time")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("FILODB_TPU_FUSED_INTERPRET", "1")


@pytest.fixture(autouse=True, scope="module")
def _clear_compile_journal():
    """The JAX engine journals its jit compiles; the reference's health
    model reads them as a compile storm in the next test file."""
    yield
    from filodb_tpu.utils.events import journal
    journal.clear()


class _Pkg:
    def __init__(self, pkg):
        self.pkg = pkg
        if pkg == "jax":
            from filodb_tpu import downsample as ds
            from filodb_tpu.core import schemas
            from filodb_tpu.core.memstore import TimeSeriesMemStore
            from filodb_tpu.core.partkey import PartKey
            from filodb_tpu.core.store import (InMemoryColumnStore,
                                               InMemoryMetaStore)
            from filodb_tpu.ingest import generator
            from filodb_tpu.memory import chunks
            from filodb_tpu.parallel.shardmapper import (ShardEvent,
                                                         ShardMapper)
            from filodb_tpu.persist.localstore import (LocalDiskColumnStore,
                                                       LocalDiskMetaStore)
            from filodb_tpu.query.engine import QueryEngine
            from filodb_tpu.query.planner import SingleClusterPlanner
            from filodb_tpu.query.planners import LongTimeRangePlanner
            from filodb_tpu.downsample import batch_job
            kw = {}
        else:
            from filodb_tpu_torch import downsample as ds
            from filodb_tpu_torch.core import schemas
            from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
            from filodb_tpu_torch.core.partkey import PartKey
            from filodb_tpu_torch.core.store import (InMemoryColumnStore,
                                                     InMemoryMetaStore)
            from filodb_tpu_torch.ingest import generator
            from filodb_tpu_torch.memory import chunks
            from filodb_tpu_torch.parallel.shardmapper import (ShardEvent,
                                                               ShardMapper)
            from filodb_tpu_torch.persist.localstore import (
                LocalDiskColumnStore, LocalDiskMetaStore)
            from filodb_tpu_torch.query.engine import QueryEngine
            from filodb_tpu_torch.query.planner import SingleClusterPlanner
            from filodb_tpu_torch.query.planners import LongTimeRangePlanner
            from filodb_tpu_torch.downsample import batch_job
            kw = {"device": "cpu"}
        self.ds, self.schemas, self.generator = ds, schemas, generator
        self.TimeSeriesMemStore, self.PartKey = TimeSeriesMemStore, PartKey
        self.InMemoryColumnStore = InMemoryColumnStore
        self.InMemoryMetaStore = InMemoryMetaStore
        self.chunks, self.batch_job = chunks, batch_job
        self.ShardEvent, self.ShardMapper = ShardEvent, ShardMapper
        self.LocalDiskColumnStore = LocalDiskColumnStore
        self.LocalDiskMetaStore = LocalDiskMetaStore
        self.QueryEngine = QueryEngine
        self.SingleClusterPlanner = SingleClusterPlanner
        self.LongTimeRangePlanner = LongTimeRangePlanner
        self.kw = kw

    def mapper(self):
        m = self.ShardMapper(1)
        m.update_from_event(self.ShardEvent("IngestionStarted", "prometheus",
                                            0, "local"))
        return m

    def raw(self, batches, column_store=None, meta_store=None):
        """(memstore, shard, mapper, engine) over the raw batches."""
        ms = self.TimeSeriesMemStore(
            column_store=column_store or self.InMemoryColumnStore(),
            meta_store=meta_store or self.InMemoryMetaStore(), **self.kw)
        sh = ms.setup("prometheus", 0)
        for b in batches(self):
            sh.ingest(b)
        mapper = self.mapper()
        return ms, sh, mapper, self.QueryEngine("prometheus", ms, mapper,
                                                **self.kw)

    def ds_store(self, column_store=None, resolutions=(RES,)):
        st = self.ds.DownsampledTimeSeriesStore(
            "prometheus", column_store=column_store
            or self.InMemoryColumnStore(), resolutions=resolutions,
            **self.kw)
        st.setup_shard(0)
        return st

    def ds_engine(self, store, mapper):
        return self.QueryEngine(
            "prometheus", store, mapper,
            planner=self.ds.DownsampleClusterPlanner(store, mapper),
            **self.kw)


def _gauges_and_counters(p):
    return [p.generator.gauge_batch(20, 720, start_ms=START),
            p.generator.counter_batch(10, 720, start_ms=START)]


def _gauges(n):
    return lambda p: [p.generator.gauge_batch(n, 720, start_ms=START)]


def _pipeline(pkg):
    """The reference's `pipeline` fixture in package `pkg`: raw gauges and
    counters flushed through a ShardDownsampler into a downsample store."""
    p = _Pkg(pkg)
    ms, sh, mapper, raw_eng = p.raw(_gauges_and_counters)
    dsr = p.ds.ShardDownsampler(resolutions=(RES,))
    sh.shard_downsampler = dsr
    sh.flush_all_groups()
    store = p.ds_store()
    assert store.ingest_downsample_batches(0, dsr.result_batches()) > 0
    return raw_eng, p.ds_engine(store, mapper)


def _matrix(res):
    """{series key: values} of a result, f64."""
    assert res.error is None, res.error
    return {str(sorted(k.labels_dict.items())):
            np.asarray(v, dtype=np.float64) for k, _, v in res.series()}


def _same(got, want, what, rtol=RTOL, atol=ATOL):
    assert set(got) == set(want) and want, what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   equal_nan=True, err_msg=f"{what} {k}")


# ------------------------------------------------------------ downsamplers


def _ts(n):
    return np.asarray([ALIGNED + (i + 1) * 10_000 for i in range(n)],
                      dtype=np.int64)


def test_period_boundaries_equal_the_reference():
    from filodb_tpu.downsample import period_boundaries as jpb
    from filodb_tpu_torch.downsample import period_boundaries as ppb
    rng = np.random.default_rng(15)
    ts = np.sort(ALIGNED + rng.choice(7_200_000, 300, replace=False))
    vals = np.cumsum(rng.exponential(3.0, 300))
    vals[[40, 41, 170]] = 0.0                     # resets, one repeated
    for res in (60_000, 300_000, 3_600_000):
        np.testing.assert_array_equal(ppb(ts, res), jpb(ts, res))
        got = ppb(ts, res, counter_vals=vals)
        np.testing.assert_array_equal(got, jpb(ts, res, counter_vals=vals))
        assert {40, 170} <= set(got.tolist())
    assert list(ppb(_ts(18), RES)) == [0, 6, 12]
    assert len(ppb(_ts(0), RES)) == 0


def _chunk_case(kind, rng):
    T, B = 96, 6
    ts = _ts(T)
    if kind == "gauge":
        return "gauge", ts, {"value": rng.normal(50.0, 10.0, T)}
    if kind == "counter":
        v = np.cumsum(rng.exponential(5.0, T))
        v[37:] -= v[36]                            # a reset at 37
        return "prom-counter", ts, {"count": v}
    row = np.cumsum(rng.integers(0, 5, T)).astype(np.float64) + 1
    row[61:] -= row[60] - 1                        # a count reset at 61
    h = row[:, None] * np.arange(1, B + 1, dtype=np.float64)[None, :]
    return "prom-histogram", ts, {"sum": h[:, -1] * 0.3, "count": h[:, -1],
                                  "h": h}


@pytest.mark.parametrize("kind", ["gauge", "counter", "histogram"])
def test_downsample_chunk_equals_the_reference(kind):
    from filodb_tpu.core import schemas as jschemas
    from filodb_tpu.downsample import downsample_chunk as jdc
    from filodb_tpu_torch.core import schemas as pschemas
    from filodb_tpu_torch.downsample import downsample_chunk as pdc
    schema, ts, cols = _chunk_case(kind, np.random.default_rng(15))
    for res in (60_000, 300_000):
        pts, pcols = pdc(pschemas.DEFAULT_SCHEMAS[schema], ts, cols, res)
        jts, jcols = jdc(jschemas.DEFAULT_SCHEMAS[schema], ts, cols, res)
        np.testing.assert_array_equal(pts, jts)
        assert set(pcols) == set(jcols)
        for name in jcols:
            np.testing.assert_array_equal(pcols[name], jcols[name])
    if kind == "counter":
        # the dip survives in the dLast sequence
        _, pcols = pdc(pschemas.DEFAULT_SCHEMAS[schema], ts, cols, RES)
        assert (np.diff(pcols["count"]) < 0).sum() == 1
    if kind == "histogram":
        _, pcols = pdc(pschemas.DEFAULT_SCHEMAS[schema], ts, cols, RES)
        assert (np.diff(pcols["h"][:, -1]) < 0).sum() == 1


# ---------------------------------------------------- the shard hook


def _hook_batches(p, n_t, t0):
    g = p.generator
    return [g.gauge_batch(12, n_t, start_ms=t0, seed=15),
            g.counter_batch(8, n_t, start_ms=t0, seed=16),
            g.histogram_batch(4, n_t, start_ms=t0, seed=17)]


def _drain_bytes(drain):
    return {res: sorted((b.schema.name, b.to_bytes()) for b in batches)
            for res, batches in drain.items()}


def test_shard_hook_drain_equals_the_reference_to_the_byte():
    """Two flushes with new samples between them, then a flush with none:
    each drain equals the reference's to the byte, and every raw sample
    is rolled up exactly once (the ds-gauge counts add up to the raw
    samples)."""
    drains = {}
    for pkg in PKGS:
        p = _Pkg(pkg)
        ms, sh, _, _ = p.raw(lambda q: _hook_batches(q, 360, START))
        dsr = p.ds.ShardDownsampler()
        assert dsr.resolutions == (60_000, 300_000)
        sh.shard_downsampler = dsr
        sh.flush_all_groups()
        first = dsr.result_batches()
        for b in _hook_batches(p, 360, START + 360 * 10_000):
            sh.ingest(b)
        sh.flush_all_groups()
        second = dsr.result_batches()
        sh.flush_all_groups()
        third = dsr.result_batches()
        drains[pkg] = [_drain_bytes(d) for d in (first, second, third)]
        if pkg == "port":
            assert third == {}
            for res in (60_000, 300_000):
                n = sum(float(b.columns["count"].sum())
                        for d in (first, second) for b in d[res]
                        if b.schema.name == "ds-gauge")
                assert n == 12 * 720, res
            hist = [b for b in first[60_000]
                    if b.schema.name == "prom-histogram"]
            assert len(hist) == 1 and hist[0].bucket_les is not None
    assert drains["port"] == drains["jax"]


# ------------------------------------------------- the ds-gauge repair


DS_METRIC = "ds_heap"


def _ds_gauge_arrays(S=64, T=240, seed=15):
    """S ds-gauge series x T one-minute periods whose columns differ:
    min < avg < max, sum = avg * count, counts 3-6."""
    rng = np.random.default_rng(seed)
    ts = np.broadcast_to(ALIGNED + (np.arange(T, dtype=np.int64) + 1)
                         * RES, (S, T))
    avg = rng.normal(100.0, 20.0, (S, T))
    count = rng.integers(3, 7, (S, T)).astype(np.float64)
    cols = {"min": avg - rng.uniform(1, 10, (S, T)),
            "max": avg + rng.uniform(1, 10, (S, T)),
            "sum": avg * count, "count": count, "avg": avg}
    return ts, cols


def _ds_gauge_engine(p, S=64):
    ms = p.TimeSeriesMemStore(**p.kw)
    sh = ms.setup("prometheus", 0)
    keys = [p.PartKey.make(DS_METRIC, {"_ws_": "demo",
                                       "_ns_": f"App-{i % 4}",
                                       "instance": f"I-{i}"})
            for i in range(S)]
    ts, cols = _ds_gauge_arrays(S)
    sh.ingest_columns("ds-gauge", keys, ts, cols)
    return p.QueryEngine("prometheus", ms, p.mapper(), **p.kw), ts, cols


@pytest.mark.parametrize("fn", GAUGE_FNS)
def test_ds_gauge_substitution_equals_the_reference(fn):
    """The leaf reads the ds-gauge column its range function names
    (DS_GAUGE_FN_SUBSTITUTION): min_over_time the `min` column,
    count_over_time sum_over_time over `count`, ...  Before this port the
    leaf read `avg`, the schema's value column, for every function."""
    got = {}
    for pkg in PKGS:
        eng, ts, cols = _ds_gauge_engine(_Pkg(pkg))
        res = eng.query_range(f"sum({fn}({DS_METRIC}[10m]))", *RANGE)
        got[pkg] = _matrix(res)
    _same(got["port"], got["jax"], fn)
    # and against the columns themselves (the windows hold 10 periods)
    col, red = {"min_over_time": ("min", np.min),
                "max_over_time": ("max", np.max),
                "sum_over_time": ("sum", np.sum),
                "count_over_time": ("count", np.sum),
                "avg_over_time": ("avg", np.mean),
                "last_over_time": ("avg", lambda w, axis: w[:, -1])}[fn]
    wends = np.arange(RANGE[0], RANGE[2] + 1, RANGE[1]) * 1000
    want = []
    for we in wends:
        sel = (ts[0] > we - 600_000) & (ts[0] <= we)
        want.append(red(cols[col][:, sel], axis=1).sum())
    (row,) = got["port"].values()
    np.testing.assert_allclose(row, want, rtol=RTOL, atol=ATOL)


def test_ds_substitution_is_idempotent():
    """Executing one plan twice gives the same bits: the substitution is
    a per-execution override, never applied to the plan itself."""
    p = _Pkg("port")
    eng, _, _ = _ds_gauge_engine(p)
    from filodb_tpu_torch.promql.parser import (TimeStepParams,
                                                query_range_to_logical_plan)
    from filodb_tpu_torch.query.rangevector import QueryContext
    for fn in ("count_over_time", "min_over_time"):
        plan = query_range_to_logical_plan(
            f"sum({fn}({DS_METRIC}[10m]))", TimeStepParams(*RANGE))
        ep = eng.planner.materialize(plan, QueryContext(device=eng.device))
        r1 = _matrix(ep.execute(eng.source))
        r2 = _matrix(ep.execute(eng.source))
        assert r1.keys() == r2.keys()
        for k in r1:
            assert r1[k].tobytes() == r2[k].tobytes()


# --------------------------------------------- stores, planner, jobs


def test_stream_store_answers_as_the_reference():
    """The streaming pipeline (flush -> ShardDownsampler -> downsample
    store): every gauge function and the counter rate equal the
    reference's; min/max/sum/count equal the raw store's on windows
    aligned to the periods; the rate is close to the raw one."""
    engines = {pkg: _pipeline(pkg) for pkg in PKGS}
    for fn in GAUGE_FNS:
        q = f'sum by (_ns_) ({fn}(heap_usage{{_ws_="demo"}}[10m]))'
        got = {pkg: _matrix(engines[pkg][1].query_range(q, *RANGE))
               for pkg in PKGS}
        _same(got["port"], got["jax"], fn)
        if fn in ("min_over_time", "max_over_time", "sum_over_time",
                  "count_over_time"):
            raw = _matrix(engines["port"][0].query_range(q, *RANGE))
            _same(got["port"], raw, f"{fn} ds vs raw")
    q = "sum(rate(request_total[10m]))"
    ds = {pkg: _matrix(engines[pkg][1].query_range(q, *RANGE))
          for pkg in PKGS}
    _same(ds["port"], ds["jax"], "rate")
    raw = _matrix(engines["port"][0].query_range(q, *RANGE))
    (d,), (r,) = ds["port"].values(), raw.values()
    both = ~(np.isnan(d) | np.isnan(r))
    assert both.any()
    np.testing.assert_allclose(d[both], r[both], rtol=0.05)


def test_pick_resolution_equals_the_reference():
    stores = [_Pkg(pkg).ds_store(resolutions=(300_000, 60_000, 3_600_000))
              for pkg in PKGS]
    assert stores[1].resolutions == (60_000, 300_000, 3_600_000)
    for step, win in itertools.product(
            (1_000, 60_000, 120_000, 600_000, 7_200_000),
            (None, 0, 60_000, 119_999, 120_000, 600_000, 7_200_000)):
        assert stores[1].pick_resolution(step, win) == \
            stores[0].pick_resolution(step, win), (step, win)
    assert stores[1].pick_resolution(60_000, 600_000) == 300_000
    assert stores[1].pick_resolution(60_000, None) == 60_000
    for pkg in PKGS:
        from importlib import import_module
        mod = import_module(("filodb_tpu" if pkg == "jax" else
                             "filodb_tpu_torch") + ".downsample.store")
        assert mod.ds_dataset_name("prometheus", 60_000) == \
            "prometheus::ds::60000"


def test_planner_retargets_leaves_to_the_picked_resolution():
    """DownsampleClusterPlanner: a 10 m window plans onto the 5 m
    dataset, a 1 m one onto the 1 m dataset; nested plans keep their own
    resolution on the per-thread stack."""
    p = _Pkg("port")
    store = p.ds_store(resolutions=(60_000, 300_000))
    eng = p.ds_engine(store, p.mapper())
    from filodb_tpu_torch.promql.parser import (TimeStepParams,
                                                query_range_to_logical_plan)
    from filodb_tpu_torch.query.rangevector import QueryContext

    def leaf_datasets(q):
        ep = eng.planner.materialize(query_range_to_logical_plan(
            q, TimeStepParams(*RANGE)), QueryContext(device=eng.device))
        out, todo = set(), [ep]
        while todo:
            n = todo.pop()
            if hasattr(n, "dataset") and not getattr(n, "children", None):
                out.add(n.dataset)
            todo += list(getattr(n, "children", []) or [])
        return out
    assert leaf_datasets("sum(rate(request_total[10m]))") == \
        {"prometheus::ds::300000"}
    assert leaf_datasets("sum(rate(request_total[1m]))") == \
        {"prometheus::ds::60000"}
    assert eng.planner._tls.res_stack == []


class _FanoutSource:
    """Leaves of a `<raw>::ds::<res>` dataset read the downsample store,
    the others the raw memstore; shards_for answers [] for downsample and
    downsample-routed datasets so the result cache bypasses them (the
    reference's FiloServer._source)."""

    def __init__(self, ms, ds_store):
        self.ms, self.ds_store = ms, ds_store
        self.device = getattr(ms, "device", None)

    def get_shard(self, dataset, shard_num):
        if "::ds::" in dataset:
            return self.ds_store.get_shard(dataset, shard_num)
        return self.ms.get_shard(dataset, shard_num)

    def shards_for(self, dataset):
        if "::ds::" in dataset or dataset == self.ds_store.raw_dataset:
            return []
        return self.ms.shards_for(dataset)


def _long_range(pkg, n=8):
    p = _Pkg(pkg)
    ms, sh, mapper, raw_eng = p.raw(_gauges(n))
    dsr = p.ds.ShardDownsampler(resolutions=(RES,))
    sh.shard_downsampler = dsr
    sh.flush_all_groups()
    store = p.ds_store()
    store.ingest_downsample_batches(0, dsr.result_batches())
    ltr = p.LongTimeRangePlanner(
        p.SingleClusterPlanner("prometheus", mapper),
        p.ds.DownsampleClusterPlanner(store, mapper),
        lambda: START + 3_600_000, lambda: START + 720 * 10_000)
    eng = p.QueryEngine("prometheus", _FanoutSource(ms, store), mapper,
                        planner=ltr, **p.kw)
    return raw_eng, eng


def test_long_time_range_stitch_equals_raw_and_the_reference():
    engines = {pkg: _long_range(pkg) for pkg in PKGS}
    for fn in ("max_over_time", "min_over_time", "sum_over_time",
               "count_over_time"):
        q = f"sum by (_ns_) ({fn}(heap_usage[10m]))"
        got = {pkg: _matrix(engines[pkg][1].query_range(q, *RANGE))
               for pkg in PKGS}
        _same(got["port"], got["jax"], fn)
        raw = _matrix(engines["port"][0].query_range(q, *RANGE))
        _same(got["port"], raw, f"{fn} stitched vs raw")


def test_long_time_range_batch_matches_individual():
    raw_eng, eng = _long_range("port")
    panels = ["sum(max_over_time(heap_usage[10m]))",
              "sum(min_over_time(heap_usage[10m])) by (_ns_)",
              "sum(sum_over_time(heap_usage[10m])) by (dc)"]
    want = [eng.query_range(q, *RANGE) for q in panels]
    got = eng.query_range_batch(panels, *RANGE)
    for q, w, g in zip(panels, want, got):
        assert g.error is None, (q, g.error)
        _same(_matrix(g), _matrix(w), q, rtol=2e-5, atol=1e-4)


def test_batch_job_store_answers_as_the_reference():
    got = {}
    for pkg in PKGS:
        p = _Pkg(pkg)
        raw_cs = p.InMemoryColumnStore()
        ms, sh, mapper, raw_eng = p.raw(_gauges(12), column_store=raw_cs)
        sh.flush_all_groups()
        ds_cs = p.InMemoryColumnStore()
        job = p.ds.DownsamplerJob(raw_cs, ds_cs, "prometheus",
                                  resolutions=(RES,))
        stats = job.run([0], START, START + 720 * 10_000)
        assert (stats.parts_scanned, stats.chunks_read) == (12, 12)
        assert stats.chunks_written == 12 and stats.records_emitted > 0
        store = p.ds_store(column_store=ds_cs)
        assert store.refresh_index(0) == 12
        eng = p.ds_engine(store, mapper)
        got[pkg] = {}
        for fn in ("max_over_time", "min_over_time", "avg_over_time"):
            q = f'sum({fn}(heap_usage{{_ws_="demo"}}[10m]))'
            got[pkg][fn] = _matrix(eng.query_range(q, *RANGE))
            if pkg == "port" and fn != "avg_over_time":
                _same(got[pkg][fn], _matrix(raw_eng.query_range(q, *RANGE)),
                      f"{fn} batch vs raw")
    for fn in got["jax"]:
        _same(got["port"][fn], got["jax"][fn], fn)


def _ds_files(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            out[os.path.relpath(path, root)] = open(path, "rb").read()
    return out


def test_batch_job_disk_store_equals_the_reference_to_the_byte(
        tmp_path, monkeypatch):
    """Raw chunks flushed once (by the reference) to a disk store; each
    package's DownsamplerJob rolls them into its own disk store, at the
    same ingestion time and chunk ids: chunk frames and part-key files
    are the same bytes (the frame index sidecar differs only in the
    mtime it records), also through the ingestion-time scan."""
    jp = _Pkg("jax")
    raw_root = str(tmp_path / "raw")
    raw_cs = jp.LocalDiskColumnStore(raw_root)
    ms, sh, _, _ = jp.raw(lambda p: [
        p.generator.gauge_batch(10, 720, start_ms=START, seed=15),
        p.generator.counter_batch(6, 720, start_ms=START, seed=16),
        p.generator.histogram_batch(3, 720, start_ms=START, seed=17)],
        column_store=raw_cs, meta_store=jp.LocalDiskMetaStore(raw_root))
    sh.flush_all_groups()
    raw_cs.close()
    files = {}
    for pkg in PKGS:
        p = _Pkg(pkg)
        monkeypatch.setattr(p.batch_job.time, "time", lambda: 1_700_000_000)
        for widen in (None, (0, 1 << 62)):
            monkeypatch.setattr(p.chunks, "_next_chunk_id",
                                itertools.count(5_000))
            root = str(tmp_path / f"{pkg}-{widen is not None}")
            raw = p.LocalDiskColumnStore(raw_root)
            out = p.LocalDiskColumnStore(root)
            stats = p.ds.DownsamplerJob(raw, out, "prometheus").run(
                [0], START + 600_000, START + 6_600_000,
                ingestion_window=widen)
            assert stats.parts_scanned == 19
            out.close()
            files[(pkg, widen is not None)] = _ds_files(root)
    for widen in (False, True):
        pf, jf = files[("port", widen)], files[("jax", widen)]
        assert set(pf) == set(jf) and len(pf) == 6
        for name in jf:
            if name.endswith(".idx"):
                assert pf[name][:14] == jf[name][:14], name
                assert pf[name][22:] == jf[name][22:], name
            else:
                assert pf[name] == jf[name], name
    # the widened ingestion-time scan rolls up the same chunks
    plain, widened = files[("port", False)], files[("port", True)]
    assert all(plain[n] == widened[n] for n in plain
               if not n.endswith(".idx"))


class _ShiftOnFirstWrite:
    """A column store wrapper whose first chunk write bumps the shard's
    stores' shift_version, as rows shifting mid-flush would: that flush
    persists but skips its seal, and the next flush re-reads the range."""

    def __init__(self, inner, shard):
        self.inner, self.shard, self.fired = inner, shard, False

    def write_chunks(self, *a, **kw):
        if not self.fired:
            self.fired = True
            for st in self.shard.stores.values():
                st.shift_version += 1
        return self.inner.write_chunks(*a, **kw)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def test_shard_hook_exactly_once_across_a_shift_skipped_seal():
    drains = {}
    for pkg in PKGS:
        p = _Pkg(pkg)
        ms, sh, _, _ = p.raw(_gauges(6))
        dsr = p.ds.ShardDownsampler(resolutions=(RES,))
        sh.shard_downsampler = dsr
        sh.column_store = _ShiftOnFirstWrite(sh.column_store, sh)
        sh.flush_all_groups()
        assert sh.column_store.fired
        first = dsr.result_batches()
        sh.flush_all_groups()          # re-reads the unsealed range
        second = dsr.result_batches()
        drains[pkg] = [_drain_bytes(first), _drain_bytes(second)]
        if pkg == "port":
            n = sum(float(b.columns["count"].sum())
                    for d in (first, second) for b in d.get(RES, ()))
            assert n == 6 * 720
    assert drains["port"] == drains["jax"]
