"""The persisted-segment tier in the port (filodb_tpu_torch.persist.
segments, persist/compactor.py, core/devicecache.ColdSegmentCache)
against the JAX package, on the same numpy inputs:

- encode_segment's bytes equal the reference's (ragged counts, NaN
  holes, counters with resets); each package decodes the other's file;
- ColdBlock's offsets, rebased values (the port's f32 against the
  reference's f64 cast to f32), bases, first and last raw values,
  cumulative drops, density and shared grid equal the reference's;
- SegmentStore listing and covering;
- the compactor writes byte-identical segment files, skips unchanged
  windows, recompacts when late frames land, and retention prunes the
  covered frames identically;
- the cold region's LRU byte bound (never above the budget, hits keep
  their place), the over-budget degrade to the host (served, never
  booked, answering to the bit as a resident block), and a sweep over
  twice the budget; the `cold` HBM booking follows the resident blocks;
- each package opens the directory the other wrote and answers the
  same (rtol 2e-4 / atol 1e-3, f32 against f64).
"""
import os
import time

import numpy as np
import pytest
import torch

from filodb_tpu.core.devicecache import ColdSegmentCache as JColdCache
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as JSCHEMAS
from filodb_tpu.persist import segments as jseg
from filodb_tpu_torch.core.devicecache import ColdSegmentCache
from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
from filodb_tpu_torch.persist import segments as pseg
from filodb_tpu_torch.persist.segments import (PersistedTier, decode_segment,
                                               encode_segment,
                                               peek_segment_meta,
                                               write_segment_file)
from filodb_tpu_torch.utils.devicetelem import telem

from test_torch_ingest import _clear_compile_journal  # noqa: F401
from test_torch_longrange import (DS, INTERVAL, RTOL, ATOL, T0, WINDOW,
                                  _Pkg, assert_close, assert_identical)


def _pks(pkg, n):
    return [pkg.PartKey("m", (("inst", f"i{i}"), ("_ws_", "w"),
                              ("_ns_", "n"))) for i in range(n)]


def _block_inputs(kind, seed=3):
    """(counts, ts [S, T], {col: vals}) with ragged counts, NaN holes and,
    for counters, resets."""
    rng = np.random.default_rng(seed)
    S, T = 5, 30
    counts = np.asarray([30, 30, 17, 1, 0], np.int32)
    ts = np.zeros((S, T), np.int64)
    for i, c in enumerate(counts):
        ts[i, :c] = T0 + np.arange(c) * INTERVAL + (i % 2) * 7
    if kind == "counter":
        v = np.cumsum(rng.integers(0, 9, size=(S, T)), axis=1).astype(float)
        v[:, 12:] -= v[:, 12:13] - 1.0          # a reset at column 12
        col = "count"
    else:
        v = rng.normal(50.0, 10.0, size=(S, T))
        col = "value"
    v[1, 5] = np.nan
    v[2, 3] = np.inf
    return counts, ts, {col: v}


@pytest.mark.parametrize("kind", ["gauge", "counter"])
def test_encode_segment_bytes_equal_and_cross_decode(tmp_path, kind):
    counts, ts, cols = _block_inputs(kind)
    schema = "prom-counter" if kind == "counter" else "gauge"
    args = (schema, T0, T0 + WINDOW)
    got = encode_segment(*args, _pks(_Pkg(True), 5), counts, ts, cols,
                         source_chunks=7)
    want = jseg.encode_segment(*args, _pks(_Pkg(False), 5), counts, ts, cols,
                               source_chunks=7)
    assert got == want
    path = str(tmp_path / f"{schema}-x.seg")
    write_segment_file(path, got)
    jpath = str(tmp_path / f"{schema}-j.seg")
    jseg.write_segment_file(jpath, want)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    meta = peek_segment_meta(jpath, DS, 0)
    assert (meta.schema_name, meta.num_series, meta.num_samples,
            meta.source_chunks) == (schema, 5, int(counts.sum()), 7)
    for dec, data in ((decode_segment, want), (jseg.decode_segment, got)):
        hdr, ts2, cols2 = dec(data)
        np.testing.assert_array_equal(hdr["counts"], counts)
        for name, v in cols.items():
            for i, c in enumerate(counts):
                np.testing.assert_array_equal(ts2[i, :c], ts[i, :c])
                np.testing.assert_array_equal(cols2[name][i, :c], v[i, :c])
                assert np.isnan(cols2[name][i, c:]).all()
    assert [PartKey.from_bytes(b) for b in
            decode_segment(want)[0]["pk_bytes"]] == _pks(_Pkg(True), 5)


def test_segment_store_covering(tmp_path):
    lists = []
    for port, mod in ((True, pseg), (False, jseg)):
        store = mod.SegmentStore(str(tmp_path / str(port)))
        pks = _pks(_Pkg(port), 1)
        for w in range(3):
            t0 = T0 + w * WINDOW
            store.write(DS, 0, "gauge", t0, t0 + WINDOW, mod.encode_segment(
                "gauge", t0, t0 + WINDOW, pks, np.asarray([1], np.int32),
                np.asarray([[t0]], np.int64), {"value": np.asarray([[1.0]])}))
        assert len(store.list(DS, 0)) == 3
        cov = store.covering(DS, 0, T0 + WINDOW, T0 + 2 * WINDOW - 1)
        assert [m.start_ms for m in cov] == [T0 + WINDOW]
        assert store.covering(DS, 0, T0 - 10 * WINDOW, T0 - 1) == []
        lists.append([(m.schema_name, m.start_ms, m.end_ms, m.num_series,
                       m.num_samples, m.file_bytes)
                      for m in store.list(DS, 0)])
    assert lists[0] == lists[1]


@pytest.mark.parametrize("kind", ["gauge", "counter"])
def test_cold_block_matches_reference(tmp_path, kind):
    counts, ts, cols = _block_inputs(kind)
    schema = "prom-counter" if kind == "counter" else "gauge"
    payload = encode_segment(schema, T0, T0 + WINDOW, _pks(_Pkg(True), 5),
                             counts, ts, cols)
    path = str(tmp_path / "b.seg")
    write_segment_file(path, payload)
    meta = peek_segment_meta(path, DS, 0)
    jmeta = jseg.peek_segment_meta(path, DS, 0)
    got = pseg.ColdBlock(meta, DEFAULT_SCHEMAS[schema],
                         *decode_segment(payload), device="cpu")
    want = jseg.ColdBlock(jmeta, JSCHEMAS[schema],
                          *jseg.decode_segment(payload), device=None)
    np.testing.assert_array_equal(got.ts_off.numpy(), np.asarray(want.ts_off))
    assert got.counter_cols == want.counter_cols
    assert (got.uniform, got.dense) == (want.uniform, want.dense)
    for name in cols:
        assert got.cols[name].dtype == torch.float32
        np.testing.assert_array_equal(
            got.cols[name].numpy(),
            np.asarray(want.cols[name]).astype(np.float32))
        np.testing.assert_array_equal(got.vbase[name], want.vbase[name])
        for part in ("first_raw", "last_raw", "cum_drop"):
            np.testing.assert_array_equal(getattr(got, part).get(name),
                                          getattr(want, part).get(name))
    assert got.nbytes == int(ts.size * 4 + sum(v.size * 4
                                               for v in cols.values()))


def _disk_pair(tmp_path, n_windows=2, n_series=4):
    """Both packages' disk stores holding the same flushed gauges."""
    out = {}
    ns = n_windows * WINDOW // INTERVAL
    ts_grid = T0 + np.arange(ns, dtype=np.int64) * INTERVAL
    vals = (np.arange(n_series)[:, None] * 100.0
            + (np.arange(ns) % 13)[None, :])
    for port in (True, False):
        pkg = _Pkg(port)
        cs = pkg.Disk(str(tmp_path / str(port)))
        ms = pkg.memstore(column_store=cs)
        shard = ms.setup(DS, 0)
        shard.ingest_columns("gauge", _pks(pkg, n_series),
                             np.broadcast_to(ts_grid, (n_series, ns)),
                             {"value": vals})
        shard.flush_all_groups()
        out[port] = (pkg, cs, shard, pkg.Seg(str(tmp_path / str(port))))
    return out, ts_grid, vals


def _segment_bytes(seg_store):
    return [open(m.path, "rb").read() for m in seg_store.list(DS, 0)]


def test_compactor_writes_identical_segments_and_recompacts(tmp_path):
    pair, ts_grid, vals = _disk_pair(tmp_path)
    now = int(ts_grid[-1]) + 10 * WINDOW
    comps = {}
    for port, (pkg, cs, shard, seg) in pair.items():
        comps[port] = comp = pkg.Comp(cs, seg, DS, 1, window_ms=WINDOW,
                                      closed_lag_ms=0)
        assert comp.compact_all(now_ms=now) == 2
        metas = seg.list(DS, 0)
        assert [m.start_ms for m in metas] == [T0, T0 + WINDOW]
        assert sum(m.num_samples for m in metas) == vals.size
        assert comp.compact_all(now_ms=now) == 0        # unchanged windows
        assert comp.windows_skipped == 2
    assert _segment_bytes(pair[True][3]) == _segment_bytes(pair[False][3])
    # a late partition flushes into the compacted windows: both recompact
    for port, (pkg, cs, shard, seg) in pair.items():
        late = [pkg.PartKey("m", (("inst", "late"), ("_ws_", "w"),
                                  ("_ns_", "n")))]
        shard.ingest_columns("gauge", late, ts_grid[None, :5],
                             {"value": np.full((1, 5), 7.0)})
        shard.flush_all_groups()
        # retention keeps frames ingested at or after a pass's start (by
        # the wall clock, in ms): let the clock move past this flush
        time.sleep(0.005)
        assert comps[port].compact_all(now_ms=now) == 1
        assert seg.list(DS, 0)[0].num_samples == vals.size // 2 + 5
    assert _segment_bytes(pair[True][3]) == _segment_bytes(pair[False][3])
    # retention: every frame is covered and older than 1 ms
    pruned = {}
    for port, (pkg, cs, shard, seg) in pair.items():
        before = cs.num_chunksets(DS, 0)
        pruned[port] = comps[port].enforce_retention(retain_raw_ms=1,
                                                     now_ms=now)
        assert pruned[port] == before and cs.num_chunksets(DS, 0) == 0
    assert pruned[True] == pruned[False]
    tier = PersistedTier(pair[True][3], DS, 1,
                         ColdSegmentCache(64 << 20, device="cpu"))
    block, verdict = tier.get_block(pair[True][3].list(DS, 0)[0])
    assert verdict == "cold_paged"
    assert block.counts.sum() == WINDOW // INTERVAL * 4 + 5


def test_compaction_scheduler_is_a_job(tmp_path):
    from filodb_tpu_torch.persist.compactor import CompactionScheduler
    from filodb_tpu_torch.utils.jobs import jobs
    pair, ts_grid, _ = _disk_pair(tmp_path, n_windows=1)
    pkg, cs, _, seg = pair[True]
    comp = pkg.Comp(cs, seg, DS, 1, window_ms=WINDOW, closed_lag_ms=0)
    sched = CompactionScheduler(comp, interval_s=3600)
    assert sched.run_once() == 1
    assert sched.passes == 1
    names = {(j["job"], j["dataset"]) for j in jobs.snapshot()}
    assert ("compaction", DS) in names


class _FakeBlock:
    def __init__(self, nbytes):
        self.nbytes = nbytes


def test_cold_region_lru_never_exceeds_budget():
    limit = 10_000
    cache = ColdSegmentCache(limit, device="cpu")
    jcache = JColdCache(limit, use_placer=False)
    booked0 = telem.hbm_booked("cpu", "cold")
    for i in range(20):
        for c in (cache, jcache):
            block, verdict = c.get(("seg", i), 1_000, 0,
                                   lambda dev: _FakeBlock(1_000))
            assert verdict == "cold_paged"
            assert c.bytes_booked <= limit
        assert telem.hbm_booked("cpu", "cold") - booked0 \
            == cache.bytes_booked
    resident = ("seg", 19)
    for c in (cache, jcache):
        _, v = c.get(resident, 1_000, 0, lambda dev: _FakeBlock(1_000))
        assert v == "cold_hit"
        for i in range(100, 109):
            c.get(("seg", i), 1_000, 0, lambda dev: _FakeBlock(1_000))
            assert c.bytes_booked <= limit
        _, v = c.get(resident, 1_000, 0, lambda dev: _FakeBlock(1_000))
        assert v == "cold_hit"
    assert cache.bytes_booked == jcache.bytes_booked
    cache.clear()
    assert telem.hbm_booked("cpu", "cold") == booked0


def test_cold_region_budget_holds_under_concurrent_page_ins():
    """Two page-ins of different segments at once, under a budget that
    holds one block: the second reservation waits for the first block to
    become evictable, so no build ever runs with more than the budget
    booked (the reference reserves both and books twice its budget)."""
    import threading
    limit = 1_000
    cache = ColdSegmentCache(limit, device="cpu")
    seen = []

    def build(dev):
        seen.append(cache.bytes_booked)
        time.sleep(0.2)
        return _FakeBlock(1_000)
    threads = [threading.Thread(target=cache.get,
                                args=(("seg", i), 1_000, 0, build))
               for i in range(2)]
    for t in threads:
        t.start()
        time.sleep(0.02)
    for t in threads:
        t.join(timeout=10)
    assert seen == [1_000, 1_000]
    assert cache.bytes_booked == 1_000 and len(cache.blocks()) == 1
    cache.clear()


def test_cold_region_over_budget_degrades_to_host():
    cache = ColdSegmentCache(5_000, device="cpu")
    seen = []
    block, verdict = cache.get(("big", 0), 50_000, 0,
                               lambda dev: seen.append(dev)
                               or _FakeBlock(50_000))
    assert verdict == "cold_paged"
    assert seen == ["host"]
    assert cache.bytes_booked == 0


def test_cold_query_sweep_over_twice_budget(tmp_path):
    """A sweep whose working set is twice the cold budget never exceeds
    the budget and still answers."""
    pair, ts_grid, _ = _disk_pair(tmp_path, n_windows=4)
    pkg, cs, _, seg = pair[True]
    pkg.Comp(cs, seg, DS, 1, window_ms=WINDOW, closed_lag_ms=0).compact_all(
        now_ms=int(ts_grid[-1]) + 10 * WINDOW)
    metas = seg.list(DS, 0)
    assert len(metas) == 4
    one = metas[0].device_bytes_estimate()
    cache = ColdSegmentCache(2 * one + one // 2, device="cpu")
    tier = PersistedTier(seg, DS, 1, cache)
    evictions = 0
    for _ in range(2):
        for m in metas:
            block, _ = tier.get_block(m)
            assert cache.bytes_booked <= cache.limit_bytes
            assert block.counts.sum() == m.num_samples
            assert not block.is_host
            evictions = max(evictions, 4 - len(cache.blocks()))
    assert evictions >= 1


def _persisted_engine(pkg, root, limit, now):
    cs = pkg.Disk(str(root))
    seg = pkg.Seg(str(root))
    pkg.Comp(cs, seg, DS, 1, window_ms=WINDOW, closed_lag_ms=0).compact_all(
        now_ms=now)
    tier = pkg.Tier(seg, DS, 1, pkg.cold_cache(limit))
    mapper = pkg.mapper()
    return pkg.engine(pkg.memstore(), mapper,
                      pkg.Persisted(DS, mapper, tier)), tier


def test_over_budget_degrade_answers_as_a_resident_block(tmp_path):
    """Counters over two segments: with a budget below one block every
    query decodes on the host (device_mirror_cold_over_budget rises, the
    region books nothing), and the answer equals the resident region's
    to the bit."""
    from filodb_tpu_torch.utils.metrics import registry
    ns = 2 * WINDOW // INTERVAL
    ts_grid = T0 + np.arange(ns, dtype=np.int64) * INTERVAL
    vals = np.cumsum(np.full((4, ns), 2.0), axis=1)
    vals[:, ns // 2:] -= vals[:, ns // 2:ns // 2 + 1] - 1.0
    pkg = _Pkg(True)
    cs = pkg.Disk(str(tmp_path))
    sh = pkg.memstore(column_store=cs).setup(DS, 0)
    sh.ingest_columns("prom-counter", _pks(pkg, 4),
                      np.broadcast_to(ts_grid, (4, ns)), {"count": vals})
    sh.flush_all_groups()
    now = int(ts_grid[-1]) + 10 * WINDOW
    eng, tier = _persisted_engine(pkg, tmp_path, 256 << 20, now)
    small, small_tier = _persisted_engine(pkg, tmp_path, 1_000, now)
    q = "sum(rate(m[10m]))"
    start_s, end_s = T0 // 1000 + 600, int(ts_grid[-1]) // 1000
    over = registry.counter("device_mirror_cold_over_budget")
    o0 = over.value
    want = eng.query_range(q, start_s, 60, end_s)
    got = small.query_range(q, start_s, 60, end_s)
    assert over.value - o0 == 2
    assert small_tier.cold_cache.bytes_booked == 0
    assert got.stats.cold_tier == "cold_paged"
    assert_identical(got, want, q)


@pytest.mark.parametrize("writer_is_port", [True, False])
def test_each_package_reads_the_others_directory(tmp_path, writer_is_port):
    """One package flushes and compacts; both open the directory and
    answer a persisted panel the same."""
    ns = 2 * WINDOW // INTERVAL
    ts_grid = T0 + np.arange(ns, dtype=np.int64) * INTERVAL
    vals = np.cumsum(np.full((4, ns), 3.0), axis=1) + 11.0
    writer = _Pkg(writer_is_port)
    cs = writer.Disk(str(tmp_path))
    sh = writer.memstore(column_store=cs).setup(DS, 0)
    sh.ingest_columns("prom-counter", _pks(writer, 4),
                      np.broadcast_to(ts_grid, (4, ns)), {"count": vals})
    sh.flush_all_groups()
    cs.close()
    now = int(ts_grid[-1]) + 10 * WINDOW
    q = "sum(rate(m[10m]))"
    start_s, end_s = T0 // 1000 + 600, int(ts_grid[-1]) // 1000
    res = {}
    for port in (True, False):
        eng, _ = _persisted_engine(_Pkg(port), tmp_path, 256 << 20, now)
        res[port] = eng.query_range(q, start_s, 60, end_s)
    assert len(os.listdir(tmp_path / DS / "shard-0" / "segments")) == 2
    assert_close(res[True], res[False], q, RTOL, ATOL)


def test_persisted_leaf_finds_the_schema_of_its_metric(tmp_path):
    """Gauges and counters compacted into one shard's segments: a counter
    panel through PersistedClusterPlanner reads the counter segments and
    answers as the in-memory store does.  The reference reads only the
    first schema it lists (the gauge segments here) and answers nothing
    (a recorded difference, ROADMAP.md Queue 3)."""
    ns = 2 * WINDOW // INTERVAL
    ts_grid = T0 + np.arange(ns, dtype=np.int64) * INTERVAL
    counters = np.cumsum(np.full((4, ns), 2.0), axis=1)
    gauges = np.arange(4)[:, None] * 10.0 + (np.arange(ns) % 7)[None, :]
    q = "sum(rate(c[10m]))"
    start_s, end_s = T0 // 1000 + 600, int(ts_grid[-1]) // 1000
    res = {}
    for port in (True, False):
        pkg = _Pkg(port)
        root = tmp_path / str(port)
        cs = pkg.Disk(str(root))
        ms = pkg.memstore(column_store=cs)
        sh = ms.setup(DS, 0)
        grid = np.broadcast_to(ts_grid, (4, ns))
        sh.ingest_columns("gauge", _pks(pkg, 4), grid, {"value": gauges})
        sh.ingest_columns("prom-counter",
                          [pkg.PartKey("c", pk.tags) for pk in _pks(pkg, 4)],
                          grid, {"count": counters})
        sh.flush_all_groups()
        now = int(ts_grid[-1]) + 10 * WINDOW
        eng, _ = _persisted_engine(pkg, root, 256 << 20, now)
        assert [m.schema_name for m in pkg.Seg(str(root)).list(DS, 0)][:2] \
            == ["gauge", "prom-counter"]
        res[port] = eng.query_range(q, start_s, 60, end_s)
        if port:
            hot = pkg.engine(ms, pkg.mapper(), pkg.Single(DS, pkg.mapper()))
            assert res[port].num_series == 1
            assert_close(res[port], hot.query_range(q, start_s, 60, end_s),
                         q)
    assert res[False].error is None and res[False].num_series == 0
