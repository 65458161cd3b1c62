"""Recovery and background persistence in the port against the JAX
package: the shard's recover_stream and compact_index
(filodb_tpu_torch.core.shard), IngestionLifecycle over MemoryStream and
CsvStream (filodb_tpu_torch.ingest.stream), and the FlushScheduler
(filodb_tpu_torch.core.flush).

- recover_stream against per-group checkpoints: the same samples
  counted, the same store (tests/test_torch_ingest.assert_same_state),
  answers within rtol 2e-4 / atol 1e-3 (__graft_entry__.py:221);
- IngestionLifecycle: the same states, events, recovery_progress and
  samples over a fresh start, a recovery then normal ingest, a flush
  stride, and a CSV file;
- compact_index after evict_ended_partitions: the same tombstones,
  postings (label values, filter lookups) and answers;
- FlushScheduler, driven pass by pass: group rotation, exponential
  backoff after injected flush failures and the recovery after it, and
  the WAL horizon reports that prune sealed segments.
"""
import os

import numpy as np
import pytest

from filodb_tpu.config import WalConfig as JWalConfig
from filodb_tpu.core.flush import FlushScheduler as JFlushScheduler
from filodb_tpu.core.index import Equals as JEquals
from filodb_tpu.core.index import EqualsRegex as JEqualsRegex
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.store import InMemoryColumnStore as JColumnStore
from filodb_tpu.core.store import InMemoryMetaStore as JMetaStore
from filodb_tpu.ingest.generator import (batch_stream, counter_batch,
                                         gauge_batch)
from filodb_tpu.ingest.stream import CsvStream as JCsvStream
from filodb_tpu.ingest.stream import IngestionLifecycle as JLifecycle
from filodb_tpu.ingest.stream import MemoryStream as JMemoryStream
from filodb_tpu.query.engine import QueryEngine as JEngine
from filodb_tpu.utils.faults import faults as jfaults
from filodb_tpu.utils.metrics import registry as jregistry
from filodb_tpu.wal import WalManager as JWalManager
from filodb_tpu.wal.segment import list_segments as jlist_segments
from filodb_tpu_torch.config import WalConfig
from filodb_tpu_torch.core.flush import FlushScheduler
from filodb_tpu_torch.core.index import Equals, EqualsRegex
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.core.store import InMemoryColumnStore, InMemoryMetaStore
from filodb_tpu_torch.ingest import stream as pstream
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.utils.faults import faults
from filodb_tpu_torch.utils.metrics import registry
from filodb_tpu_torch.wal import WalManager
from filodb_tpu_torch.wal.segment import list_segments

from test_torch_flush import _answers, _pair
from test_torch_ingest import (  # noqa: F401 (the fixture)
    _clear_compile_journal, assert_same_answers, assert_same_state, to_port)

START = 1_600_000_000_000
START_S = START // 1000
RTOL, ATOL = 2e-4, 1e-3
DS = "prometheus"


def _stores():
    return (JMemStore(column_store=JColumnStore(), meta_store=JMetaStore()),
            TimeSeriesMemStore(device="cpu",
                               column_store=InMemoryColumnStore(),
                               meta_store=InMemoryMetaStore()))


def _restarted(jm, pm):
    """New memstores over the same column and meta stores (a crash)."""
    return (JMemStore(column_store=jm.column_store,
                      meta_store=jm.meta_store),
            TimeSeriesMemStore(device="cpu", column_store=pm.column_store,
                               meta_store=pm.meta_store))


def _stream(kind):
    full = (gauge_batch(12, 120, start_ms=START) if kind == "gauge"
            else counter_batch(12, 120, start_ms=START, resets=True))
    return list(batch_stream(full, samples_per_chunk=20))


QUERIES = {"gauge": ["avg by (_ns_) (avg_over_time(heap_usage[5m]))",
                     "max by (_ns_) (heap_usage)"],
           "counter": ["sum by (_ns_) (rate(request_total[5m]))",
                       "max by (_ns_) (increase(request_total[5m]))"]}


@pytest.mark.parametrize("kind", ["gauge", "counter"])
def test_recover_stream_against_checkpoints_matches_jax(kind):
    """Batches 0-2 flushed everywhere, batch 3 flushed in a few groups
    only, batches 4-5 never: the restarted shard's recover_stream over
    the whole stream skips per group exactly what its checkpoint
    covers."""
    items = _stream(kind)
    jm, pm = _stores()
    js, ps = jm.setup(DS, 0), pm.setup(DS, 0)
    for i, (b, off) in enumerate(items[:4]):
        js.ingest(b, off)
        ps.ingest(to_port(b), off)
        if i == 2:
            js.flush_all_groups()
            ps.flush_all_groups()
    groups = sorted({p.group for p in ps.partitions})[:3]
    for g in groups:
        js.flush_group(g)
        ps.flush_group(g)
    assert ps.meta_store.read_checkpoints(DS, 0) == \
        js.meta_store.read_checkpoints(DS, 0)
    jm2, pm2 = _restarted(jm, pm)
    js2, ps2 = jm2.setup(DS, 0), pm2.setup(DS, 0)
    assert ps2.recover_index() == js2.recover_index() == 12
    nj = js2.recover_stream(iter(items))
    npt = ps2.recover_stream((to_port(b), off) for b, off in items)
    assert npt == nj
    # every group's first two batches skip, batch 3 in the flushed groups
    assert 12 * 20 * 2 < npt < 12 * 20 * 3
    assert_same_state(jm2, pm2)
    assert_same_answers(jm2, pm2, QUERIES[kind], 119)


def _kinds(events):
    return [e.kind for e in events]


@pytest.mark.parametrize("case", ["fresh", "recovery", "stride"])
def test_lifecycle_over_a_memory_stream_matches_jax(case):
    kind = "counter" if case == "recovery" else "gauge"
    items = _stream(kind)
    jm, pm = _stores()
    if case == "recovery":
        js, ps = jm.setup(DS, 0), pm.setup(DS, 0)
        for b, off in items[:3]:
            js.ingest(b, off)
            ps.ingest(to_port(b), off)
        js.flush_all_groups()
        ps.flush_all_groups()
        js.ingest(*items[3])
        ps.ingest(to_port(items[3][0]), items[3][1])
        g = ps.partitions[0].group
        js.flush_group(g)
        ps.flush_group(g)
        jm, pm = _restarted(jm, pm)
    js, ps = jm.setup(DS, 0), pm.setup(DS, 0)
    jev, pev = [], []
    stride = 2 if case == "stride" else 0
    jl = JLifecycle(js, JMemoryStream(items), [jev.append],
                    flush_stride=stride)
    pl = pstream.IngestionLifecycle(
        ps, pstream.MemoryStream([(to_port(b), o) for b, o in items]),
        [pev.append], flush_stride=stride)
    assert pl.state.value == jl.state.value == "NotStarted"
    nj, npt = jl.start(), pl.start()
    assert npt == nj
    assert pl.state.value == jl.state.value == "Normal"
    assert pl.recovery_progress == jl.recovery_progress == 1.0
    assert _kinds(pev) == _kinds(jev)
    assert [(e.dataset, e.shard) for e in pev] == \
        [(e.dataset, e.shard) for e in jev]
    if case == "recovery":
        assert _kinds(pev).count("RecoveryInProgress") > 1
        assert nj < 12 * 120
    if case == "stride":
        assert ps.stats.flushes == js.stats.flushes >= 3
    assert_same_state(jm, pm)
    assert_same_answers(jm, pm, QUERIES[kind], 119)


def test_lifecycle_stop_before_start_matches_jax():
    items = _stream("gauge")
    jm, pm = _stores()
    jl = JLifecycle(jm.setup(DS, 0), JMemoryStream(items), [])
    pl = pstream.IngestionLifecycle(
        pm.setup(DS, 0),
        pstream.MemoryStream([(to_port(b), o) for b, o in items]), [])
    jl.stop()
    pl.stop()
    assert pl.start() == jl.start() == 0
    assert pl.state.value == jl.state.value == "Stopped"


def _csv(path):
    rows = ["timestamp,metric,_ws_,_ns_,instance,value"]
    for i in range(720):
        rows.append(f"{START + (i // 6) * 10_000},heap_usage,demo,"
                    f"App-{i % 2},Instance-{i % 6},{(i * 7) % 13}.5")
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def test_lifecycle_over_a_csv_stream_matches_jax(tmp_path):
    path = _csv(tmp_path / "in.csv")
    js_, ps_ = JCsvStream(path, batch_size=100), \
        pstream.create_stream("csv", path=path, batch_size=100)
    jb, pb = list(js_.batches(from_offset=99)), list(ps_.batches(99))
    assert [o for _, o in pb] == [o for _, o in jb] == \
        [199, 299, 399, 499, 599, 699, 719]
    for (a, _), (b, _) in zip(jb, pb):
        np.testing.assert_array_equal(b.timestamps, a.timestamps)
        np.testing.assert_array_equal(b.columns["value"], a.columns["value"])
        assert [k.to_bytes() for k in b.part_keys] == \
            [k.to_bytes() for k in a.part_keys]
    jm, pm = _stores()
    jev, pev = [], []
    jl = JLifecycle(jm.setup(DS, 0), js_, [jev.append])
    pl = pstream.IngestionLifecycle(pm.setup(DS, 0), ps_, [pev.append])
    assert pl.start() == jl.start() == 720
    assert _kinds(pev) == _kinds(jev)
    assert pl.state.value == jl.state.value == "Normal"
    assert_same_state(jm, pm)
    assert_same_answers(jm, pm, QUERIES["gauge"], 119)


# --------------------------------------------------------- index compaction

def _postings(sh, eq, regex):
    return (sorted(sh.index.label_values("instance")),
            sorted(sh.index.label_values("_ns_")),
            sh.index.part_ids_from_filters(
                [eq("_metric_", "heap_usage")], 0, 1 << 62).tolist(),
            sh.index.part_ids_from_filters(
                [regex("instance", "Instance-(1|4|7)")], 0, 1 << 62).tolist())


@pytest.mark.parametrize("threshold", [0, 3, 5])
def test_compact_index_after_eviction_matches_jax(threshold):
    jm, pm, js, ps = _pair("gauge", column_store=False)
    for sh in (js, ps):
        for pid in (1, 4, 5, 9):
            sh.index.update_end_time(pid, START + 1000)
    assert ps.evict_ended_partitions(START + 2000) == \
        js.evict_ended_partitions(START + 2000) == 4
    before = _postings(ps, Equals, EqualsRegex)
    assert before == _postings(js, JEquals, JEqualsRegex)
    _, want = _answers(JEngine(DS, jm), "sum by (_ns_) (heap_usage)")
    assert ps.index.tombstone_count == js.index.tombstone_count == 4
    ran = ps.compact_index(threshold)
    assert ran == js.compact_index(threshold) == (threshold in (0, 3))
    assert ps.index.tombstone_count == js.index.tombstone_count \
        == (0 if ran else 4)
    # a second call compacts what the threshold held back, else no-op
    assert ps.compact_index() == js.compact_index() == (not ran)
    after = _postings(ps, Equals, EqualsRegex)
    assert after == _postings(js, JEquals, JEqualsRegex)
    # the evicted instances' values are gone; lookups are unchanged
    assert len(before[0]) == 12 and len(after[0]) == 8
    assert after[2:] == before[2:]
    _, got = _answers(QueryEngine(DS, pm, device="cpu"),
                      "sum by (_ns_) (heap_usage)")
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                   equal_nan=True)


# ----------------------------------------------------------- flush scheduler

class _Passes:
    """Stands in for the scheduler's stop event: `_run` then makes
    exactly `n` passes on the calling thread without sleeping."""

    def __init__(self, n):
        self.n, self.flag = n, False

    def is_set(self):
        return self.flag

    def set(self):
        self.flag = True

    def wait(self, timeout=None):
        self.n -= 1
        self.flag = self.n <= 0
        return self.flag


def _run_passes(sched, n):
    sched._stop = _Passes(n)
    sched._run()


def _schedulers(jm, pm, ds, **kw):
    return JFlushScheduler(jm, ds, **kw), FlushScheduler(pm, ds, **kw)


def _sched_state(s):
    return (s.flushes, s.errors, dict(s._err_streak),
            sorted(s._backoff_until))


def _counter_pair(ds, n=8, samples=300):
    jm, pm = _stores()
    js, ps = jm.setup(ds, 0), pm.setup(ds, 0)
    b = counter_batch(n, samples, start_ms=START)
    js.ingest(b, 5)
    ps.ingest(to_port(b), 5)
    return jm, pm, js, ps


def test_flush_scheduler_rotation_matches_jax():
    ds = "flush_rotation"
    jm, pm, js, ps = _counter_pair(ds)
    jsch, psch = _schedulers(jm, pm, ds, interval_s=60.0, headroom=False)
    for sch in (jsch, psch):
        _run_passes(sch, ps._groups)          # one full rotation
    assert _sched_state(psch) == _sched_state(jsch)
    assert psch.flushes == ps._groups
    assert ps.meta_store.read_checkpoints(ds, 0) == \
        js.meta_store.read_checkpoints(ds, 0)
    store = ps.stores["prom-counter"]
    n = store.num_series
    assert (store.sealed[:n] == store.counts[:n]).all()
    assert_same_state_in(jm, pm, ds)


def assert_same_state_in(jm, pm, ds):
    js, ps = jm.get_shard(ds, 0), pm.get_shard(ds, 0)
    for name, a in js.stores.items():
        b = ps.stores[name]
        n = a.num_series
        np.testing.assert_array_equal(b.sealed[:n], a.sealed[:n])
        np.testing.assert_array_equal(b.counts[:n], a.counts[:n])
    assert ps.stats.chunks_flushed == js.stats.chunks_flushed
    assert ps.stats.flushes == js.stats.flushes


def test_flush_scheduler_backs_off_then_recovers_as_jax():
    ds = "flush_backoff"
    jm, pm, js, ps = _counter_pair(ds)
    jsch, psch = _schedulers(jm, pm, ds, interval_s=60.0, headroom=False)
    g0 = min(p.group for p in ps.partitions)
    # the first flush that persists fails; the shard then backs off one
    # tick (1 s here), far longer than the passes take
    with jfaults.plan("flush.persist", "error", first_k=1), \
            faults.plan("flush.persist", "error", first_k=1):
        _run_passes(jsch, g0 + 3)
        _run_passes(psch, g0 + 3)
    assert _sched_state(psch) == _sched_state(jsch) == (g0, 1, {0: 1}, [0])
    assert registry.gauge("flush_backoff_active", dataset=ds).value == \
        jregistry.gauge("flush_backoff_active", dataset=ds).value == 1
    assert registry.counter("flush_errors", dataset=ds, shard="0").value \
        == jregistry.counter("flush_errors", dataset=ds,
                             shard="0").value == 1
    assert psch.job.consecutive_errors == jsch.job.consecutive_errors == 1
    # the backoff expires: the next flush succeeds and clears the streak
    for sch in (jsch, psch):
        sch._backoff_until[0] = 0.0
        _run_passes(sch, 2)
    assert _sched_state(psch) == _sched_state(jsch)
    assert psch._err_streak == {} and psch._backoff_until == {}
    assert registry.gauge("flush_backoff_active", dataset=ds).value == \
        jregistry.gauge("flush_backoff_active", dataset=ds).value == 0
    assert_same_state_in(jm, pm, ds)


def test_flush_scheduler_reports_wal_horizons_as_jax(tmp_path):
    """Slabs appended through each package's WAL and ingested at their
    seq; one full rotation of the scheduler reports each shard's
    earliest checkpoint, which prunes the sealed segments it covers."""
    ds = "flush_wal"
    jm, pm = _stores()
    jmgr = JWalManager(str(tmp_path / "jax"), ds,
                       JWalConfig(segment_max_bytes=1))
    pmgr = WalManager(str(tmp_path / "port"), ds,
                      WalConfig(segment_max_bytes=1))
    try:
        full = counter_batch(8, 300, start_ms=START)
        for pkg, ms, mgr in (("jax", jm, jmgr), ("port", pm, pmgr)):
            sh = ms.setup(ds, 0)
            for b, _ in batch_stream(full, samples_per_chunk=50):
                b = b if pkg == "jax" else to_port(b)
                ts = b.timestamps.reshape(8, -1)
                vals = b.columns["count"].reshape(8, -1)
                seq = mgr.append_grid(0, "prom-counter", b.part_keys, ts,
                                      {"count": vals})
                sh.ingest_columns("prom-counter", b.part_keys, ts,
                                  {"count": vals}, offset=seq)
        segs0 = len(list_segments(pmgr.dir))
        assert segs0 == len(jlist_segments(jmgr.dir)) > 2
        jsch, psch = _schedulers(jm, pm, ds, interval_s=60.0,
                                 headroom=False, wal=None)
        jsch.wal, psch.wal = jmgr, pmgr
        for sch in (jsch, psch):
            _run_passes(sch, pm.get_shard(ds, 0)._groups)
        horizon = pm.meta_store.read_earliest_checkpoint(ds, 0)
        assert horizon == jm.meta_store.read_earliest_checkpoint(ds, 0) == 5
        assert registry.gauge("wal_persisted_horizon", dataset=ds).value \
            == jregistry.gauge("wal_persisted_horizon",
                               dataset=ds).value == horizon
        names = sorted(os.path.basename(p) for _, p in
                       list_segments(pmgr.dir))
        assert names == sorted(os.path.basename(p) for _, p in
                               jlist_segments(jmgr.dir))
        assert len(names) < segs0
    finally:
        jmgr.close()
        pmgr.close()


def test_flush_scheduler_final_flush_on_stop_matches_jax():
    ds = "flush_stop"
    jm, pm, js, ps = _counter_pair(ds, samples=40)     # under the floor
    jsch, psch = _schedulers(jm, pm, ds, interval_s=60.0, headroom=False)
    for sch in (jsch, psch):
        _run_passes(sch, 4)
        sch.stop(final_flush=True)
    assert _sched_state(psch) == _sched_state(jsch)
    store = ps.stores["prom-counter"]
    n = store.num_series
    assert (store.sealed[:n] == store.counts[:n]).all()
    assert_same_state_in(jm, pm, ds)
