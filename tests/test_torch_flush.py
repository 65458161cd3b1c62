"""Flush, seal, memory enforcement, eviction and demand paging in the port
(filodb_tpu_torch.core.shard, memory/resident.py, core/store.py) against
the JAX package; the chunk encoding itself is tests/test_torch_codec.py's.

- Flush: the same chunks per series in an InMemoryColumnStore, the same
  part-key records and group checkpoints in the meta store.
- enforce_memory, then full-range queries that page the evicted history
  back (from the resident tier or the column store): answers within
  rtol 2e-4 / atol 1e-3 of the JAX engine's (__graft_entry__.py:221).
- evict_ended_partitions and the tombstone reclaim.
- The paging limit: PagedLimitExceeded keeps the work done, and the
  leaf turns it into QueryError("paged_limit_exceeded").
"""
import numpy as np
import pytest

from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.store import InMemoryColumnStore as JColumnStore
from filodb_tpu.core.store import InMemoryMetaStore as JMetaStore
from filodb_tpu.ingest.generator import (counter_batch, gauge_batch,
                                         histogram_batch)
from filodb_tpu.query.engine import QueryEngine as JEngine
from filodb_tpu.query.rangevector import PlannerParams as JParams
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.core.shard import PagedLimitExceeded
from filodb_tpu_torch.core.store import InMemoryColumnStore, InMemoryMetaStore
from filodb_tpu_torch.memory import chunks
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.query.rangevector import PlannerParams
from filodb_tpu_torch.utils.counters import counters

from test_torch_codec import INGEST_MS, _same_chunk
from test_torch_ingest import (  # noqa: F401 (the fixture)
    _clear_compile_journal, assert_same_state, time_slices, to_port)

START = 1_600_000_000_000
START_S = START // 1000
RTOL, ATOL = 2e-4, 1e-3


def _pair(kind, column_store=True):
    """JAX and port memstores holding the same slices of one batch, with
    in-memory column and meta stores (or none)."""
    if kind == "hist":
        full = histogram_batch(6, 240, start_ms=START)
        bounds = [(0, 120), (120, 200), (200, 240)]
    elif kind == "gauge":
        full = gauge_batch(12, 240, start_ms=START)
        bounds = [(0, 100), (100, 240)]
    else:
        full = counter_batch(16, 240, start_ms=START, resets=True)
        bounds = [(0, 100), (100, 180), (180, 240)]
    kw = {}
    jkw = {}
    if column_store:
        kw = dict(column_store=InMemoryColumnStore(),
                  meta_store=InMemoryMetaStore())
        jkw = dict(column_store=JColumnStore(), meta_store=JMetaStore())
    jm = JMemStore(**jkw)
    pm = TimeSeriesMemStore(device="cpu", **kw)
    js, ps = jm.setup("prometheus", 0), pm.setup("prometheus", 0)
    for i, b in enumerate(time_slices(full, bounds)):
        js.ingest(b, offset=10 + i)
        ps.ingest(to_port(b), offset=10 + i)
    return jm, pm, js, ps


def _flush_all(shard):
    return sum(shard.flush_group(g, ingestion_time_ms=INGEST_MS)
               for g in range(shard._groups))


@pytest.mark.parametrize("kind", ["counter", "gauge", "hist"])
def test_flush_writes_same_chunks_and_checkpoints(kind):
    jm, pm, js, ps = _pair(kind)
    assert _flush_all(js) == _flush_all(ps) == len(ps.partitions)
    assert ps.stats.chunks_flushed == len(ps.partitions)
    assert pm.meta_store.read_checkpoints("prometheus", 0) == \
        jm.meta_store.read_checkpoints("prometheus", 0)
    assert set(pm.meta_store.read_checkpoints("prometheus", 0).values()) \
        == {12 if kind != "gauge" else 11}
    for jp, pp in zip(js.partitions, ps.partitions):
        want = jm.column_store.read_chunks("prometheus", 0, jp.part_key,
                                           0, 1 << 62)
        got = pm.column_store.read_chunks("prometheus", 0, pp.part_key,
                                          0, 1 << 62)
        assert len(got) == len(want) == 1
        _same_chunk(got[0], want[0])
        # the same encoded chunk stays resident
        assert ps.resident.read(pp.part_id, 0, 1 << 62)[0] is got[0]
    jpk = {r.part_key.to_bytes(): r for r in
           jm.column_store.read_part_keys("prometheus", 0)}
    ppk = {r.part_key.to_bytes(): r for r in
           pm.column_store.read_part_keys("prometheus", 0)}
    assert set(jpk) == set(ppk)
    for k, r in ppk.items():
        assert (r.schema_name, r.start_time_ms, r.end_time_ms) == \
            (jpk[k].schema_name, jpk[k].start_time_ms, jpk[k].end_time_ms)
    assert_same_state(jm, pm)
    assert ps.resident.bytes_used == js.resident.bytes_used
    # a second flush has nothing left to seal; checkpoints hold
    assert _flush_all(ps) == 0
    assert pm.flush_all("prometheus") == 0


def test_flush_min_samples_batches_like_jax():
    """Write-buffer batching: partitions below min_samples wait, and the
    group checkpoint claims only the last fully persisted offset."""
    jm, pm, js, ps = _pair("counter")
    for sh in (js, ps):
        sh.flush_group(0, INGEST_MS, min_samples=10_000)
        sh.flush_group(1, INGEST_MS)
        sh.flush_group(1, INGEST_MS, min_samples=10_000)
    assert pm.meta_store.read_checkpoints("prometheus", 0) == \
        jm.meta_store.read_checkpoints("prometheus", 0)
    assert ps._group_skip_rounds == js._group_skip_rounds
    assert_same_state(jm, pm)


QUERIES = {
    "counter": ["sum by (_ns_) (rate(request_total[5m]))",
                "max by (_ns_) (changes(request_total[5m]))",
                "request_total"],
    "gauge": ["avg by (_ns_) (avg_over_time(heap_usage[5m]))",
              "max by (_ns_) (heap_usage)"],
    "hist": ["sum by (_ns_) (rate(http_latency[5m]))",
             "histogram_quantile(0.9, sum by (_ns_) "
             "(rate(http_latency[5m])))"],
}


def _answers(eng, q, params=None):
    r = eng.query_range(q, START_S + 300, 60, START_S + 2390, params)
    assert r.error is None, r.error
    return r, sorted((k.labels, np.asarray(v, np.float64))
                     for k, _, v in r.series())


@pytest.mark.parametrize("kind", ["counter", "gauge", "hist"])
@pytest.mark.parametrize("column_store", [True, False])
def test_enforce_memory_then_paged_answers_match_jax(kind, column_store):
    jm, pm, js, ps = _pair(kind, column_store)
    je = JEngine("prometheus", jm)
    pe = QueryEngine("prometheus", pm, device="cpu")
    for q in QUERIES[kind]:
        _answers(pe, q)                       # the mirror exists
    assert js.memory_usage() == ps.memory_usage()
    released = ps.enforce_memory(budget_bytes=1, active_tail_rows=40)
    assert released == js.enforce_memory(budget_bytes=1, active_tail_rows=40)
    assert released > 0
    assert js.memory_usage() == ps.memory_usage()
    store = next(iter(ps.stores.values()))
    assert int(store.counts[:store.num_series].max()) == 40
    fb0 = counters.get("device_mirror_query_fallbacks")
    for qi, q in enumerate(QUERIES[kind]):
        got_res, got = _answers(pe, q)
        _, want = _answers(je, q)
        if qi == 0:
            assert got_res.stats.samples_paged > 0
        assert [k for k, _ in got] == [k for k, _ in want], q
        for (k, g), (_, w) in zip(got, want):
            assert (np.isnan(g) == np.isnan(w)).all(), (q, k)
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       equal_nan=True, err_msg=f"{q} {k}")
    mirror = store.device_mirror
    assert mirror.join_rebuild(timeout=60)
    assert counters.get("device_mirror_query_fallbacks") > fb0
    assert mirror.is_fresh(store)
    assert_same_state(jm, pm)


def test_evict_ended_partitions_matches_jax():
    jm, pm, js, ps = _pair("gauge", column_store=False)
    ended = [1, 4, 5, 9]
    for sh in (js, ps):
        for pid in ended:
            sh.index.update_end_time(pid, START + 1000)
    epoch0 = ps.keys_epoch
    assert ps.evict_ended_partitions(START + 2000, max_per_lock=3) == \
        js.evict_ended_partitions(START + 2000, max_per_lock=3) == 4
    assert ps.keys_epoch > epoch0
    assert ps.num_partitions == js.num_partitions == 8
    assert ps.stats.evictions == js.stats.evictions == 4
    pe = QueryEngine("prometheus", pm, device="cpu")
    je = JEngine("prometheus", jm)
    for q in ("heap_usage", "avg by (_ns_) (avg_over_time(heap_usage[5m]))"):
        _, got = _answers(pe, q)
        _, want = _answers(je, q)
        assert [k for k, _ in got] == [k for k, _ in want]
        for (_, g), (_, w) in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       equal_nan=True)
    # tombstones stay resolvable until the grace window passes
    assert ps.partitions[1] is not None and not ps._pid_alive[1]
    assert ps._prune_tombstones(grace_s=0.0) == 4
    assert ps.partitions[1] is None
    k = ps.keys_for(np.array([1, 0]))
    assert k[0].labels == (("_evicted_", "1"),)
    assert dict(k[1].labels)["instance"] == "Instance-0"
    # an evicted key ingested again becomes a new partition
    g = gauge_batch(12, 10, start_ms=START + 3_000_000)
    n_before = len(ps.partitions)
    ps.ingest(to_port(g), offset=99)
    assert len(ps.partitions) == n_before + 4
    assert ps.num_partitions == 12


def test_paged_limit_exceeded_keeps_work_and_surfaces_as_query_error():
    jm, pm, js, ps = _pair("counter")
    ps.enforce_memory(budget_bytes=1, active_tail_rows=4)
    js.enforce_memory(budget_bytes=1, active_tail_rows=4)
    parts = ps.partitions[:4]
    with pytest.raises(PagedLimitExceeded) as ei:
        ps.ensure_paged(parts, START, START + 2400_000, max_samples=250)
    err = ei.value
    assert isinstance(err, ValueError)
    assert err.samples_paged > 250 and err.partitions_paged >= 1
    store = ps.stores["prom-counter"]
    assert int(store.paged_floor[parts[0].row]) <= START
    from filodb_tpu.core.shard import PagedLimitExceeded as JPagedLimit
    with pytest.raises(JPagedLimit) as jei:
        js.ensure_paged(js.partitions[:4], START, START + 2400_000,
                        max_samples=250)
    assert (err.samples_paged, err.partitions_paged) == \
        (jei.value.samples_paged, jei.value.partitions_paged)
    assert_same_state(jm, pm)
    q = "sum(rate(request_total[5m]))"
    got = QueryEngine("prometheus", pm, device="cpu").query_range(
        q, START_S + 300, 60, START_S + 2390,
        PlannerParams(scan_limit=600, enforced_limits=True))
    want = JEngine("prometheus", jm).query_range(
        q, START_S + 300, 60, START_S + 2390,
        JParams(scan_limit=600, enforced_limits=True))
    assert want.error.startswith("paged_limit_exceeded:")
    assert got.error == want.error
    # under a limit that fits, the same query pages and answers
    ok = QueryEngine("prometheus", pm, device="cpu").query_range(
        q, START_S + 300, 60, START_S + 2390,
        PlannerParams(scan_limit=10_000, enforced_limits=True))
    assert ok.error is None and len(list(ok.series())) == 1


def test_resident_cache_budget_evicts_oldest_only_when_persistent():
    from filodb_tpu_torch.memory.resident import ResidentChunkCache
    ts = START + np.arange(50, dtype=np.int64) * 10_000
    cs = [chunks.encode_chunkset(ts + i * 500_000,
                                 {"v": np.arange(50.0) + i},
                                 {"v": "double"}, INGEST_MS)
          for i in range(4)]
    budget = 2 * (cs[0].nbytes + ResidentChunkCache.CHUNK_OVERHEAD) + 10
    c = ResidentChunkCache(budget, persistent=True)
    e0 = counters.get("resident_chunks_evicted")
    for i, x in enumerate(cs):
        c.add(i % 2, x)
    assert c.num_chunks == 2 and c.chunks_evicted == 2
    assert counters.get("resident_chunks_evicted") - e0 == 2
    assert c.coverage_floor(0) == int(cs[2].info.start_time_ms)
    keep = ResidentChunkCache(budget, persistent=False)
    for i, x in enumerate(cs):
        keep.add(i % 2, x)
    assert keep.num_chunks == 4
    keep.drop_part(0)
    assert keep.num_chunks == 2 and keep.read(1, 0, 1 << 62)[0] is cs[1]


def test_drop_shard_keeps_persisted_chunks():
    """drop_shard releases the local working set (and only once); the
    chunks it flushed stay in the column store, as in the reference."""
    jm, pm, js, ps = _pair("gauge")
    _flush_all(ps)
    _flush_all(js)
    n = pm.column_store.num_chunksets()
    assert n == jm.column_store.num_chunksets() == len(ps.partitions)
    assert pm.drop_shard("prometheus", 0) == jm.drop_shard("prometheus", 0)
    assert pm.get_shard("prometheus", 0) is None
    assert pm.drop_shard("prometheus", 0) is False
    assert pm.column_store.num_chunksets() == n
    with pytest.raises(KeyError):
        pm.ingest("prometheus", 0, to_port(gauge_batch(2, 3, start_ms=START)))
