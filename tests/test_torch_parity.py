"""The port against the JAX package where the reference's own tests,
pointed at the port, found it doing less (`tests/
torch_parity_audit.py`).  Each case runs both packages on the same inputs,
made from a seed with numpy, and asserts that the port answers as the
reference: series within rtol 2e-4 / atol 1e-3 (`__graft_entry__.py:221`),
flags, errors, schema sets, group counts, span names and cache keys
exactly.

1. a cold leaf shipped to another node rebinds to that node's tier
   (`persist.segments.query_tier`): a cold-read cluster with one data
   node and two query-only nodes, and the leaf's wire round trip;
2. a dead object store under the cold tier is `shard_unavailable`: a
   flagged partial with `allow_partial_results`, an error without;
3. the config's `schemas` block reaches the memstore and a FiloServer;
4. the shard reads `store.groups_per_shard`, `shard_mem_size`,
   `active_tail_rows`, `resident_cache_bytes` and the flush scheduler
   `min_flush_samples` from its config;
5. a killed query stops paging history between partitions and keeps
   what it paged;
6. a remote write's trace holds the shard's `ingest_columns` span, and
   a flush records `span_flush_seconds`;
7. span events carry the node's name (kernel ledger events too, where
   the reference stamps an empty one), span reporters and the span kill
   switch work, and `FiloSchedulers` asserts thread names;
8. the host group cache drops a shard's entries of older epochs;
9. a column its schema lacks fails a query with the reference's error,
   through the engine (range, instant, batch) and over HTTP (its 400);
   both planners refuse the chunk-metadata plan with one ValueError;
   the native host library is `lib`, the library or None, equal to the
   reference's, and importing it builds and loads nothing;
and the pieces that were missing: `TimeSeriesShard.gather_series`,
`TimeSeriesMemStore.recover_index` / `recover_stream`, and the shard's
registry metrics (`ingested_rows`, `chunks_flushed`, `dense_store_bytes`,
`memory_pressure_evictions`, `write_lock_stalls`).
"""
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from filodb_tpu import config as jconfig
from filodb_tpu.core import memstore as jmemstore
from filodb_tpu.core.flush import FlushScheduler as JFlushScheduler
from filodb_tpu.core.partkey import PartKey as JPartKey
from filodb_tpu.core.records import RecordBatch as JBatch
from filodb_tpu.core.store import InMemoryColumnStore as JColStore
from filodb_tpu.core.store import InMemoryMetaStore as JMetaStore
from filodb_tpu.parallel import serialize as jserialize
from filodb_tpu.parallel import testcluster as jtestcluster
from filodb_tpu.parallel.shardmapper import ShardEvent as JShardEvent
from filodb_tpu.parallel.shardmapper import ShardMapper as JShardMapper
from filodb_tpu.query import activequeries as jaq
from filodb_tpu.query import transformers as jtransformers
from filodb_tpu.query.engine import QueryEngine as JEngine
from filodb_tpu.query.execbase import QueryError as JQueryError
from filodb_tpu.query.rangevector import PlannerParams as JPlannerParams
from filodb_tpu.query.rangevector import QueryContext as JQueryContext
from filodb_tpu.standalone import DatasetConfig as JDatasetConfig
from filodb_tpu.standalone import FiloServer as JFiloServer
from filodb_tpu.utils import metrics as jmetrics
from filodb_tpu_torch import config as pconfig
from filodb_tpu_torch.core import memstore as pmemstore
from filodb_tpu_torch.core.flush import FlushScheduler
from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.records import RecordBatch
from filodb_tpu_torch.core.store import InMemoryColumnStore, InMemoryMetaStore
from filodb_tpu_torch.parallel import serialize as pserialize
from filodb_tpu_torch.parallel import testcluster as ptestcluster
from filodb_tpu_torch.parallel.shardmapper import ShardEvent, ShardMapper
from filodb_tpu_torch.query import activequeries as paq
from filodb_tpu_torch.query import transformers as ptransformers
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.query.execbase import QueryError
from filodb_tpu_torch.query.rangevector import PlannerParams, QueryContext
from filodb_tpu_torch.standalone import DatasetConfig, FiloServer
from filodb_tpu_torch.utils import metrics as pmetrics

from test_torch_ingest import _clear_compile_journal  # noqa: F401
from test_torch_longrange import DS as COLD_DS
from test_torch_longrange import N_WINDOWS, assert_close, assert_identical
from test_torch_objectstore import (PANELS, PKGS, SPAN,  # noqa: F401
                                    _fresh_failure_state, _local_engine,
                                    _setup)
from test_torch_recovery import _run_passes
from torch_doors import assert_same_stores

DS = "prometheus"
SEED = 20
STEP_MS = 10_000
T0 = 1_600_000_000_000

J = {"memstore": lambda **kw: jmemstore.TimeSeriesMemStore(**kw),
     "PartKey": JPartKey, "Batch": JBatch, "ColStore": JColStore,
     "MetaStore": JMetaStore, "Mapper": JShardMapper, "Event": JShardEvent,
     "Engine": lambda ds, ms, mapper: JEngine(ds, ms, mapper),
     "settings": jconfig.FilodbSettings, "QueryError": JQueryError,
     "PlannerParams": JPlannerParams, "aq": jaq, "metrics": jmetrics,
     "tr": jtransformers, "Flush": JFlushScheduler,
     "Server": lambda **kw: JFiloServer(**kw), "Dataset": JDatasetConfig,
     "testcluster": jtestcluster, "serialize": jserialize,
     "QueryContext": JQueryContext}
P = {"memstore": lambda **kw: pmemstore.TimeSeriesMemStore(device="cpu",
                                                           **kw),
     "PartKey": PartKey, "Batch": RecordBatch, "ColStore": InMemoryColumnStore,
     "MetaStore": InMemoryMetaStore, "Mapper": ShardMapper,
     "Event": ShardEvent,
     "Engine": lambda ds, ms, mapper: QueryEngine(ds, ms, mapper,
                                                  device="cpu"),
     "settings": pconfig.FilodbSettings, "QueryError": QueryError,
     "PlannerParams": PlannerParams, "aq": paq, "metrics": pmetrics,
     "tr": ptransformers, "Flush": FlushScheduler,
     "Server": lambda **kw: FiloServer(device="cpu", **kw),
     "Dataset": DatasetConfig, "testcluster": ptestcluster,
     "serialize": pserialize, "QueryContext": QueryContext}
BOTH = {"jax": J, "port": P}


def _gauges(S, k, seed=SEED):
    """ts [S, k] on a 10 s grid from T0 and seeded gauge values."""
    rng = np.random.default_rng(seed)
    ts = np.broadcast_to(T0 + STEP_MS * np.arange(k, dtype=np.int64), (S, k))
    vals = np.round(rng.uniform(0.0, 100.0, (S, k)), 3)
    return np.ascontiguousarray(ts), vals


def _keys(pkg, S, metric="heap_usage"):
    return [pkg["PartKey"].make(metric, {
        "_ws_": "demo", "_ns_": f"App-{i % 4}", "instance": f"I-{i}"})
        for i in range(S)]


def _mapper(pkg, shards=1, ds=DS):
    m = pkg["Mapper"](shards)
    for s in range(shards):
        m.update_from_event(pkg["Event"]("IngestionStarted", ds, s, "n"))
    return m


def _series(res):
    assert res.error is None, res.error
    return {k: (np.asarray(t), np.asarray(v)) for k, t, v in res.series()}


def assert_series_close(port, ref):
    a, b = _series(port), _series(ref)
    assert len(a) == len(b) and len(a) > 0
    for k in b:
        ka = [x for x in a if str(x) == str(k)]
        assert len(ka) == 1, k
        np.testing.assert_array_equal(a[ka[0]][0], b[k][0])
        np.testing.assert_allclose(a[ka[0]][1], b[k][1], rtol=2e-4,
                                   atol=1e-3)


# ------------------------------------------------- 1. cold leaves shipped


def test_cold_read_cluster_with_two_query_only_nodes(tmp_path):
    """One data node and two query-only nodes over one object store: the
    cold leaves go round-robin to nodes that own no shard and revive
    against their tier.  Four rounds of each panel, each bit-identical
    to the package's local tier; the port's within tolerance of the
    reference's."""
    answers = {}
    for name in PKGS:
        pkg, _, _, _ = PKGS[name]
        _, seg_store, _, _, store, up = _setup(name, tmp_path)
        assert up.run_once() == N_WINDOWS
        local = _local_engine(pkg, seg_store)
        tc = BOTH[name]["testcluster"]
        kw = {"device": "cpu"} if name == "port" else {}
        c = tc.make_cold_read_cluster(store, num_shards=1, dataset=COLD_DS,
                                      data_nodes=("data0",),
                                      query_nodes=("q1", "q2"), **kw)
        try:
            assert c.mapper.query_nodes == ["q1", "q2"]
            assert c.mapper.query_node_table() == [
                {"node": "q1", "role": "query-only"},
                {"node": "q2", "role": "query-only"}]
            answers[name] = []
            for q in PANELS:
                want = local.query_range(q, SPAN[0], 300, SPAN[1])
                for _ in range(4):
                    got = c.engine.query_range(q, SPAN[0], 300, SPAN[1])
                    assert got.error is None, got.error
                    assert_identical(got, want, q)
                answers[name].append(got)
        finally:
            c.stop()
    for q, p, j in zip(PANELS, answers["port"], answers["jax"]):
        assert_close(p, j, q)


def test_cold_leaf_wire_round_trip_rebinds_the_tier(tmp_path):
    """A SelectPersistedSegmentsExec encodes its tier as the dataset's
    name; the decoder binds the tier registered in the receiving
    process (`query_tier`), the last one built for the dataset."""
    seen = {}
    for name in PKGS:
        pkg, _, _, _ = PKGS[name]
        _, seg_store, *_ = _setup(name, tmp_path)
        tier = pkg.Tier(seg_store, COLD_DS, 1, pkg.cold_cache())
        if name == "jax":
            from filodb_tpu.persist.segments import query_tier
            from filodb_tpu.query.exec import SelectPersistedSegmentsExec
        else:
            from filodb_tpu_torch.persist.segments import query_tier
            from filodb_tpu_torch.query.leafexec import \
                SelectPersistedSegmentsExec
        assert query_tier(COLD_DS) is tier
        t0 = int(SPAN[0]) * 1000
        leaf = SelectPersistedSegmentsExec(
            BOTH[name]["QueryContext"](query_id="rt"), COLD_DS, 0, [], t0,
            t0 + 3_600_000, tier)
        ser = BOTH[name]["serialize"]
        back = ser.loads(ser.dumps(leaf))
        assert back.tier is tier
        seen[name] = (type(back).__name__, back.shard, back.chunk_start_ms,
                      back.chunk_end_ms, list(back.filters))
    assert seen["port"] == seen["jax"]


# ---------------------------------------------------- 2. dead object store


def _remote_tier_engine(name, store):
    pkg, mod, _, _ = PKGS[name]
    remote = mod.RemoteSegmentStore(store, COLD_DS, 1, ttl_s=1_000.0)
    remote.mount()
    tier = pkg.Tier(remote, COLD_DS, 1, pkg.cold_cache())
    mapper = pkg.mapper()
    return pkg.engine(pkg.memstore(), mapper,
                      pkg.Persisted(COLD_DS, mapper, tier))


@pytest.mark.parametrize("partial", [True, False])
def test_dead_object_store_is_shard_unavailable(tmp_path, partial):
    out = {}
    for name in PKGS:
        _, _, fr, br = PKGS[name]
        *_, store, up = _setup(name, tmp_path)
        assert up.run_once() == N_WINDOWS
        eng = _remote_tier_engine(name, store)
        br.configure(failure_threshold=2, open_base_s=0.05, open_max_s=0.1,
                     jitter=0.0)
        pp = BOTH[name]["PlannerParams"](allow_partial_results=partial)
        with fr.plan("objectstore.get", "error", first_k=1_000_000):
            res = eng.query_range("sum(m)", SPAN[0], 300, SPAN[1], pp)
        err = None if res.error is None else res.error.split(" (")[0]
        out[name] = (err, res.partial, res.num_series)
    assert out["port"] == out["jax"]
    if partial:
        assert out["port"] == (None, True, 0)
    else:
        assert out["port"][0] == \
            "shard_unavailable: shard 0: cold tier unavailable"


# ------------------------------------------------- 3. config schemas


SENSOR_SCHEMA = {"env-schema": {"columns": ["timestamp:ts", "v:double"],
                                "value_column": "v"}}


def test_config_schemas_reach_the_memstore_and_the_server():
    """`env-schema` declared in config: the memstore takes it, and a
    FiloServer ingests and answers a series of it; an explicit schemas=
    still wins."""
    S, k = 6, 60
    ts, vals = _gauges(S, k)
    out = {}
    for name, pkg in BOTH.items():
        cfg = pkg["settings"]().overlay({"schemas": SENSOR_SCHEMA})
        ms = pkg["memstore"](config=cfg)
        explicit = pkg["memstore"](config=cfg,
                                   schemas=jmemstore.DEFAULT_SCHEMAS
                                   if name == "jax"
                                   else pmemstore.DEFAULT_SCHEMAS)
        srv = pkg["Server"](datasets=[pkg["Dataset"](DS, num_shards=1)],
                            config=cfg)
        try:
            sh = srv.memstore.get_shard(DS, 0)
            n = sh.ingest_columns("env-schema", _keys(pkg, S, "room_temp"),
                                  ts, {"v": vals})
            res = srv.engines[DS].query_range(
                "avg by (_ns_) (avg_over_time(room_temp[5m]))",
                T0 // 1000 + 300, 60, T0 // 1000 + 590)
            out[name] = ("env-schema" in ms.schemas,
                         "env-schema" in explicit.schemas,
                         sorted(sh.stores), n, res)
        finally:
            srv.shutdown()
    assert out["port"][:4] == out["jax"][:4]
    assert out["port"][:4] == (True, False, ["env-schema"], S * k)
    assert_series_close(out["port"][4], out["jax"][4])


# -------------------------------------------- 4. the store.* settings


def _store_cfg(pkg, **store):
    cfg = pkg["settings"]()
    for k, v in store.items():
        setattr(cfg.store, k, v)
    return cfg


def test_groups_per_shard_from_config():
    out = {}
    for name, pkg in BOTH.items():
        cfg = _store_cfg(pkg, groups_per_shard=7)
        srv = pkg["Server"](datasets=[pkg["Dataset"](DS, num_shards=2)],
                            config=cfg)
        try:
            S, k = 40, 3
            ts, vals = _gauges(S, k)
            keys = _keys(pkg, S)
            sh = srv.memstore.get_shard(DS, 0)
            sh.ingest_columns("gauge", keys, ts, {"value": vals})
            groups = sorted({sh.group_for(pk) for pk in keys})
            out[name] = ([s._groups for s in srv.memstore.shards_for(DS)],
                         groups, sh.config is cfg)
        finally:
            srv.shutdown()
    assert out["port"] == out["jax"]
    assert out["port"][0] == [7, 7] and max(out["port"][1]) < 7


@pytest.mark.parametrize("setting", ["shard_mem_size", "active_tail_rows"])
def test_enforce_memory_reads_the_budget_and_the_tail(setting):
    """enforce_memory() with no arguments: a config budget of 1 byte
    evicts (the default 512 MiB would not), and the tail it keeps is
    the config's."""
    S, k = 8, 600
    ts, vals = _gauges(S, k)
    out = {}
    for name, pkg in BOTH.items():
        kw = ({"shard_mem_size": 1} if setting == "shard_mem_size"
              else {"shard_mem_size": 1, "active_tail_rows": 50})
        cfg = _store_cfg(pkg, **kw)
        ms = pkg["memstore"](config=cfg, column_store=pkg["ColStore"](),
                             meta_store=pkg["MetaStore"]())
        sh = ms.setup(DS, 0)
        sh.ingest_columns("gauge", _keys(pkg, S), ts, {"value": vals})
        released = sh.enforce_memory()
        counts = sh.stores["gauge"].counts[:S].tolist()
        out[name] = (released > 0, counts, sh.stats.evictions)
    assert out["port"] == out["jax"]
    tail = 512 if setting == "shard_mem_size" else 50
    assert out["port"] == (True, [min(k, tail)] * S, 1)


def test_resident_cache_bytes_from_config():
    out = {}
    for name, pkg in BOTH.items():
        cfg = _store_cfg(pkg, resident_cache_bytes=12_345)
        sh = pkg["memstore"](config=cfg).setup(DS, 0)
        out[name] = sh.resident.budget_bytes
    assert out["port"] == out["jax"] == 12_345


def test_flush_scheduler_reads_min_flush_samples_at_each_flush():
    """A background pass leaves partitions under min_flush_samples
    unsealed; raising the setting between passes takes effect."""
    S = 16
    out = {}
    for name, pkg in BOTH.items():
        cfg = _store_cfg(pkg, min_flush_samples=1_000, groups_per_shard=2)
        ms = pkg["memstore"](config=cfg, column_store=pkg["ColStore"](),
                             meta_store=pkg["MetaStore"]())
        sh = ms.setup(DS, 0)
        ts, vals = _gauges(S, 300)
        sh.ingest_columns("gauge", _keys(pkg, S), ts, {"value": vals})
        sched = pkg["Flush"](ms, DS, interval_s=0.0)
        _run_passes(sched, 2)
        held = sh.stats.chunks_flushed
        cfg.store.min_flush_samples = 100
        _run_passes(sched, 2)
        out[name] = (held, sh.stats.chunks_flushed)
    assert out["port"] == out["jax"]
    assert out["port"][0] == 0 and out["port"][1] > 0


def _counter_store(pkg, cfg, S=24, k=360):
    """A store of S seeded counters over k 10 s samples -> (memstore,
    shard, engine)."""
    rng = np.random.default_rng(SEED)
    ts = np.broadcast_to(T0 + STEP_MS * np.arange(k, dtype=np.int64), (S, k))
    vals = np.cumsum(rng.uniform(0.0, 10.0, (S, k)), axis=1)
    ms = pkg["memstore"](config=cfg, column_store=pkg["ColStore"](),
                         meta_store=pkg["MetaStore"]())
    sh = ms.setup(DS, 0)
    sh.ingest_columns("prom-counter", _keys(pkg, S, "request_total"),
                      np.ascontiguousarray(ts), {"count": vals})
    return ms, sh, pkg["Engine"](DS, ms, _mapper(pkg))


RATE_Q = "sum by (_ns_) (rate(request_total[5m]))"
RATE_SPAN = (T0 // 1000 + 600, 60, T0 // 1000 + 3590)


def test_mirror_settings_from_the_shard_config(monkeypatch):
    """`store.device_mirror_enabled = False`: no mirror, the host gather
    answers.  `store.mirror_background_rebuild = False`: after an
    eviction the first query rebuilds the mirror inline."""
    monkeypatch.setenv("FILODB_TPU_FUSED_INTERPRET", "1")
    out = {}
    for name, pkg in BOTH.items():
        off = _store_cfg(pkg, device_mirror_enabled=False)
        _, sh_off, eng_off = _counter_store(pkg, off)
        r_off = eng_off.query_range(RATE_Q, *RATE_SPAN)
        inline = _store_cfg(pkg, mirror_background_rebuild=False)
        _, sh, eng = _counter_store(pkg, inline)
        eng.query_range(RATE_Q, *RATE_SPAN)
        store = sh.stores["prom-counter"]
        sh.flush_all_groups()
        sh._enforce_memory(budget=1, tail=60)
        r_inline = eng.query_range(RATE_Q, *RATE_SPAN)
        out[name] = (getattr(sh_off.stores["prom-counter"], "device_mirror",
                             None) is None,
                     store.device_mirror.is_fresh(store), r_off, r_inline)
    assert out["port"][:2] == out["jax"][:2] == (True, True)
    assert_series_close(out["port"][2], out["jax"][2])
    assert_series_close(out["port"][3], out["jax"][3])


def test_host_route_threshold_from_the_config(monkeypatch):
    """Under FILODB_TPU_FORCE_HOST_ROUTE the router sends a working set
    of at most the process settings' `query.host_route_max_samples`
    samples to the host; a shard config that differs is not read."""
    monkeypatch.setenv("FILODB_TPU_FUSED_INTERPRET", "1")
    monkeypatch.setenv("FILODB_TPU_FORCE_HOST_ROUTE", "1")
    caps = ((2_000_000, 2_000_000), (10, 10), (2_000_000, 10),
            (10, 2_000_000))               # (the settings', the shard's)
    out = {}
    for name, pkg in BOTH.items():
        routed = []
        for cap, shard_cap in caps:
            cfg = pkg["settings"]()
            cfg.query.host_route_max_samples = shard_cap
            *_, eng = _counter_store(pkg, cfg)
            monkeypatch.setattr(
                (jconfig if name == "jax" else pconfig).settings().query,
                "host_route_max_samples", cap)
            c = pkg["metrics"].registry.counter("leaf_host_routed")
            before = c.value
            res = eng.query_range(RATE_Q, *RATE_SPAN)
            routed.append((c.value - before, res))
        out[name] = routed
    assert [r for r, _ in out["port"]] == [r for r, _ in out["jax"]] \
        == [1, 0, 1, 0]
    for (_, p), (_, j) in zip(out["port"], out["jax"]):
        assert_series_close(p, j)


def test_fused_prep_cache_hits_are_counted(monkeypatch):
    monkeypatch.setenv("FILODB_TPU_FUSED_INTERPRET", "1")
    out = {}
    for name, pkg in BOTH.items():
        *_, eng = _counter_store(pkg, pkg["settings"]())
        c = pkg["metrics"].registry.counter("leaf_fused_prep_hits")
        eng.query_range(RATE_Q, *RATE_SPAN)         # the mirror's upload
        eng.query_range(RATE_Q, *RATE_SPAN)         # fused, a cache miss
        before = c.value
        res = eng.query_range(RATE_Q, *RATE_SPAN)   # fused, a cache hit
        out[name] = (c.value - before, res)
    assert out["port"][0] == out["jax"][0] == 1
    assert_series_close(out["port"][1], out["jax"][1])


# ------------------------------------------------ 5. cancel while paging


def _flushed_and_restarted(pkg, S=8, k=40):
    """A store whose samples are only on its column store: ingest,
    flush, then a fresh memstore over the same stores and recover_index
    (the reference test's setup)."""
    cs, meta = pkg["ColStore"](), pkg["MetaStore"]()
    ms = pkg["memstore"](column_store=cs, meta_store=meta)
    ts, vals = _gauges(S, k)
    keys = _keys(pkg, S)
    sh = ms.setup(DS, 0)
    for j in range(0, k, 10):
        sh.ingest(pkg["Batch"].from_grid(sh.schemas["gauge"], keys,
                                         ts[:, j:j + 10],
                                         {"value": vals[:, j:j + 10]}), j)
    sh.flush_all_groups()
    ms2 = pkg["memstore"](column_store=cs, meta_store=meta)
    sh2 = ms2.setup(DS, 0)
    assert sh2.recover_index() == S
    return ms2, sh2, ts, vals


def test_paging_loop_honors_cancel_and_keeps_paged_work():
    out = {}
    for name, pkg in BOTH.items():
        ms, sh, ts, vals = _flushed_and_restarted(pkg)
        pids = np.arange(sh.num_partitions, dtype=np.int64)
        calls = []

        def cancel():
            calls.append(1)
            if len(calls) > 2:
                raise pkg["QueryError"]("query_canceled", "killed")

        with pytest.raises(pkg["QueryError"], match="query_canceled"):
            sh.ensure_paged_pids("gauge", pids, 0, 10_000_000_000_000,
                                 cancel=cancel)
        kept = sh.stores["gauge"].counts[:sh.num_partitions].tolist()
        again = sh.ensure_paged_pids("gauge", pids, 0, 10_000_000_000_000)
        out[name] = (len(calls), kept, again)
    assert out["port"] == out["jax"]
    assert out["port"][0] == 3
    assert sorted(out["port"][1]) == [0] * 6 + [40] * 2


def _query_killed_during_paging(pkg, ms, sh, q, span, after):
    """Run q with a registered cancel token that is killed while the
    leaf reads the `after`-th partition's history -> (result,
    partitions read)."""
    aq = pkg["aq"]
    ent = aq.active_queries.register(f"parity-kill-{id(ms)}", q)
    read = sh._read_sealed_chunks
    seen = []

    def hooked(info, *a, **kw):
        seen.append(info.part_id)
        if len(seen) == after:
            ent.token.cancel("admin", "killed during paging")
        return read(info, *a, **kw)

    sh._read_sealed_chunks = hooked
    aq.set_admission(ent)
    try:
        res = pkg["Engine"](DS, ms, _mapper(pkg)).query_range(q, *span)
    finally:
        del sh._read_sealed_chunks
        aq.set_admission(None)
        aq.active_queries.deregister(ent, "killed")
    return res, len(seen)


def test_query_killed_during_paging_ends_canceled_and_retry_answers():
    q = "sum by (_ns_) (avg_over_time(heap_usage[5m]))"
    span = (T0 // 1000 + 300, 60, T0 // 1000 + 390)
    out, retry = {}, {}
    for name, pkg in BOTH.items():
        ms, sh, ts, vals = _flushed_and_restarted(pkg)
        res, read = _query_killed_during_paging(pkg, ms, sh, q, span, 2)
        out[name] = (res.error.split(" (")[0] if res.error else None, read)
        retry[name] = pkg["Engine"](DS, ms, _mapper(pkg)).query_range(
            q, *span)
    assert out["port"] == out["jax"]
    assert out["port"] == ("query_canceled: query killed", 2)
    assert_series_close(retry["port"], retry["jax"])


# ----------------------------------------------------- 6. write spans


def _write_payload(pkg_name, series=6, k=3):
    if pkg_name == "jax":
        from filodb_tpu.http import remotepb
        from filodb_tpu.utils import snappy
    else:
        from filodb_tpu_torch.http import remotepb
        from filodb_tpu_torch.utils import snappy
    rng = np.random.default_rng(SEED)
    start = T0
    out = []
    for i in range(series):
        labels = [("__name__", "trace_test_total"), ("_ws_", "trc"),
                  ("_ns_", "t"), ("inst", f"i{i}")]
        samples = [(float(rng.integers(0, 1000)), start + j * 10_000)
                   for j in range(k)]
        out.append(remotepb.PromTimeSeries(labels, samples))
    return snappy.compress(remotepb.encode_write_request(out))


def _node_names():
    return jmetrics.NODE_NAME, pmetrics.NODE_NAME


@pytest.fixture
def _restore_node_names():
    before = _node_names()
    yield
    jmetrics.NODE_NAME, pmetrics.NODE_NAME = before


def test_remote_write_trace_holds_ingest_columns_with_the_node(
        _restore_node_names):
    out = {}
    for name, pkg in BOTH.items():
        srv = pkg["Server"](datasets=[pkg["Dataset"](DS, num_shards=2)],
                            node_name=f"node-{name}")
        try:
            st, pay = srv.api.handle("POST", "/api/v1/write", {},
                                     _write_payload(name))
            assert st == 204
            tid = pay["_headers"]["X-Trace-Id"]
            events = pkg["metrics"].collector.trace(tid)
            leaves = {e["span"].rsplit(".", 1)[-1] for e in events}
            ingest = [e for e in events
                      if e["span"].endswith("ingest_columns")]
            out[name] = (leaves, sorted({e["node"] for e in ingest}),
                         sorted(e.get("dataset") for e in ingest))
        finally:
            srv.shutdown()
    assert out["port"][0] == out["jax"][0]
    assert {"remote_write", "rw_decode", "rw_admission", "rw_build_slabs",
            "ingest_columns"} <= out["port"][0]
    assert out["port"][1] == ["node-port"] and out["jax"][1] == ["node-jax"]
    assert out["port"][2] == out["jax"][2]


def test_flush_span_and_shard_registry_metrics():
    """The shard's registry metrics as the reference records them."""
    S, k = 5, 50
    ts, vals = _gauges(S, k)
    out = {}
    for name, pkg in BOTH.items():
        reg = pkg["metrics"].registry
        ds = f"parity-metrics-{name}"
        ms = pkg["memstore"](column_store=pkg["ColStore"](),
                             meta_store=pkg["MetaStore"]())
        sh = ms.setup(ds, 0)
        sh.ingest(pkg["Batch"].from_grid(sh.schemas["gauge"], _keys(pkg, S),
                                         ts[:, :20], {"value": vals[:, :20]}))
        sh.ingest_columns("gauge", _keys(pkg, S), ts[:, 20:],
                          {"value": vals[:, 20:]})
        sh.flush_all_groups()
        sh.enforce_memory(budget_bytes=1, active_tail_rows=10)
        out[name] = (
            reg.counter("ingested_rows", dataset=ds, shard="0").value,
            reg.counter("chunks_flushed", dataset=ds).value > 0,
            reg.histogram("span_flush_seconds", dataset=ds).count > 0,
            reg.histogram("span_ingest_columns_seconds",
                          dataset=ds).count,
            reg.gauge("dense_store_bytes", dataset=ds, shard="0").value > 0,
            reg.counter("memory_pressure_evictions", dataset=ds).value)
    assert out["port"] == out["jax"]
    assert out["port"] == (S * k, True, True, 1, True, 1)


def test_write_lock_stall_is_counted():
    out = {}
    for name, pkg in BOTH.items():
        reg = pkg["metrics"].registry
        ds = f"parity-stall-{name}"
        sh = pkg["memstore"]().setup(ds, 0)
        held, release = threading.Event(), threading.Event()

        def hold():
            with sh.write_lock:
                held.set()
                release.wait(5)

        t = threading.Thread(target=hold)
        t.start()
        held.wait(5)
        timer = threading.Timer(0.2, release.set)
        timer.start()
        with sh._write_locked("parity", warn_after_s=0.05):
            pass
        t.join()
        out[name] = reg.counter("write_lock_stalls", dataset=ds,
                                shard="0").value
    assert out["port"] == out["jax"] == 1


# --------------------------------------------- 7. span events, reporters


def test_span_events_carry_the_node_and_feed_reporters(_restore_node_names):
    out = {}
    for name, pkg in BOTH.items():
        m = pkg["metrics"]
        m.NODE_NAME = f"n-{name}"
        seen = []
        rep = lambda full, dur, tags: seen.append((full, dict(tags)))  # noqa
        m.add_span_reporter(rep)
        tid = m.mint_trace_id()
        try:
            with m.trace_context(tid):
                with m.span("parity_outer", q="1"):
                    with m.span("parity_inner"):
                        pass
        finally:
            m.remove_span_reporter(rep)
        with m.span("parity_outer", q="1"):
            pass                                  # reporter removed
        events = [(e["span"], e["node"], e.get("q"))
                  for e in m.collector.trace(tid)]
        out[name] = (seen, [(s, q) for s, _, q in events],
                     {n for _, n, _ in events})
    assert out["port"][:2] == out["jax"][:2]
    assert out["port"][0] == [("parity_outer.parity_inner", {}),
                              ("parity_outer", {"q": "1"})]
    assert out["port"][2] == {"n-port"} and out["jax"][2] == {"n-jax"}


def test_kernel_dispatch_events_carry_the_node_set_at_boot(
        _restore_node_names):
    """A kernel ledger entry on a live trace is a span event with the
    node's name.  The reference stamps the name its devicetelem module
    imported (empty: NODE_NAME is set at boot, after the import); the
    port reads the name set at boot, as its spans do."""
    from filodb_tpu.utils.devicetelem import telem as jtelem
    from filodb_tpu_torch.utils.devicetelem import telem as ptelem
    out = {}
    for name, telem in (("jax", jtelem), ("port", ptelem)):
        m = BOTH[name]["metrics"]
        m.NODE_NAME = f"boot-{name}"
        tid = m.mint_trace_id()
        telem.record_dispatch("parity_kernel", device="cpu", seconds=1e-4,
                              origin=tid)
        out[name] = [(e["span"], e["node"]) for e in m.collector.trace(tid)]
    assert out["port"] == [("kernel_dispatch", "boot-port")]
    assert out["jax"] == [("kernel_dispatch", "")]


def test_span_kill_switch_skips_histograms_traces_and_reporters():
    out = {}
    for name, pkg in BOTH.items():
        m = pkg["metrics"]
        h = m.registry.histogram("span_parity_switch_seconds")
        seen = []
        rep = lambda full, dur, tags: seen.append(full)  # noqa: E731
        m.add_span_reporter(rep)
        tid = m.mint_trace_id()
        m.set_spans_enabled(False)
        try:
            with m.trace_context(tid), m.span("parity_switch"):
                pass
            off = (h.count, len(seen), len(m.collector.trace(tid) or []))
        finally:
            m.set_spans_enabled(True)
        with m.trace_context(tid), m.span("parity_switch"):
            pass
        m.remove_span_reporter(rep)
        out[name] = (off, (h.count - off[0], len(seen),
                           len(m.collector.trace(tid) or [])))
    assert out["port"] == out["jax"] == ((0, 0, 0), (1, 1, 1))


def test_filo_schedulers_assert_thread_name():
    out = {}
    for name, pkg in BOTH.items():
        fs = pkg["metrics"].FiloSchedulers
        res = []
        fs.assert_thread_name(fs.INGEST)          # disabled: a no-op
        fs.enabled = True
        try:
            def run():
                fs.assert_thread_name(fs.FLUSH)
                try:
                    fs.assert_thread_name(fs.QUERY)
                except AssertionError as e:
                    res.append(str(e))
            t = threading.Thread(target=run, name="filo-flush-0")
            t.start()
            t.join()
        finally:
            fs.enabled = False
        out[name] = ((fs.INGEST, fs.QUERY, fs.FLUSH), res)
    assert out["port"] == out["jax"]
    assert len(out["port"][1]) == 1 and "'query'" in out["port"][1][0]


# ------------------------------------------------ 8. the group cache


def test_group_cache_evicts_older_epochs_of_the_same_shard():
    """Keys of the cache after: epoch 0 of shard A; epoch 1 of A (evicts
    A's epoch 0, keeps B's); a stale epoch-0 token of A (installs
    nothing, evicts nothing)."""
    S = 8
    out = {}
    for name, pkg in BOTH.items():
        tr = pkg["tr"]
        keys_a = [_rv_key(name, i, "a") for i in range(S)]
        keys_b = [_rv_key(name, i, "b") for i in range(S)]
        with tr._HOST_GROUP_LOCK:
            tr._HOST_GROUP_CACHE.clear()
        by = ("_ns_",)
        ta0, ta1, tb0 = ("A", 0, b"p"), ("A", 1, b"p"), ("B", 0, b"p")
        steps = []
        for tok, keys in ((ta0, keys_a), (tb0, keys_b), (ta1, keys_a),
                          (ta0, keys_a)):
            gids, gkeys = tr._group_ids_cached(tok, keys, by, ())
            steps.append((sorted(k[0] for k in tr._HOST_GROUP_CACHE),
                          gids.tolist(), len(gkeys)))
        with tr._HOST_GROUP_LOCK:
            tr._HOST_GROUP_CACHE.clear()
        out[name] = steps
    assert out["port"] == out["jax"]
    assert out["port"][2][0] == [("A", 1, b"p"), ("B", 0, b"p")]
    assert out["port"][3][0] == out["port"][2][0]


def _rv_key(name, i, tag):
    if name == "jax":
        from filodb_tpu.query.rangevector import RangeVectorKey
    else:
        from filodb_tpu_torch.query.rangevector import RangeVectorKey
    return RangeVectorKey(tuple(sorted({"_ns_": f"ns-{i % 3}",
                                        "inst": f"{tag}{i}"}.items())))


# ---------------------------------------------- the missing public pieces


def test_gather_series_matches_the_reference():
    S, k = 12, 30
    ts, vals = _gauges(S, k)
    out = {}
    for name, pkg in BOTH.items():
        sh = pkg["memstore"]().setup(DS, 0)
        sh.ingest_columns("gauge", _keys(pkg, S), ts, {"value": vals})
        res = sh.lookup_partitions([_filter(name, "_ns_", "App-1")],
                                   0, 1 << 62)
        got = sh.gather_series(res.parts_by_schema[res.first_schema])
        assert sh.gather_series([]) is None
        g_ts, g_cols, g_counts, store = got
        assert store is sh.stores["gauge"]
        assert isinstance(g_ts, np.ndarray)
        out[name] = (g_ts, g_cols["value"], g_counts)
    for a, b in zip(out["port"], out["jax"]):
        np.testing.assert_array_equal(a, b)
    assert out["port"][0].shape[0] == S // 4


def _filter(name, label, value):
    if name == "jax":
        from filodb_tpu.core.index import Equals
    else:
        from filodb_tpu_torch.core.index import Equals
    return Equals(label, value)


def test_memstore_recover_index_and_recover_stream():
    """Flush part of a stream, restart, recover the index and replay the
    whole stream through the memstore: batches at or below each group's
    checkpoint are skipped, so the stores end as the reference's."""
    S, k = 10, 60
    ts, vals = _gauges(S, k)
    stores, counts = {}, {}
    for name, pkg in BOTH.items():
        cs, meta = pkg["ColStore"](), pkg["MetaStore"]()
        ms = pkg["memstore"](column_store=cs, meta_store=meta)
        sh = ms.setup(DS, 0)
        keys = _keys(pkg, S)

        def stream():
            for j in range(0, k, 10):
                yield (pkg["Batch"].from_grid(
                    sh.schemas["gauge"], keys, ts[:, j:j + 10],
                    {"value": vals[:, j:j + 10]}), j)
        for i, (b, off) in enumerate(stream()):
            sh.ingest(b, off)
            if i == 2:
                sh.flush_all_groups()
        ms2 = pkg["memstore"](column_store=cs, meta_store=meta)
        n_index = ms2.recover_index(DS, 0)
        n_replay = ms2.recover_stream(DS, 0, stream())
        stores[name] = ms2
        counts[name] = (n_index, n_replay,
                        ms2.get_shard(DS, 0).stats.rows_ingested)
    assert counts["port"] == counts["jax"]
    assert counts["port"][:2] == (S, S * 30)
    assert_same_stores(stores["port"], stores["jax"])


# ---------------------------------------- 9. the last differences


def _two_schema_store(pkg):
    """24 seeded counters and 24 seeded gauges on one shard -> engine."""
    rng = np.random.default_rng(SEED)
    S, k = 24, 240
    ts = np.ascontiguousarray(np.broadcast_to(
        T0 + STEP_MS * np.arange(k, dtype=np.int64), (S, k)))
    ms = pkg["memstore"](column_store=pkg["ColStore"](),
                         meta_store=pkg["MetaStore"]())
    sh = ms.setup(DS, 0)
    sh.ingest_columns("prom-counter", _keys(pkg, S, "request_total"), ts,
                      {"count": np.cumsum(rng.uniform(0, 10, (S, k)), 1)})
    sh.ingest_columns("gauge", _keys(pkg, S), ts,
                      {"value": np.round(rng.uniform(0, 100, (S, k)), 3)})
    return pkg["Engine"](DS, ms, _mapper(pkg))


@pytest.fixture(scope="module")
def two_schema_engines():
    return {name: _two_schema_store(pkg) for name, pkg in BOTH.items()}


UNKNOWN_COLUMN = {"counter": ("sum(rate(request_total::nosuch[5m]))",
                              "request_total::nosuch"),
                  "gauge": ("sum(heap_usage::nope)", "heap_usage::nope")}
END_S = T0 // 1000 + 2390


@pytest.mark.parametrize("form", ["range", "instant", "batch"])
@pytest.mark.parametrize("schema", ["counter", "gauge"])
def test_unknown_column_error_equals_the_reference(two_schema_engines,
                                                   schema, form):
    errors = {}
    for name, eng in two_schema_engines.items():
        for q in UNKNOWN_COLUMN[schema]:
            if form == "range":
                res = [eng.query_range(q, T0 // 1000 + 600, 60, END_S)]
            elif form == "instant":
                res = [eng.query_instant(q, END_S)]
            else:
                res = eng.query_range_batch([q, q], T0 // 1000 + 600, 60,
                                            END_S)
            errors.setdefault(name, []).extend(r.error for r in res)
    col = "nosuch" if schema == "counter" else "nope"
    assert errors["port"] == errors["jax"]
    assert set(errors["port"]) == {f"KeyError: '{col}'"}


@pytest.mark.parametrize("route", ["query_range", "query"])
@pytest.mark.parametrize("q", [q for pair in UNKNOWN_COLUMN.values()
                               for q in pair])
def test_unknown_column_http_answer_equals_the_reference(two_schema_engines,
                                                         route, q):
    from filodb_tpu.http.routes import PromHttpApi as JApi
    from filodb_tpu_torch.http.routes import PromHttpApi
    params = {"query": q, "time": str(END_S)} if route == "query" else {
        "query": q, "start": str(T0 // 1000 + 600), "end": str(END_S),
        "step": "1m"}
    answers = {}
    for name, Api in (("jax", JApi), ("port", PromHttpApi)):
        st, p = Api({DS: two_schema_engines[name]}).handle(
            "GET", f"/api/v1/{route}", params)
        answers[name] = (st, p["status"], p["errorType"], p["error"])
    assert answers["port"] == answers["jax"]
    assert answers["port"][:3] == (400, "error", "query_error")


def test_raw_chunk_meta_plan_refused_by_both_planners():
    from filodb_tpu.query import logical as jlp
    from filodb_tpu.query.planner import SingleClusterPlanner as JPlanner
    from filodb_tpu_torch.query import logical as plp
    from filodb_tpu_torch.query.planner import SingleClusterPlanner
    errors = {}
    for name, lp, Planner in (("jax", jlp, JPlanner),
                              ("port", plp, SingleClusterPlanner)):
        pkg = BOTH[name]
        plan = lp.RawChunkMeta(lp.IntervalSelector(0, 1 << 62),
                               (_filter(name, "_metric_", "heap_usage"),),
                               "value")
        with pytest.raises(ValueError) as ei:
            Planner(DS, _mapper(pkg)).materialize(plan,
                                                  pkg["QueryContext"]())
        errors[name] = str(ei.value)
    assert errors["port"] == errors["jax"] == \
        "cannot materialize RawChunkMeta"


@pytest.fixture(scope="module")
def native_libs():
    from filodb_tpu import native as jnative
    from filodb_tpu_torch import native as pnative
    if jnative.lib is None or pnative.lib is None:
        pytest.skip("a native host library did not build: "
                    f"{pnative.build_error() or 'the reference'}")
    return jnative.lib, pnative.lib


@pytest.mark.parametrize("n", [0, 5, 33, 1024])
def test_native_lib_equals_the_reference_library(native_libs, n):
    from filodb_tpu_torch.native import lib
    ref, port = native_libs
    assert lib is port
    rng = np.random.default_rng(SEED + n)
    data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    for seed in (0, 1, 0xDEADBEEF):
        assert port.xxhash32(data, seed) == ref.xxhash32(data, seed)
        assert port.xxhash64(data, seed) == ref.xxhash64(data, seed)
    vals = rng.integers(0, 2**40, n).astype(np.uint64)
    vals[::3] = 0
    packed = port.nibble_pack(vals)
    assert packed == ref.nibble_pack(vals)
    np.testing.assert_array_equal(port.nibble_unpack(packed, n), vals)
    np.testing.assert_array_equal(ref.nibble_unpack(packed, n), vals)


def test_importing_native_builds_and_loads_nothing():
    """A fresh interpreter imports the package: no build, no library in
    the process, `lib` not yet resolved; the first read resolves it and
    keeps it in the module's globals."""
    probe = (
        "import json, filodb_tpu_torch.native as n\n"
        "maps = lambda: open('/proc/self/maps').read()\n"
        "before = {'tried': n._tried, 'kept': 'lib' in vars(n),\n"
        "          'mapped': 'libfilodb_native' in maps()}\n"
        "got = n.lib\n"
        "print(json.dumps({'before': before, 'kept': vars(n).get('lib', 0)\n"
        "                  is got, 'tried': n._tried}))\n")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=300,
                         cwd=str(Path(__file__).resolve().parents[1]))
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"before": {"tried": False, "kept": False,
                              "mapped": False},
                   "kept": True, "tried": True}
