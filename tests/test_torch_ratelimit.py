"""The port's cardinality tracker, quotas and stores (core/ratelimit.py)
and the shard's admission pieces against the JAX package's, mirroring
tests/test_ratelimit.py: the same calls on each package's tracker give
the same records and the same QuotaReachedException; a SQLite
cardinality file written by either package reopens in the other with the
same counts; the shard drops over-quota and over-budget series as the
reference does; /api/v1/metering/cardinality and /api/v1/status/tsdb
answer the reference's payloads.  The CLI's topkcard waits for the port's
cli.py.
"""
import json
import urllib.request

import pytest

import filodb_tpu.core.ratelimit as jrl
import filodb_tpu_torch.core.ratelimit as rl
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.ingest.generator import gauge_batch as jgauge_batch
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.ingest.generator import gauge_batch

from test_torch_ingest import _clear_compile_journal  # noqa: F401
from torch_doors import DS, Node, assert_same_stores, split_headers

START = 1_600_000_020_000
PKGS = {"jax": (jrl, JMemStore, jgauge_batch, {}),
        "port": (rl, TimeSeriesMemStore, gauge_batch, {"device": "cpu"})}


def _rec(r):
    return None if r is None else (r.prefix, r.ts_count, r.active_ts_count,
                                   r.children_count, r.children_quota)


def _track_n(tracker, ws, ns, metric, n):
    for i in range(n):
        tracker.series_created((ws, ns, f"{metric}{i}"))


def _both(fn):
    out = {pkg: fn(*mods) for pkg, mods in PKGS.items()}
    assert out["port"] == out["jax"]
    return out["port"]


def test_counts_at_every_depth():
    def run(m, *_):
        t = m.CardinalityTracker()
        _track_n(t, "demo", "App-1", "m", 5)
        _track_n(t, "demo", "App-2", "m", 3)
        return ([_rec(t.cardinality(p)) for p in
                 ((), ("demo",), ("demo", "App-1"), ("demo", "App-2"),
                  ("demo", "App-1", "m3"), ("nosuch",))],
                [_rec(r) for r in t.top_k(("demo",), 1)],
                sorted(_rec(r) for r in t.children(("demo",))))
    out = _both(run)
    assert out[0][0][1] == 8 and out[0][2][1] == 5 and out[0][1][3] == 2
    assert out[1][0][:2] == (("demo", "App-1"), 5)


def test_quota_enforced_at_prefix():
    def run(m, *_):
        qs = m.QuotaSource(default_quota=1_000_000)
        qs.set_quota(("demo", "App-1"), 3)
        t = m.CardinalityTracker(quota_source=qs)
        _track_n(t, "demo", "App-1", "m", 3)
        with pytest.raises(m.QuotaReachedException) as ei:
            t.series_created(("demo", "App-1", "m99"))
        t.series_created(("demo", "App-2", "m0"))
        return (ei.value.prefix, ei.value.quota, str(ei.value),
                _rec(t.cardinality(("demo",))))
    out = _both(run)
    assert out[0] == ("demo", "App-1") and out[3][1] == 4


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_quota_at_every_prefix_depth(depth):
    def run(m, *_):
        qs = m.QuotaSource(default_quota=1_000_000)
        qs.set_quota(("demo", "App-1")[:depth], 4)
        t = m.CardinalityTracker(quota_source=qs)
        raised = []
        for i in range(6):
            try:
                t.series_created(("demo", "App-1", f"m{i}"))
            except m.QuotaReachedException as e:
                raised.append((i, e.prefix))
        return raised, _rec(t.cardinality(()))
    raised, root = _both(run)
    assert [i for i, _ in raised] == [4, 5] and root[1] == 4


def test_counts_decrement_on_stop_and_churn_is_quota_neutral():
    def run(m, *_):
        t = m.CardinalityTracker()
        _track_n(t, "demo", "App-1", "m", 4)
        t.series_stopped(("demo", "App-1", "m0"))
        a = _rec(t.cardinality(("demo", "App-1")))
        t.series_created(("demo", "App-1", "m0"))
        return a, _rec(t.cardinality(("demo", "App-1")))
    a, b = _both(run)
    assert a[1:3] == (3, 3) and b[1] == 4


def test_children_count_stable_under_churn():
    def run(m, *_):
        t = m.CardinalityTracker()
        seen = []
        for _ in range(5):
            for i in range(3):
                t.series_created(("demo", f"App-{i}", "m"))
            seen.append((t.cardinality(("demo",)).children_count,
                         t.cardinality(()).children_count))
            for i in range(3):
                t.series_stopped(("demo", f"App-{i}", "m"))
            seen.append(t.cardinality(("demo",)).children_count)
        return seen
    assert _both(run) == [(3, 1), 0] * 5


def test_evict_reingest_does_not_exhaust_quota():
    def run(m, *_):
        qs = m.QuotaSource(default_quota=1_000_000)
        qs.set_quota(("demo",), 3)
        t = m.CardinalityTracker(quota_source=qs)
        for _ in range(5):
            for i in range(3):
                t.series_created(("demo", f"App-{i}", "m"))
            for i in range(3):
                t.series_stopped(("demo", f"App-{i}", "m"))
        return _rec(t.cardinality(("demo",)))
    assert _both(run)[1] == 0


@pytest.mark.parametrize("writer, reader", [("jax", "port"),
                                            ("port", "jax")])
def test_sqlite_file_reopens_in_the_other_package(tmp_path, writer, reader):
    """A SqliteCardinalityStore file written by one package's tracker is
    read by the other's with the same counts, quotas and children."""
    path = str(tmp_path / "card.db")
    w = PKGS[writer][0]
    store = w.SqliteCardinalityStore(path, flush_every=7)
    qs = w.QuotaSource(default_quota=1_000_000)
    qs.set_quota(("demo", "App-1"), 50)
    t = w.CardinalityTracker(store=store, quota_source=qs)
    _track_n(t, "demo", "App-1", "m", 5)
    _track_n(t, "demo", "App-2", "n", 9)
    t.series_stopped(("demo", "App-2", "n0"))
    want = [_rec(t.cardinality(p)) for p in
            ((), ("demo",), ("demo", "App-1"), ("demo", "App-2"))]
    want_top = [_rec(x) for x in t.top_k(("demo",), 5)]
    store.close()
    r = PKGS[reader][0]
    store2 = r.SqliteCardinalityStore(path)
    t2 = r.CardinalityTracker(store=store2)
    assert [_rec(t2.cardinality(p)) for p in
            ((), ("demo",), ("demo", "App-1"), ("demo", "App-2"))] == want
    assert [_rec(x) for x in t2.top_k(("demo",), 5)] == want_top
    store2.close()


def test_sqlite_store_batched_writes_and_flush(tmp_path):
    path = str(tmp_path / "card.db")
    store = rl.SqliteCardinalityStore(path, flush_every=1000)
    for i in range(50):
        store.write(rl.CardinalityRecord(("demo", f"App-{i}"),
                                         ts_count=i + 1))
    other = jrl.SqliteCardinalityStore(path)
    assert other.read(("demo", "App-0")) is None
    assert store.read(("demo", "App-7")).ts_count == 8
    assert len(store.scan_children(("demo",))) == 50     # scan flushes
    other2 = jrl.SqliteCardinalityStore(path)
    assert other2.read(("demo", "App-0")).ts_count == 1
    other.close()
    other2.close()
    store.close()


def test_sqlite_store_crash_recovery(tmp_path):
    path = str(tmp_path / "card.db")
    store = rl.SqliteCardinalityStore(path, flush_every=10)
    for i in range(25):
        store.write(rl.CardinalityRecord(("ws", f"ns-{i}"), ts_count=i))
    store.flush()
    del store._conn
    del store
    for m in (rl, jrl):
        back = m.SqliteCardinalityStore(path)
        assert len(back.scan_children(("ws",))) == 25
        assert back.read(("ws", "ns-24")).ts_count == 24
        back.close()


def test_shard_drops_series_over_quota():
    def run(m, MemStore, gen, kw):
        ms = MemStore(**kw)
        shard = ms.setup(DS, 0)
        qs = m.QuotaSource(default_quota=1_000_000)
        qs.set_quota((), 6)
        shard.cardinality_tracker = m.CardinalityTracker(quota_source=qs)
        n = shard.ingest(gen(10, 100, start_ms=START))
        n2 = shard.ingest(gen(10, 100, start_ms=START + 1_000_000))
        return (n, n2, shard.num_partitions, shard.stats.quota_dropped,
                shard.stats.rows_dropped, shard.stats.rows_ingested)
    assert _both(run) == (600, 600, 6, 8, 800, 1200)


def test_tenant_series_budget_and_eviction_release(tmp_path):
    """index.tenant_series_limit: over-budget series drop, internal
    workspaces are exempt, eviction gives the budget back."""
    from torch_doors import apply_settings

    def run(m, MemStore, gen, kw):
        if MemStore is JMemStore:
            from filodb_tpu.config import FilodbSettings
            from filodb_tpu.core.partkey import PartKey
            from filodb_tpu.core.records import RecordBatch
        else:
            from filodb_tpu_torch.config import FilodbSettings
            from filodb_tpu_torch.core.partkey import PartKey
            from filodb_tpu_torch.core.records import RecordBatch
        cfg = apply_settings(FilodbSettings(),
                             {"index.tenant_series_limit": 5})
        ms = MemStore(config=cfg, **kw)
        sh = ms.setup(DS, 0)
        import numpy as np
        keys = [PartKey.make("m", {"_ws_": ws, "_ns_": "a", "i": str(i)})
                for ws in ("demo", "_rules_") for i in range(8)]
        ts = np.full((16, 1), START, np.int64)
        got = sh.ingest(RecordBatch.from_grid(
            sh.schemas["gauge"], keys, ts, {"value": np.ones((16, 1))}))
        before = (got, sh.num_partitions, sh.stats.tenant_rejected)
        for pid in range(3):
            sh.index.update_end_time(pid, START)
        evicted = sh.evict_ended_partitions(START + 1)
        got2 = sh.ingest(RecordBatch.from_grid(
            sh.schemas["gauge"], keys, ts + 10_000,
            {"value": np.ones((16, 1))}))
        return before, evicted, got2, sh.stats.tenant_rejected, \
            sh.stats.quota_dropped
    out = _both(run)
    assert out[0] == (13, 13, 3)


# ---------------------------------------------------------------- routes

@pytest.fixture()
def pair():
    nodes = {pkg: Node(pkg, shards=2) for pkg in PKGS}
    yield nodes
    for n in nodes.values():
        n.close()


def _ingest_gauges(pair):
    for pkg, node in pair.items():
        gen = PKGS[pkg][2]
        for s in range(2):
            node.memstore.get_shard(DS, s).ingest(
                gen(20 + 5 * s, 10, start_ms=START))
    assert_same_stores(pair["jax"].memstore, pair["port"].memstore)


@pytest.mark.parametrize("params", [
    {}, {"prefix": "", "k": "5"}, {"prefix": "demo"},
    {"prefix": "demo,App-1", "k": "3"}, {"prefix": "nosuch"}],
    ids=["default", "root_k5", "ws", "ns_k3", "unknown"])
def test_http_cardinality_endpoint(pair, params):
    _ingest_gauges(pair)
    out = {pkg: n.get("/promql/prometheus/api/v1/metering/cardinality",
                      params) for pkg, n in pair.items()}
    assert out["port"] == out["jax"]
    assert out["port"][0] == 200
    if not params:
        assert out["port"][1]["data"][0] == {
            "prefix": ["demo"], "tsCount": 45, "activeTsCount": 45,
            "childrenCount": 20}


@pytest.mark.parametrize("limit", ["10", "3"])
def test_status_tsdb_endpoint(pair, limit):
    _ingest_gauges(pair)
    out = {pkg: n.get("/api/v1/status/tsdb", {"limit": limit})
           for pkg, n in pair.items()}
    assert out["port"] == out["jax"]
    head = out["port"][1]["data"]["headStats"]
    assert head["numSeries"] == 45
    assert out["port"][1]["data"]["seriesCountByTenant"] == \
        [{"name": "demo", "value": 45}]


def test_http_cardinality_over_a_socket():
    """The endpoint through the port's FiloHttpServer."""
    from filodb_tpu_torch.http.server import FiloHttpServer
    node = Node("port", shards=1)
    node.memstore.get_shard(DS, 0).ingest(gauge_batch(20, 10,
                                                      start_ms=START))
    srv = FiloHttpServer(node.api, port=0)
    srv.start()
    try:
        url = (f"http://127.0.0.1:{srv.port}/promql/prometheus/api/v1/"
               f"metering/cardinality?prefix=&k=5")
        with urllib.request.urlopen(url, timeout=30) as r:
            payload = json.loads(r.read())
        assert payload["status"] == "success"
        assert payload["data"][0]["prefix"] == ["demo"]
        assert payload["data"][0]["tsCount"] == 20
    finally:
        srv.stop()
        node.close()


def test_tracker_flush_rides_shard_flush(tmp_path):
    path = str(tmp_path / "card.db")
    ms = TimeSeriesMemStore(device="cpu")
    sh = ms.setup(DS, 0)
    store = rl.SqliteCardinalityStore(path, flush_every=1 << 20)
    sh.cardinality_tracker = rl.CardinalityTracker(store=store)
    sh.ingest(gauge_batch(12, 30))
    assert store._dirty
    sh.flush_all_groups()
    assert not store._dirty
    fresh = jrl.SqliteCardinalityStore(path)
    assert fresh.read(("demo",)) is not None
    fresh.close()
    store.close()


def test_recover_index_counts_quota_drops(tmp_path):
    """A recovered shard whose tracker's quota is lower than its persisted
    series keeps what fits and counts the rest, as the reference does."""
    def run(m, MemStore, gen, kw):
        if MemStore is JMemStore:
            from filodb_tpu.core.store import (InMemoryColumnStore,
                                               InMemoryMetaStore)
        else:
            from filodb_tpu_torch.core.store import (InMemoryColumnStore,
                                                     InMemoryMetaStore)
        cs, meta = InMemoryColumnStore(), InMemoryMetaStore()
        ms = MemStore(column_store=cs, meta_store=meta, **kw)
        ms.setup(DS, 0).ingest(gen(10, 20, start_ms=START))
        ms.get_shard(DS, 0).flush_all_groups()
        ms2 = MemStore(column_store=cs, meta_store=meta, **kw)
        sh = ms2.setup(DS, 0)
        qs = m.QuotaSource(default_quota=1_000_000)
        qs.set_quota((), 7)
        sh.cardinality_tracker = m.CardinalityTracker(quota_source=qs)
        return sh.recover_index(), sh.stats.quota_dropped
    assert _both(run) == (7, 3)


def test_budget_rejection_shows_in_tsdb_status():
    settings = {"index.tenant_series_limit": 4}
    nodes = {pkg: Node(pkg, shards=1, settings=settings) for pkg in PKGS}
    try:
        out = {}
        for pkg, node in nodes.items():
            node.memstore.get_shard(DS, 0).ingest(
                PKGS[pkg][2](10, 5, start_ms=START))
            out[pkg] = split_headers(*node.get("/api/v1/status/tsdb"))[:2]
        assert out["port"] == out["jax"]
        head = out["port"][1]["data"]["headStats"]
        assert head["tenantSeriesRejected"] == 6
        assert head["tenantSeriesLimit"] == 4
    finally:
        for n in nodes.values():
            n.close()
