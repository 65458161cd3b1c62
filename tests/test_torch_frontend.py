"""The port's query-serving frontend (filodb_tpu_torch/query/frontend.py,
resultcache.py, coalesce.py, qos.py, activequeries.py), modelled on
tests/test_query_frontend.py, test_qos.py and test_activequeries.py.

The store is tests/test_query_frontend.py's: 50 seeded counters x 360
samples, ingested in two slices so the append horizon moves.  Cached
answers (full, partial and past-the-horizon re-polls) are held to the
port engine's own full recompute (rtol 1e-12, as the reference holds
its cache) and to the JAX engine over the same batches (rtol 2e-4 /
atol 1e-3, __graft_entry__.py:221).  Also: singleflight, the coalescer
merging concurrent panels into one batch (bit-identical to the panels
alone), the weighted-fair scheduler shedding, a kill and a deadline, and
a result block holding a tensor through the cache.
"""
import threading
import time

import numpy as np
import pytest
import torch

from filodb_tpu.core.memstore import TimeSeriesMemStore as JaxMemStore
from filodb_tpu.ingest.generator import counter_batch
from filodb_tpu.query.engine import QueryEngine as JaxEngine
from filodb_tpu_torch.config import FilodbSettings
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.query.activequeries import active_queries, verdict_of
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.query.frontend import QueryFrontend
from filodb_tpu_torch.query.leafexec import MultiSchemaPartitionsExec
from filodb_tpu_torch.query.rangevector import (PlannerParams, QueryResult,
                                                RangeVectorKey, ResultBlock)
from filodb_tpu_torch.utils.metrics import registry

from test_torch_ingest import to_port

START = 1_600_000_000_000
S_SEC = START // 1000
Q = "sum by (_ns_)(rate(request_total[5m]))"
PANELS = [Q, "avg by (_ns_)(rate(request_total[5m]))",
          "count by (_ns_)(rate(request_total[5m]))",
          "sum by (_ns_)(increase(request_total[5m]))"]


@pytest.fixture(autouse=True, scope="module")
def _clear_compile_journal():
    """The JAX engine's queries journal jit compiles under their trace
    ids, which the reference's health model reads as a compile storm in
    the next test file this process runs; clear the journal after."""
    yield
    from filodb_tpu.utils.events import journal
    journal.clear()


def _slice(full, lo_i, hi_i):
    from filodb_tpu.core.records import RecordBatch
    keep = ((full.timestamps >= START + lo_i * 10_000)
            & (full.timestamps < START + hi_i * 10_000))
    return RecordBatch(full.schema, full.part_keys, full.part_idx[keep],
                       full.timestamps[keep],
                       {k: v[keep] for k, v in full.columns.items()},
                       full.bucket_les)


class _Stores:
    """The port's and the JAX package's shard over the same slices."""

    def __init__(self):
        self.full = counter_batch(50, 360, start_ms=START)
        self.ms = TimeSeriesMemStore(device="cpu")
        self.sh = self.ms.setup("prometheus", 0)
        self.jms = JaxMemStore()
        self.jsh = self.jms.setup("prometheus", 0)
        self.eng = QueryEngine("prometheus", self.ms, device="cpu")
        self.jeng = JaxEngine("prometheus", self.jms)
        self.ingest(0, 240, 0)

    def ingest(self, lo, hi, offset):
        part = _slice(self.full, lo, hi)
        self.sh.ingest(to_port(part), offset=offset)
        self.jsh.ingest(part, offset=offset)


@pytest.fixture()
def stores():
    return _Stores()


def _values(res):
    assert res.error is None, res.error
    return {tuple(sorted(k.labels_dict.items())): np.asarray(v, np.float64)
            for k, _, v in res.series()}


def _bits(res):
    return {k: v.tobytes() for k, v in _values(res).items()}


def _close(got, want, rtol, atol=0.0):
    g, w = _values(got), _values(want)
    assert set(g) == set(w) and w
    for k in w:
        assert (np.isnan(g[k]) == np.isnan(w[k])).all(), k
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol,
                                   equal_nan=True, err_msg=str(k))


def _counter(name, **tags):
    return registry.counter(name, **tags).value


# ------------------------------------------------------------ singleflight


def test_singleflight_shares_one_execution():
    calls = [0]
    lock = threading.Lock()

    class StubEngine:
        dataset = "d"
        source = None                    # no shard state: cache bypass

        def query_range(self, q, s, st, e, pp=None):
            with lock:
                calls[0] += 1
            time.sleep(0.15)             # hold the flight open
            return QueryResult([])

    fe = QueryFrontend(StubEngine(), config=FilodbSettings())
    hits0 = _counter("query_singleflight_hits")
    barrier = threading.Barrier(8)
    results = []

    def client():
        barrier.wait()
        results.append(fe.query_range(Q, 1, 60, 100))

    threads = [threading.Thread(target=client) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    hits = _counter("query_singleflight_hits") - hits0
    assert len(results) == 8
    assert calls[0] < 8, "identical in-flight queries did not dedup"
    assert hits == 8 - calls[0]
    fe.query_range(Q, 2, 60, 100)        # another key never dedups
    assert calls[0] == 8 - hits + 1


# ------------------------------------------------------------ result cache


def test_repoll_full_hit_matches_engine_and_jax(stores):
    fe = QueryFrontend(stores.eng, config=FilodbSettings())
    args = (S_SEC + 600, 60, S_SEC + 2390)
    first = fe.query_range(Q, *args)
    assert first.stats.result_cache == "miss"
    hits0 = _counter("query_result_cache_hits")
    got = fe.query_range(Q, *args)
    assert _counter("query_result_cache_hits") == hits0 + 1
    assert got.stats.result_cache == "hit"
    assert _bits(got) == _bits(stores.eng.query_range(Q, *args))
    _close(got, stores.jeng.query_range(Q, *args), 2e-4, 1e-3)


def test_sliding_repoll_partial_hit_matches_full_recompute(stores):
    fe = QueryFrontend(stores.eng, config=FilodbSettings())
    fe.query_range(Q, S_SEC + 600, 60, S_SEC + 2390)
    stores.ingest(240, 360, 1)           # the live edge advances
    p0 = _counter("query_result_cache_partial_hits")
    args = (S_SEC + 720, 60, S_SEC + 3590)   # a step-aligned slide
    got = fe.query_range(Q, *args)
    assert _counter("query_result_cache_partial_hits") == p0 + 1
    assert got.stats.result_cache == "partial"
    _close(got, stores.eng.query_range(Q, *args), 1e-12)
    _close(got, stores.jeng.query_range(Q, *args), 2e-4, 1e-3)


def test_cache_never_serves_windows_past_append_horizon(stores):
    """Windows past the data edge are recomputed on a re-poll: ingest
    that lands inside the queried range shows up."""
    fe = QueryFrontend(stores.eng, config=FilodbSettings())
    args = (S_SEC + 600, 60, S_SEC + 2990)
    first = _values(fe.query_range(Q, *args))
    assert stores.sh.append_horizon_ms() == START + 239 * 10_000
    stores.ingest(240, 300, 1)
    got = fe.query_range(Q, *args)
    _close(got, stores.eng.query_range(Q, *args), 1e-12)
    _close(got, stores.jeng.query_range(Q, *args), 2e-4, 1e-3)
    g = _values(got)
    assert any(not np.array_equal(first[k], g[k], equal_nan=True)
               for k in g)


def test_tensor_values_cached_as_host_rows():
    """A result block whose values are a tensor is cached through
    host_values: the hit is a numpy block with the same bits, and no
    tensor is held by the cache."""
    keys = [RangeVectorKey.make({"s": str(i)}) for i in range(3)]
    vals = torch.arange(3 * 5, dtype=torch.float64).reshape(3, 5) / 7.0

    class StubEngine:
        dataset = "d"

        def query_range(self, q, s, st, e, pp=None):
            wends = np.arange(s, e + 1, st, dtype=np.int64) * 1000
            return QueryResult([ResultBlock(keys, wends,
                                            vals[:, :len(wends)])])

    from filodb_tpu_torch.query.resultcache import ResultCache
    cache = ResultCache()
    eng = StubEngine()

    def run(s, e):
        return eng.query_range("up", s, 60, e)

    state = (("tok",), 10_000_000)
    miss = cache.query_range(run, "up", 60, 60, 300, "pp", state)
    hit = cache.query_range(run, "up", 60, 60, 300, "pp", state)
    assert hit.stats.result_cache == "hit"
    assert isinstance(hit.blocks[0].values, np.ndarray)
    assert hit.blocks[0].values.tobytes() == \
        miss.blocks[0].values.numpy().tobytes()
    for ent in cache._entries.values():
        assert all(isinstance(r, np.ndarray) for r in ent.series.values())


# ------------------------------------------------------------- coalescer


def test_coalescer_merges_concurrent_panels_into_one_batch(stores):
    cfg = FilodbSettings()
    cfg.query.result_cache_enabled = False
    # a window long enough for all four threads to join under load
    fe = QueryFrontend(stores.eng, window_s=1.0, config=cfg)
    args = (S_SEC + 600, 60, S_SEC + 2390)
    alone = {q: _bits(stores.eng.query_range(q, *args)) for q in PANELS}
    b0 = _counter("coalesce_merged_batches")
    m0 = _counter("fused_batch_merged_panels")
    results = {}
    barrier = threading.Barrier(len(PANELS))

    def client(q):
        barrier.wait()
        results[q] = fe.query_range(q, *args)

    threads = [threading.Thread(target=client, args=(q,)) for q in PANELS]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert _counter("coalesce_merged_batches") == b0 + 1
    # sum and avg share one rate launch (count is host math, increase
    # its own launch)
    assert _counter("fused_batch_merged_panels") - m0 == 2
    for q in PANELS:
        assert _bits(results[q]) == alone[q], q
        _close(results[q], stores.jeng.query_range(q, *args), 2e-4, 1e-3)


# -------------------------------------------------- scheduler, kill, deadline


def test_scheduler_sheds_a_full_tenant_queue(stores):
    cfg = FilodbSettings()
    cfg.query.max_concurrent_queries = 1
    cfg.query.tenant_max_queue_depth = 1
    cfg.query.result_cache_enabled = False
    cfg.query.singleflight_enabled = False
    fe = QueryFrontend(stores.eng, config=cfg)
    q = 'sum(rate(request_total{_ws_="demo"}[5m]))'
    args = (S_SEC + 600, 60, S_SEC + 1190)
    assert fe.scheduler.admit("hog", 1.0).acquired
    queued_res = []
    t = threading.Thread(
        target=lambda: queued_res.append(fe.query_range(q, *args)))
    t.start()
    time.sleep(0.15)                      # demo's depth-1 queue is full
    try:
        res = fe.query_range(q, *args)
    finally:
        fe.scheduler.release("hog")
    t.join(timeout=10)
    assert res.error.split(":", 1)[0] == "tenant_overloaded"
    assert res.retry_after_s > 0 and verdict_of(res) == "shed"
    assert queued_res and queued_res[0].error is None


def _held_leaf(monkeypatch, release: threading.Event,
               entered: threading.Event):
    """Leaves that wait for `release` after gathering (a long scan)."""
    real = MultiSchemaPartitionsExec._do_execute

    def held(self, source):
        out = real(self, source)
        entered.set()
        release.wait(10)
        return out

    monkeypatch.setattr(MultiSchemaPartitionsExec, "_do_execute", held)


def test_kill_returns_query_canceled(stores, monkeypatch):
    cfg = FilodbSettings()
    cfg.query.result_cache_enabled = False
    fe = QueryFrontend(stores.eng, config=cfg)
    release, entered = threading.Event(), threading.Event()
    _held_leaf(monkeypatch, release, entered)
    out = []
    t = threading.Thread(target=lambda: out.append(
        fe.query_range(Q, S_SEC + 600, 60, S_SEC + 2390)))
    t.start()
    assert entered.wait(10)
    rows = [r for r in active_queries.snapshot() if r["promql"] == Q]
    assert len(rows) == 1 and rows[0]["phase"] == "executing"
    k0 = _counter("queries_killed", reason="admin")
    assert active_queries.kill(rows[0]["queryID"])["killed"]
    release.set()
    t.join(timeout=10)
    assert out[0].error.startswith("query_canceled")
    assert verdict_of(out[0]) == "killed"
    assert QueryEngine.to_prom_matrix(out[0])["errorType"] == "canceled"
    assert _counter("queries_killed", reason="admin") == k0 + 1
    assert not active_queries.get(rows[0]["queryID"])


def test_deadline_returns_query_timeout(stores, monkeypatch):
    fe = QueryFrontend(stores.eng, config=FilodbSettings())
    release, entered = threading.Event(), threading.Event()
    _held_leaf(monkeypatch, release, entered)
    threading.Timer(0.3, release.set).start()
    res = fe.query_range(Q, S_SEC + 600, 60, S_SEC + 2390,
                         PlannerParams(timeout_s=0.1))
    assert res.error.startswith("query_timeout")
    assert verdict_of(res) == "deadline"
    assert QueryEngine.to_prom_matrix(res)["errorType"] == "timeout"
    # a bare engine stamps the server default, and the request's budget
    # can only shrink it
    monkeypatch.undo()
    ok = stores.eng.query_range(Q, S_SEC + 600, 60, S_SEC + 2390,
                                PlannerParams(timeout_s=30))
    assert ok.error is None
