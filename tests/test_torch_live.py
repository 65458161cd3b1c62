"""The port's shard under live ingest, on device="cpu": the reference's
test_background_rebuild_keeps_full_refresh_off_query_path
(tests/test_query_frontend.py:270) and
test_concurrent_ingest_query_matches_quiesced (tests/test_concurrency.py:52),
ported; each final answer is also held against the JAX engine over the
same data (rtol 2e-4 / atol 1e-3, __graft_entry__.py:221).
"""
import threading

import numpy as np

from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.ingest.generator import counter_batch
from filodb_tpu.query.engine import QueryEngine as JEngine
from filodb_tpu_torch.core.devicecache import store_nbytes
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.utils.counters import counters

from test_torch_ingest import (  # noqa: F401 (the fixture)
    _clear_compile_journal, sub, time_slices, to_port)

START = 1_600_000_000_000
S_SEC = START // 1000
Q = 'sum by (_ns_)(rate(request_total[5m]))'


def _series_dict(res):
    assert res.error is None, res.error
    return {str(k): np.asarray(v, np.float64) for k, _, v in res.series()}


def _evict_cycle(sh):
    """Force a shift_version bump the way memory enforcement does: seal
    everything, truncate to an active tail, release capacity."""
    store = sh.stores["prom-counter"]
    shift0 = store.shift_version
    sh.flush_all_groups()
    released = sh._enforce_memory(budget=1, tail=60)
    assert store.shift_version > shift0
    return released


def test_background_rebuild_keeps_full_refresh_off_query_path():
    """After an eviction-driven shift_version bump, the next query is
    served by the host gather (fallback counter) while the full mirror
    re-upload runs on a mirror-rebuild thread; once published, queries
    ride the mirror again.  Results stay correct throughout."""
    ms = TimeSeriesMemStore(device="cpu")
    sh = ms.setup("prometheus", 0)
    full = counter_batch(24, 360, start_ms=START)
    first = next(time_slices(full, [(0, 240)]))
    sh.ingest(to_port(first), offset=0)
    eng = QueryEngine("prometheus", ms, device="cpu")
    assert eng.mirror_background_rebuild            # default on
    args = (S_SEC + 600, 60, S_SEC + 2390)
    assert eng.query_range(Q, *args).error is None      # mirror built
    store = sh.stores["prom-counter"]
    mirror = store.device_mirror
    assert mirror is not None

    _evict_cycle(sh)
    assert not mirror.can_update_inline(store)
    fb0 = counters.get("device_mirror_query_fallbacks")
    rb0 = counters.get("device_mirror_bg_rebuilds")
    got = _series_dict(eng.query_range(Q, *args))
    assert counters.get("device_mirror_query_fallbacks") == fb0 + 1
    t = mirror._bg_thread
    assert t is not None
    t.join(timeout=60)
    assert not t.is_alive()
    assert counters.get("device_mirror_bg_rebuilds") >= rb0 + 1
    assert mirror.is_fresh(store)
    assert mirror.last_refresh_kind == "full"
    # the post-rebuild query uses the fresh mirror and agrees
    again = _series_dict(eng.query_range(Q, *args))
    assert counters.get("device_mirror_query_fallbacks") == fb0 + 1
    assert set(again) == set(got)
    for k in got:
        np.testing.assert_allclose(again[k], got[k], rtol=1e-5,
                                   equal_nan=True)
    jm = JMemStore()
    jm.setup("prometheus", 0).ingest(first, offset=0)
    want = _series_dict(JEngine("prometheus", jm).query_range(Q, *args))
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-3,
                                   equal_nan=True)


def test_inline_rebuild_when_background_rebuild_is_off():
    """mirror_background_rebuild=False: the full re-upload runs inline on
    the query, with no fallback and no thread."""
    ms = TimeSeriesMemStore(device="cpu")
    sh = ms.setup("prometheus", 0)
    sh.ingest(to_port(next(time_slices(counter_batch(12, 240, start_ms=START),
                                       [(0, 240)]))), offset=0)
    eng = QueryEngine("prometheus", ms, device="cpu",
                      mirror_background_rebuild=False)
    args = (S_SEC + 600, 60, S_SEC + 2390)
    before = _series_dict(eng.query_range(Q, *args))
    mirror = sh.stores["prom-counter"].device_mirror
    _evict_cycle(sh)
    fb0 = counters.get("device_mirror_query_fallbacks")
    after = _series_dict(eng.query_range(Q, *args))
    assert counters.get("device_mirror_query_fallbacks") == fb0
    assert mirror._bg_thread is None
    assert mirror.last_refresh_kind == "full"
    assert mirror.is_fresh(sh.stores["prom-counter"])
    for k in before:
        np.testing.assert_allclose(after[k], before[k], rtol=1e-5,
                                   equal_nan=True)


def test_rebuild_over_the_cap_reports_it_instead_of_serving_from_the_host():
    """A page-in that grows the store past its mirror's cap: the query
    refreshes inline and reports MirrorCapExceeded, as an over-cap store
    always did; no background rebuild starts and no query falls back to
    the host gather, however often it is asked."""
    ms = TimeSeriesMemStore(device="cpu")
    sh = ms.setup("prometheus", 0)
    sh.ingest(to_port(next(time_slices(counter_batch(12, 240, start_ms=START),
                                       [(0, 240)]))), offset=0)
    eng = QueryEngine("prometheus", ms, device="cpu")
    args = (S_SEC + 600, 60, S_SEC + 2390)
    _series_dict(eng.query_range(Q, *args))
    store = sh.stores["prom-counter"]
    mirror = store.device_mirror
    _evict_cycle(sh)
    # the evicted store fits, the paged one (its history back) does not
    mirror.hbm_limit_bytes = store_nbytes(store) * 2
    fb0 = counters.get("device_mirror_query_fallbacks")
    er0 = counters.get("device_mirror_bg_rebuild_errors")
    for _ in range(3):
        res = eng.query_range(Q, *args)
        assert res.error is not None and "MirrorCapExceeded" in res.error
        assert store_nbytes(store) > mirror.hbm_limit_bytes
    assert counters.get("device_mirror_query_fallbacks") == fb0
    assert counters.get("device_mirror_bg_rebuild_errors") == er0
    assert mirror._bg_thread is None


def test_failed_background_rebuild_reaches_the_next_query(monkeypatch):
    """A background rebuild that fails: the query that started it was
    served by the host gather, every later one refreshes inline and
    reports the error (no further fallback) until a refresh succeeds;
    then queries ride the mirror again, with the same answer."""
    ms = TimeSeriesMemStore(device="cpu")
    sh = ms.setup("prometheus", 0)
    sh.ingest(to_port(next(time_slices(counter_batch(12, 240, start_ms=START),
                                       [(0, 240)]))), offset=0)
    eng = QueryEngine("prometheus", ms, device="cpu")
    args = (S_SEC + 600, 60, S_SEC + 2390)
    before = _series_dict(eng.query_range(Q, *args))
    store = sh.stores["prom-counter"]
    mirror = store.device_mirror
    _evict_cycle(sh)

    def failing_upload(store):
        raise RuntimeError("upload failed")

    monkeypatch.setattr(mirror, "_refresh", failing_upload)
    fb0 = counters.get("device_mirror_query_fallbacks")
    er0 = counters.get("device_mirror_bg_rebuild_errors")
    during = _series_dict(eng.query_range(Q, *args))
    assert counters.get("device_mirror_query_fallbacks") == fb0 + 1
    assert mirror.join_rebuild(60)
    assert counters.get("device_mirror_bg_rebuild_errors") == er0 + 1
    for _ in range(2):
        res = eng.query_range(Q, *args)
        assert res.error == "RuntimeError: upload failed"
    assert counters.get("device_mirror_query_fallbacks") == fb0 + 1
    monkeypatch.undo()
    after = _series_dict(eng.query_range(Q, *args))
    assert mirror.is_fresh(store) and mirror.last_refresh_kind == "full"
    assert counters.get("device_mirror_query_fallbacks") == fb0 + 1
    assert set(during) == set(after) == set(before)
    for k in before:
        np.testing.assert_allclose(during[k], before[k], rtol=1e-5,
                                   equal_nan=True)
        np.testing.assert_allclose(after[k], before[k], rtol=1e-5,
                                   equal_nan=True)


S = 120          # series
STEP = 10_000
TOTAL = 360
_FULL = counter_batch(S, TOTAL, start_ms=START)


def _slice_batch(t0_idx, nsamples):
    """Slice of the one canonical batch covering sample indices
    [t0_idx, t0_idx + nsamples)."""
    return sub(_FULL, (_FULL.timestamps >= START + t0_idx * STEP)
               & (_FULL.timestamps < START + (t0_idx + nsamples) * STEP))


def _query_all(eng, t_end_idx):
    return eng.query_range(Q, S_SEC + 600, 60, S_SEC + t_end_idx * 10)


def test_concurrent_ingest_query_matches_quiesced():
    """Queries racing live ingest produce only valid snapshots, and the
    final quiesced result equals a store built without any concurrency
    (and the JAX engine's)."""
    ms = TimeSeriesMemStore(device="cpu")
    sh = ms.setup("prometheus", 0)
    sh.ingest(to_port(_slice_batch(0, 60)), offset=0)    # 10 minutes
    eng = QueryEngine("prometheus", ms, device="cpu")
    batches = [to_port(_slice_batch(idx, 30)) for idx in range(60, TOTAL, 30)]
    errors = []

    def ingester():
        for o, b in enumerate(batches, 1):
            try:
                sh.ingest(b, offset=o)
            except Exception as e:  # noqa: BLE001
                errors.append(e)
                return

    def querier():
        while ing.is_alive():
            try:
                res = _query_all(eng, TOTAL)
                assert res.error is None, res.error
                for _, _, vs in res.series():
                    arr = np.asarray(vs)
                    finite = arr[np.isfinite(arr)]
                    # counter rates are positive for this generator
                    assert (finite >= 0).all()
            except Exception as e:  # noqa: BLE001
                errors.append(e)
                return

    ing = threading.Thread(target=ingester)
    qry = threading.Thread(target=querier)
    ing.start()
    qry.start()
    ing.join(timeout=120)
    qry.join(timeout=120)
    assert not ing.is_alive() and not qry.is_alive()
    assert not errors, errors[:3]
    assert counters.get("device_mirror_incremental_errors") == 0

    ms2 = TimeSeriesMemStore(device="cpu")
    ms2.setup("prometheus", 0).ingest(to_port(_slice_batch(0, TOTAL)))
    eng2 = QueryEngine("prometheus", ms2, device="cpu")
    got = _series_dict(_query_all(eng, TOTAL))
    want = _series_dict(_query_all(eng2, TOTAL))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9,
                                   equal_nan=True)
    jm = JMemStore()
    jm.setup("prometheus", 0).ingest(_slice_batch(0, TOTAL))
    jwant = _series_dict(_query_all(JEngine("prometheus", jm), TOTAL))
    for k in jwant:
        np.testing.assert_allclose(got[k], jwant[k], rtol=2e-4, atol=1e-3,
                                   equal_nan=True)
