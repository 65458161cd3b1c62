"""The port's incremental device mirror (DeviceMirror._refresh_incremental
and _refresh_pad_only, on device="cpu"): the reference's seven cases of
tests/test_mirror_incremental.py, and the same slices into both packages
with their mirrors compared after every refresh.

An incrementally-updated mirror must equal a fresh full upload of the
same store: timestamps to the bit, absolute values (rebased value plus
vbase) within rtol 1e-6 / atol 1e-6 (the reference's own bound, its
tests/test_mirror_incremental.py:44-54), the same counts, col_finite
and correction state, and a uniform grid only where the full upload
finds one (the reference's incremental rule keeps it only when every
row appended the same offsets); anything that rearranges cells must
take the full upload.  Across packages the same bound holds between the two
mirrors, and the incremental count rises step for step alike.
"""
import numpy as np
import pytest

from filodb_tpu.core.devicecache import DeviceMirror as JMirror
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.ingest.generator import counter_batch, histogram_batch
from filodb_tpu.query.engine import QueryEngine as JEngine
from filodb_tpu.utils.metrics import registry
from filodb_tpu_torch.core.devicecache import DeviceMirror
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.records import RecordBatch
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.utils.counters import counters

from test_torch_ingest import (  # noqa: F401 (the fixture)
    _clear_compile_journal, sub, time_slices, to_port)

START = 1_600_000_000_000
START_S = START // 1000


def _slices(batch, bounds):
    """The port's RecordBatches of the JAX batch's time slices."""
    return [to_port(b) for b in time_slices(batch, bounds)]


def _mirror_state(snap):
    """ts offsets, counts and absolute values (rebased + vbase) of a
    snapshot of either package, as numpy."""
    out = {"ts": np.asarray(snap.ts_off), "counts": np.asarray(snap.counts)}
    for n, a in snap.cols.items():
        col = np.asarray(a, np.float64)
        vb = np.asarray(snap.vbases[n], np.float64)
        out[f"abs_{n}"] = col + (vb[:, None, :] if col.ndim == 3
                                 else vb[:, None])
    return out


def _assert_states_match(a_snap, b_snap, same_grid_verdict=True):
    """Two snapshots hold the same state.  same_grid_verdict=False: a_snap
    (incremental) may keep uniform_grid off where b_snap (a full upload)
    finds it on — the reference's rule keeps the grid only when every
    row appended the same offsets — but never the other way round."""
    a, b = _mirror_state(a_snap), _mirror_state(b_snap)
    np.testing.assert_array_equal(a["ts"], b["ts"])
    np.testing.assert_array_equal(a["counts"], b["counts"])
    assert set(a) == set(b)
    for k in b:
        if k.startswith("abs_"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6,
                                       equal_nan=True, err_msg=k)
    if same_grid_verdict:
        assert a_snap.uniform_grid == b_snap.uniform_grid
    else:
        assert b_snap.uniform_grid or not a_snap.uniform_grid
    assert a_snap.col_finite == b_snap.col_finite
    if a_snap.uniform_grid:
        np.testing.assert_array_equal(np.asarray(a_snap.ts_row0),
                                      np.asarray(b_snap.ts_row0))


def _assert_equivalent(store, mirror):
    """Mirror state after incremental updates == a fresh full upload."""
    fresh = DeviceMirror(device="cpu")
    assert fresh._refresh(store)
    _assert_states_match(mirror.snapshot(), fresh.snapshot(),
                         same_grid_verdict=False)
    snap, fsnap = mirror.snapshot(), fresh.snapshot()
    for n in fsnap.vbase_valid:
        np.testing.assert_array_equal(snap.vbase_valid[n],
                                      fsnap.vbase_valid[n])
    # the incremental continuation state matches what a full upload of
    # the whole rows computes
    for n in fsnap.tail_last_raw:
        np.testing.assert_array_equal(snap.tail_last_raw[n],
                                      fsnap.tail_last_raw[n])
        np.testing.assert_allclose(snap.tail_cum_drop[n],
                                   fsnap.tail_cum_drop[n], rtol=1e-12)


def _incr():
    return counters.get("device_mirror_incremental")


def _shard():
    ms = TimeSeriesMemStore(device="cpu")
    return ms, ms.setup("prometheus", 0)


def test_append_only_counter_updates_incrementally():
    ms, sh = _shard()
    # resets exercise the tail reset-correction continuation
    full = counter_batch(30, 200, start_ms=START, resets=True)
    slices = _slices(full, [(0, 50), (50, 90), (90, 140), (140, 200)])
    sh.ingest(slices[0], offset=0)
    store = sh.stores["prom-counter"]
    mirror = DeviceMirror(device="cpu")
    assert mirror.ensure_fresh(store)
    before = _incr()
    for i, sl in enumerate(slices[1:], 1):
        sh.ingest(sl, offset=i)
        assert mirror.ensure_fresh(store)
        assert mirror.last_refresh_kind == "incremental"
        _assert_equivalent(store, mirror)
    assert _incr() - before == 3, "appends did not take the fast path"


def test_new_series_and_time_growth():
    ms, sh = _shard()
    sh.ingest(to_port(counter_batch(10, 60, start_ms=START)), offset=0)
    store = sh.stores["prom-counter"]
    mirror = DeviceMirror(device="cpu")
    assert mirror.ensure_fresh(store)
    # NEW series appear later (S growth) while old ones extend (T growth)
    ext = counter_batch(10, 90, start_ms=START)
    sh.ingest(to_port(sub(ext, ext.timestamps >= START + 60 * 10_000)),
              offset=1)
    more = to_port(counter_batch(3, 90, start_ms=START, seed=9))
    keys = [PartKey.make(pk.metric, {**dict(pk.tags), "inst": f"n{i}"})
            for i, pk in enumerate(more.part_keys)]
    sh.ingest(RecordBatch(more.schema, keys, more.part_idx, more.timestamps,
                          more.columns, more.bucket_les), offset=2)
    before = _incr()
    assert mirror.ensure_fresh(store)
    assert _incr() == before + 1
    _assert_equivalent(store, mirror)

    # a growth burst past the threshold correctly chooses the full upload
    burst = to_port(counter_batch(40, 400, start_ms=START, seed=11))
    keys2 = [PartKey.make(pk.metric, {**dict(pk.tags), "inst": f"b{i}"})
             for i, pk in enumerate(burst.part_keys)]
    sh.ingest(RecordBatch(burst.schema, keys2, burst.part_idx,
                          burst.timestamps, burst.columns,
                          burst.bucket_les), offset=3)
    before = _incr()
    assert mirror.ensure_fresh(store)
    assert _incr() == before, "burst should take the full path"
    assert mirror.last_refresh_kind == "full"
    _assert_equivalent(store, mirror)


def test_histogram_incremental():
    ms, sh = _shard()
    full = histogram_batch(8, 120, start_ms=START)
    mirror = DeviceMirror(device="cpu")
    before = _incr()
    # slices below the 50% threshold so the [R, L, B] seeded correction
    # runs
    for i, sl in enumerate(_slices(full, [(0, 60), (60, 90), (90, 120)])):
        sh.ingest(sl, offset=i)
        store = sh.stores["prom-histogram"]
        assert mirror.ensure_fresh(store)
        _assert_equivalent(store, mirror)
    assert _incr() - before == 2, \
        "histogram appends did not take the incremental path"


def test_all_nan_row_gets_real_vbase_on_first_finite_append():
    """A row whose first upload had no finite values (vbase 0) gets a REAL
    base from its first finite append — large counters would otherwise
    land on the device un-rebased and lose their f32 deltas."""
    ms, sh = _shard()
    base = to_port(counter_batch(4, 40, start_ms=START))
    nan_cols = {k: np.full_like(v, np.nan) for k, v in base.columns.items()}
    sh.ingest(RecordBatch(base.schema, base.part_keys, base.part_idx,
                          base.timestamps, nan_cols, base.bucket_les),
              offset=0)
    store = sh.stores["prom-counter"]
    mirror = DeviceMirror(device="cpu")
    assert mirror.ensure_fresh(store)
    big = 2.0 ** 31
    n = 20
    ts = np.tile(START + (40 + np.arange(n, dtype=np.int64)) * 10_000, 4)
    idx = np.repeat(np.arange(4, dtype=np.int32), n)
    vals = big + np.arange(n, dtype=np.float64)[None, :] + \
        np.arange(4)[:, None] * 1000.0
    sh.ingest(RecordBatch(base.schema, base.part_keys, idx, ts,
                          {"count": vals.ravel()}), offset=1)
    before = _incr()
    assert mirror.ensure_fresh(store)
    assert _incr() == before + 1
    rb = mirror.snapshot().cols["count"].numpy()
    finite = rb[np.isfinite(rb)]
    # rebased device values are SMALL (deltas kept in f32)
    assert np.abs(finite).max() < 1e5, np.abs(finite).max()
    _assert_equivalent(store, mirror)


def test_rearranging_ops_fall_back_to_full_refresh():
    ms, sh = _shard()
    sh.ingest(to_port(counter_batch(10, 120, start_ms=START)), offset=0)
    store = sh.stores["prom-counter"]
    mirror = DeviceMirror(device="cpu")
    assert mirror.ensure_fresh(store)
    sv = store.shift_version
    # eviction shifts cells -> shift_version bumps -> incremental refused
    sh.flush_all_groups()
    store.evict_oldest(30)
    assert store.shift_version > sv
    assert not mirror.can_update_inline(store)
    before = _incr()
    assert mirror.ensure_fresh(store)
    assert _incr() == before, "shifted store must NOT go incremental"
    assert mirror.last_refresh_kind == "full"
    _assert_equivalent(store, mirror)


def _rate_answers(eng):
    r = eng.query_range('sum by (_ns_)(rate(request_total[5m]))',
                        START_S + 600, 60, START_S + 2390)
    assert r.error is None, r.error
    return {str(k): np.asarray(v) for k, _, v in r.series()}


def test_incremental_correctness_through_query_path():
    """Rates served from an incrementally-updated mirror match a store
    uploaded once in full, and the JAX engine over the same slices."""
    full = counter_batch(20, 240, start_ms=START, resets=True)
    ms, sh = _shard()
    eng = QueryEngine("prometheus", ms, device="cpu")
    jm = JMemStore()
    jsh = jm.setup("prometheus", 0)
    before = _incr()
    for i, sl in enumerate(time_slices(full, [(0, 80), (80, 160),
                                              (160, 240)])):
        sh.ingest(to_port(sl), offset=i)
        jsh.ingest(sl, offset=i)
        got = _rate_answers(eng)
    assert _incr() == before + 2
    ms2, sh2 = _shard()
    sh2.ingest(to_port(full), offset=0)
    want = _rate_answers(QueryEngine("prometheus", ms2, device="cpu"))
    jwant = _rate_answers(JEngine("prometheus", jm))
    assert set(got) == set(want) == set(jwant)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                   equal_nan=True)
        np.testing.assert_allclose(got[k], jwant[k], rtol=2e-4, atol=1e-3,
                                   equal_nan=True)


def test_series_growth_with_zero_new_samples_pads_without_error():
    """A new row registered with no surviving samples (S grows, no new
    cells) takes the pad-only path, not the error fallback."""
    ms, sh = _shard()
    sh.ingest(to_port(counter_batch(10, 60, start_ms=START)), offset=0)
    store = sh.stores["prom-counter"]
    mirror = DeviceMirror(device="cpu")
    assert mirror.ensure_fresh(store)
    with store.mutation():
        store.new_row()
    err0 = counters.get("device_mirror_incremental_errors")
    before = _incr()
    assert mirror.ensure_fresh(store)
    assert counters.get("device_mirror_incremental_errors") == err0
    assert _incr() == before + 1
    assert mirror.last_refresh_kind == "pad"
    _assert_equivalent(store, mirror)
    # appends after the pad continue incrementally + correctly
    full = counter_batch(10, 90, start_ms=START)
    sh.ingest(to_port(sub(full, full.timestamps >= START + 60 * 10_000)),
              offset=1)
    assert mirror.ensure_fresh(store)
    assert mirror.last_refresh_kind == "incremental"
    _assert_equivalent(store, mirror)


def test_refresh_never_writes_a_published_snapshot():
    """Every refresh builds new device arrays of exactly [S, t_used]: a
    snapshot published earlier keeps its cells through scrapes that grow
    the time axis and through a ragged append whose cells lie inside its
    extent."""
    ms, sh = _shard()
    full = counter_batch(6, 80, start_ms=START)
    sh.ingest(to_port(sub(full, full.timestamps < START + 60 * 10_000)))
    store = sh.stores["prom-counter"]
    mirror = DeviceMirror(device="cpu")
    mirror.ensure_fresh(store)
    snaps = [mirror.snapshot()]
    for i in range(60, 64):
        sh.ingest(to_port(sub(full, full.timestamps == START + i * 10_000)))
        mirror.ensure_fresh(store)
        snaps.append(mirror.snapshot())
        assert snaps[-1].uniform_grid
    held = [(sn.ts_off.numpy().copy(), sn.cols["count"].numpy().copy())
            for sn in snaps]
    for j, sn in enumerate(snaps):
        assert sn.ts_off.shape[1] == 60 + j
        assert sn.cols["count"].shape[1] == 60 + j
        assert (sn.ts_off.numpy() != np.iinfo(np.int32).max).all()
    # row 0 gets a sample at position 64, then the other rows catch up:
    # their cells lie inside the extent of the snapshot in between
    sh.ingest(to_port(sub(full, (full.timestamps == START + 64 * 10_000)
                          & (full.part_idx == 0))))
    mirror.ensure_fresh(store)
    rag = mirror.snapshot()
    rag_held = rag.ts_off.numpy().copy(), rag.cols["count"].numpy().copy()
    sh.ingest(to_port(sub(full, (full.timestamps == START + 64 * 10_000)
                          & (full.part_idx > 0))))
    mirror.ensure_fresh(store)
    assert mirror.last_refresh_kind == "incremental"
    for sn, (ts, col) in zip(snaps + [rag], held + [rag_held]):
        np.testing.assert_array_equal(sn.ts_off.numpy(), ts)
        np.testing.assert_array_equal(sn.cols["count"].numpy(), col)
    assert rag.t_used == mirror.snapshot().t_used == 65
    assert not rag.uniform_grid and not mirror.snapshot().uniform_grid
    _assert_equivalent(store, mirror)


@pytest.mark.parametrize("kind", ["counter", "histogram", "ragged"])
def test_incremental_matches_jax_step_for_step(kind):
    """The same slices into both packages; after every refresh the two
    mirrors agree (timestamps to the bit, absolutes within 1e-6, counts,
    uniform_grid, col_finite) and both took the same kind of refresh."""
    if kind == "histogram":
        full = histogram_batch(6, 100, start_ms=START)
        bounds = [(0, 60), (60, 61), (61, 75), (75, 100)]
    else:
        full = counter_batch(12, 100, start_ms=START, resets=True)
        bounds = [(0, 60), (60, 61), (61, 62), (62, 80), (80, 100)]
    slices = list(time_slices(full, bounds))
    if kind == "ragged":
        # some series miss a scrape, one series gets NaN samples
        slices[2] = sub(slices[2], slices[2].part_idx % 4 != 1)
        slices[3].columns["count"][slices[3].part_idx == 2] = np.nan
    jm, pm = JMemStore(), TimeSeriesMemStore(device="cpu")
    js, ps = jm.setup("prometheus", 0), pm.setup("prometheus", 0)
    jmirror, pmirror = JMirror(), DeviceMirror(device="cpu")
    for i, sl in enumerate(slices):
        js.ingest(sl, offset=i)
        ps.ingest(to_port(sl), offset=i)
        name = next(iter(ps.stores))
        j0 = registry.counter("device_mirror_incremental").value
        p0 = _incr()
        assert jmirror.ensure_fresh(js.stores[name])
        assert pmirror.ensure_fresh(ps.stores[name])
        assert registry.counter("device_mirror_incremental").value - j0 \
            == _incr() - p0 == (1 if i else 0)
        _assert_states_match(pmirror.snapshot(), jmirror.snapshot())
        _assert_equivalent(ps.stores[name], pmirror)

