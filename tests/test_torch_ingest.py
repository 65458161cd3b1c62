"""The port's per-record ingest (TimeSeriesShard.ingest, ingest_columns,
the memstore's ingest and ingest_stream) against the JAX package's: the
same batches, made by filodb_tpu.ingest.generator and carried over with
filodb_tpu_torch.core.convert.record_batch_from_arrays, go into both.

Cases: grid batches, interleaved keys (one sample of each series in
turn), flat ragged batches (series with different sample counts), a
batch with duplicate part keys, out-of-order and duplicate-timestamp
drops, a stream with interleaved flushes, and the duplicate-key slab of
ingest_columns (flattened into a RecordBatch, as in the reference).

Checks: each store's ts, columns, counts, sealed watermarks and
last_ts equal to the bit, ShardStats and ingested_offset equal, and the
two engines' answers within rtol 2e-4 / atol 1e-3
(__graft_entry__.py:221), NaN placement exact.
"""
import numpy as np
import pytest

from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.records import RecordBatch as JBatch
from filodb_tpu.ingest.generator import (counter_batch, gauge_batch,
                                         histogram_batch)
from filodb_tpu.query.engine import QueryEngine as JEngine
from filodb_tpu_torch.core.convert import record_batch_from_arrays
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.core.records import RecordBatch, RecordBatchBuilder
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
from filodb_tpu_torch.query.engine import QueryEngine

START = 1_600_000_000_000
START_S = START // 1000
RTOL, ATOL = 2e-4, 1e-3
STATS = ("rows_ingested", "partitions_created", "rows_dropped",
         "chunks_flushed", "flushes", "evictions")


@pytest.fixture(autouse=True, scope="module")
def _clear_compile_journal():
    """The JAX engine's queries journal a jit compile per new shape, which
    the reference's health model reads as a compile storm for the next
    120 s in whatever test file this process runs next; clear the
    journal after this file (as tests/test_torch_engine.py does).  The
    other live-ingest test files import this fixture."""
    yield
    from filodb_tpu.utils.events import journal
    journal.clear()


def to_port(b):
    """A JAX RecordBatch as the port's, through plain arrays."""
    return record_batch_from_arrays(
        b.schema.name,
        [{**pk.tags_dict, "_metric_": pk.metric} for pk in b.part_keys],
        b.part_idx, b.timestamps, b.columns, b.bucket_les)


def sub(b, keep):
    return JBatch(b.schema, b.part_keys, b.part_idx[keep], b.timestamps[keep],
                  {k: v[keep] for k, v in b.columns.items()}, b.bucket_les)


def time_slices(b, bounds):
    for lo, hi in bounds:
        yield sub(b, (b.timestamps >= START + lo * 10_000)
                  & (b.timestamps < START + hi * 10_000))


def interleave(b):
    """The batch's records ordered by time, then key: one sample of each
    series in turn (the flat shape a broker delivers)."""
    order = np.lexsort((b.part_idx, b.timestamps))
    return sub(b, order)


def both(batches, offsets=None):
    """Ingest the same batches into a JAX and a port memstore."""
    jm, pm = JMemStore(), TimeSeriesMemStore(device="cpu")
    js, ps = jm.setup("prometheus", 0), pm.setup("prometheus", 0)
    for i, b in enumerate(batches):
        off = i if offsets is None else offsets[i]
        nj = js.ingest(b, offset=off)
        npt = ps.ingest(to_port(b), offset=off)
        assert nj == npt
    return jm, pm


def assert_same_state(jm, pm):
    js, ps = jm.get_shard("prometheus", 0), pm.get_shard("prometheus", 0)
    assert set(js.stores) == set(ps.stores)
    for name, a in js.stores.items():
        b = ps.stores[name]
        s = a.num_series
        assert b.num_series == s
        t = max(a.time_used, 1)
        assert b.time_used == a.time_used
        np.testing.assert_array_equal(b.counts[:s], a.counts[:s])
        np.testing.assert_array_equal(b.sealed[:s], a.sealed[:s])
        np.testing.assert_array_equal(b.ts[:s, :t], a.ts[:s, :t])
        counted = np.arange(t)[None, :] < a.counts[:s, None]
        np.testing.assert_array_equal(b.last_ts[:s][a.counts[:s] > 0],
                                      a.last_ts[:s][a.counts[:s] > 0])
        for col, arr in a.cols.items():
            if arr is None:
                assert b.cols[col] is None
                continue
            got, want = b.cols[col][:s, :t], arr[:s, :t]
            assert got.tobytes() == want.tobytes(), col
            assert (np.isnan(got) | counted.reshape(counted.shape + (1,) *
                                                    (got.ndim - 2))).all()
        if a.bucket_les is not None:
            np.testing.assert_array_equal(b.bucket_les, a.bucket_les)
        assert b.dropped_out_of_order == a.dropped_out_of_order
    for f in STATS:
        assert getattr(ps.stats, f) == getattr(js.stats, f), f
    assert ps.ingested_offset == js.ingested_offset
    assert ps.num_partitions == js.num_partitions
    assert [p.part_key.to_bytes() for p in ps.partitions] == \
        [p.part_key.to_bytes() for p in js.partitions]
    assert [p.group for p in ps.partitions] == [p.group for p in js.partitions]


def assert_same_answers(jm, pm, queries, end_idx):
    je, pe = JEngine("prometheus", jm), QueryEngine("prometheus", pm,
                                                    device="cpu")
    n = 0
    for q in queries:
        want = je.query_range(q, START_S + 600, 60, START_S + end_idx * 10)
        got = pe.query_range(q, START_S + 600, 60, START_S + end_idx * 10)
        assert want.error is None and got.error is None, (want.error,
                                                          got.error)
        w = sorted((k.labels, np.asarray(v)) for k, _, v in want.series())
        g = sorted((k.labels, np.asarray(v)) for k, _, v in got.series())
        assert [k for k, _ in g] == [k for k, _ in w], q
        for (k, wv), (_, gv) in zip(w, g):
            assert (np.isnan(gv) == np.isnan(wv)).all(), (q, k)
            np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=ATOL,
                                       equal_nan=True, err_msg=f"{q} {k}")
        n += len(w)
    assert n > 0


COUNTER_QS = ["sum by (_ns_) (rate(request_total[5m]))",
              "max by (_ns_) (increase(request_total[5m]))",
              "sum by (_ns_) (changes(request_total[5m]))"]
GAUGE_QS = ["avg by (_ns_) (avg_over_time(heap_usage[5m]))",
            "max by (_ns_) (heap_usage)"]


def _case(case):
    """-> (batches, queries, end index in 10 s steps)."""
    c = counter_batch(20, 150, start_ms=START)
    if case == "grid":
        return list(time_slices(c, [(0, 60), (60, 61), (61, 150)])), \
            COUNTER_QS, 149
    if case == "interleaved":
        return [interleave(b) for b in
                time_slices(c, [(0, 70), (70, 150)])], COUNTER_QS, 149
    if case == "flat_ragged":
        # each batch drops a random fifth of its records: series gain
        # different numbers of samples (and some rows none at all)
        rng = np.random.default_rng(5)
        return [sub(b, rng.random(b.num_records) >= 0.2) for b in
                time_slices(c, [(0, 70), (70, 150)])], COUNTER_QS, 149
    if case == "gauge_flat":
        g = gauge_batch(16, 120, start_ms=START)
        return [interleave(b) for b in
                time_slices(g, [(0, 50), (50, 120)])], GAUGE_QS, 119
    if case == "histogram":
        h = histogram_batch(6, 90, start_ms=START)
        return list(time_slices(h, [(0, 40), (40, 90)])), \
            ["sum by (_ns_) (rate(http_latency[5m]))"], 89
    if case == "duplicate_keys":
        # a key table listing each of 10 series twice, entry j + 10
        # carrying the later half of series j's samples: grid-shaped, but
        # two entries alias one series, so ingest takes the flat path
        g = next(time_slices(c, [(0, 100)]))
        ts2, v2 = g.timestamps.reshape(20, 100), g.columns["count"].reshape(
            20, 100)
        ts = np.concatenate([ts2[:10, :50], ts2[:10, 50:]])
        vals = np.concatenate([v2[:10, :50], v2[:10, 50:]])
        keys = list(g.part_keys[:10]) * 2
        return [JBatch(g.schema, keys,
                       np.repeat(np.arange(20, dtype=np.int32), 50),
                       ts.ravel(), {"count": vals.ravel()})], COUNTER_QS, 99
    if case == "out_of_order":
        a, b, rest = time_slices(c, [(0, 80), (60, 100), (100, 150)])
        # a re-delivered overlap (60-80 dropped), then records out of order
        # inside one batch: every sample older than its series' last drops
        rev = sub(rest, np.arange(rest.num_records)[::-1])
        return [a, b, rev, a], COUNTER_QS, 149
    raise ValueError(case)


@pytest.mark.parametrize("case", ["grid", "interleaved", "flat_ragged",
                                  "gauge_flat", "histogram",
                                  "duplicate_keys", "out_of_order"])
def test_ingest_matches_jax(case):
    batches, queries, end_idx = _case(case)
    jm, pm = both(batches)
    assert_same_state(jm, pm)
    assert_same_answers(jm, pm, queries, end_idx)


def test_grid_detection_and_key_table_cache():
    """A grid batch takes the rectangular path and a reused key list
    resolves from the cache; the port's _grid_samples agrees with the
    reference's on grid, flat and near-grid shapes."""
    from filodb_tpu.core.shard import TimeSeriesShard as JShard
    from filodb_tpu_torch.core.shard import TimeSeriesShard
    c = counter_batch(8, 12, start_ms=START)
    shapes = [c, interleave(c), sub(c, np.arange(c.num_records - 1)),
              sub(c, np.r_[1:c.num_records, 0])]
    for b in shapes:
        assert TimeSeriesShard._grid_samples(to_port(b)) == \
            JShard._grid_samples(b)
    assert TimeSeriesShard._grid_samples(to_port(c)) == 12
    pm = TimeSeriesMemStore(device="cpu")
    sh = pm.setup("prometheus", 0)
    pb = to_port(c)
    keys = pb.part_keys
    for i in range(3):
        ts = (pb.timestamps + i * 120_000).reshape(8, 12)
        sh.ingest(RecordBatch.from_grid(pb.schema, keys, ts,
                                        {"count": pb.columns["count"]
                                         .reshape(8, 12) + i * 1e4}),
                  offset=i)
    assert sh.stats.partitions_created == 8
    assert sh.stats.rows_ingested == 8 * 36 and sh.ingested_offset == 2


def test_ingest_columns_duplicate_keys_flattens_like_jax():
    """A columnar slab whose key list repeats keys ingests through the
    per-record path (RecordBatch.from_grid), as the reference's does:
    it no longer raises.  Rows 3-5 of each slab repeat the keys of rows
    0-2 with the next 25 samples of the same series."""
    c = counter_batch(3, 100, start_ms=START)
    pc = to_port(c)
    jkeys = list(c.part_keys) * 2
    pkeys = list(pc.part_keys) * 2
    ts = c.timestamps.reshape(3, 100)
    vals = c.columns["count"].reshape(3, 100)
    jm, pm = JMemStore(), TimeSeriesMemStore(device="cpu")
    js, ps = jm.setup("prometheus", 0), pm.setup("prometheus", 0)
    for lo in (0, 50):
        slab_ts = np.concatenate([ts[:, lo:lo + 25], ts[:, lo + 25:lo + 50]])
        slab_v = np.concatenate([vals[:, lo:lo + 25],
                                 vals[:, lo + 25:lo + 50]])
        nj = js.ingest_columns("prom-counter", jkeys, slab_ts,
                               {"count": slab_v}, offset=lo)
        npt = ps.ingest_columns("prom-counter", pkeys, slab_ts,
                                {"count": slab_v}, offset=lo)
        assert nj == npt == 150
    assert_same_state(jm, pm)
    np.testing.assert_array_equal(ps.stores["prom-counter"].ts[:3, :100], ts)
    assert_same_answers(jm, pm, COUNTER_QS, 99)


def test_ingest_stream_with_flushes_matches_jax():
    """memstore.ingest_stream with a group flush every 2 batches: the same
    store, stats and checkpoints as the reference."""
    from filodb_tpu.ingest.generator import batch_stream
    c = counter_batch(12, 120, start_ms=START)
    jm, pm = JMemStore(), TimeSeriesMemStore(device="cpu")
    js, ps = jm.setup("prometheus", 0), pm.setup("prometheus", 0)
    # 2 groups so every flush seals something
    js._groups = ps._groups = 2
    js._group_pids = [[], []]
    ps._group_pids = [[], []]
    js._group_skip_rounds = [0, 0]
    ps._group_skip_rounds = [0, 0]
    stream = list(batch_stream(c, 20))
    nj = jm.ingest_stream("prometheus", 0, iter(stream), flush_every=2)
    npt = pm.ingest_stream("prometheus", 0,
                           iter([(to_port(b), o) for b, o in stream]),
                           flush_every=2)
    assert nj == npt == 12 * 120
    assert_same_state(jm, pm)
    assert pm.meta_store.read_checkpoints("prometheus", 0) == \
        jm.meta_store.read_checkpoints("prometheus", 0)
    assert ps.stats.chunks_flushed > 0


def test_record_batch_builder_matches_jax():
    from filodb_tpu.core.records import RecordBatchBuilder as JBuilder
    from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as JSCHEMAS
    c = counter_batch(3, 5, start_ms=START)
    pc = to_port(c)
    jb, pb = JBuilder(JSCHEMAS["prom-counter"]), \
        RecordBatchBuilder(DEFAULT_SCHEMAS["prom-counter"])
    for i in range(c.num_records):
        k = int(c.part_idx[i])
        jb.add(c.part_keys[k], int(c.timestamps[i]),
               count=float(c.columns["count"][i]))
        pb.add(pc.part_keys[k], int(c.timestamps[i]),
               count=float(c.columns["count"][i]))
    jb.add_rows(c.part_keys[0], c.timestamps[:2] + 10**6,
                {"count": np.array([1.0, 2.0])})
    pb.add_rows(pc.part_keys[0], c.timestamps[:2] + 10**6,
                {"count": np.array([1.0, 2.0])})
    want, got = jb.build(), pb.build()
    assert [k.to_bytes() for k in got.part_keys] == \
        [k.to_bytes() for k in want.part_keys]
    np.testing.assert_array_equal(got.part_idx, want.part_idx)
    np.testing.assert_array_equal(got.timestamps, want.timestamps)
    np.testing.assert_array_equal(got.columns["count"], want.columns["count"])
    with pytest.raises(ValueError):
        RecordBatch(got.schema, got.part_keys, got.part_idx[:-1],
                    got.timestamps, got.columns).validate()
