"""The local-disk column and meta stores in the port
(filodb_tpu_torch.persist.localstore), the shard's recover_index and the
chunk-metadata plan SelectChunkInfosExec, against the JAX package:

- one ChunkSet written through both stores gives byte-identical
  chunks.log and partkeys.log files, and each package reads the other's
  directory back to the same chunk;
- part-key upserts (last wins), a torn tail, a corrupt frame, the
  ingestion-time scan, atomic checkpoints (the same JSON bytes), the
  frame index sidecar and its staleness check, batched reads;
- the same batches flushed by both packages give the same frames (all
  but the process-local chunk ids);
- crash recovery: a fresh memstore on the same directory recovers the
  index (recover_index), the unflushed offsets are ingested again, and
  queries page the flushed frames back on demand: answers within rtol
  2e-4 / atol 1e-3 of the JAX package's recovered store, also from a
  directory the JAX package wrote;
- SelectChunkInfosExec rows equal the reference's, chunk ids aside.
"""
import os

import numpy as np
import pytest

from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.partkey import PartKey as JPartKey
from filodb_tpu.core.store import PartKeyRecord as JRecord
from filodb_tpu.ingest.generator import (batch_stream, gauge_batch,
                                         histogram_batch)
from filodb_tpu.memory import chunks as jchunks
from filodb_tpu.memory.histogram import HistogramBuckets as JBuckets
from filodb_tpu.persist import LocalDiskColumnStore as JDisk
from filodb_tpu.persist import LocalDiskMetaStore as JMeta
from filodb_tpu.query.engine import QueryEngine as JEngine
from filodb_tpu.query.exec import SelectChunkInfosExec as JChunkInfos
from filodb_tpu.query.rangevector import QueryContext as JContext
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.store import PartKeyRecord
from filodb_tpu_torch.memory import chunks
from filodb_tpu_torch.memory.histogram import default_buckets
from filodb_tpu_torch.persist import LocalDiskColumnStore, LocalDiskMetaStore
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.query.exec import SelectChunkInfosExec
from filodb_tpu_torch.query.rangevector import QueryContext
from filodb_tpu_torch.utils.metrics import registry

from test_torch_codec import INGEST_MS, _same_chunk
from test_torch_ingest import _clear_compile_journal, to_port  # noqa: F401
from test_torch_longrange import assert_close

LABELS = {"_ws_": "w", "_ns_": "n", "instance": "i0"}


def _chunkset(hist=False, n=20, start_ms=0, ing_ms=123_000):
    """The same chunk in both packages' types (one chunk id)."""
    ts = np.arange(n, dtype=np.int64) * 10_000 + start_ms
    if hist:
        scheme = default_buckets()
        mat = np.cumsum(np.random.default_rng(0).integers(
            0, 5, size=(n, scheme.num_buckets)), axis=1).astype(np.int64)
        cs = chunks.encode_chunkset(ts, {"h": mat}, {"h": "hist"}, ing_ms,
                                    scheme)
    else:
        vals = np.sin(np.arange(n) / 3.0) * 50 + 100
        cs = chunks.encode_chunkset(ts, {"value": vals}, {"value": "double"},
                                    ing_ms)
    i = cs.info
    jcs = jchunks.ChunkSet(
        jchunks.ChunkSetInfo(i.chunk_id, i.ingestion_time_ms, i.num_rows,
                             i.start_time_ms, i.end_time_ms),
        {k: jchunks.ColumnChunk(c.kind, c.payload, base=c.base,
                                slope=c.slope, num_buckets=c.num_buckets)
         for k, c in cs.columns.items()},
        None if cs.bucket_scheme is None
        else JBuckets(tuple(cs.bucket_scheme.les)))
    return cs, jcs


def _shard_files(root, ds="p"):
    d = os.path.join(str(root), ds, "shard-0")
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("hist", [False, True])
def test_frames_byte_identical_and_read_across(tmp_path, hist):
    schema = "prom-histogram" if hist else "gauge"
    cs, jcs = _chunkset(hist)
    pk, jpk = PartKey.make("m", LABELS), JPartKey.make("m", LABELS)
    port, ref = LocalDiskColumnStore(str(tmp_path / "port")), \
        JDisk(str(tmp_path / "jax"))
    port.write_chunks("p", 0, pk, [cs], schema)
    ref.write_chunks("p", 0, jpk, [jcs], schema)
    port.write_part_keys("p", 0, [PartKeyRecord(pk, schema, 0, 190_000)])
    ref.write_part_keys("p", 0, [JRecord(jpk, schema, 0, 190_000)])
    port.close()
    ref.close()
    files, jfiles = _shard_files(tmp_path / "port"), \
        _shard_files(tmp_path / "jax")
    assert set(files) == set(jfiles) == {"chunks.log", "chunks.log.idx",
                                         "partkeys.log"}
    for name in ("chunks.log", "partkeys.log"):
        assert files[name] == jfiles[name], name
    # the frame index sidecar records its log's mtime, and nothing else
    # of the machine: the rest is the same bytes
    assert files["chunks.log.idx"][:14] == jfiles["chunks.log.idx"][:14]
    assert files["chunks.log.idx"][22:] == jfiles["chunks.log.idx"][22:]
    # each package reads the other's directory
    got = LocalDiskColumnStore(str(tmp_path / "jax")).read_chunks(
        "p", 0, pk, 0, 10**15)
    want = JDisk(str(tmp_path / "port")).read_chunks("p", 0, jpk, 0, 10**15)
    assert len(got) == len(want) == 1
    _same_chunk(got[0], want[0])
    assert got[0].info.chunk_id == cs.info.chunk_id
    for name, v in chunks.decode_chunkset(got[0]).items():
        np.testing.assert_array_equal(
            v, jchunks.decode_chunkset(want[0])[name])
    recs = LocalDiskColumnStore(str(tmp_path / "jax")).read_part_keys("p", 0)
    assert [(r.part_key, r.schema_name, r.end_time_ms) for r in recs] == \
        [(pk, schema, 190_000)]


def test_partkey_upsert_last_wins(tmp_path):
    store = LocalDiskColumnStore(str(tmp_path))
    pk = PartKey.make("m", {"_ws_": "w", "_ns_": "n"})
    store.write_part_keys("p", 0, [PartKeyRecord(pk, "gauge", 100, 200)])
    store.write_part_keys("p", 0, [PartKeyRecord(pk, "gauge", 100, 900)])
    store.close()
    recs = LocalDiskColumnStore(str(tmp_path)).read_part_keys("p", 0)
    assert len(recs) == 1 and recs[0].end_time_ms == 900
    assert [r.end_time_ms for r in JDisk(str(tmp_path)).read_part_keys(
        "p", 0)] == [900]


def _three_frames(tmp_path):
    store = LocalDiskColumnStore(str(tmp_path))
    pk = PartKey.make("m", {"_ws_": "w", "_ns_": "n"})
    for i in range(3):
        store.write_chunks("p", 0, pk, [_chunkset(start_ms=i * 1_000_000)[0]],
                           "gauge")
    store.close()
    return os.path.join(str(tmp_path), "p", "shard-0", "chunks.log"), pk


def test_torn_tail_tolerated(tmp_path):
    path, pk = _three_frames(tmp_path)
    os.remove(path + ".idx")
    with open(path, "r+b") as f:            # a crash mid-append
        f.truncate(os.path.getsize(path) - 17)
    assert len(LocalDiskColumnStore(str(tmp_path)).read_chunks(
        "p", 0, pk, 0, 10**15)) == 2
    assert len(JDisk(str(tmp_path)).read_chunks(
        "p", 0, JPartKey.make("m", {"_ws_": "w", "_ns_": "n"}), 0,
        10**15)) == 2


def test_corrupt_frame_stops_scan(tmp_path):
    path, pk = _three_frames(tmp_path)
    os.remove(path + ".idx")
    with open(path, "r+b") as f:
        f.seek(40)
        f.write(b"\xde\xad")                # CRC mismatch in frame 0
    assert LocalDiskColumnStore(str(tmp_path)).read_chunks(
        "p", 0, pk, 0, 10**15) == []


def test_ingestion_time_scan(tmp_path):
    store = LocalDiskColumnStore(str(tmp_path))
    pk = PartKey.make("m", {"_ws_": "w", "_ns_": "n"})
    for ing in (100_000, 200_000, 300_000):
        store.write_chunks("p", 0, pk, [_chunkset(ing_ms=ing)[0]], "gauge")
    hits = list(store.scan_chunks_by_ingestion_time("p", 0, 150_000,
                                                    300_000))
    assert len(hits) == 1
    assert hits[0][2].info.ingestion_time_ms == 200_000
    assert (hits[0][0], hits[0][1]) == (pk, "gauge")


def test_metastore_checkpoints_atomic(tmp_path):
    for Meta, sub in ((LocalDiskMetaStore, "port"), (JMeta, "jax")):
        meta = Meta(str(tmp_path / sub))
        meta.write_checkpoint("p", 0, 0, 10)
        meta.write_checkpoint("p", 0, 1, 20)
        meta.write_checkpoint("p", 0, 0, 30)
    meta2 = LocalDiskMetaStore(str(tmp_path / "jax"))
    assert meta2.read_checkpoints("p", 0) == {0: 30, 1: 20}
    assert meta2.read_earliest_checkpoint("p", 0) == 20
    assert meta2.read_highest_checkpoint("p", 0) == 30
    assert meta2.read_checkpoints("p", 1) == {}
    name = os.path.join("p", "checkpoints-0.json")
    assert open(tmp_path / "port" / name, "rb").read() == \
        open(tmp_path / "jax" / name, "rb").read()
    assert not [f for f in os.listdir(tmp_path / "port" / "p")
                if f.endswith(".tmp")]


def _flushed_pair(tmp_path, kind="gauge", split=2):
    """Both packages ingest the same stream into disk stores and flush the
    first `split` batches; -> (stream, JAX store, port store, roots)."""
    batch = (histogram_batch(3, 40, start_ms=1_000_000) if kind == "hist"
             else gauge_batch(6, 120, start_ms=1_000_000))
    stream = list(batch_stream(batch, samples_per_chunk=30))
    out = {}
    for port in (True, False):
        root = tmp_path / ("port" if port else "jax")
        if port:
            ms = TimeSeriesMemStore(
                column_store=LocalDiskColumnStore(str(root / "col")),
                meta_store=LocalDiskMetaStore(str(root / "meta")),
                device="cpu")
        else:
            ms = JMemStore(column_store=JDisk(str(root / "col")),
                           meta_store=JMeta(str(root / "meta")))
        shard = ms.setup("prometheus", 0)
        for b, off in stream[:split]:
            shard.ingest(to_port(b) if port else b, off)
        for g in range(shard._groups):
            shard.flush_group(g, ingestion_time_ms=INGEST_MS)
        for b, off in stream[split:]:        # ingested, never flushed
            shard.ingest(to_port(b) if port else b, off)
        ms.column_store.close()
        out[port] = (ms, root)
    return stream, out


def test_flushed_frames_equal_the_reference(tmp_path):
    _, out = _flushed_pair(tmp_path)
    port = LocalDiskColumnStore(str(out[True][1] / "col"))
    ref = JDisk(str(out[False][1] / "col"))
    precs = {r.part_key.to_bytes(): r for r in
             port.read_part_keys("prometheus", 0)}
    jrecs = {r.part_key.to_bytes(): r for r in
             ref.read_part_keys("prometheus", 0)}
    assert set(precs) == set(jrecs) and len(precs) == 6
    for kb, r in precs.items():
        got = port.read_chunks("prometheus", 0, r.part_key, 0, 10**15)
        want = ref.read_chunks("prometheus", 0, jrecs[kb].part_key, 0,
                               10**15)
        assert len(got) == len(want) == 1
        _same_chunk(got[0], want[0])
    assert LocalDiskMetaStore(str(out[True][1] / "meta")).read_checkpoints(
        "prometheus", 0) == JMeta(str(out[False][1] / "meta")
                                  ).read_checkpoints("prometheus", 0)


def _recovered(root, port, stream, split):
    """A fresh memstore over `root`: the index recovered from disk, the
    offsets past the checkpoints ingested again."""
    if port:
        ms = TimeSeriesMemStore(
            column_store=LocalDiskColumnStore(str(root / "col")),
            meta_store=LocalDiskMetaStore(str(root / "meta")), device="cpu")
    else:
        ms = JMemStore(column_store=JDisk(str(root / "col")),
                       meta_store=JMeta(str(root / "meta")))
    shard = ms.setup("prometheus", 0)
    n = shard.recover_index()
    for b, off in stream[split:]:
        shard.ingest(to_port(b) if port else b, off)
    return ms, shard, n


QUERIES = [  # (query, start s, end s): the series run 1,000-2,190 s
    ('sum_over_time(heap_usage{_ws_="demo"}[20m])', 2_200, 2_200),
    ('heap_usage{_ws_="demo"}', 1_300, 2_190),
    ('max by (_ns_) (avg_over_time(heap_usage[5m]))', 1_300, 2_190)]


@pytest.mark.parametrize("writer_is_port", [True, False])
def test_crash_recovery_pages_flushed_frames(tmp_path, writer_is_port):
    """Ingest, flush two of four batches to disk, 'crash'; a fresh
    memstore of each package recovers the index from the writer's
    directory, takes the unflushed offsets again, and full-range queries
    page the flushed frames back: both packages answer the same."""
    stream, out = _flushed_pair(tmp_path)
    root = out[writer_is_port][1]
    res = {}
    for port in (True, False):
        ms, shard, n = _recovered(root, port, stream, 2)
        assert n == 6
        assert len(shard.lookup_partitions([], 0, 10**15).part_ids) == 6
        eng = QueryEngine("prometheus", ms, device="cpu") if port \
            else JEngine("prometheus", ms)
        res[port] = [eng.query_range(q, a, 60, b) for q, a, b in QUERIES]
    for (q, _, _), a, b in zip(QUERIES, res[True], res[False]):
        assert a.num_series > 0, q
        assert_close(a, b, q)
    # every sample but the first (the window is left-open) contributes:
    # the first 60 a series came back from disk
    vals = gauge_batch(6, 120, start_ms=1_000_000).columns["value"]
    total = sum(float(v[0]) for _, _, v in res[True][0].series())
    np.testing.assert_allclose(
        total, vals.reshape(6, 120)[:, 1:].sum(), rtol=1e-6)


def test_recovered_histograms_page_back(tmp_path):
    """Histogram frames page back after recovery as the reference's do:
    the first 30 samples of each of 3 histograms, [S, T, B] columns."""
    stream, out = _flushed_pair(tmp_path, kind="hist", split=1)
    paged = {}
    for port in (True, False):
        ms, shard, n = _recovered(out[port][1], port, stream, len(stream))
        assert n == 3
        parts = shard.lookup_partitions([], 0, 10**15).parts_by_schema[
            "prom-histogram"]
        paged[port] = shard.ensure_paged(parts, 0, 10**15)
        store = shard.stores["prom-histogram"]
        rows = [p.row for p in parts]
        assert store.cols["h"].shape[2] == store.num_buckets
        assert np.isfinite(store.cols["h"][rows, :30, :]).all()
    assert paged[True] == paged[False] == 3 * 30


def test_sidecar_index_roundtrip_and_staleness(tmp_path):
    _, out = _flushed_pair(tmp_path)
    col = str(out[True][1] / "col")
    cs = LocalDiskColumnStore(col)
    hits0 = registry.counter("chunk_index_sidecar", verdict="hit").value
    cs._load_shard("prometheus", 0)
    assert registry.counter("chunk_index_sidecar",
                            verdict="hit").value == hits0 + 1
    snap = {b: [(r.offset, r.chunk_id) for r in refs]
            for b, refs in cs._chunk_idx[("prometheus", 0)].items()}
    assert len(snap) == 6
    cs.close()
    idx = os.path.join(col, "prometheus", "shard-0", "chunks.log.idx")
    with open(idx, "r+b") as f:
        f.seek(6)
        f.write(b"\xff\xff\xff\xff")        # break the recorded size
    stale0 = registry.counter("chunk_index_sidecar", verdict="stale").value
    cs2 = LocalDiskColumnStore(col)
    cs2._load_shard("prometheus", 0)
    assert registry.counter("chunk_index_sidecar",
                            verdict="stale").value == stale0 + 1
    assert {b: [(r.offset, r.chunk_id) for r in refs]
            for b, refs in cs2._chunk_idx[("prometheus", 0)].items()} == snap
    recs = cs2.read_part_keys("prometheus", 0)
    reqs = [(r.part_key, 0, 10**15) for r in recs]
    multi = cs2.read_chunks_multi("prometheus", 0, reqs)
    for (pk, t0, t1), got in zip(reqs, multi):
        assert [c.info.chunk_id for c in got] == \
            [c.info.chunk_id for c in cs2.read_chunks("prometheus", 0, pk,
                                                      t0, t1)]


def _rows_sans_ids(rows):
    return sorted(tuple(sorted((k, str(v)) for k, v in r.items()
                               if k not in ("chunkId", "partId")))
                  for r in rows)


def test_select_chunk_infos_matches_reference(tmp_path):
    """The chunk-metadata plan over a recovered shard (flushed frames in
    the column store, the replayed tail unsealed in the dense store)."""
    stream, out = _flushed_pair(tmp_path)
    rows = {}
    for port in (True, False):
        ms, shard, _ = _recovered(out[port][1], port, stream, 2)
        Plan, Ctx = (SelectChunkInfosExec, QueryContext) if port \
            else (JChunkInfos, JContext)
        plan = Plan(Ctx(), "prometheus", 0, [], 0, 1 << 62)
        res, stats = plan._do_execute(ms)
        assert stats.series_scanned == 6
        rows[port] = res.data
    assert _rows_sans_ids(rows[True]) == _rows_sans_ids(rows[False])
    assert {r["tier"] for r in rows[True]} == {"persisted", "dense"}
    assert len(rows[True]) == 12
    plan = SelectChunkInfosExec(QueryContext(), "prometheus", 0, [], 0, 1)
    assert plan.args_str() == JChunkInfos(JContext(), "prometheus", 0, [],
                                          0, 1).args_str()


def test_raw_chunk_meta_plan_fans_out_select_chunk_infos(tmp_path):
    """The chunk-metadata plan: both planners refuse RawChunkMeta with the
    same ValueError, and the leaf a caller builds by hand (as the
    reference's CLI does) answers one shard's rows, a column named."""
    from filodb_tpu.core.index import Equals as JEquals
    from filodb_tpu.parallel.shardmapper import ShardEvent as JEvent
    from filodb_tpu.parallel.shardmapper import ShardMapper as JMapper
    from filodb_tpu.query import logical as jlp
    from filodb_tpu.query.planner import SingleClusterPlanner as JPlanner
    from filodb_tpu_torch.core.index import Equals
    from filodb_tpu_torch.query import logical as lp
    from filodb_tpu_torch.query.planner import SingleClusterPlanner
    from filodb_tpu_torch.parallel.shardmapper import ShardEvent, ShardMapper
    errors = []
    for port in (True, False):
        M, E, L, P, C = ((ShardMapper, ShardEvent, lp, SingleClusterPlanner,
                          QueryContext) if port else
                         (JMapper, JEvent, jlp, JPlanner, JContext))
        mapper = M(1)
        mapper.update_from_event(E("IngestionStarted", "prometheus", 0, "n"))
        plan = L.RawChunkMeta(L.IntervalSelector(0, 1 << 62), (), "value")
        with pytest.raises(ValueError) as ei:
            P("prometheus", mapper).materialize(plan, C())
        errors.append(str(ei.value))
    assert errors[0] == errors[1] == "cannot materialize RawChunkMeta"
    stream, out = _flushed_pair(tmp_path)
    rows = {}
    for port in (True, False):
        ms, _, _ = _recovered(out[port][1], port, stream, 2)
        Plan, Ctx, Eq = ((SelectChunkInfosExec, QueryContext, Equals) if port
                         else (JChunkInfos, JContext, JEquals))
        leaf, _ = Plan(Ctx(), "prometheus", 0,
                       (Eq("_metric_", "heap_usage"),), 0, 1 << 62,
                       col_name="value")._do_execute(ms)
        rows[port] = leaf.data
    assert len(rows[True]) == 12
    assert _rows_sans_ids(rows[True]) == _rows_sans_ids(rows[False])
