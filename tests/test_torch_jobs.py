"""The port's batch and maintenance jobs (filodb_tpu_torch/jobs:
batch_io, copier, buster) against the JAX package's on the same seeded
batches:

- an NPZ bundle exported by the port holds the reference's arrays, array
  by array; an exported CSV equals the reference's byte for byte;
- a bundle written by the reference imports into the port and answers
  within rtol 2e-4 / atol 1e-3 of the reference's own import, and the
  port's bundle imports into the reference the same way;
- ChunkCopier, PartitionKeysCopier and CardinalityBuster give the
  reference's stats and leave the target stores holding the same keys.
"""
import numpy as np
import pytest

from filodb_tpu.core.index import Equals as JEquals
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.store import InMemoryColumnStore as JColumnStore
from filodb_tpu.core.store import InMemoryMetaStore as JMetaStore
from filodb_tpu.ingest import generator as jgen
from filodb_tpu.jobs import CardinalityBuster as JBuster
from filodb_tpu.jobs import ChunkCopier as JChunkCopier
from filodb_tpu.jobs import PartitionKeysCopier as JKeysCopier
from filodb_tpu.jobs import batch_io as jbatch_io
from filodb_tpu.persist import LocalDiskColumnStore as JDisk
from filodb_tpu.query.engine import QueryEngine as JEngine
from filodb_tpu_torch.core.index import Equals
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.core.store import InMemoryColumnStore, InMemoryMetaStore
from filodb_tpu_torch.ingest import generator as gen
from filodb_tpu_torch.jobs import (CardinalityBuster, ChunkCopier,
                                   PartitionKeysCopier)
from filodb_tpu_torch.jobs import batch_io
from filodb_tpu_torch.persist import LocalDiskColumnStore
from filodb_tpu_torch.query.engine import QueryEngine

from test_torch_ingest import _clear_compile_journal  # noqa: F401

START = 1_600_000_020_000
DS = "prometheus"
RTOL, ATOL = 2e-4, 1e-3


def _both(batches, jcs=None, cs=None):
    """(JAX memstore, port memstore), shard 0 of DS, each ingesting the
    same generator batches [(name, args, kwargs)] from its own package's
    generator (the same seeded arrays: the port's is a copy)."""
    jms = JMemStore(column_store=jcs or JColumnStore(),
                    meta_store=JMetaStore())
    ms = TimeSeriesMemStore(column_store=cs or InMemoryColumnStore(),
                            meta_store=InMemoryMetaStore(), device="cpu")
    for m in (jms, ms):
        m.setup(DS, 0)
    for i, (name, args, kw) in enumerate(batches):
        jms.ingest(DS, 0, getattr(jgen, name)(*args, **kw), offset=i)
        ms.ingest(DS, 0, getattr(gen, name)(*args, **kw), offset=i)
    return jms, ms


MIXED = [("counter_batch", (20, 120), {"start_ms": START}),
         ("gauge_batch", (12, 120), {"start_ms": START}),
         ("histogram_batch", (6, 60), {"start_ms": START})]


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("metric", [None, "request_total", "heap_usage",
                                    "http_latency"])
def test_exported_bundle_arrays_equal_the_reference(tmp_path, metric):
    jms, ms = _both(MIXED)
    filt = [("_metric_", metric)] if metric else [("_ws_", "demo")]
    lo, hi = START + 50_000, START + 1_000_000
    n_j = jbatch_io.export_series(jms, DS, [JEquals(*f) for f in filt],
                                  lo, hi, str(tmp_path / "j.npz"))
    n_p = batch_io.export_series(ms, DS, [Equals(*f) for f in filt],
                                 lo, hi, str(tmp_path / "p.npz"))
    assert n_p == n_j > 0
    a, b = _npz(tmp_path / "p.npz"), _npz(tmp_path / "j.npz")
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    la, sa, _ = batch_io.load_bundle(str(tmp_path / "p.npz"))
    lb, sb, _ = jbatch_io.load_bundle(str(tmp_path / "j.npz"))
    assert (la, sa) == (lb, sb)


@pytest.mark.parametrize("value_column", [None, "count"])
def test_exported_csv_equals_the_reference_bytes(tmp_path, value_column):
    jms, ms = _both(MIXED)
    lo, hi = START, START + 2_000_000
    kw = {"value_column": value_column} if value_column else {}
    filt = [("_metric_", "request_total")] if value_column else \
        [("_ws_", "demo")]
    rows_j = jbatch_io.export_csv(jms, DS, [JEquals(*f) for f in filt],
                                  lo, hi, str(tmp_path / "j.csv"), **kw)
    rows_p = batch_io.export_csv(ms, DS, [Equals(*f) for f in filt],
                                 lo, hi, str(tmp_path / "p.csv"), **kw)
    assert rows_p == rows_j > 0
    assert (tmp_path / "p.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()


QUERIES = [
    "sum by (_ns_) (rate(request_total[5m]))",
    "max by (_ns_) (heap_usage)",
    "histogram_quantile(0.9, sum(rate(http_latency[5m])))",
]


def _answers(res):
    out = {}
    for key, ts, vals in res.series():
        out[str(key)] = (np.asarray(ts), np.asarray(vals, np.float64))
    return out


def _assert_same_answers(got, want, q):
    assert got.error is None and want.error is None, (got.error, want.error)
    a, b = _answers(got), _answers(want)
    assert set(a) == set(b) and a, q
    for k in a:
        np.testing.assert_array_equal(a[k][0], b[k][0])
        np.testing.assert_allclose(a[k][1], b[k][1], rtol=RTOL, atol=ATOL,
                                   equal_nan=True, err_msg=q)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bundle_imports_across_packages(tmp_path, writer):
    """A bundle one package exported bulk-loads into both; every query
    over the port's import answers as the reference's import."""
    jms, ms = _both(MIXED)
    path = str(tmp_path / "bundle.npz")
    if writer == "jax":
        n = jbatch_io.export_series(jms, DS, [JEquals("_ws_", "demo")],
                                    START, START + 2_000_000, path)
    else:
        n = batch_io.export_series(ms, DS, [Equals("_ws_", "demo")],
                                   START, START + 2_000_000, path)
    assert n == 38
    jms2 = JMemStore()
    ms2 = TimeSeriesMemStore(device="cpu")
    jms2.setup(DS, 0)
    ms2.setup(DS, 0)
    assert batch_io.import_series(ms2, DS, path) == \
        jbatch_io.import_series(jms2, DS, path)
    assert ms2.get_shard(DS, 0).stores["prom-histogram"].bucket_les \
        is not None
    s = START // 1000
    for q in QUERIES:
        want = JEngine(DS, jms2).query_range(q, s + 350, 60, s + 590)
        got = QueryEngine(DS, ms2, device="cpu").query_range(
            q, s + 350, 60, s + 590)
        _assert_same_answers(got, want, q)
        # the import answers as the store it was exported from
        _assert_same_answers(
            got, JEngine(DS, jms).query_range(q, s + 350, 60, s + 590), q)


def _flushed(tmp_path=None, n_series=10):
    jcs = JDisk(str(tmp_path / "jsrc")) if tmp_path else JColumnStore()
    cs = LocalDiskColumnStore(str(tmp_path / "src")) if tmp_path \
        else InMemoryColumnStore()
    jms, ms = _both([("gauge_batch", (n_series, 360), {"start_ms": START})],
                    jcs, cs)
    jms.get_shard(DS, 0).flush_all_groups()
    ms.get_shard(DS, 0).flush_all_groups()
    return jcs, cs


@pytest.mark.parametrize("window", [(0, 360 * 10_000), (10**9, 2 * 10**9),
                                    (1_000_000, 2_000_000)])
def test_chunk_copier_equals_the_reference(window):
    jcs, cs = _flushed()
    lo, hi = START + window[0], START + window[1]
    jdst, dst = JColumnStore(), InMemoryColumnStore()
    want = JChunkCopier(jcs, jdst, DS).run([0], lo, hi)
    got = ChunkCopier(cs, dst, DS).run([0], lo, hi)
    assert (got.parts_scanned, got.chunks_copied, got.bytes_copied) == \
        (want.parts_scanned, want.chunks_copied, want.bytes_copied)
    for rec, jrec in zip(cs.read_part_keys(DS, 0),
                         jcs.read_part_keys(DS, 0)):
        assert rec.part_key.to_bytes() == jrec.part_key.to_bytes()
        a = dst.read_chunks(DS, 0, rec.part_key, 0, 1 << 62)
        b = jdst.read_chunks(DS, 0, jrec.part_key, 0, 1 << 62)
        assert [c.info.num_rows for c in a] == [c.info.num_rows for c in b]
        assert [c.nbytes for c in a] == [c.nbytes for c in b]


def test_partkeys_copier_equals_the_reference():
    jcs, cs = _flushed()
    jdst, dst = JColumnStore(), InMemoryColumnStore()
    want = JKeysCopier(jcs, jdst, DS, "copy").run([0], START, START + 10**9)
    got = PartitionKeysCopier(cs, dst, DS, "copy").run([0], START,
                                                      START + 10**9)
    assert got.partkeys_copied == want.partkeys_copied == 10
    assert [(r.part_key.to_bytes(), r.schema_name, r.start_time_ms,
             r.end_time_ms) for r in dst.read_part_keys("copy", 0)] == \
        [(r.part_key.to_bytes(), r.schema_name, r.start_time_ms,
          r.end_time_ms) for r in jdst.read_part_keys("copy", 0)]


@pytest.mark.parametrize("match", [{"_ns_": "App-1"}, {"_ws_": "nobody"},
                                   {"_metric_": "heap_usage"}])
def test_cardinality_buster_equals_the_reference(tmp_path, match):
    jcs, cs = _flushed(tmp_path)
    want = JBuster(jcs, DS).run([0], match)
    got = CardinalityBuster(cs, DS).run([0], match)
    assert (got.parts_scanned, got.parts_deleted) == \
        (want.parts_scanned, want.parts_deleted)
    assert sorted(r.part_key.to_bytes() for r in cs.read_part_keys(DS, 0)) \
        == sorted(r.part_key.to_bytes() for r in jcs.read_part_keys(DS, 0))


def test_cardinality_buster_refuses_a_store_without_deletion():
    from filodb_tpu_torch.core.store import NullColumnStore
    with pytest.raises(NotImplementedError):
        CardinalityBuster(NullColumnStore(), DS).run([0], {"_ns_": "x"})
