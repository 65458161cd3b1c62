"""The port's write-ahead log (filodb_tpu_torch.wal) and its snappy codec
(filodb_tpu_torch.utils.snappy) against the JAX package's:

- snappy: compress is byte-identical below and above _FAST_MIN (the
  vectorized encoder), each package decodes the other's output, and
  malformed input raises the same errors;
- WalRecord.encode is byte-identical in every mode (inline and ref key
  tables, shared-row and full timestamps, histogram columns with
  bucket_les), and each package decodes the other's bodies;
- the same appends through both WalManagers give byte-identical segment
  files; a log written by either package replays into the other's
  memstore with equal ReplayStats, equal store contents and query
  answers within rtol 2e-4 / atol 1e-3 (__graft_entry__.py:221);
- a torn tail ends replay cleanly, a flipped byte mid-log counts one
  corrupt segment and replay goes on with the next, restart points skip
  records, note_persisted prunes the same segments, and the next seq
  after recover_writer_state is the reference's;
- a wal.fsync fault fails the commit (WalWriteError) and withholds the
  ack.
"""
import os

import numpy as np
import pytest

from filodb_tpu.config import WalConfig as JWalConfig
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.partkey import PartKey as JPartKey
from filodb_tpu.parallel.shardmapper import ShardEvent as JShardEvent
from filodb_tpu.parallel.shardmapper import ShardMapper as JShardMapper
from filodb_tpu.query.engine import QueryEngine as JEngine
from filodb_tpu.utils import snappy as jsnappy
from filodb_tpu.utils.faults import faults as jfaults
from filodb_tpu.wal import WalManager as JWalManager
from filodb_tpu.wal import WalWriteError as JWalWriteError
from filodb_tpu.wal import replay_dir as jreplay_dir
from filodb_tpu.wal import segment as jsegment
from filodb_tpu.wal.writer import recover_writer_state as jrecover
from filodb_tpu_torch.config import WalConfig
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.parallel.shardmapper import ShardEvent, ShardMapper
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.utils import snappy
from filodb_tpu_torch.utils.faults import faults
from filodb_tpu_torch.wal import WalManager, WalWriteError, replay_dir
from filodb_tpu_torch.wal import segment
from filodb_tpu_torch.wal.writer import recover_writer_state

from test_torch_ingest import _clear_compile_journal  # noqa: F401

START = 1_600_000_000_000
START_S = START // 1000
RTOL, ATOL = 2e-4, 1e-3
DS = "prometheus"
LES = np.array([0.1, 0.5, 1.0, 5.0, np.inf])
PKGS = {
    "jax": dict(pk=JPartKey, mgr=JWalManager, cfg=JWalConfig,
                ms=JMemStore, seg=jsegment),
    "port": dict(pk=PartKey, mgr=WalManager, cfg=WalConfig,
                 ms=lambda: TimeSeriesMemStore(device="cpu"), seg=segment),
}


# ------------------------------------------------------------------ snappy

def _payloads():
    rng = np.random.default_rng(11)
    ramp = np.cumsum(rng.integers(0, 20, size=6000)).astype(np.float64)
    return {
        "empty": b"",
        "short": b"abc",
        "text": b"the quick brown fox " * 50,
        "random_small": rng.bytes(4000),
        "zeros_large": bytes(1 << 16),
        "random_large": rng.bytes(70_000),
        "counters_large": ramp.tobytes(),
        "mixed_large": (b"x" * 20_000) + rng.bytes(30_000) + (b"yz" * 9_000),
    }


@pytest.mark.parametrize("name", sorted(_payloads()))
def test_snappy_compress_is_the_reference_bytes(name):
    data = _payloads()[name]
    assert (len(data) >= snappy._FAST_MIN) == name.endswith("_large")
    ours, ref = snappy.compress(data), jsnappy.compress(data)
    assert ours == ref
    assert snappy.decompress(ref) == data
    assert jsnappy.decompress(ours) == data


@pytest.mark.parametrize("bad", [
    b"",                          # empty input
    b"\x0a\x0c",                  # literal of 4 bytes, 0 given
    b"\x0a\xf0\x01",              # literal with a truncated length byte
    b"\x04\x01\x00",              # copy before any output
    b"\x05\x04abc",               # fewer bytes than the preamble says
], ids=["empty", "truncated_literal", "truncated_length", "bad_offset",
        "length_mismatch"])
def test_snappy_malformed_input_raises_the_reference_error(bad):
    with pytest.raises(ValueError) as ref:
        jsnappy.decompress(bad)
    with pytest.raises(ValueError) as ours:
        snappy.decompress(bad)
    assert str(ours.value) == str(ref.value)


# ----------------------------------------------------------- record bytes

def _keys(pkg, n, metric="m", ns="app"):
    PK = PKGS[pkg]["pk"]
    return [PK.make(metric, {"i": str(i), "_ws_": "demo",
                             "_ns_": f"{ns}{i % 3}"}) for i in range(n)]


def _record_cases():
    rng = np.random.default_rng(3)
    S, k = 6, 4
    row = START + np.arange(k, dtype=np.int64) * 10_000
    shared = np.broadcast_to(row, (S, k))
    full = row[None, :] + rng.integers(0, 5, size=(S, 1)) * 1000
    vals = rng.normal(size=(S, k))
    hist = np.cumsum(rng.integers(0, 4, size=(S, k, len(LES))),
                     axis=2).astype(np.float64)
    return {
        "gauge_shared_ts": ("gauge", "m", shared, {"value": vals}, None),
        "gauge_full_ts": ("gauge", "m", full, {"value": vals}, None),
        "counter_one_sample": ("prom-counter", "request_total",
                               shared[:, :1].copy(),
                               {"count": np.abs(vals[:, :1])}, None),
        "histogram": ("prom-histogram", "lat", shared,
                      {"sum": hist.sum(axis=2), "count": hist[..., -1],
                       "h": hist}, LES),
    }


@pytest.mark.parametrize("case", sorted(_record_cases()))
@pytest.mark.parametrize("mode", ["bare", "inline", "ref"])
def test_record_encode_is_the_reference_bytes(case, mode):
    schema, metric, ts, cols, les = _record_cases()[case]
    bodies = {}
    for pkg in PKGS:
        seg = PKGS[pkg]["seg"]
        keys = _keys(pkg, ts.shape[0], metric)
        rec = seg.WalRecord(9, 3, schema, keys, ts, cols, les)
        blob, h = seg.key_table_entry(keys)
        table = {"bare": None, "inline": (seg.TABLE_INLINE, blob, h),
                 "ref": (seg.TABLE_REF, blob, h)}[mode]
        bodies[pkg] = (rec.encode(table=table), blob, h)
    assert bodies["port"] == bodies["jax"]
    body, _, h = bodies["port"]
    for pkg in PKGS:
        seg = PKGS[pkg]["seg"]
        tables = ({h: _keys(pkg, ts.shape[0], metric)} if mode == "ref"
                  else {})
        out = seg.WalRecord.decode(body, tables)
        assert (out.seq, out.shard, out.schema) == (9, 3, schema)
        assert [pk.to_bytes() for pk in out.part_keys] == \
            [pk.to_bytes() for pk in _keys(pkg, ts.shape[0], metric)]
        np.testing.assert_array_equal(out.ts, ts)
        assert set(out.columns) == set(cols)
        for c, a in cols.items():
            assert out.columns[c].tobytes() == \
                np.ascontiguousarray(a, np.float64).tobytes()
        if les is None:
            assert out.bucket_les is None
        else:
            np.testing.assert_array_equal(out.bucket_les, les)


def test_frame_and_garbage_match_the_reference():
    body = b"\x00" * 100 + bytes(range(256)) * 200
    assert segment.frame_record(body) == jsegment.frame_record(body)
    for seg, Corrupt in ((segment, segment.WalCorruption),
                         (jsegment, jsegment.WalCorruption)):
        with pytest.raises(Corrupt):
            seg.WalRecord.decode(b"\x01\x02\x03")


# --------------------------------------------------------------- the log

def _appends(seed=5):
    """A small mixed workload: a steady gauge scrape (one key table
    reused, so ref records after the first in a segment), counters with
    per-row timestamps, histograms with bucket bounds, over two shards."""
    rng = np.random.default_rng(seed)
    out = []
    k = 6
    for b in range(8):
        row = START + (b * k + np.arange(k, dtype=np.int64)) * 10_000
        out.append((b % 2, "gauge", ("m", 12),
                    np.broadcast_to(row, (12, k)),
                    {"value": rng.normal(50, 10, size=(12, k))}, None))
        if b % 2 == 0:
            jitter = rng.integers(0, 3, size=(5, 1)) * 1000
            base = 100.0 * b + np.arange(5, dtype=np.float64)[:, None]
            out.append((0, "prom-counter", ("request_total", 5),
                        row[None, :] + jitter,
                        {"count": base + np.cumsum(
                            rng.integers(0, 9, size=(5, k)), axis=1)},
                        None))
        if b % 4 == 1:
            h = np.cumsum(rng.integers(0, 3, size=(3, k, len(LES))),
                          axis=2).astype(np.float64) + 50 * b
            out.append((1, "prom-histogram", ("lat", 3),
                        np.broadcast_to(row, (3, k)),
                        {"sum": h.sum(axis=2), "count": h[..., -1],
                         "h": h}, LES))
    return out


def _write(pkg, root, appends, segment_max_bytes=2000, ingest_into=None):
    """Append each slab.  With `ingest_into` (a memstore) in the door's
    sequence: append without waiting, ingest the slab at its seq, and
    commit once for the last seq; otherwise each append waits for its
    commit, so segments rotate at the same records in every run."""
    P = PKGS[pkg]
    mgr = P["mgr"](str(root), DS,
                   P["cfg"](segment_max_bytes=segment_max_bytes))
    tables = {}
    seq = -1
    for shard, schema, (metric, n), ts, cols, les in appends:
        keys = tables.setdefault((metric, n), _keys(pkg, n, metric))
        seq = mgr.append_grid(shard, schema, keys, ts, cols, les,
                              wait=ingest_into is None)
        if ingest_into is not None:
            sh = ingest_into.get_shard(DS, shard) or ingest_into.setup(DS,
                                                                       shard)
            sh.ingest_columns(schema, keys, ts, cols, offset=seq,
                              bucket_les=les)
    mgr.commit(seq)
    return mgr


def _segment_files(root):
    d = os.path.join(str(root), DS)
    return {name: open(os.path.join(d, name), "rb").read()
            for name in sorted(os.listdir(d))}


def test_segments_are_the_reference_bytes(tmp_path):
    appends = _appends()
    for pkg in PKGS:
        _write(pkg, tmp_path / pkg, appends).close()
    ours, ref = _segment_files(tmp_path / "port"), \
        _segment_files(tmp_path / "jax")
    assert len(ref) > 2                   # several segments rotated
    assert list(ours) == list(ref)
    for name in ref:
        assert ours[name] == ref[name], name


def _stats(st):
    return (st.records, st.samples, st.skipped_records, st.corrupt_segments,
            st.last_seq, dict(st.shards))


def _shards_of(ms):
    return sorted(sh.shard_num for sh in ms.shards_for(DS))


def assert_same_stores(jm, pm):
    assert _shards_of(jm) == _shards_of(pm)
    for s in _shards_of(jm):
        js, ps = jm.get_shard(DS, s), pm.get_shard(DS, s)
        assert set(js.stores) == set(ps.stores)
        for name, a in js.stores.items():
            b = ps.stores[name]
            n, t = a.num_series, max(a.time_used, 1)
            assert (b.num_series, b.time_used) == (n, a.time_used)
            np.testing.assert_array_equal(b.counts[:n], a.counts[:n])
            np.testing.assert_array_equal(b.ts[:n, :t], a.ts[:n, :t])
            for col, arr in a.cols.items():
                assert b.cols[col][:n, :t].tobytes() == \
                    arr[:n, :t].tobytes(), (s, name, col)
        assert [p.part_key.to_bytes() for p in ps.partitions] == \
            [p.part_key.to_bytes() for p in js.partitions]
        assert ps.ingested_offset == js.ingested_offset
        assert ps.stats.rows_ingested == js.stats.rows_ingested


QUERIES = ["sum by (_ns_) (m)", "max by (i) (avg_over_time(m[2m]))",
           "sum(rate(request_total[5m]))",
           "histogram_quantile(0.9, sum(rate(lat[5m])))"]


def _mappers(shards):
    jmap, pmap = JShardMapper(shards), ShardMapper(shards)
    for s in range(shards):
        jmap.update_from_event(JShardEvent("IngestionStarted", DS, s, "l"))
        pmap.update_from_event(ShardEvent("IngestionStarted", DS, s, "l"))
    return jmap, pmap


def assert_same_answers(jm, pm, end_s=START_S + 470):
    jmap, pmap = _mappers(2)
    je = JEngine(DS, jm, jmap)
    pe = QueryEngine(DS, pm, pmap, device="cpu")
    n = 0
    for q in QUERIES:
        want = je.query_range(q, START_S + 300, 30, end_s)
        got = pe.query_range(q, START_S + 300, 30, end_s)
        assert want.error is None and got.error is None, (q, want.error,
                                                          got.error)
        w = sorted((k.labels, np.asarray(v)) for k, _, v in want.series())
        g = sorted((k.labels, np.asarray(v)) for k, _, v in got.series())
        assert [k for k, _ in g] == [k for k, _ in w], q
        for (k, wv), (_, gv) in zip(w, g):
            np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=ATOL,
                                       equal_nan=True, err_msg=f"{q} {k}")
        n += len(w)
    assert n > 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_log_replays_in_both_packages(tmp_path, writer):
    """A log either package wrote replays into both memstores with equal
    stats and stores, and both equal the store that wrote the log."""
    appends = _appends()
    live = PKGS[writer]["ms"]()
    _write(writer, tmp_path, appends, ingest_into=live).close()
    d = str(tmp_path / DS)
    jm, pm = JMemStore(), TimeSeriesMemStore(device="cpu")
    jst = jreplay_dir(d, jm, DS)
    pst = replay_dir(d, pm, DS)
    assert _stats(pst) == _stats(jst)
    assert pst.records == len(appends) and pst.corrupt_segments == 0
    assert pst.samples == sum(a[3].size for a in appends)
    assert_same_stores(jm, pm)
    assert_same_stores(*((live, pm) if writer == "jax" else (jm, live)))
    assert_same_answers(jm, pm)


def _replay_both(d, restart_points=None):
    jm, pm = JMemStore(), TimeSeriesMemStore(device="cpu")
    jst = jreplay_dir(d, jm, DS, restart_points)
    pst = replay_dir(d, pm, DS, restart_points)
    assert _stats(pst) == _stats(jst)
    return jm, pm, pst


def test_torn_tail_ends_replay_cleanly(tmp_path):
    appends = _appends()
    _write("port", tmp_path, appends).close()
    d = str(tmp_path / DS)
    last = segment.list_segments(d)[-1][1]
    with open(last, "r+b") as f:
        f.truncate(os.path.getsize(last) - 7)         # mid-frame
    jm, pm, st = _replay_both(d)
    assert st.corrupt_segments == 0
    assert st.records == len(appends) - 1             # never acknowledged
    assert_same_stores(jm, pm)


def test_flipped_byte_mid_log_counts_one_corrupt_segment(tmp_path):
    appends = _appends()
    _write("port", tmp_path, appends).close()
    d = str(tmp_path / DS)
    segs = segment.list_segments(d)
    assert len(segs) > 2
    with open(segs[0][1], "r+b") as f:
        f.seek(20)                                    # inside frame one
        b = f.read(1)
        f.seek(20)
        f.write(bytes([b[0] ^ 0xFF]))
    jm, pm, st = _replay_both(d)
    assert st.corrupt_segments == 1
    # the damaged segment's records are lost; the later segments replay
    assert 0 < st.records < len(appends)
    assert st.last_seq == len(appends) - 1
    assert_same_stores(jm, pm)


def test_restart_points_skip_records(tmp_path):
    appends = _appends()
    _write("port", tmp_path, appends).close()
    d = str(tmp_path / DS)
    rp = {0: 6, 1: 3}
    jm, pm, st = _replay_both(d, rp)
    want_skipped = sum(1 for i, a in enumerate(appends) if i <= rp[a[0]])
    assert st.skipped_records == want_skipped > 0
    assert st.records == len(appends) - want_skipped
    assert_same_stores(jm, pm)


def test_manager_replay_reasserts_restart_points_and_prunes(tmp_path):
    appends = _appends()
    outs = {}
    for pkg in PKGS:
        P = PKGS[pkg]
        _write(pkg, tmp_path / pkg, appends).close()
        mgr = P["mgr"](str(tmp_path / pkg), DS,
                       P["cfg"](segment_max_bytes=2000))
        try:
            ms = P["ms"]()
            for s in range(3):
                ms.setup(DS, s)
            st = mgr.replay(ms, restart_points={0: 8, 1: 5, 2: -1})
            outs[pkg] = (_stats(st), mgr.writer.next_seq,
                         sorted(os.path.basename(p) for _, p in
                                P["seg"].list_segments(mgr.dir)),
                         [ms.get_shard(DS, s).ingested_offset
                          for s in range(3)])
        finally:
            mgr.close()
    assert outs["port"] == outs["jax"]
    # the restart point stands as the offset of a shard that replayed
    # nothing past it
    assert outs["port"][3][2] == -1 and outs["port"][3][0] >= 8


def test_note_persisted_prunes_the_same_segments(tmp_path):
    appends = _appends()
    seen = {}
    for pkg in PKGS:
        mgr = _write(pkg, tmp_path / pkg, appends, segment_max_bytes=1000)
        steps = []
        try:
            for shard, horizon in ((0, 4), (1, 2), (1, 7), (0, 9),
                                   (0, mgr.writer.committed_seq),
                                   (1, mgr.writer.committed_seq)):
                mgr.note_persisted(shard, horizon)
                steps.append(sorted(os.listdir(mgr.dir)))
        finally:
            mgr.close()
        seen[pkg] = steps
    assert seen["port"] == seen["jax"]
    assert len(seen["port"][0]) > len(seen["port"][-1]) == 1


def test_next_seq_after_recover_writer_state(tmp_path):
    appends = _appends()
    _write("port", tmp_path, appends).close()
    d = str(tmp_path / DS)
    ours, ref = recover_writer_state(d), jrecover(d)
    assert ours[0] == ref[0] == len(appends)
    assert ours[1] == ref[1]
    mgr = WalManager(str(tmp_path), DS, WalConfig(segment_max_bytes=2000))
    try:
        k = appends[0]
        seq = mgr.append_grid(0, k[1], _keys("port", k[2][1], k[2][0]),
                              k[3], k[4])
        assert seq == len(appends)
        # the pre-restart segments are prunable once persisted
        assert [s[:2] for s in mgr.writer._sealed] == \
            [s[:2] for s in ref[1]]
    finally:
        mgr.close()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_fsync_fault_fails_the_commit_and_withholds_the_ack(tmp_path, pkg):
    P = PKGS[pkg]
    fr, Err = (faults, WalWriteError) if pkg == "port" \
        else (jfaults, JWalWriteError)
    mgr = P["mgr"](str(tmp_path), DS, P["cfg"]())
    try:
        shard, schema, (metric, n), ts, cols, les = _appends()[0]
        keys = _keys(pkg, n, metric)
        with fr.plan("wal.fsync", "error", first_k=1):
            with pytest.raises(Err):
                mgr.append_grid(shard, schema, keys, ts, cols)
            assert mgr.writer.committed_seq < 0       # no ack
        # the writer recovers: the next append commits and acks, while
        # the failed seq's ack stays withheld
        seq = mgr.append_grid(shard, schema, keys, ts, cols)
        assert seq == 1 and mgr.writer.committed_seq >= 1
        with pytest.raises(Err):
            mgr.commit(0)
    finally:
        mgr.close()
