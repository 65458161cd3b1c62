"""The port's Prometheus remote-write door (filodb_tpu_torch.http.remotepb,
gateway/remotewrite.py, POST /api/v1/write) against the JAX package's,
mirroring tests/test_remote_write.py: the JAX node is its FiloServer, the
port's a PromHttpApi over a hand-built GatewayPipeline
(tests/torch_doors.py).  The same requests go to both; statuses, payloads,
usage rows and store contents must be equal, PromQL answers within rtol
2e-4 / atol 1e-3.
"""
import struct
import time

import numpy as np
import pytest

from filodb_tpu.http import remotepb as jpb
from filodb_tpu.utils import snappy as jsnappy
from filodb_tpu_torch.http import remotepb
from filodb_tpu_torch.utils import snappy

from test_torch_ingest import _clear_compile_journal  # noqa: F401
from torch_doors import (DS, Node, assert_same_stores, split_headers,
                         store_dump, usage_of)

START = 1_600_000_000_000
RTOL, ATOL = 2e-4, 1e-3
PKGS = ("jax", "port")


@pytest.fixture(autouse=True)
def _fresh_usage():
    wins = {}
    for pkg in PKGS:
        usage_of(pkg).clear()
        wins[pkg] = usage_of(pkg).window_s
    yield
    for pkg in PKGS:
        usage_of(pkg).window_s = wins[pkg]
        usage_of(pkg).clear()


def _series(pb, n=8, k=4, ws="demo", ns="app", metric="http_req_total"):
    out = []
    for i in range(n):
        labels = [("__name__", metric), ("_ws_", ws), ("_ns_", ns),
                  ("inst", str(i))]
        samples = [(float(i * 100 + j), START + j * 10_000)
                   for j in range(k)]
        out.append(pb.PromTimeSeries(labels, samples))
    return out


def _payload(series):
    return snappy.compress(remotepb.encode_write_request(series))


@pytest.fixture()
def nodes(request, tmp_path):
    made = []

    def make(**kw):
        pair = {}
        for pkg in PKGS:
            if kw.get("wal"):
                pair[pkg] = Node(pkg, shards=kw.get("shards", 2),
                                 wal_dir=tmp_path / f"wal-{pkg}",
                                 settings=kw.get("settings"))
            else:
                pair[pkg] = Node(pkg, shards=kw.get("shards", 2),
                                 settings=kw.get("settings"))
            made.append(pair[pkg])
        return pair
    yield make
    for n in made:
        n.close()


def _both(pair, fn):
    """fn(node) on each package's node -> {pkg: result}."""
    return {pkg: fn(node) for pkg, node in pair.items()}


def _matrix(payload):
    return {tuple(sorted(r["metric"].items())):
            np.array([float(v) for _, v in r["values"]])
            for r in payload["data"]["result"]}


def _assert_same_matrix(a, b):
    ma, mb = _matrix(a), _matrix(b)
    assert sorted(ma) == sorted(mb) and ma
    for k in ma:
        np.testing.assert_allclose(mb[k], ma[k], rtol=RTOL, atol=ATOL)


def _usage_rows(pkg):
    return {(r["ws"], r["ns"]): {k: r[k] for k in (
        "ingestSamples", "ingestRejected", "windowSamplesOffered")}
        for r in usage_of(pkg).snapshot()}


# ---------------------------------------------------------------- codec

def test_codec_table_is_the_implementation():
    assert remotepb.CODECS["Label"] == (remotepb.encode_label,
                                        remotepb.decode_label)
    assert remotepb.CODECS["Sample"] == (remotepb.encode_sample,
                                         remotepb.decode_sample)
    assert remotepb.CODECS["TimeSeries"] == (remotepb.encode_timeseries,
                                             remotepb.decode_timeseries)


def test_codec_table_parity_hand_built_fixtures():
    label_wire = b"\x0a\x03job\x12\x03api"
    sample_wire = b"\x09" + struct.pack("<d", 1.5) \
        + b"\x10" + b"\x80\x80\xba\xbb\xc8\x2e"
    ts_wire = (b"\x0a" + bytes([len(label_wire)]) + label_wire
               + b"\x12" + bytes([len(sample_wire)]) + sample_wire)
    wr_wire = b"\x0a" + bytes([len(ts_wire)]) + ts_wire
    for pb in (remotepb, jpb):
        assert pb.decode_label(label_wire) == ("job", "api")
        assert pb.encode_label(("job", "api")) == label_wire
        assert pb.decode_sample(sample_wire) == (1.5, START)
        assert pb.encode_sample((1.5, START)) == sample_wire
        ts = pb.decode_timeseries(ts_wire)
        assert (ts.labels, ts.samples) == ([("job", "api")], [(1.5, START)])
        assert pb.encode_timeseries(ts) == ts_wire
        assert pb.encode_write_request([ts]) == wr_wire
        assert pb.decode_write_request(wr_wire) == [ts]


def _random_series(pb, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        labels = [("__name__", f"m{i % 3}"), ("_ws_", "demo"),
                  ("_ns_", f"App-{i % 4}"), ("inst", f"i-{i}"),
                  ("path", "/a,b=c dé")]
        k = int(rng.integers(1, 6))
        vals = rng.normal(size=k) * 10.0 ** rng.integers(-3, 9)
        vals[0] = [np.nan, np.inf, -0.0, 1.0][i % 4]
        ts = START + np.sort(rng.integers(-10**6, 10**6, size=k))
        if i == 5:
            ts = -ts                       # negative int64 timestamps
        out.append(pb.PromTimeSeries(
            labels, [(float(v), int(t)) for v, t in zip(vals, ts)]))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_write_request_bytes_equal_both_directions(seed):
    ours = remotepb.encode_write_request(_random_series(remotepb, seed))
    ref = jpb.encode_write_request(_random_series(jpb, seed))
    assert ours == ref
    assert snappy.compress(ours) == jsnappy.compress(ref)
    for pb, blob in ((remotepb, ref), (jpb, ours)):
        got = pb.decode_write_request(blob)
        want = _random_series(pb, seed)
        assert [s.labels for s in got] == [s.labels for s in want]
        for g, w in zip(got, want):
            assert np.array(g.samples).tobytes() == \
                np.array(w.samples).tobytes()


def test_write_request_roundtrip_and_unknown_fields():
    series = _series(remotepb, 3, 2)
    wire = remotepb.encode_write_request(series)
    assert remotepb.decode_write_request(wire) == series
    wire2 = wire + b"\x1a\x04\x08\x01\x12\x00"
    assert remotepb.decode_write_request(wire2) == series
    assert [s.labels for s in jpb.decode_write_request(wire2)] == \
        [s.labels for s in series]
    s = remotepb.PromTimeSeries([("__name__", "m")], [(-2.5, -1000)])
    assert remotepb.decode_write_request(
        remotepb.encode_write_request([s])) == [s]


# ----------------------------------------------------------- conformance

def test_write_ingest_promql_and_remote_read_roundtrip(nodes):
    pair = nodes()
    body = _payload(_series(remotepb))
    st = _both(pair, lambda n: split_headers(
        *n.post("/api/v1/write", body))[:2])
    assert st["port"] == st["jax"] == (204, {})
    q = {"query": "http_req_total", "start": str(START // 1000),
         "end": str(START // 1000 + 30), "step": "10"}
    res = _both(pair, lambda n: n.get("/api/v1/query_range", q))
    assert res["port"][0] == res["jax"][0] == 200
    _assert_same_matrix(res["jax"][1], res["port"][1])
    by_inst = {dict(k)["inst"]: v for k, v in _matrix(res["port"][1]).items()}
    assert by_inst["3"].tolist() == [300.0, 301.0, 302.0, 303.0]
    rq = snappy.compress(remotepb.encode_read_request([remotepb.PromQuery(
        START, START + 30_000,
        [remotepb.LabelMatcher(remotepb.EQ, "__name__",
                               "http_req_total")])]))
    blobs = _both(pair, lambda n: n.post("/api/v1/read", rq))
    assert blobs["port"][0] == blobs["jax"][0] == 200
    assert blobs["port"][1] == blobs["jax"][1]
    got = remotepb.decode_read_response(snappy.decompress(blobs["port"][1]))
    assert len(got[0]) == 8 and sum(len(s.samples) for s in got[0]) == 32
    assert_same_stores(pair["jax"].memstore, pair["port"].memstore)
    assert _usage_rows("port") == _usage_rows("jax")


def test_write_ragged_sample_counts_slab_grouping(nodes):
    pair = nodes()
    body = _payload(_series(remotepb, 4, 2)
                    + _series(remotepb, 3, 5, metric="other_total"))
    st = _both(pair, lambda n: n.post("/api/v1/write", body)[0])
    assert st == {"jax": 204, "port": 204}
    got = _both(pair, lambda n: sum(
        sh.stats.rows_ingested for sh in n.memstore.shards_for(DS)))
    assert got["port"] == got["jax"] == 4 * 2 + 3 * 5
    assert_same_stores(pair["jax"].memstore, pair["port"].memstore)


@pytest.mark.parametrize("body", [
    b"\xff\xfe garbage",                     # not snappy at all
    snappy.compress(b"\x0a\xff\x01ab"),      # truncated protobuf
    snappy.compress(b""),                    # empty write: a no-op 204
], ids=["not_snappy", "truncated_protobuf", "empty"])
def test_write_malformed_payloads_400_with_trace_headers(nodes, body):
    pair = nodes(shards=1)
    raw = _both(pair, lambda n: n.post("/api/v1/write", body))
    for pkg in PKGS:
        status, payload = raw[pkg]
        assert "X-Trace-Id" in payload["_headers"]
        assert "traceparent" in payload["_headers"]
    out = {pkg: split_headers(*raw[pkg])[:2] for pkg in PKGS}
    assert out["port"] == out["jax"]
    assert out["port"][0] == (204 if body == snappy.compress(b"") else 400)


# ---------------------------------------------------------- backpressure

def test_over_limit_tenant_429_retry_after(nodes):
    pair = nodes(settings={"query.tenant_ingest_samples_limit": 40,
                           "query.tenant_limit_window_s": 0.3})
    for pkg in PKGS:
        usage_of(pkg).window_s = 0.3
    pay = _payload(_series(remotepb, 8, 4))
    other = _payload(_series(remotepb, 2, 2, ws="other", ns="ns2",
                             metric="other_m"))
    seen = {}
    for pkg, node in pair.items():
        out = [split_headers(*node.post("/api/v1/write", pay))
               for _ in range(3)]
        out.append(split_headers(*node.post("/api/v1/write", other)))
        time.sleep(0.35)
        out.append(split_headers(*node.post("/api/v1/write", pay)))
        assert int(out[2][2]["Retry-After"]) >= 1
        seen[pkg] = [(s, p) for s, p, _ in out]
    assert [s for s, _ in seen["jax"]] == [204, 204, 429, 204, 204]
    assert seen["port"] == seen["jax"]
    assert seen["port"][2][1]["errorType"] == "too_many_requests"
    assert_same_stores(pair["jax"].memstore, pair["port"].memstore)


def test_mixed_tenant_write_no_bypass(nodes):
    pair = nodes(settings={"query.tenant_ingest_samples_limit": 10})
    abusive = _payload(_series(remotepb, 8, 4, ws="abuser"))
    mixed = _payload(_series(remotepb, 2, 2, ws="polite",
                             metric="polite_total")
                     + _series(remotepb, 8, 4, ws="abuser"))
    out = {}
    for pkg, node in pair.items():
        node.post("/api/v1/write", abusive)
        out[pkg] = split_headers(*node.post("/api/v1/write", mixed))
    assert out["port"][:2] == out["jax"][:2]
    assert out["port"][0] == 429
    assert int(out["port"][2]["Retry-After"]) >= 1
    rows = _usage_rows("port")
    assert rows == _usage_rows("jax")
    assert rows[("polite", "app")]["ingestSamples"] == 4
    assert rows[("abuser", "app")]["ingestSamples"] == 32
    assert rows[("abuser", "app")]["ingestRejected"] >= 1
    assert_same_stores(pair["jax"].memstore, pair["port"].memstore)


def test_tenant_from_scope_orgid_header(nodes):
    pair = nodes(settings={"query.tenant_ingest_samples_limit": 10})
    pay = _payload(_series(remotepb, 8, 4, ws="", ns=""))
    hdr = {"X-Scope-OrgID": "hdrws/hdrns"}
    out = {}
    for pkg, node in pair.items():
        node.post("/api/v1/write", pay, headers=hdr)
        second = split_headers(*node.post("/api/v1/write", pay,
                                          headers=hdr))[:2]
        fresh = split_headers(*node.post(
            "/api/v1/write", pay, headers={"X-Scope-OrgID": "fresh"}))[:2]
        out[pkg] = (second, fresh)
    assert out["port"] == out["jax"]
    assert out["port"][0][0] == 429 and out["port"][1][0] == 204
    rows = _usage_rows("port")
    assert rows == _usage_rows("jax")
    assert rows[("hdrws", "hdrns")]["ingestRejected"] >= 1


# -------------------------------------------------------- WAL-backed ack

def test_write_with_wal_survives_restart(nodes, tmp_path):
    pair = nodes(wal=True)
    body = _payload(_series(remotepb))
    for node in pair.values():
        assert node.post("/api/v1/write", body)[0] == 204
        assert node.wal.writer.committed_seq >= 0
    before = store_dump(pair["port"].memstore)
    for node in pair.values():
        node.close()
    pair = nodes(wal=True)
    q = {"query": "http_req_total", "start": str(START // 1000),
         "end": str(START // 1000 + 30), "step": "10"}
    res = _both(pair, lambda n: n.get("/api/v1/query_range", q))
    assert res["port"][0] == res["jax"][0] == 200
    assert len(res["port"][1]["data"]["result"]) == 8
    _assert_same_matrix(res["jax"][1], res["port"][1])
    assert_same_stores(pair["jax"].memstore, pair["port"].memstore)
    after = store_dump(pair["port"].memstore)
    assert sorted(after) == sorted(before)


def test_wal_commit_failure_withholds_ack(nodes):
    from filodb_tpu.utils.faults import faults as jfaults
    from filodb_tpu_torch.utils.faults import faults
    pair = nodes(wal=True)
    body = _payload(_series(remotepb, 4, 2))
    out = {}
    for pkg, node in pair.items():
        fl = jfaults if pkg == "jax" else faults
        with fl.plan("wal.fsync", "error", first_k=1):
            failed = split_headers(*node.post("/api/v1/write", body))[:2]
        retried = node.post("/api/v1/write", body)[0]
        out[pkg] = (failed[0], failed[1]["errorType"], retried)
    assert out["port"] == out["jax"] == (503, "unavailable", 204)


def _attach_replica(node):
    """A replica door of the node's own package holding a copy of every
    shard, wired as the node's replicator (RF 2, quorum acks)."""
    if node.pkg == "jax":
        from filodb_tpu import replication as r
        from filodb_tpu.core.memstore import TimeSeriesMemStore as Ms
        from filodb_tpu.parallel.shardmapper import ShardStatus
        kw = {}
    else:
        from filodb_tpu_torch import replication as r
        from filodb_tpu_torch.core.memstore import TimeSeriesMemStore as Ms
        from filodb_tpu_torch.parallel.shardmapper import ShardStatus
        kw = {"device": "cpu"}
    replica = Ms(**kw)
    door = r.ReplicationServer(replica, node="B").start()
    cli = r.ReplicaClient(*door.address)
    mapper = node.srv.mappers[DS]
    mapper.replication_factor = 2
    for s in range(node.shards):
        mapper.register_replica(s, "B", status=ShardStatus.ACTIVE)
    manager = r.ReplicationManager(DS, mapper, lambda n: cli,
                                   local_node=mapper.node_for_shard(0))
    node.api.replicators[DS] = manager
    return replica, door, manager


def test_replicator_is_not_ported(nodes):
    """A sink built with a replicator fans every slab out to the shard's
    other owner, as the reference's does: the request acks 204 after
    the replica's append, the replica holds what the node holds, and
    the replicas of both packages hold the same."""
    pair = nodes(shards=2)
    body = _payload(_series(remotepb, 8, 4))
    replicas, doors = {}, []
    try:
        for pkg, node in pair.items():
            replica, door, manager = _attach_replica(node)
            doors.append((door, manager))
            replicas[pkg] = replica
            assert split_headers(*node.post("/api/v1/write", body))[0] \
                == 204
            assert_same_stores(node.memstore, replica)
            snap = manager.snapshot()
            assert [(r["peer"], r["acked"] > 0, r["lagging"])
                    for r in snap] == [("B", True, False)]
        assert_same_stores(replicas["port"], replicas["jax"])
    finally:
        for door, manager in doors:
            manager.stop()
            door.stop()


def test_replicated_sink_fills_replication_seconds(nodes):
    """The fan-out's share of the ingest loop lands in
    IngestStats.replication_s, in both packages."""
    pair = nodes(shards=2)
    doors = []
    try:
        for pkg, node in pair.items():
            if pkg == "jax":
                from filodb_tpu.http import remotepb as pb
                from filodb_tpu.utils.freshness import IngestStats
            else:
                pb = remotepb
                from filodb_tpu_torch.utils.freshness import IngestStats
            replica, door, manager = _attach_replica(node)
            doors.append((door, manager))
            stats = IngestStats()
            sink = node.api._remote_write_sink(DS)
            assert sink.replicator is manager
            n, dropped = sink.ingest_series(_series(pb, 8, 4),
                                            stats=stats)
            assert (n, dropped) == (32, 0)
            assert stats.replication_s > 0.0
            assert stats.ingest_s >= 0.0
    finally:
        for door, manager in doors:
            manager.stop()
            door.stop()


def test_existing_counter_series_lands_in_its_own_schema(nodes):
    """A series that exists as a prom-counter gains the written samples
    in the counter store, where rate() reads them (the reference writes
    them into the gauge store at the counter store's row)."""
    from filodb_tpu_torch.core.partkey import PartKey
    pair = nodes(shards=1)
    port = pair["port"]
    sh = port.memstore.get_shard(DS, 0)
    keys = [PartKey.make("request_total", {"_ws_": "demo", "_ns_": "app",
                                           "inst": str(i)})
            for i in range(3)]
    ts = START + np.arange(30, dtype=np.int64)[None, :] * 10_000
    vals = np.cumsum(np.ones((3, 30)), axis=1)
    sh.ingest_columns("prom-counter", keys, np.repeat(ts, 3, 0),
                      {"count": vals})
    series = [remotepb.PromTimeSeries(
        [("__name__", "request_total"), ("_ws_", "demo"), ("_ns_", "app"),
         ("inst", str(i))], [(31.0, START + 300_000)]) for i in range(3)]
    assert port.post("/api/v1/write", _payload(series))[0] == 204
    assert list(sh.stores) == ["prom-counter"]
    assert sh.stats.schema_dropped == 0
    row = sh.partitions[0].row
    assert sh.stores["prom-counter"].counts[row] == 31
    assert sh.stores["prom-counter"].cols["count"][row, 30] == 31.0


# ---------------------------------------------------- Influx-door parity

def _influx_lines(ws, ns, n, t_ms):
    return [f"req,_ws_={ws},_ns_={ns},inst={i} counter=1 {t_ms * 1_000_000}"
            for i in range(n)]


def test_influx_gateway_admission_parity(nodes):
    pair = nodes(settings={"query.tenant_ingest_samples_limit": 10})
    for pkg in PKGS:
        usage_of(pkg).window_s = 60.0
    body = "\n".join(_influx_lines("demo", "app", 8, START)).encode()
    out = {}
    for pkg, node in pair.items():
        res = [split_headers(*node.post("/influx/write", body))
               for _ in range(3)]
        assert int(res[2][2]["Retry-After"]) >= 1
        out[pkg] = ([r[:2] for r in res], dict(node.gateway.drops))
    assert out["port"] == out["jax"]
    assert [s for s, _ in out["port"][0]] == [204, 204, 429]
    assert out["port"][1].get("tenant_limit_exceeded", 0) >= 8
    from filodb_tpu_torch.utils.metrics import registry
    assert registry.counter("tenant_ingest_rejections", ws="demo",
                            ns="app").value >= 1
    assert _usage_rows("port") == _usage_rows("jax")
    assert_same_stores(pair["jax"].memstore, pair["port"].memstore)


def test_container_sink_admission_parity():
    from filodb_tpu.config import FilodbSettings as JSettings
    from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as JSCHEMAS
    from filodb_tpu.gateway.server import KafkaContainerSink as JSink
    from filodb_tpu.parallel.shardmapper import ShardMapper as JMapper
    from filodb_tpu_torch.config import FilodbSettings
    from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
    from filodb_tpu_torch.gateway.server import KafkaContainerSink
    from filodb_tpu_torch.parallel.shardmapper import ShardMapper
    lines = _influx_lines("demo", "app", 8, START)
    out = {}
    for pkg, (Sink, Mapper, Cfg, schemas) in {
            "jax": (JSink, JMapper, JSettings, JSCHEMAS),
            "port": (KafkaContainerSink, ShardMapper, FilodbSettings,
                     DEFAULT_SCHEMAS)}.items():
        cfg = Cfg()
        cfg.query.tenant_ingest_samples_limit = 10
        frames = []

        def produce(topic, partition, value, frames=frames):
            frames.append((topic, partition, value))
            return len(frames)

        sink = Sink(produce, "ts", Mapper(2), schemas=schemas, config=cfg)
        counts = [sink.publish_lines(lines) for _ in range(3)]
        out[pkg] = (counts, dict(sink.drops), frames)
    assert out["port"][:2] == out["jax"][:2]
    assert out["port"][0] == [8, 8, 0]
    assert out["port"][1].get("tenant_limit_exceeded") == 8
    # the frames on the broker are byte for byte the reference's
    assert out["port"][2] == out["jax"][2] and out["port"][2]


def test_mixed_tenant_batch_keeps_admitted_records(nodes):
    pair = nodes(settings={"query.tenant_ingest_samples_limit": 4})
    abusive = _influx_lines("abuser", "x", 6, START)
    mixed = abusive + _influx_lines("polite", "y", 3, START + 10_000)
    out = {}
    for pkg, node in pair.items():
        node.post("/influx/write", "\n".join(abusive).encode())
        out[pkg] = split_headers(*node.post(
            "/influx/write", "\n".join(mixed).encode()))[:2]
    assert out["port"] == out["jax"] == (204, {})
    rows = _usage_rows("port")
    assert rows == _usage_rows("jax")
    assert rows[("polite", "y")]["ingestSamples"] == 3
    assert rows[("abuser", "x")]["ingestSamples"] == 6
    assert_same_stores(pair["jax"].memstore, pair["port"].memstore)


def test_a_key_of_another_schema_is_dropped_not_written_into_its_row(
        nodes):
    """A series created as a gauge by remote write, then sent through
    /influx/write as a counter (the prom-counter schema): the port's
    shard drops the counter sample and counts it in stats.schema_dropped;
    the gauge's row and the counter store are untouched."""
    pair = nodes(shards=1)
    port = pair["port"]
    series = [remotepb.PromTimeSeries(
        [("__name__", "req"), ("_ws_", "demo"), ("_ns_", "app"),
         ("inst", str(i))], [(float(i), START)]) for i in range(3)]
    assert port.post("/api/v1/write", _payload(series))[0] == 204
    sh = port.memstore.get_shard(DS, 0)
    before = store_dump(port.memstore)
    lines = "\n".join(_influx_lines("demo", "app", 3, START + 10_000))
    st, _ = port.post("/influx/write", lines.encode())
    assert st == 204
    assert sh.stats.schema_dropped == 3
    after = store_dump(port.memstore)
    assert sorted(after) == sorted(before)
    for k, (ts, cols) in before.items():
        assert after[k][0].tobytes() == ts.tobytes()
        assert after[k][1]["value"].tobytes() == cols["value"].tobytes()
    assert sorted(sh.stores) == ["gauge", "prom-counter"]
    assert int(sh.stores["prom-counter"].counts.sum()) == 0
    assert [int(sh.stores["gauge"].counts[p.row]) for p in sh.partitions] \
        == [1, 1, 1]
