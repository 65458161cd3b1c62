"""The port's Influx gateway and broker stream (gateway/influx.py,
gateway/router.py, gateway/server.py, ingest/filebroker.py,
ingest/kafka.py, ingest/kafka_wire.py, ingest/generator.py) against the
JAX package's, mirroring the Influx cases of tests/test_ingest.py,
tests/test_gateway_server.py and tests/test_kafka_source.py:

- the parser and the line -> batch conversion give the reference's
  records and batches (their wire frames byte for byte), drop reasons
  included; the generators give the reference's arrays;
- a FileBackedBroker log written by one package's KafkaContainerSink is
  the other's to the byte, and each package's filebroker stream consumes
  the other's log into a memstore with the same contents;
- the port's gateway as an OS process (`python -m
  filodb_tpu_torch.gateway.server`), the broker, the port's node, crash
  and checkpointed recovery, with the reference's panel answers within
  rtol 2e-4 / atol 1e-3;
- Kafka record batches are byte-compatible, and the port's WireConsumer
  speaks to tests/kafka_broker.py (the reference's codec on the broker
  side).
"""
import logging
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import filodb_tpu.gateway.influx as jinflux
import filodb_tpu.ingest.generator as jgen
import filodb_tpu.ingest.kafka_wire as jwire
import filodb_tpu_torch.ingest.generator as gen
import filodb_tpu_torch.ingest.kafka_wire as wire
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.gateway.server import KafkaContainerSink as JSink
from filodb_tpu.ingest.filebroker import FileBackedBroker as JBroker
from filodb_tpu.ingest.stream import create_stream as jcreate_stream
from filodb_tpu.parallel.shardmapper import ShardMapper as JMapper
from filodb_tpu.parallel.shardmapper import SpreadProvider as JSpread
from filodb_tpu.query.engine import QueryEngine as JEngine
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.core.records import RecordBatch
from filodb_tpu_torch.core.store import InMemoryColumnStore, InMemoryMetaStore
from filodb_tpu_torch.gateway import (GatewayPipeline, influx_lines_to_batches,
                                      parse_influx_line, split_batch_by_shard)
from filodb_tpu_torch.gateway.server import (GatewayServer, KafkaContainerSink,
                                             send_lines)
from filodb_tpu_torch.ingest.filebroker import FileBackedBroker
from filodb_tpu_torch.ingest.kafka import KafkaIngestionStream
from filodb_tpu_torch.ingest.stream import create_stream
from filodb_tpu_torch.parallel.shardmapper import ShardMapper, SpreadProvider
from filodb_tpu_torch.query.engine import QueryEngine

from test_torch_ingest import _clear_compile_journal  # noqa: F401
from torch_doors import assert_same_stores

START = 1_600_000_000_000
NUM_SHARDS = 4
TOPIC = "timeseries"
RTOL, ATOL = 2e-4, 1e-3
RATE_Q = "sum by (_ns_)(rate(request_total[5m]))"

LINES = [
    "cpu_usage,host=h1,dc=us-east value=0.64 1620000000000000000",
    'disk\\ usage,path=/var\\,log used=123i,pct=0.5,label="a b",on=true '
    "1000000000",
    "", "# comment", "no_fields_here", ",empty=measurement v=1", "m v=1",
    "http_requests,app=a counter=100 1000000000",
    "cpu_load,app=a value=0.7 1000000000",
    "lat,app=a 0.5=10,2.5=25,+Inf=30,sum=55.5,count=30 2000000000",
    "lat 0.5=1,2.5=2,sum=3,count=3 1000000",
    'm,t=1 str="not-numeric" 1600000000000000000',
    'quoted,t=x f="a,b=c d" 1600000000000000000',
    "esc\\,m,t\\ a=b\\=c v=-1.5e3 1600000000123456789",
    "neg,t=1 v=-7i -1000000",
    "bad_ts,t=1 v=1 12ab",
    "multi,t=1 a=1,b=2,c=3 1600000000000000000",
]


def _rec(r):
    return None if r is None else (r.measurement, r.tags, r.fields, r.ts_ms)


@pytest.mark.parametrize("now_ms", [None, 77])
def test_parse_influx_line_is_the_reference(now_ms):
    for line in LINES:
        assert _rec(parse_influx_line(line, now_ms=now_ms)) == \
            _rec(jinflux.parse_influx_line(line, now_ms=now_ms)), line


def test_parse_influx_documented_cases():
    r = parse_influx_line(LINES[0])
    assert (r.measurement, r.tags, r.fields, r.ts_ms) == (
        "cpu_usage", {"host": "h1", "dc": "us-east"}, {"value": 0.64},
        1620000000000)
    r = parse_influx_line(LINES[1])
    assert r.measurement == "disk usage" and r.tags == {"path": "/var,log"}
    assert r.fields == {"used": 123.0, "pct": 0.5, "label": "a b",
                        "on": 1.0}
    assert parse_influx_line("m v=1").ts_ms == 0


def test_lines_to_batches_are_the_reference_frames():
    drops, jdrops = {}, {}
    ours = influx_lines_to_batches(LINES, now_ms=5, drops=drops)
    ref = jinflux.influx_lines_to_batches(LINES, now_ms=5, drops=jdrops)
    assert drops == jdrops and drops
    assert [b.to_bytes() for b in ours] == [b.to_bytes() for b in ref]
    by_schema = {b.schema.name for b in ours}
    assert by_schema == {"prom-counter", "gauge", "prom-histogram"}
    hist = next(b for b in ours if b.schema.name == "prom-histogram")
    np.testing.assert_array_equal(hist.bucket_les, [0.5, 2.5, np.inf])
    # each package decodes the other's frames
    for b in ref:
        assert RecordBatch.from_bytes(b.to_bytes()).to_bytes() == \
            b.to_bytes()


@pytest.mark.parametrize("name, args", [
    ("gauge_batch", (7, 13)), ("counter_batch", (9, 40)),
    ("histogram_batch", (5, 12)), ("region_gauge_batch", (12, 6))])
def test_generators_are_the_reference(name, args):
    ours, ref = getattr(gen, name)(*args), getattr(jgen, name)(*args)
    assert ours.to_bytes() == ref.to_bytes()
    chunks = list(gen.batch_stream(ours, 4))
    jchunks = list(jgen.batch_stream(ref, 4))
    assert [(b.to_bytes(), o) for b, o in chunks] == \
        [(b.to_bytes(), o) for b, o in jchunks]


def test_gateway_routing_and_ingest():
    out = {}
    for pkg, (MS, Mapper, Spread, Pipe, kw) in {
            "jax": (JMemStore, JMapper, JSpread,
                    __import__("filodb_tpu.gateway.router",
                               fromlist=["x"]).GatewayPipeline, {}),
            "port": (TimeSeriesMemStore, ShardMapper, SpreadProvider,
                     GatewayPipeline, {"device": "cpu"})}.items():
        ms = MS(**kw)
        mapper = Mapper(4)
        mapper.register_node([0, 1, 2, 3], "local")
        for s in range(4):
            ms.setup("prometheus", s)
        gw = Pipe(ms, "prometheus", mapper, Spread(1))
        lines = [f"metric_{i},_ws_=demo,_ns_=App-{i % 3},instance=i{i} "
                 f"value={i}.5 {1_000_000_000 * (i + 1)}" for i in range(20)]
        n = gw.ingest_lines(lines + ["bad line_"])
        out[pkg] = (n, [ms.get_shard("prometheus", s).stats.rows_ingested
                        for s in range(4)], dict(gw.drops),
                    gw.lines_dropped, ms)
    assert out["port"][:4] == out["jax"][:4]
    assert out["port"][0] == 20 and sum(out["port"][1]) == 20
    assert_same_stores(out["jax"][4], out["port"][4])
    batches = influx_lines_to_batches(
        [f"m,_ws_=demo,_ns_=App-{i % 3},instance=i{i} value=1 1000000000"
         for i in range(20)])
    routed = split_batch_by_shard(batches[0], ShardMapper(4),
                                  SpreadProvider(1))
    assert sum(b.num_records for b in routed.values()) == 20


# ------------------------------------------------------------- the broker

def _counter_lines(num_series=24, num_samples=120, start_ms=START):
    rng = np.random.default_rng(3)
    vals = np.cumsum(rng.integers(1, 20, size=(num_series, num_samples)),
                     axis=1)
    lines = []
    for s in range(num_series):
        tags = f"_ws_=demo,_ns_=App-{s % 4},instance=i{s}"
        for t in range(num_samples):
            ts_ns = (start_ms + t * 10_000) * 1_000_000
            lines.append(f"request_total,{tags} "
                         f"counter={float(vals[s, t])} {ts_ns}")
    return lines


def _log_bytes(root):
    return {name: open(os.path.join(root, name), "rb").read()
            for name in sorted(os.listdir(root))}


def _consume_into(ms, broker_dir, create, upto_offset=None):
    for shard_num in range(NUM_SHARDS):
        ms.setup("prometheus", shard_num)
        stream = create("filebroker", topic=TOPIC, shard=shard_num,
                        broker_dir=broker_dir)
        batches = stream.batches(-1)
        if upto_offset is not None:
            batches = ((b, o) for b, o in batches if o <= upto_offset)
        ms.ingest_stream("prometheus", shard_num, batches, flush_every=3)
        stream.teardown()
        ms.get_shard("prometheus", shard_num).flush_all_groups()


def _query(ms, pkg):
    if pkg == "jax":
        eng = JEngine("prometheus", ms, JMapper(NUM_SHARDS))
    else:
        eng = QueryEngine("prometheus", ms, ShardMapper(NUM_SHARDS),
                          device="cpu")
    res = eng.query_range(RATE_Q, START // 1000 + 600, 60,
                          START // 1000 + 1200)
    assert res.error is None, res.error
    return {tuple(sorted(k.labels_dict.items())): np.asarray(v, np.float64)
            for k, _, v in res.series()}


def _assert_close(got, want):
    assert set(got) == set(want) and want
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   equal_nan=True)


def test_broker_log_is_the_reference_in_both_directions(tmp_path):
    """The same lines through each package's KafkaContainerSink give
    byte-identical broker logs; each package's filebroker stream consumes
    the other's log into a memstore with the same contents."""
    lines = _counter_lines(12, 120)
    dirs = {}
    for pkg, (Sink, Broker, Mapper, Spread) in {
            "jax": (JSink, JBroker, JMapper, JSpread),
            "port": (KafkaContainerSink, FileBackedBroker, ShardMapper,
                     SpreadProvider)}.items():
        dirs[pkg] = str(tmp_path / pkg)
        broker = Broker(dirs[pkg])
        sink = Sink(broker.produce, TOPIC, Mapper(NUM_SHARDS), Spread(0))
        for i in range(0, len(lines), 200):
            sink.publish_lines(lines[i:i + 200])
    assert _log_bytes(dirs["port"]) == _log_bytes(dirs["jax"])
    assert FileBackedBroker(dirs["jax"]).end_offset(TOPIC, 0) == \
        JBroker(dirs["jax"]).end_offset(TOPIC, 0)
    # the port's stream reads the JAX gateway's log, the JAX stream the
    # port's
    port_ms = TimeSeriesMemStore(device="cpu")
    _consume_into(port_ms, dirs["jax"], create_stream)
    jax_ms = JMemStore()
    _consume_into(jax_ms, dirs["port"], jcreate_stream)
    assert_same_stores(jax_ms, port_ms)
    _assert_close(_query(port_ms, "port"), _query(jax_ms, "jax"))


def test_gateway_process_to_broker_to_node_query(tmp_path):
    """The port's gateway as an OS process, the TCP socket the boundary;
    the port's node consumes the broker, crashes, recovers from its
    checkpoints and answers as the reference fed the same lines."""
    broker_dir = str(tmp_path / "broker")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "filodb_tpu_torch.gateway.server",
         "--broker-dir", broker_dir, "--port", "0",
         "--num-shards", str(NUM_SHARDS), "--topic", TOPIC],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env)
    lines = _counter_lines()
    try:
        line = proc.stdout.readline()
        assert line.startswith("GATEWAY_READY"), line
        port = int(line.strip().split("port=")[1])
        send_lines("127.0.0.1", port, lines)
        broker = FileBackedBroker(broker_dir)

        def broker_records():
            return sum(RecordBatch.from_bytes(v).num_records
                       for p in range(NUM_SHARDS)
                       for v in broker.read_all(TOPIC, p))
        deadline = time.time() + 30
        while broker_records() < len(lines) and time.time() < deadline:
            time.sleep(0.1)
        assert broker_records() == len(lines)
        assert sum(1 for p in range(NUM_SHARDS)
                   if broker.end_offset(TOPIC, p)) >= 2
    finally:
        proc.terminate()
        proc.wait(timeout=10)

    cs, meta = InMemoryColumnStore(), InMemoryMetaStore()
    ms = TimeSeriesMemStore(column_store=cs, meta_store=meta, device="cpu")
    _consume_into(ms, broker_dir, create_stream)
    got = _query(ms, "port")

    from filodb_tpu.gateway.router import GatewayPipeline as JPipe
    truth = JMemStore()
    for s in range(NUM_SHARDS):
        truth.setup("prometheus", s)
    JPipe(truth, "prometheus", JMapper(NUM_SHARDS),
          JSpread(0)).ingest_lines(lines, offset=1)
    want = _query(truth, "jax")
    _assert_close(got, want)

    ms2 = TimeSeriesMemStore(column_store=cs, meta_store=meta, device="cpu")
    for shard_num in range(NUM_SHARDS):
        sh2 = ms2.setup("prometheus", shard_num)
        sh2.recover_index()
        checkpoints = meta.read_checkpoints("prometheus", shard_num)
        resume_from = min(checkpoints.values()) if checkpoints else -1
        if FileBackedBroker(broker_dir).end_offset(TOPIC, shard_num):
            assert resume_from >= 0
        stream = create_stream("filebroker", topic=TOPIC, shard=shard_num,
                               broker_dir=broker_dir)
        sh2.recover_stream((b, off) for b, off in stream.batches(resume_from))
        stream.teardown()
    _assert_close(_query(ms2, "port"), want)


def test_gateway_server_in_process_histograms(tmp_path):
    broker = FileBackedBroker(str(tmp_path))
    sink = KafkaContainerSink(broker.produce, TOPIC,
                              ShardMapper(NUM_SHARDS), SpreadProvider(0))
    server = GatewayServer(sink, port=0)
    server.start()
    lines = []
    for s in range(8):
        tags = f"_ws_=demo,_ns_=App-{s % 2},instance=h{s}"
        for t in range(30):
            ts_ns = (START + t * 10_000) * 1_000_000
            c = (t + 1) * (s + 1)
            lines.append(f"http_latency,{tags} "
                         f"0.5={c * 0.3},2={c * 0.7},+Inf={float(c)},"
                         f"sum={c * 1.3},count={float(c)} {ts_ns}")
    try:
        send_lines("127.0.0.1", server.port, lines)
        deadline = time.time() + 20
        while sink.stats()["records_out"] < len(lines) \
                and time.time() < deadline:
            time.sleep(0.05)
        stats = sink.stats()
        assert stats["records_out"] == len(lines), stats
        assert stats["drops"] == {}, stats
    finally:
        server.stop()
    frames = [v for p in range(NUM_SHARDS) for v in broker.read_all(TOPIC, p)]
    assert sum(RecordBatch.from_bytes(f).num_records for f in frames) == \
        len(lines)
    assert any(RecordBatch.from_bytes(f).schema.name == "prom-histogram"
               for f in frames)
    # the JAX package decodes the port's histogram frames to the same bytes
    from filodb_tpu.core.records import RecordBatch as JRecordBatch
    for f in frames:
        assert JRecordBatch.from_bytes(f).to_bytes() == f


def test_sink_drop_reasons_accounted_and_logged(tmp_path, caplog):
    lines = ["garbage with no fields section_",
             'm,t=1 str="not-numeric" 1600000000000000000',
             "hist,t=1 0.5=1,2=3,sum=4,count=3 1600000000000000000",
             "ok_metric,t=1 counter=5 1600000000000000000"]
    out = {}
    for pkg, (Sink, Broker, Mapper, Spread) in {
            "jax": (JSink, JBroker, JMapper, JSpread),
            "port": (KafkaContainerSink, FileBackedBroker, ShardMapper,
                     SpreadProvider)}.items():
        broker = Broker(str(tmp_path / pkg))
        sink = Sink(broker.produce, TOPIC, Mapper(2), Spread(0))
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="filodb.gateway"):
            n = sink.publish_lines(lines)
        out[pkg] = (n, sink.stats(),
                    any("dropped lines" in r.message for r in caplog.records))
    assert out["port"] == out["jax"]
    assert out["port"][0] == 1 and out["port"][2]
    assert out["port"][1]["drops"] == {"parse_error": 1,
                                       "no_numeric_fields": 1,
                                       "histogram_missing_inf_bucket": 1}


def test_pipeline_drop_reasons(caplog):
    ms = TimeSeriesMemStore(device="cpu")
    ms.setup("prometheus", 0)
    pipe = GatewayPipeline(ms, "prometheus", ShardMapper(1),
                           SpreadProvider(0))
    with caplog.at_level(logging.WARNING, logger="filodb.gateway"):
        pipe.ingest_lines(["bad line_", "m,t=1 counter=2 "
                           "1600000000000000000"], offset=1)
    assert pipe.drops.get("parse_error") == 1
    assert any("dropped lines" in r.message for r in caplog.records)


# ------------------------------------------------------------------ kafka

def _produce_slices(broker, num_slices=10, series=30, samples_per=12):
    full = gen.counter_batch(series, num_slices * samples_per,
                             start_ms=START)
    for i in range(num_slices):
        lo = START + i * samples_per * 10_000
        k = (full.timestamps >= lo) & (full.timestamps
                                       < lo + samples_per * 10_000)
        sub = RecordBatch(full.schema, full.part_keys, full.part_idx[k],
                          full.timestamps[k],
                          {kk: v[k] for kk, v in full.columns.items()},
                          full.bucket_les)
        broker.produce(TOPIC, 0, sub.to_bytes())
    return full


def test_kafka_source_consumes_and_resumes(tmp_path):
    broker = FileBackedBroker(str(tmp_path))
    full = _produce_slices(broker)
    stream = KafkaIngestionStream(TOPIC, shard=0,
                                  consumer_factory=broker.consumer_factory())
    got = list(stream.batches(from_offset=-1))
    stream.teardown()
    assert [off for _, off in got] == list(range(10))
    assert sum(b.num_records for b, _ in got) == full.num_records
    np.testing.assert_array_equal(
        np.sort(np.concatenate([b.timestamps for b, _ in got])),
        np.sort(full.timestamps))
    stream = create_stream("kafka", topic=TOPIC, shard=0,
                           consumer_factory=broker.consumer_factory())
    assert [off for _, off in stream.batches(from_offset=6)] == [7, 8, 9]


def test_kafka_end_to_end_ingest_crash_resume(tmp_path):
    """Consume with flushes, crash, resume from the checkpointed
    watermarks: the answers of an unfailed run, and the reference's."""
    broker = FileBackedBroker(str(tmp_path))
    _produce_slices(broker)
    jbroker = JBroker(str(tmp_path))
    assert [v for v in jbroker.read_all(TOPIC, 0)] == \
        broker.read_all(TOPIC, 0)

    def stream():
        return KafkaIngestionStream(
            TOPIC, shard=0, consumer_factory=broker.consumer_factory())
    cs, meta = InMemoryColumnStore(), InMemoryMetaStore()
    ms = TimeSeriesMemStore(column_store=cs, meta_store=meta, device="cpu")
    ms.setup("prometheus", 0)
    ms.ingest_stream("prometheus", 0,
                     ((b, o) for b, o in stream().batches(-1) if o < 6),
                     flush_every=2)
    ms.get_shard("prometheus", 0).flush_all_groups()
    ms2 = TimeSeriesMemStore(column_store=cs, meta_store=meta, device="cpu")
    sh2 = ms2.setup("prometheus", 0)
    sh2.recover_index()
    resume_from = min(meta.read_checkpoints("prometheus", 0).values())
    assert resume_from >= 0
    sh2.recover_stream((b, o) for b, o in stream().batches(resume_from))
    truth = JMemStore()
    truth.setup("prometheus", 0)
    from filodb_tpu.ingest.kafka import KafkaIngestionStream as JStream
    truth.ingest_stream("prometheus", 0, JStream(
        TOPIC, shard=0,
        consumer_factory=jbroker.consumer_factory()).batches(-1))

    def q(store, pkg):
        eng = (JEngine("prometheus", store) if pkg == "jax" else
               QueryEngine("prometheus", store, device="cpu"))
        res = eng.query_range(RATE_Q, START // 1000 + 600, 60,
                              START // 1000 + 1190)
        assert res.error is None, res.error
        return {str(k): np.asarray(v, np.float64) for k, _, v in
                res.series()}
    got, want = q(ms2, "port"), q(truth, "jax")
    assert set(got) == set(want) and len(want) == 10
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   equal_nan=True)
    assert sh2.stats.rows_dropped == 0


def test_kafka_wire_codec_is_the_reference():
    assert wire.crc32c(b"") == 0
    assert wire.crc32c(b"123456789") == 0xE3069283
    assert wire.crc32c(b"\x00" * 32) == 0x8A9136AA
    for n in (0, 1, -1, 63, -64, 64, 300, -301, 2**31, -2**31, 2**40):
        buf = wire.write_varint(n)
        assert buf == jwire.write_varint(n)
        assert wire.read_varint(buf, 0) == (n, len(buf))
    values = [b"alpha", b"", b"x" * 1000, bytes(range(256)),
              gen.counter_batch(4, 3).to_bytes()]
    ours = wire.encode_record_batch(17, values)
    assert ours == jwire.encode_record_batch(17, values)
    want = [(17 + i, v) for i, v in enumerate(values)]
    assert wire.decode_record_batches(ours) == want
    assert jwire.decode_record_batches(ours) == want
    bad = bytearray(ours)
    bad[-1] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        wire.decode_record_batches(bytes(bad))


def test_wire_consumer_against_the_test_broker():
    """The port's KafkaWireClient and WireConsumer (the branch
    KafkaIngestionStream takes without kafka-python) against the
    protocol-faithful broker of tests/kafka_broker.py."""
    from tests.kafka_broker import KafkaTestBroker
    broker = KafkaTestBroker().start()
    try:
        host, _, port = broker.bootstrap.partition(":")
        cli = wire.KafkaWireClient(host, int(port))
        frames = [gen.counter_batch(8, 4, start_ms=START + i * 40_000)
                  .to_bytes() for i in range(6)]
        assert 1 in cli.api_versions()
        base = cli.produce("filodb-records", 3, frames[:4])
        assert cli.list_offset("filodb-records", 3, -2) == base
        assert cli.list_offset("filodb-records", 3, -1) == base + 4
        assert [v for _, v in cli.fetch("filodb-records", 3, base + 2)] == \
            frames[2:4]
        cli.close()
        ms = TimeSeriesMemStore(device="cpu")
        shard = ms.setup("prometheus", 3)
        stream = KafkaIngestionStream("filodb-records", 3,
                                      bootstrap_servers=broker.bootstrap)
        assert stream._consumer_factory is None
        seen = []
        for batch, offset in stream.batches(from_offset=-1):
            shard.ingest(batch, offset=offset)
            seen.append(offset)
            if len(seen) == 4:
                stream._consumer.stop()
        stream.teardown()
        assert seen == [0, 1, 2, 3]
        assert int(shard.stats.rows_ingested) == 4 * 8 * 4
        cli = wire.KafkaWireClient(host, int(port))
        cli.produce("filodb-records", 3, frames[4:])
        cli.close()
        stream2 = KafkaIngestionStream("filodb-records", 3,
                                       bootstrap_servers=broker.bootstrap)
        seen2 = []
        for batch, offset in stream2.batches(from_offset=3):
            shard.ingest(batch, offset=offset)
            seen2.append(offset)
            if len(seen2) == 2:
                stream2._consumer.stop()
        stream2.teardown()
        assert seen2 == [4, 5]
        assert int(shard.stats.rows_ingested) == 6 * 8 * 4
    finally:
        broker.stop()
