"""Standalone gateway server: TCP Influx listener → per-shard broker sink
(port of filodb_tpu/gateway/server.py).

The reference's ingest backbone decouples the gateway from the DB nodes:
a Netty TCP server parses Influx lines, builds record containers, and
PUBLISHES each to its shard's Kafka partition; nodes consume their
partition and checkpoint offsets (ref:
gateway/src/main/scala/filodb/gateway/GatewayServer.scala:58-115,
gateway/.../KafkaContainerSink.scala:24-69).  This module reproduces that
as its own OS process:

    influx client --TCP--> GatewayServer --produce--> broker partition[s]
                                                        |
    node ingestion stream  <--consume/offset-checkpoint-+

Run it:  python -m filodb_tpu_torch.gateway.server --broker-dir /var/filodb/broker
         python -m filodb_tpu_torch.gateway.server --bootstrap-servers k1:9092

The broker is either the durable local append-log
(ingest/filebroker.FileBackedBroker — the local-disk Kafka analogue, see
its module docstring) or a real Kafka cluster via kafka-python.
"""
from __future__ import annotations

import argparse
import logging
import socket
import socketserver
import sys
import threading
import time
from typing import Callable, Dict, Iterable, Optional

from filodb_tpu_torch.core.records import RecordBatch
from filodb_tpu_torch.core.schemas import Schemas, DEFAULT_SCHEMAS
from filodb_tpu_torch.gateway.accounting import DropLog
from filodb_tpu_torch.gateway.influx import influx_lines_to_batches
from filodb_tpu_torch.gateway.router import split_batch_by_shard
from filodb_tpu_torch.parallel.shardmapper import ShardMapper, SpreadProvider

log = logging.getLogger("filodb.gateway")


class KafkaContainerSink:
    """Publish per-shard RecordBatch frames to broker partitions
    (ref: KafkaContainerSink.scala:24-69 — container → partition=shard).

    `produce(topic, partition, bytes) -> offset` is the only broker
    contract; FileBackedBroker and a kafka-python producer both satisfy
    it.  Drop accounting is per REASON and logged (rate-limited), not a
    single silent counter."""

    def __init__(self, produce: Callable[[str, int, bytes], int],
                 topic: str, mapper: ShardMapper,
                 spread_provider: Optional[SpreadProvider] = None,
                 schemas: Schemas = DEFAULT_SCHEMAS,
                 config=None):
        self.produce = produce
        self.topic = topic
        self.mapper = mapper
        self.spread = spread_provider or SpreadProvider(0)
        self.schemas = schemas
        # per-tenant ingest admission parity with the remote_write front
        # door (utils/usage.admit_ingest): the TCP gateway has no reply
        # channel, so over-limit tenants' records drop WITH accounting —
        # `tenant_limit_exceeded` in the drop log plus the
        # tenant_ingest_rejections counter — never silently
        if config is None:
            from filodb_tpu_torch.config import settings
            config = settings()
        self.ingest_limit = config.query.tenant_ingest_samples_limit
        self.lines_in = 0
        self.records_out = 0
        self.frames_out = 0
        self._drop_log = DropLog()
        self._lock = threading.Lock()

    def publish_lines(self, lines: Iterable[str],
                      now_ms: Optional[int] = None) -> int:
        """Parse, route, and publish; returns records published.  The
        TCP door has no headers to carry a traceparent, so each flush
        batch runs under a MINTED write-path trace id (doc/
        observability.md): the parse/route/produce spans land in the
        trace ring and slow batches in /admin/ingestlog like the HTTP
        doors."""
        from filodb_tpu_torch.utils.freshness import DoorTrace
        from filodb_tpu_torch.utils.metrics import span
        from filodb_tpu_torch.gateway.accounting import admit_batch
        lines = list(lines)
        door = DoorTrace("gateway", self.topic,
                         body_bytes=sum(len(ln) for ln in lines))
        published = 0
        with door, span("gateway_publish"):
            drops: Dict[str, int] = {}
            batches = influx_lines_to_batches(lines, self.schemas, now_ms,
                                              drops=drops)
            for batch in batches:
                batch, _retry = admit_batch(batch, self.ingest_limit,
                                            drops)
                if batch is None:
                    continue
                for shard_num, sub in split_batch_by_shard(
                        batch, self.mapper, self.spread).items():
                    self.produce(self.topic, shard_num, sub.to_bytes())
                    published += sub.num_records
                    with self._lock:
                        self.frames_out += 1
        with self._lock:
            self.lines_in += len(lines)
            self.records_out += published
        self._drop_log.record(drops)
        door.stats.series = len(lines)
        door.stats.samples = door.stats.ingested = published
        door.finish()
        return published

    @property
    def drops(self) -> Dict[str, int]:
        return self._drop_log.totals

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {"lines_in": self.lines_in,
                    "records_out": self.records_out,
                    "frames_out": self.frames_out,
                    "drops": dict(self._drop_log.totals)}


class GatewayServer:
    """Threaded TCP server speaking newline-delimited Influx line protocol
    (the reference's Netty pipeline: delimiter-framed UTF-8 lines,
    ref: GatewayServer.scala:139-155).  Lines buffer per connection and
    flush to the sink every `batch_lines` or on connection close."""

    def __init__(self, sink: KafkaContainerSink, host: str = "127.0.0.1",
                 port: int = 8007, batch_lines: int = 512):
        self.sink = sink
        outer = self

        max_line = 1 << 20               # the Netty pipeline's frame cap

        class _Handler(socketserver.StreamRequestHandler):
            def handle(self):
                buf = []
                skipping = False
                while True:
                    raw = self.rfile.readline(max_line)
                    if not raw:
                        break
                    if not raw.endswith(b"\n") and len(raw) >= max_line:
                        # oversized frame: account it once, then discard
                        # up to the next newline instead of buffering GBs
                        if not skipping:
                            outer.sink._drop_log.record(
                                {"line_too_long": 1})
                        skipping = True
                        continue
                    if skipping:
                        skipping = False
                        continue         # tail of the oversized line
                    buf.append(raw.decode("utf-8", "replace"))
                    if len(buf) >= batch_lines:
                        outer.sink.publish_lines(buf)
                        buf = []
                if buf:
                    outer.sink.publish_lines(buf)

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _Handler)
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="gateway-accept", daemon=True)
        self._thread.start()
        log.info("gateway listening on :%d", self.port)

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def send_lines(host: str, port: int, lines: Iterable[str]) -> None:
    """Minimal client: ship lines to a gateway over one TCP connection."""
    with socket.create_connection((host, port)) as s:
        payload = "".join(line.rstrip("\n") + "\n" for line in lines)
        s.sendall(payload.encode("utf-8"))


def build_sink(args, schemas: Schemas = DEFAULT_SCHEMAS
               ) -> KafkaContainerSink:
    mapper = ShardMapper(args.num_shards)
    spread = SpreadProvider(args.spread)
    if args.broker_dir:
        from filodb_tpu_torch.ingest.filebroker import FileBackedBroker
        broker = FileBackedBroker(args.broker_dir, fsync=args.fsync)
        produce = broker.produce
    else:
        try:
            from kafka import KafkaProducer  # type: ignore
        except ImportError as e:
            raise SystemExit(
                "kafka-python is not installed; use --broker-dir for the "
                "local append-log broker") from e
        producer = KafkaProducer(bootstrap_servers=args.bootstrap_servers)

        def produce(topic: str, partition: int, value: bytes) -> int:
            md = producer.send(topic, value=value,
                               partition=partition).get(timeout=30)
            return md.offset
    return KafkaContainerSink(produce, args.topic, mapper, spread, schemas)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="FiloDB-TPU gateway server (Influx TCP -> broker)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8007,
                    help="TCP Influx listener port (0 = ephemeral)")
    ap.add_argument("--topic", default="timeseries")
    ap.add_argument("--num-shards", type=int, default=4)
    ap.add_argument("--spread", type=int, default=0)
    ap.add_argument("--broker-dir", default="",
                    help="local append-log broker directory (no Kafka)")
    ap.add_argument("--fsync", action="store_true",
                    help="fsync the broker log on every frame")
    ap.add_argument("--bootstrap-servers", default="localhost:9092")
    ap.add_argument("--stats-interval", type=float, default=0.0,
                    help="print sink stats every N seconds (0 = off)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    sink = build_sink(args)
    server = GatewayServer(sink, args.host, args.port)
    server.start()
    # announce the bound port on stdout so callers (and tests) that asked
    # for an ephemeral port can discover it
    print(f"GATEWAY_READY port={server.port}", flush=True)
    try:
        while True:
            time.sleep(args.stats_interval or 3600)
            if args.stats_interval:
                print(f"GATEWAY_STATS {sink.stats()}", flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()


if __name__ == "__main__":
    main(sys.argv[1:])
