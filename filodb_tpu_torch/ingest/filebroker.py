"""Durable local append-log broker with Kafka partition/offset semantics
(port of filodb_tpu/ingest/filebroker.py).

The reference decouples gateway from DB nodes through Kafka: the gateway
publishes per-shard RecordContainer frames, nodes consume their partition
and checkpoint offsets (ref: gateway/.../KafkaContainerSink.scala:24-69,
kafka/.../KafkaIngestionStream.scala:17-57).  This module is the
local-disk analogue of that broker for single-machine and test
deployments — the same philosophy as persist/localstore.py standing in
for Cassandra (SURVEY §7.7): real durability and replay semantics, no
external service.  One file per (topic, partition); a message is a
4-byte big-endian length + payload; the offset is the message index.

Works ACROSS OS processes: the gateway process appends, node processes
tail.  kafka-python deployments use ingest/kafka.py against a real
broker instead — both sides share the IngestionStream contract.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Iterator, List, Optional

from filodb_tpu_torch.core.schemas import Schemas, DEFAULT_SCHEMAS
from filodb_tpu_torch.ingest.stream import register_stream_factory


class FileBackedBroker:
    """Append-log-per-partition broker with Kafka offset semantics."""

    def __init__(self, root: str, fsync: bool = False):
        self.root = str(root)
        self.fsync = fsync
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        # (topic, partition) -> message count, maintained by THIS process's
        # produces (other processes' appends are re-counted lazily)
        self._count_cache: dict = {}

    def _path(self, topic: str, partition: int) -> str:
        return os.path.join(self.root, f"{topic}-{partition}.log")

    def produce(self, topic: str, partition: int, value: bytes) -> int:
        """Append one message; returns its assigned offset.  Atomic w.r.t.
        other producers in THIS process via the lock; cross-process
        single-writer per partition is the deployment contract (exactly
        Kafka's per-partition ordering model).  The per-partition count is
        cached after one initial header-only scan, so appends are O(1)."""
        with self._lock:
            key = (topic, partition)
            offset = self._count_cache.get(key)
            if offset is None:
                offset = self._scan_count(topic, partition)
            with open(self._path(topic, partition), "ab") as f:
                f.write(len(value).to_bytes(4, "big") + value)
                if self.fsync:
                    f.flush()
                    os.fsync(f.fileno())
            self._count_cache[key] = offset + 1
            return offset

    def _scan_count(self, topic: str, partition: int) -> int:
        """Message count via a header-only scan: read each 4-byte length,
        seek over the body — O(messages) tiny reads, O(1) memory."""
        path = self._path(topic, partition)
        if not os.path.exists(path):
            return 0
        n = 0
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            pos = 0
            while True:
                hdr = f.read(4)
                if len(hdr) < 4:
                    return n
                body_len = int.from_bytes(hdr, "big")
                pos += 4 + body_len
                if pos > size:
                    return n            # torn tail write
                f.seek(body_len, 1)
                n += 1

    def end_offset(self, topic: str, partition: int) -> int:
        return self._scan_count(topic, partition)

    def read_all(self, topic: str, partition: int) -> List[bytes]:
        path = self._path(topic, partition)
        out: List[bytes] = []
        if not os.path.exists(path):
            return out
        with open(path, "rb") as f:
            while True:
                hdr = f.read(4)
                if len(hdr) < 4:
                    return out
                body = f.read(int.from_bytes(hdr, "big"))
                if len(body) < int.from_bytes(hdr, "big"):
                    return out          # torn tail write: ignore like Kafka
                out.append(body)

    class _Msg:
        __slots__ = ("offset", "value")

        def __init__(self, offset: int, value: bytes):
            self.offset, self.value = offset, value

    def consume(self, topic: str, partition: int, from_offset: int = -1,
                follow: bool = False, poll_interval_s: float = 0.05,
                stop: Optional[threading.Event] = None
                ) -> Iterator["FileBackedBroker._Msg"]:
        """Yield messages with offset > from_offset.  follow=True tails the
        log (the live-node mode); otherwise stops at the current end.
        Reads are sequential with a remembered byte position — a tailing
        poll costs one stat-sized read attempt, not a rescan of the log."""
        path = self._path(topic, partition)
        offset = -1
        pos = 0
        while True:
            progressed = False
            if os.path.exists(path):
                with open(path, "rb") as f:
                    f.seek(pos)
                    while True:
                        hdr = f.read(4)
                        if len(hdr) < 4:
                            break
                        n = int.from_bytes(hdr, "big")
                        body = f.read(n)
                        if len(body) < n:
                            break       # torn tail: retry after the writer
                        offset += 1
                        pos = f.tell()
                        progressed = True
                        if offset > from_offset:
                            yield FileBackedBroker._Msg(offset, body)
            if not follow or (stop is not None and stop.is_set()):
                if not progressed:
                    return
                continue                 # drain to a quiescent end first
            time.sleep(poll_interval_s)

    def consumer_factory(self, follow: bool = False,
                         stop: Optional[threading.Event] = None) -> Callable:
        """Factory with the KafkaIngestionStream consumer contract."""
        def factory(topic: str, partition: int, from_offset: int):
            return self.consume(topic, partition, from_offset,
                                follow=follow, stop=stop)
        return factory


def _make_filebroker_stream(topic: str, shard: int,
                            broker_dir: str = "",
                            schemas: Schemas = DEFAULT_SCHEMAS,
                            follow: bool = False, **kwargs):
    """`filebroker` IngestionStream factory: reuses KafkaIngestionStream's
    framing/offset logic against the local broker."""
    from filodb_tpu_torch.ingest.kafka import KafkaIngestionStream
    broker = FileBackedBroker(broker_dir)
    return KafkaIngestionStream(
        topic, shard, schemas=schemas,
        consumer_factory=broker.consumer_factory(follow=follow))


register_stream_factory("filebroker", _make_filebroker_stream)
