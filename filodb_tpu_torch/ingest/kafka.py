"""Kafka ingestion transport (port of filodb_tpu/ingest/kafka.py).

ref: kafka/.../KafkaIngestionStream.scala:17-57 — one shard maps to exactly
one Kafka partition of the ingestion topic; messages are RecordContainer
bytes (here: RecordBatch.to_bytes frames); offsets are Kafka offsets, which
plug straight into the group-watermark checkpoint protocol.

The kafka-python client is an optional dependency: `KafkaIngestionStream`
imports it lazily and raises a clear error when absent.  `consumer_factory`
is injectable, so tests (and brokers-in-tests) run against a fake consumer
— the same seam the reference's TestConsumer/SourceSinkSuite uses.
"""
from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

from filodb_tpu_torch.core.records import RecordBatch
from filodb_tpu_torch.core.schemas import Schemas, DEFAULT_SCHEMAS
from filodb_tpu_torch.ingest.stream import IngestionStream, register_stream_factory


class KafkaIngestionStream(IngestionStream):
    """One stream = one (topic, partition) = one shard
    (ref: KafkaIngestionStream.scala:17: `shard == Kafka partition`)."""

    def __init__(self, topic: str, shard: int,
                 bootstrap_servers: str = "localhost:9092",
                 schemas: Schemas = DEFAULT_SCHEMAS,
                 consumer_factory: Optional[Callable] = None,
                 poll_timeout_ms: int = 1000):
        self.topic = topic
        self.shard = shard
        self.bootstrap_servers = bootstrap_servers
        self.schemas = schemas
        self.poll_timeout_ms = poll_timeout_ms
        self._consumer_factory = consumer_factory
        self._consumer = None

    def _make_consumer(self, from_offset: int):
        if self._consumer_factory is not None:
            return self._consumer_factory(self.topic, self.shard, from_offset)
        try:
            from kafka import KafkaConsumer, TopicPartition  # type: ignore
        except ImportError:
            # no kafka-python: speak the Kafka binary protocol directly
            # (ingest/kafka_wire.py — Fetch v4 / ListOffsets v1 against
            # any >= 0.11 broker; exercised by the env-gated IT in
            # tests/test_kafka_wire_it.py)
            from filodb_tpu_torch.ingest.kafka_wire import WireConsumer
            consumer = WireConsumer(self.bootstrap_servers, self.topic,
                                    self.shard)
            if from_offset >= 0:
                consumer.seek(None, from_offset + 1)
            else:
                consumer.seek_to_beginning()
            return consumer
        consumer = KafkaConsumer(
            bootstrap_servers=self.bootstrap_servers,
            enable_auto_commit=False,   # offsets commit via flush watermarks
            value_deserializer=None)
        tp = TopicPartition(self.topic, self.shard)
        consumer.assign([tp])
        if from_offset >= 0:
            consumer.seek(tp, from_offset + 1)
        else:
            consumer.seek_to_beginning(tp)
        return consumer

    def batches(self, from_offset: int = -1
                ) -> Iterator[Tuple[RecordBatch, int]]:
        self._consumer = self._make_consumer(from_offset)
        for msg in self._consumer:
            if msg.offset <= from_offset:
                continue            # fakes may not support seeking
            batch = RecordBatch.from_bytes(msg.value, self.schemas)
            yield batch, msg.offset

    def teardown(self) -> None:
        if self._consumer is not None:
            close = getattr(self._consumer, "close", None)
            if close:
                close()
            self._consumer = None


register_stream_factory("kafka", KafkaIngestionStream)
