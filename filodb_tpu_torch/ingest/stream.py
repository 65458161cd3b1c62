"""Pluggable ingestion streams + the per-shard ingestion lifecycle (port
of filodb_tpu/ingest/stream.py: the memory and CSV streams, the
registry and IngestionLifecycle).

Mirrors the reference's transport abstraction (ref:
coordinator/.../IngestionStream.scala:14-43 — `IngestionStream.get` yields
record containers with offsets; `IngestionStreamFactory.create(config, schemas,
shard, offset)` builds one per shard) and the IngestionActor state machine
(ref: coordinator/.../IngestionActor.scala:58,114,171,294 — resync →
recover index → replay from checkpoints with progress events → normal
streaming).  Kafka's role (1 shard = 1 partition of containers) is played by
any stream yielding (RecordBatch, offset) in offset order.
"""
from __future__ import annotations

import csv
import enum
import threading
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.records import RecordBatch, RecordBatchBuilder
from filodb_tpu_torch.core.schemas import Schemas, DEFAULT_SCHEMAS
from filodb_tpu_torch.core.shard import TimeSeriesShard
from filodb_tpu_torch.parallel.shardmapper import ShardEvent


class IngestionStream:
    """A source of (RecordBatch, offset) in ascending-offset order
    (ref: IngestionStream.scala:14-25)."""

    def batches(self, from_offset: int = -1) -> Iterator[Tuple[RecordBatch, int]]:
        raise NotImplementedError

    def teardown(self) -> None:
        pass


class MemoryStream(IngestionStream):
    """In-memory stream for tests/benchmarks — the noOpSource analogue
    (ref: jmh/.../QueryInMemoryBenchmark.scala:87)."""

    def __init__(self, items: Iterable[Tuple[RecordBatch, int]]):
        self.items = list(items)

    def batches(self, from_offset: int = -1):
        for batch, off in self.items:
            if off > from_offset:
                yield batch, off


class CsvStream(IngestionStream):
    """CSV file source (ref: coordinator/.../sources/CsvStream.scala:124).

    Format: header row with `timestamp` (ms), `metric` (or `__name__`), the
    schema's data columns by name, and any other columns as tags.  Offsets are
    data-line numbers grouped by `batch_size` (the offset of a batch is its
    LAST line number), so rewinding to a checkpoint offset works exactly like
    the reference's line-number rewind.
    """

    def __init__(self, path: str, schema_name: str = "gauge",
                 schemas: Schemas = DEFAULT_SCHEMAS, batch_size: int = 100):
        self.path = path
        self.schemas = schemas
        self.schema = schemas[schema_name]
        self.batch_size = batch_size

    def batches(self, from_offset: int = -1):
        value_cols = [c.name for c in self.schema.data_columns
                      if c.col_type != "hist"]
        with open(self.path, newline="") as f:
            reader = csv.DictReader(f)
            builder = RecordBatchBuilder(self.schema)
            pending = 0
            lineno = -1
            for row in reader:
                lineno += 1
                if lineno <= from_offset:
                    continue
                metric = row.get("metric") or row.get("__name__") or ""
                tags = {k: v for k, v in row.items()
                        if k not in ("timestamp", "metric", "__name__",
                                     "tags", *value_cols)
                        and v}
                # packed tag column: `tags` holds `k=v` pairs split by ';';
                # a plain value stays a literal `tags` label
                # (the map-column form of the reference's CSV source)
                packed = row.get("tags")
                if packed:
                    if "=" in packed:
                        for kv in packed.split(";"):
                            k, _, v = kv.partition("=")
                            if k and v:
                                tags[k] = v
                    else:
                        tags["tags"] = packed
                values = {c: float(row[c]) for c in value_cols if c in row}
                builder.add(PartKey.make(metric, tags),
                            int(row["timestamp"]), **values)
                pending += 1
                if pending >= self.batch_size:
                    yield builder.build(), lineno
                    builder = RecordBatchBuilder(self.schema)
                    pending = 0
            if pending:
                yield builder.build(), lineno


# Factory registry (ref: IngestionStreamFactory resolved from config
# `sourcefactory` class name, coordinator/.../IngestionStream.scala:43)
_STREAM_FACTORIES: Dict[str, Callable[..., IngestionStream]] = {}


def register_stream_factory(name: str, factory: Callable[..., IngestionStream]) -> None:
    _STREAM_FACTORIES[name] = factory


def create_stream(name: str, **kwargs) -> IngestionStream:
    return _STREAM_FACTORIES[name](**kwargs)


register_stream_factory("csv", CsvStream)
register_stream_factory("memory", MemoryStream)


# --------------------------------------------------------------- lifecycle

class IngestionState(enum.Enum):
    """ref: IngestionActor lifecycle states / published ShardEvents."""
    NOT_STARTED = "NotStarted"
    RECOVERING = "Recovering"
    NORMAL = "Normal"
    STOPPED = "Stopped"
    ERROR = "Error"


class IngestionLifecycle:
    """Drives one shard through recovery then normal ingestion
    (ref: IngestionActor.startIngestion:171 → doRecovery:294 →
    normalIngestion:139).  Flush groups rotate every `flush_stride` batches so
    persistence overlaps ingestion (the flush-group pipelining strategy,
    ref: TimeSeriesShard.scala:230-241, doc/ingestion.md:114-129)."""

    def __init__(self, shard: TimeSeriesShard, stream: IngestionStream,
                 subscribers: Iterable[Callable[[ShardEvent], None]] = (),
                 flush_stride: int = 0):
        self.shard = shard
        self.stream = stream
        self.subscribers = list(subscribers)
        self.flush_stride = flush_stride
        self.state = IngestionState.NOT_STARTED
        self.recovery_progress = 0.0
        self._next_flush_group = 0
        self._batches_since_flush = 0
        self._stop = threading.Event()

    def _publish(self, event_type: str, **extra) -> None:
        ev = ShardEvent(event_type, self.shard.dataset, self.shard.shard_num,
                        "local")
        for sub in self.subscribers:
            sub(ev)

    def _maybe_flush(self) -> None:
        if not self.flush_stride:
            return
        self._batches_since_flush += 1
        if self._batches_since_flush >= self.flush_stride:
            self.shard.flush_group(self._next_flush_group)
            self._next_flush_group = (self._next_flush_group + 1) % self.shard._groups
            self._batches_since_flush = 0

    def start(self) -> int:
        """Run recovery + ingest the stream to exhaustion.  Returns samples
        ingested (recovery replays + normal).  Continuous sources should call
        this on a dedicated thread and use stop()."""
        try:
            self._publish("RecoveryInProgress")
            self.state = IngestionState.RECOVERING
            self.shard.recover_index()
            cps = self.shard.meta_store.read_checkpoints(
                self.shard.dataset, self.shard.shard_num)
            start_off = min(cps.values()) if cps else -1
            end_off = max(cps.values()) if cps else -1
            total = 0
            started = False
            for batch, off in self.stream.batches(from_offset=start_off):
                if self._stop.is_set():
                    break
                if off <= end_off:
                    total += self.shard.recover_stream([(batch, off)])
                    span = max(end_off - start_off, 1)
                    self.recovery_progress = min((off - start_off) / span, 1.0)
                    self._publish("RecoveryInProgress")
                else:
                    if not started:
                        self.recovery_progress = 1.0
                        self.state = IngestionState.NORMAL
                        self._publish("IngestionStarted")
                        started = True
                    total += self.shard.ingest(batch, off)
                    self._maybe_flush()
            if not started:
                self.state = IngestionState.NORMAL
                self._publish("IngestionStarted")
            if self._stop.is_set():
                self.state = IngestionState.STOPPED
                self._publish("IngestionStopped")
            return total
        except Exception:
            self.state = IngestionState.ERROR
            self._publish("IngestionError")
            raise

    def stop(self) -> None:
        self._stop.set()
        self.stream.teardown()
