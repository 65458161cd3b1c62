"""Gateway shard routing: batch → per-shard sub-batches → shard ingest
(port of filodb_tpu/gateway/router.py).

The reference gateway computes `shardMapper.ingestionShard(shardKeyHash,
partitionHash, spread)` per record and publishes each container to its
shard's Kafka partition (ref: gateway/.../GatewayServer.scala:101-115,
coordinator/.../ShardMapper.scala:108-120).  Here routing produces per-shard
RecordBatches handed to local shards or serialized for a remote transport.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np

from filodb_tpu_torch.core.records import RecordBatch
from filodb_tpu_torch.core.schemas import Schemas, DEFAULT_SCHEMAS
from filodb_tpu_torch.parallel.shardmapper import ShardMapper, SpreadProvider


def split_batch_by_shard(batch: RecordBatch, mapper: ShardMapper,
                         spread_provider: SpreadProvider) -> Dict[int, RecordBatch]:
    """Route each record to its shard via the spread math
    (ref: ShardMapper.ingestionShard:108-120)."""
    if batch.num_records == 0:
        return {}
    shard_of_key = np.asarray([
        mapper.ingestion_shard(
            pk.shard_key_hash(), pk.partition_hash(),
            spread_provider.spread_for(pk.shard_key()))
        for pk in batch.part_keys])
    rec_shards = shard_of_key[batch.part_idx]
    out: Dict[int, RecordBatch] = {}
    for s in np.unique(rec_shards).tolist():
        keep = rec_shards == s
        out[s] = RecordBatch(batch.schema, batch.part_keys,
                             batch.part_idx[keep], batch.timestamps[keep],
                             {k: v[keep] for k, v in batch.columns.items()},
                             batch.bucket_les)
    return out


class GatewayPipeline:
    """Influx lines → parsed batches → shard-routed ingest
    (the GatewayServer data path minus the TCP listener, which lives in
    gateway/server.py; ref: GatewayServer.scala:58-115)."""

    def __init__(self, memstore, dataset: str, mapper: ShardMapper,
                 spread_provider: Optional[SpreadProvider] = None,
                 schemas: Schemas = DEFAULT_SCHEMAS,
                 config=None):
        self.memstore = memstore
        self.dataset = dataset
        self.mapper = mapper
        self.spread = spread_provider or SpreadProvider(0)
        self.schemas = schemas
        self.lines_dropped = 0
        # per-tenant ingest admission parity with the remote_write front
        # door: no door bypasses the limits (utils/usage.admit_ingest)
        if config is None:
            from filodb_tpu_torch.config import settings
            config = settings()
        self.ingest_limit = config.query.tenant_ingest_samples_limit
        # WAL manager when this dataset is durability-fronted (attached
        # by the node; the remote_write sink built over this pipeline
        # reads it)
        self.wal = None
        # per-reason drop accounting + rate-limited warn, shared with
        # the decoupled sink (gateway/accounting.py)
        from filodb_tpu_torch.gateway.accounting import DropLog
        self._drop_log = DropLog()
        # per-THREAD retry hint: the pipeline is shared across HTTP
        # handler threads, and instance-level state would let tenant A's
        # all-rejected call read tenant B's reset (silent drop where the
        # contract promises a 429) or vice versa
        import threading
        self._tls = threading.local()

    @property
    def last_retry_after(self):
        """Retry-After seconds when THIS thread's last ingest_lines call
        rejected records, else None."""
        return getattr(self._tls, "retry_after", None)

    @property
    def drops(self) -> Dict[str, int]:
        return self._drop_log.totals

    def ingest_lines(self, lines: Iterable[str],
                     now_ms: Optional[int] = None,
                     offset: int = -1):
        """Returns samples ingested.  Over-limit tenants' records drop
        with accounting; `last_retry_after` carries the window-roll hint
        for callers with a reply channel (the /influx HTTP endpoint
        turns an everything-rejected call into 429 + Retry-After)."""
        from filodb_tpu_torch.gateway.accounting import admit_batch
        from filodb_tpu_torch.gateway.influx import influx_lines_to_batches
        lines = list(lines)
        drops: Dict[str, int] = {}
        batches = influx_lines_to_batches(lines, self.schemas, now_ms,
                                          drops=drops)
        n = 0
        got = 0
        self._tls.retry_after = None
        for batch in batches:
            got += batch.num_records
            batch, retry_after = admit_batch(batch, self.ingest_limit,
                                             drops)
            if retry_after is not None:
                self._tls.retry_after = retry_after
            if batch is None:
                continue
            for shard_num, sub in split_batch_by_shard(
                    batch, self.mapper, self.spread).items():
                shard = self.memstore.get_shard(self.dataset, shard_num)
                if shard is not None:
                    n += shard.ingest(sub, offset)
        self.lines_dropped += len(lines) - got
        self._drop_log.record(drops)
        return n
