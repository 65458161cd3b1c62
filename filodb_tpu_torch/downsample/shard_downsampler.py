"""ShardDownsampler — emits downsample records as raw chunks are flushed
(port of filodb_tpu/downsample/shard_downsampler.py).

ref: core/.../downsample/ShardDownsampler.scala:103 — at flush time each
encoded chunk is downsampled at every configured resolution and the
resulting records are published to the downsample dataset(s).  Here the
emitted form is RecordBatch (the same unit the ingest path consumes), so a
DownsampledTimeSeriesStore — or a Kafka-analogue stream — can ingest them
unchanged.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.records import RecordBatch, RecordBatchBuilder
from filodb_tpu_torch.core.schemas import Schema, Schemas, DEFAULT_SCHEMAS
from filodb_tpu_torch.downsample.downsamplers import downsample_chunk

DEFAULT_RESOLUTIONS = (60_000, 300_000)      # 1m, 5m (conf: downsample block)


class ShardDownsampler:
    """Accumulates downsample records for one shard across flushes
    (ref: ShardDownsampler.scala:103)."""

    def __init__(self, schemas: Schemas = DEFAULT_SCHEMAS,
                 resolutions: Sequence[int] = DEFAULT_RESOLUTIONS):
        self.schemas = schemas
        self.resolutions = tuple(resolutions)
        self._builders: Dict[int, Dict[str, RecordBatchBuilder]] = {
            r: {} for r in self.resolutions}

    def _builder(self, res: int, schema: Schema) -> RecordBatchBuilder:
        b = self._builders[res].get(schema.name)
        if b is None:
            b = RecordBatchBuilder(schema)
            self._builders[res][schema.name] = b
        return b

    def downsample(self, part_key: PartKey, schema: Schema, ts: np.ndarray,
                   cols: Dict[str, np.ndarray],
                   bucket_les: Optional[np.ndarray] = None) -> int:
        """Downsample one flushed chunk at every resolution; returns records
        emitted.  Schemas with no downsamplers (untyped) emit nothing
        (ref: ShardDownsampler enabled only for schemas with downsamplers)."""
        if not schema.downsamplers or schema.downsample_schema is None:
            return 0
        target = self.schemas[schema.downsample_schema]
        emitted = 0
        for res in self.resolutions:
            out_ts, out_cols = downsample_chunk(schema, ts, cols, res)
            if len(out_ts) == 0:
                continue
            b = self._builder(res, target)
            if bucket_les is not None:
                b.set_bucket_les(bucket_les)
            b.add_rows(part_key, out_ts, out_cols)
            emitted += len(out_ts)
        return emitted

    def result_batches(self) -> Dict[int, List[RecordBatch]]:
        """Drain accumulated records: {resolution_ms: [RecordBatch]}."""
        out: Dict[int, List[RecordBatch]] = {}
        for res, builders in self._builders.items():
            batches = [b.build() for b in builders.values() if b._ts]
            if batches:
                out[res] = batches
        self._builders = {r: {} for r in self.resolutions}
        return out
