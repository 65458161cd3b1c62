"""Shared per-reason drop accounting for the gateway ingest paths (port
of filodb_tpu/gateway/accounting.py): per-error visibility like the
reference's InfluxProtocolParser logging, not one silent counter."""
from __future__ import annotations

import logging
import threading
import time
from typing import Dict

log = logging.getLogger("filodb.gateway")


class DropLog:
    """Accumulates drop counts by reason and emits a rate-limited warning
    whenever a flush carried drops.  Used by the synchronous
    GatewayPipeline and the decoupled KafkaContainerSink alike."""

    def __init__(self, log_interval_s: float = 5.0):
        self.totals: Dict[str, int] = {}
        self._interval = log_interval_s
        self._last_log = 0.0
        self._lock = threading.Lock()

    def record(self, drops: Dict[str, int]) -> None:
        if not drops:
            return
        with self._lock:
            for reason, n in drops.items():
                self.totals[reason] = self.totals.get(reason, 0) + n
            now = time.monotonic()
            emit = now - self._last_log > self._interval
            if emit:
                self._last_log = now
            totals = dict(self.totals)
        if emit:
            log.warning("gateway dropped lines: %s (totals: %s)",
                        drops, totals)


def admit_batch(batch, ingest_limit: int, drops: Dict[str, int]):
    """Per-tenant ingest admission for a parsed RecordBatch — the Influx
    doors' parity with the remote_write front door's 429 gate (one
    admission ledger, utils/usage.admit_ingest, no door bypasses it).

    Returns (admitted batch or None, retry_after seconds or None).  The
    Influx TCP gateway has no reply channel, so a rejected tenant's
    records are dropped WITH accounting (`tenant_limit_exceeded` in the
    drop log + the tenant_ingest_rejections counter); the HTTP /influx
    endpoint surfaces retry_after as 429 + Retry-After when everything
    bounced.  Mixed-tenant batches keep the admitted tenants' records."""
    import numpy as np

    from filodb_tpu_torch.utils.usage import usage
    if not ingest_limit or batch.num_records == 0:
        return batch, None
    tenants = [(pk.tags_dict.get("_ws_", ""), pk.tags_dict.get("_ns_", ""))
               for pk in batch.part_keys]
    per_key = np.bincount(batch.part_idx, minlength=len(batch.part_keys))
    offered: Dict[tuple, int] = {}
    for i, t in enumerate(tenants):
        offered[t] = offered.get(t, 0) + int(per_key[i])
    rejected = {}
    retry_after = None
    for t, n in offered.items():
        ra = usage.admit_ingest(t[0], t[1], n, ingest_limit)
        if ra is not None:
            rejected[t] = n
            retry_after = max(retry_after or 0.0, ra)
    if not rejected:
        return batch, None
    drops["tenant_limit_exceeded"] = \
        drops.get("tenant_limit_exceeded", 0) + sum(rejected.values())
    if len(rejected) == len(offered):
        return None, retry_after
    keep_key = np.asarray([t not in rejected for t in tenants])
    keep = keep_key[batch.part_idx]
    from filodb_tpu_torch.core.records import RecordBatch
    return RecordBatch(batch.schema, batch.part_keys,
                       batch.part_idx[keep], batch.timestamps[keep],
                       {k: v[keep] for k, v in batch.columns.items()},
                       batch.bucket_les), retry_after
