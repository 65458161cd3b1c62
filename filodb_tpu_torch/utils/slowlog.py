"""Slow-operation flight recorders, query and ingest (port of
filodb_tpu/utils/slowlog.py).

The serving frontend records every query whose total wall (queue wait
included) exceeds `query.slow_query_threshold_s` into a bounded ring
buffer: the promql, grid params, tenant, the full QueryStats phase
attribution, and the stitched cross-node span tree captured at record
time (trace buffers are bounded and recycle — a slowlog entry must not
dangle a trace id that has already been evicted).  Exposed at
GET /admin/slowlog and optionally mirrored to a JSONL sink
(`query.slowlog_path`) for offline triage.

This is the MySQL-slow-log / Monarch-query-annal shape: when the p99
spikes, the operator reads the actual offending operations with their
breakdown.

The write path has the same recorder: ingest batches whose door-to-ack
wall exceeds `ingest.slow_batch_threshold_s` land in a second ring
(`IngestSlowLog`, GET /admin/ingestlog) with tenant, byte and sample
counts, the per-stage breakdown and the batch's trace id; the write
doors (remote write, /influx/write, the TCP gateway) record into it.
"""
from __future__ import annotations

import collections
import json
import logging
import threading
import time
from typing import List, Optional, Tuple

log = logging.getLogger("filodb.slowlog")


class _RingLog:
    """Bounded ring + monotonic seq + optional JSONL mirror — the shared
    flight-recorder mechanics both slow logs ride on."""

    def __init__(self, threshold_s: float, max_entries: int,
                 path: str = ""):
        self.threshold_s = threshold_s
        self.path = path
        self._lock = threading.Lock()
        self._entries: collections.deque = collections.deque(
            maxlen=max_entries)
        self._seq = 0

    def configure(self, threshold_s: Optional[float] = None,
                  max_entries: Optional[int] = None,
                  path: Optional[str] = None) -> "_RingLog":
        """Apply config (standalone.FiloServer at boot; tests directly).
        Shrinking max_entries keeps the newest records."""
        with self._lock:
            if threshold_s is not None:
                self.threshold_s = threshold_s
            if path is not None:
                self.path = path
            if max_entries is not None and \
                    max_entries != self._entries.maxlen:
                self._entries = collections.deque(self._entries,
                                                  maxlen=max_entries)
        return self

    def _append(self, rec: dict) -> None:
        """Sequence + ring-append + best-effort JSONL mirror."""
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._entries.append(rec)
        if self.path:
            try:
                with self._lock:   # serialize appends; keep lines whole
                    with open(self.path, "a") as f:
                        f.write(json.dumps(rec) + "\n")
            except OSError as e:
                # the sink is best-effort; the ring buffer is the record
                from filodb_tpu_torch.utils.metrics import registry
                registry.counter("slowlog_sink_errors").increment()
                log.warning("slowlog sink %s failed: %s", self.path, e)

    # ------------------------------------------------------------- read

    def entries(self, limit: int = 0) -> List[dict]:
        """Newest-last snapshot (the /admin payload)."""
        with self._lock:
            out = list(self._entries)
        return out[-limit:] if limit else out

    def clear(self) -> int:
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
        return n

    def __len__(self) -> int:
        return len(self._entries)


class SlowQueryLog(_RingLog):

    def __init__(self, threshold_s: float = 10.0, max_entries: int = 128,
                 path: str = ""):
        super().__init__(threshold_s, max_entries, path)

    # ------------------------------------------------------------ record

    def maybe_record(self, promql: str, start_s: int, step_s: int,
                     end_s: int, duration_s: float, result,
                     tenant: Tuple[str, str] = ("", ""),
                     origin: str = "query_range",
                     threshold_s: Optional[float] = None,
                     force: bool = False) -> bool:
        """Record iff duration crossed the threshold (the caller's
        config override wins over the singleton's).  `result` is the
        QueryResult (stats + trace_id + error ride along).  `force`
        records regardless of duration — the frontend uses it for SHED
        queries (verdict `shed`), which are fast by design but exactly
        what an operator triaging a tenant's 429s needs to read.
        Returns whether a record was taken."""
        thr = self.threshold_s if threshold_s is None else threshold_s
        if not force and (thr <= 0 or duration_s < thr):
            return False
        from filodb_tpu_torch.query.activequeries import verdict_of
        from filodb_tpu_torch.utils.metrics import collector, registry
        trace_id = getattr(result, "trace_id", "") or ""
        spans: List[dict] = []
        if trace_id:
            # copy NOW: the trace collector's ring recycles old traces
            spans = sorted(collector.trace(trace_id),
                           key=lambda e: e.get("end_unix_s", 0))
        stats = getattr(result, "stats", None)
        rec = {
            "unix_ts": round(time.time(), 3),
            "origin": origin,
            "promql": promql,
            "start_s": int(start_s), "step_s": int(step_s),
            "end_s": int(end_s),
            "duration_s": round(duration_s, 6),
            "tenant": {"ws": tenant[0], "ns": tenant[1]},
            # the stable query id IS the trace id: both names,
            # so slowlog <-> /admin/traces/<id> correlation is a copy-
            # paste, not a manual join — and the final VERDICT
            # (completed/killed/deadline/error) rides both records
            "trace_id": trace_id,
            "query_id": trace_id,
            "verdict": verdict_of(result),
            "error": getattr(result, "error", None),
            "partial": bool(getattr(result, "partial", False)),
            "stats": stats.to_dict() if stats is not None else None,
            "spans": spans,
        }
        self._append(rec)
        if duration_s >= thr > 0:
            # genuinely slow (force-recorded sheds keep their own
            # queries_shed accounting — they are fast, that's the point)
            registry.counter("slow_queries", origin=origin).increment()
            log.warning("slow query (%.2fs > %.2fs): %s [%s..%s step %s] "
                        "trace=%s", duration_s, thr, promql,
                        start_s, end_s, step_s, trace_id)
        return True

    def seq_for_trace(self, trace_id: str) -> Optional[int]:
        """Ring seq of the newest record carrying this trace id, or None
        — the /admin/traces/<id> -> slowlog half of the cross-link."""
        if not trace_id:
            return None
        with self._lock:
            for rec in reversed(self._entries):
                if rec.get("trace_id") == trace_id:
                    return rec.get("seq")
        return None


class IngestSlowLog(_RingLog):
    """The write path's flight recorder: batches over
    `ingest.slow_batch_threshold_s` door-to-ack, with per-stage
    breakdown and trace id (GET /admin/ingestlog)."""

    def __init__(self, threshold_s: float = 5.0, max_entries: int = 128,
                 path: str = ""):
        super().__init__(threshold_s, max_entries, path)

    def maybe_record(self, stats,
                     threshold_s: Optional[float] = None) -> bool:
        """`stats` is a utils.freshness.IngestStats; records iff its
        total wall crossed the threshold.  The stitched span tree is
        copied at record time, like the query ring."""
        thr = self.threshold_s if threshold_s is None else threshold_s
        if thr <= 0 or stats.total_s < thr:
            return False
        from filodb_tpu_torch.utils.metrics import collector, registry
        spans: List[dict] = []
        if stats.trace_id:
            spans = sorted(collector.trace(stats.trace_id),
                           key=lambda e: e.get("end_unix_s", 0))
        rec = stats.to_dict()
        rec["unix_ts"] = round(time.time(), 3)
        rec["spans"] = spans
        self._append(rec)
        registry.counter("slow_ingest_batches",
                         origin=stats.origin).increment()
        log.warning("slow ingest batch (%.3fs > %.3fs): %d samples / "
                    "%d series / %d bytes [%s] trace=%s",
                    stats.total_s, thr, stats.samples, stats.series,
                    stats.bytes_in, stats.origin, stats.trace_id)
        return True


# process-wide instances: the frontend records into the query ring,
# /admin/slowlog and /admin/ingestlog read them
slowlog = SlowQueryLog()
ingestlog = IngestSlowLog()
