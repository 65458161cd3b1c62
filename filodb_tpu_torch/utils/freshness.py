"""Write-path freshness: per-batch IngestStats + the ingest SLO layer
(port of filodb_tpu/utils/freshness.py, a JAX-free copy; the write
doors feed it through DoorTrace, and the health model reads it).

"How stale is my data?" gets a measured answer (doc/observability.md):

  * ``IngestStats`` — one ingest batch's door-to-ack record: byte /
    sample / series counts, tenant, the per-stage breakdown (decode,
    admission, WAL append, group-commit fsync wait, replication
    fan-out, memstore ingest) and the batch's trace id.  The doors fill
    it, the ingest slowlog (utils/slowlog.IngestSlowLog) records slow
    ones, and its stage seconds feed the histograms below.
  * ``ingest_ack_seconds{ws}`` — ingest-to-ack: door arrival to the
    durable ack, per tenant workspace.
  * ``ingest_freshness_seconds{ws}`` — ingest-to-queryable: the ack
    wall clock minus the batch's newest sample timestamp (how far
    behind "queryable now" the data's own clock is; compare the result
    cache's `append_horizon_ms` immutability line).  Clamped at zero
    for future-stamped samples.
  * ``FreshnessTracker`` — the SLO fold: a batch whose ack wall crosses
    ``ingest.slow_batch_threshold_s`` is a BREACH; sustained breaches
    (>= `breach_count` inside `window_s`) flip the health evaluator's
    `ingest` subsystem to degraded until they age out.  A single slow
    fsync is a blip; a pattern of them is an incident.

Everything here rides the ordinary metrics registry, so the `_self_`
self-scrape loop (utils/selfmon.py) makes all of it PromQL-queryable
and ruler-alertable with zero extra wiring.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Dict, List, Optional

from filodb_tpu_torch.utils.metrics import registry

# seconds-scale bounds for the ack/freshness histograms (an fsync stall
# or replica wait lives in the 0.01-10 s band; the default ms-ish span
# bounds would smear it across two buckets)
FRESHNESS_BOUNDS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 300.0)


@dataclasses.dataclass
class IngestStats:
    """One ingest batch's door-to-ack attribution (the write-path
    QueryStats analogue)."""
    origin: str = "remote_write"          # remote_write | influx | gateway
    dataset: str = ""
    trace_id: str = ""
    tenant_ws: str = ""
    tenant_ns: str = ""
    bytes_in: int = 0
    samples: int = 0
    series: int = 0
    slabs: int = 0
    shards: List[int] = dataclasses.field(default_factory=list)
    ingested: int = 0
    dropped: int = 0
    # per-stage seconds (exclusive where the stages are sequential; the
    # WAL fsync overlaps memstore ingest by design, so wal_commit_wait_s
    # is the RESIDUAL wait after the overlapped work finished)
    decode_s: float = 0.0
    admission_s: float = 0.0
    build_slabs_s: float = 0.0
    wal_append_s: float = 0.0
    wal_commit_wait_s: float = 0.0
    replication_s: float = 0.0
    ingest_s: float = 0.0
    total_s: float = 0.0
    # newest sample timestamp (ms) per tenant ws — the freshness input
    newest_ts_ms: Dict[str, int] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        d = {
            "origin": self.origin, "dataset": self.dataset,
            "trace_id": self.trace_id,
            "tenant": {"ws": self.tenant_ws, "ns": self.tenant_ns},
            "bytes_in": int(self.bytes_in),
            "samples": int(self.samples), "series": int(self.series),
            "slabs": int(self.slabs), "shards": sorted(self.shards),
            "ingested": int(self.ingested), "dropped": int(self.dropped),
            "duration_s": round(self.total_s, 6),
            "stages": {
                "decode_s": round(self.decode_s, 6),
                "admission_s": round(self.admission_s, 6),
                "build_slabs_s": round(self.build_slabs_s, 6),
                "wal_append_s": round(self.wal_append_s, 6),
                "wal_commit_wait_s": round(self.wal_commit_wait_s, 6),
                "replication_s": round(self.replication_s, 6),
                "ingest_s": round(self.ingest_s, 6),
            },
        }
        return d


class FreshnessTracker:
    """Rolling breach window -> health verdict (the `ingest` subsystem
    in utils/health.HealthEvaluator)."""

    def __init__(self, threshold_s: float = 5.0, breach_count: int = 3,
                 window_s: float = 60.0):
        self.threshold_s = threshold_s
        self.breach_count = max(int(breach_count), 1)
        self.window_s = window_s
        self._lock = threading.Lock()
        self._breaches: collections.deque = collections.deque(maxlen=1024)
        self._batches = 0
        self._last_breach_unix = 0.0

    def configure(self, threshold_s: Optional[float] = None,
                  breach_count: Optional[int] = None,
                  window_s: Optional[float] = None) -> "FreshnessTracker":
        with self._lock:
            if threshold_s is not None:
                self.threshold_s = threshold_s
            if breach_count is not None:
                self.breach_count = max(int(breach_count), 1)
            if window_s is not None:
                self.window_s = window_s
        return self

    def reset(self) -> None:
        with self._lock:
            self._breaches.clear()
            self._batches = 0
            self._last_breach_unix = 0.0

    # ------------------------------------------------------------ record

    def note_batch(self, stats: IngestStats,
                   ack_unix_ms: Optional[int] = None) -> None:
        """Fold one acked batch: the ack/freshness histograms (per
        tenant workspace, exemplar = the batch's trace id) plus the
        breach window.  Called on the ack path — everything here is a
        few dict hits and at most a handful of histogram records."""
        now = time.time()
        ack_ms = int(now * 1000) if ack_unix_ms is None else ack_unix_ms
        ws = stats.tenant_ws or "_default_"
        registry.histogram("ingest_ack_seconds", bounds=FRESHNESS_BOUNDS,
                           ws=ws, origin=stats.origin).record(
            stats.total_s, exemplar=stats.trace_id or None)
        for t_ws, newest_ms in stats.newest_ts_ms.items():
            lag_s = max((ack_ms - int(newest_ms)) / 1000.0, 0.0)
            registry.histogram("ingest_freshness_seconds",
                               bounds=FRESHNESS_BOUNDS,
                               ws=t_ws or "_default_").record(
                lag_s, exemplar=stats.trace_id or None)
        with self._lock:
            self._batches += 1
            if self.threshold_s > 0 and stats.total_s >= self.threshold_s:
                self._breaches.append(now)
                self._last_breach_unix = now
                breached = True
            else:
                breached = False
        if breached:
            registry.counter("ingest_freshness_breaches",
                             origin=stats.origin).increment()

    # ----------------------------------------------------------- verdict

    def _recent_breaches(self, now: Optional[float] = None) -> int:
        now = time.time() if now is None else now
        cutoff = now - self.window_s
        with self._lock:
            while self._breaches and self._breaches[0] < cutoff:
                self._breaches.popleft()
            return len(self._breaches)

    def verdict(self) -> dict:
        """The health evaluator's `ingest` subsystem entry: degraded
        while the breach window stays saturated; self-clears as the
        breaches age past `window_s`."""
        recent = self._recent_breaches()
        sustained = recent >= self.breach_count
        out = {
            "status": "degraded" if sustained else "ok",
            "recentBreaches": recent,
            "breachThresholdSeconds": self.threshold_s,
            "windowSeconds": self.window_s,
            "batches": self._batches,
        }
        if self._last_breach_unix:
            out["lastBreachUnixSeconds"] = round(self._last_breach_unix, 3)
        return out


# process-wide instance: the doors feed it, the health evaluator reads
# it, standalone.FiloServer configures it from FilodbSettings
freshness = FreshnessTracker()


class DoorTrace:
    """The shared per-door trace bookkeeping (remote_write, /influx,
    the TCP gateway): parse-or-mint the W3C trace id, build the
    IngestStats, run the door body under the trace context with the
    `remote_write` origin tagged, and on `finish(status)` fold acked
    batches into the freshness histograms + the ingest slowlog and
    hand back the response trace headers — ONE implementation of the
    policy instead of a copy per door."""

    def __init__(self, origin: str, dataset: str, headers=None,
                 body_bytes: int = 0,
                 threshold_s: Optional[float] = None):
        from filodb_tpu_torch.utils.metrics import (mint_trace_id,
                                              parse_traceparent)
        self.headers = {k.lower(): v
                        for k, v in (headers or {}).items()}
        self.trace_id = parse_traceparent(
            self.headers.get("traceparent")) or mint_trace_id()
        self.stats = IngestStats(origin=origin, dataset=dataset,
                                 trace_id=self.trace_id,
                                 bytes_in=body_bytes)
        self._threshold_s = threshold_s
        self._ctx = None
        self._t0 = 0.0

    def __enter__(self) -> "DoorTrace":
        from filodb_tpu_torch.utils.metrics import collector, trace_context
        self._t0 = time.perf_counter()
        self._ctx = trace_context(self.trace_id)
        self._ctx.__enter__()
        collector.note_origin(self.trace_id, "remote_write")
        return self

    def __exit__(self, exc_type, exc, tb):
        self._ctx.__exit__(exc_type, exc, tb)
        self.stats.total_s = time.perf_counter() - self._t0
        return False

    def trace_headers(self) -> Dict[str, str]:
        from filodb_tpu_torch.utils.metrics import make_traceparent
        return {"X-Trace-Id": self.trace_id,
                "traceparent": make_traceparent(self.trace_id)}

    def finish(self, status: int = 200) -> Dict[str, str]:
        """Fold the batch (acked statuses only: a 4xx/5xx is the
        client's or durability's problem, not a freshness breach) and
        return the response trace headers."""
        if status < 400:
            from filodb_tpu_torch.utils.slowlog import ingestlog
            freshness.note_batch(self.stats)
            ingestlog.maybe_record(self.stats,
                                   threshold_s=self._threshold_s)
        return self.trace_headers()
