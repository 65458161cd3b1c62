"""Self-scrape meta-monitoring: the TSDB monitors itself with itself
(port of filodb_tpu/utils/selfmon.py).

The production stance for a monitoring system (Prometheus scrapes its
own /metrics; Google's Monarch monitors itself with itself, VLDB'20 §7)
is that the TSDB's own telemetry must be queryable and alertable
THROUGH ITS OWN query and rules engines — dashboards over
`rate(wal_fsync_seconds_count[5m])`, alerts on `job_consecutive_errors`
— not only visible to an external scraper that may not exist.

`SelfScraper` closes the loop: an in-process loop snapshots the metrics
registry every `selfmon.interval_s` and writes every counter / gauge /
histogram through the ordinary columnar `ingest_columns` path (the same
shard-routed MemstoreSink the ruler's write-back uses) under a reserved
`_self_` tenant with `job="filodb"` and an `instance` label from the
node id.  Prometheus exposition naming is preserved — counters land as
`name_total`, histograms as `name_bucket{le=...}` / `name_sum` /
`name_count` — so PromQL written against a real Prometheus scrape of
/metrics works unchanged against the self-scraped series.

The `_self_` workspace is exempt from the scan-limit gate like
`_rules_` (utils/usage.INTERNAL_WORKSPACES) but fully accounted, so
self-monitoring burn shows up in /api/v1/usage without ever starving
itself out of its own answers.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

TENANT_WS = "_self_"
TENANT_NS = "selfmon"

# seconds-scale scrape-duration bounds
_SCRAPE_BOUNDS = (0.0005, 0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                  0.5, 1.0, 2.5, 5.0)


class SelfScraper:
    """Snapshot the metrics registry -> columnar ingest, on a timer."""

    def __init__(self, memstore, dataset: str, mapper=None,
                 spread_provider=None, node_name: str = "local",
                 interval_s: float = 15.0):
        from filodb_tpu_torch.rules import MemstoreSink
        self.dataset = dataset
        self.node = node_name
        self.interval_s = max(float(interval_s), 0.05)
        self.sink = MemstoreSink(memstore, dataset, mapper,
                                 spread_provider)
        self.scrapes = 0
        self.errors = 0
        self.last_series = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # (metric, tag tuple) -> PartKey: series identity is stable
        # across scrapes, so per-series key construction runs once per
        # NEW series, not once per scrape x series
        self._key_memo: Dict[Tuple, object] = {}
        from filodb_tpu_torch.utils.jobs import jobs
        self._job = jobs.register("selfmon", interval_s=self.interval_s,
                                  dataset=dataset)

    # ------------------------------------------------------------ control

    def start(self) -> "SelfScraper":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="filodb-selfmon")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _run(self) -> None:
        # first scrape immediately: a freshly-booted node's own metrics
        # must be queryable within one interval, not two
        while not self._stop.is_set():
            try:
                with self._job.tick():
                    self.scrape_once()
            except Exception:  # noqa: BLE001 — the loop must survive;
                pass           # the job tick recorded the error
            self._stop.wait(self.interval_s)

    # ------------------------------------------------------------- scrape

    def _part_key(self, name: str, tags: Tuple[Tuple[str, str], ...]):
        from filodb_tpu_torch.core.partkey import PartKey
        memo_key = (name, tags)
        pk = self._key_memo.get(memo_key)
        if pk is None:
            labels = {"_ws_": TENANT_WS, "_ns_": TENANT_NS,
                      "job": "filodb", "instance": self.node}
            for k, v in tags:
                # a metric tag colliding with a scrape-identity label
                # (job_runs_total carries its own `job` tag) gets the
                # Prometheus honor_labels=false treatment: the scraped
                # label moves to exported_<name>, identity wins
                labels["exported_" + k if k in labels else k] = v
            pk = PartKey.make(name, labels)
            if len(self._key_memo) > 65_536:
                # hostile tag churn must not pin unbounded keys
                self._key_memo.clear()
            self._key_memo[memo_key] = pk
        return pk

    def scrape_once(self, now_ms: Optional[int] = None) -> int:
        """One registry snapshot -> one columnar write per shard;
        returns series written.  Raises on sink failure (the caller's
        job tick records it; the next interval retries)."""
        from filodb_tpu_torch.utils.metrics import registry
        t0 = time.perf_counter()
        samples = registry.snapshot_samples()
        now_ms = int(time.time() * 1000) if now_ms is None else now_ms
        keys: List[object] = []
        vals: List[float] = []
        for name, tags, value in samples:
            keys.append(self._part_key(name, tags))
            vals.append(float(value))
        n = self.sink.write(keys, now_ms, vals)
        self.scrapes += 1
        self.last_series = n
        dur = time.perf_counter() - t0
        registry.histogram("selfmon_scrape_seconds",
                           bounds=_SCRAPE_BOUNDS).record(dur)
        registry.gauge("selfmon_series").update(n)
        registry.counter("selfmon_samples").increment(n)
        self._job.set_progress(f"{n} series @ {now_ms}")
        return n
