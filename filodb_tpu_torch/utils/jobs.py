"""Unified background-job registry — one answer to "what is this node
doing, and is any of it wedged?" (port of filodb_tpu/utils/jobs.py, a
JAX-free copy).

The reference grew a fleet of recurring workers — the flush scheduler, the WAL
group committer, the segment compactor/retention pass, ruler group
runners, device-mirror background rebuilds, the trace exporter, the
self-scrape loop — each with its own scattered counters and no common
place an operator (or the health evaluator) can ask for last-run /
duration / error-streak state.  The reference ships exactly this surface
as its shard-status admin (ref: HealthRoute.scala / ClusterApiRoute.scala);
Prometheus exposes the analogue per-scrape-loop and per-rule-group.

Every worker registers a `JobHandle` and reports ticks through it:

  * `with handle.tick(): ...` — records start/end, feeds the
    `job_duration_seconds{job,dataset}` histogram, tracks lag vs the
    declared schedule (`job_lag_seconds`: gap between consecutive starts
    minus the interval — a starving scheduler shows here long before it
    misses anything visibly), and maintains the consecutive-error
    streak.  An exception escaping the tick marks it failed and
    re-raises; a loop that catches internally calls `note_error`
    mid-tick (or standalone) instead.
  * `handle.set_progress("shard 3/8")` — a human-readable string for
    the current position, shown at GET /admin/jobs.

Registry metrics (`job_runs_total`, `job_errors_total`,
`job_consecutive_errors` gauge) make every job alertable via the
self-scrape loop (utils/selfmon.py) — the shipped example alert group
fires on `job_consecutive_errors >= N`.  The registry itself is bounded
(MAX_JOBS): a pathological caller minting job names cannot grow it (or
the metric registry's tag space) without bound — overflow handles work
but are not retained or exported.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

# seconds-scale duration/lag bounds (the registry default histogram is
# tuned for millisecond latencies; background jobs run for seconds)
_SECONDS_BOUNDS = (0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 2.5,
                   5.0, 10.0, 30.0, 60.0, 300.0, 1800.0)


class JobHandle:
    """One recurring worker's observable state.  Thread-safe: ticks and
    snapshots may race (the flush thread ticks while an HTTP scrape
    snapshots)."""

    def __init__(self, name: str, interval_s: float = 0.0,
                 dataset: str = "", critical: bool = False,
                 exported: bool = True):
        self.name = name
        self.dataset = dataset
        # False for registry-overflow handles: state still tracks, but
        # no per-job metric tags are minted (hostile name churn must not
        # grow the metric registry either)
        self.exported = exported
        # declared schedule; 0 = event-driven (no lag accounting)
        self.interval_s = float(interval_s)
        # critical jobs failing (streak >= failed_streak) flip /ready to
        # 503 — the flush scheduler and WAL committer qualify; a broken
        # trace exporter does not
        self.critical = bool(critical)
        # error streak at or past this = the health verdict "failed"
        # (below it but nonzero = "degraded")
        self.failed_streak = 5
        self._lock = threading.Lock()
        self.runs = 0
        self.errors = 0
        self.consecutive_errors = 0
        self.last_start_unix_s = 0.0
        self.last_end_unix_s = 0.0
        self.last_duration_s = 0.0
        self.last_error = ""
        self.last_error_unix_s = 0.0
        self.progress = ""
        self.running = False

    # ------------------------------------------------------------- ticks

    def tick(self) -> "_Tick":
        return _Tick(self)

    def note_ok(self, duration_s: Optional[float] = None) -> None:
        """Event-driven success (jobs without a tick scope, e.g. one WAL
        group commit)."""
        now = time.time()
        with self._lock:
            self.runs += 1
            self.consecutive_errors = 0
            self.last_end_unix_s = now
            if duration_s is not None:
                self.last_duration_s = duration_s
        self._export(duration_s)

    def note_error(self, err, duration_s: Optional[float] = None) -> None:
        """One failed run (standalone, or mid-tick from a loop that
        catches its own exceptions — the enclosing tick then reports
        failed without double-counting)."""
        from filodb_tpu_torch.utils.metrics import registry
        now = time.time()
        with self._lock:
            self.runs += 1
            self.errors += 1
            self.consecutive_errors += 1
            self.last_error = f"{err}"[:300]
            self.last_error_unix_s = now
            self.last_end_unix_s = now
            if duration_s is not None:
                self.last_duration_s = duration_s
            streak = self.consecutive_errors
        if self.exported:
            registry.counter("job_errors", **self._tags()).increment()
        self._export(duration_s)
        if streak == self.failed_streak:
            # one journal entry at the ok->failed edge (not per error:
            # a wedged job must not flood the flight recorder)
            from filodb_tpu_torch.utils.events import journal
            journal.emit("job_failed", subsystem="jobs", job=self.name,
                         dataset=self.dataset, streak=streak,
                         error=self.last_error)

    def set_progress(self, text: str) -> None:
        self.progress = str(text)[:200]

    def _tags(self) -> Dict[str, str]:
        tags = {"job": self.name}
        if self.dataset:
            tags["dataset"] = self.dataset
        return tags

    def _export(self, duration_s: Optional[float]) -> None:
        if not self.exported:
            return
        from filodb_tpu_torch.utils.metrics import registry
        tags = self._tags()
        registry.counter("job_runs", **tags).increment()
        registry.gauge("job_consecutive_errors", **tags).update(
            self.consecutive_errors)
        if duration_s is not None:
            registry.histogram("job_duration_seconds",
                               bounds=_SECONDS_BOUNDS,
                               **tags).record(duration_s)

    def _note_lag(self, start_unix_s: float) -> None:
        from filodb_tpu_torch.utils.metrics import registry
        if not self.exported or self.interval_s <= 0 \
                or self.last_start_unix_s <= 0:
            return
        lag = (start_unix_s - self.last_start_unix_s) - self.interval_s
        registry.histogram("job_lag_seconds", bounds=_SECONDS_BOUNDS,
                           **self._tags()).record(max(lag, 0.0))

    # ---------------------------------------------------------- snapshot

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "job": self.name,
                "dataset": self.dataset,
                "intervalSeconds": self.interval_s,
                "critical": self.critical,
                "running": self.running,
                "runs": self.runs,
                "errors": self.errors,
                "consecutiveErrors": self.consecutive_errors,
                "failedStreak": self.failed_streak,
                "lastStartUnixSeconds": round(self.last_start_unix_s, 3),
                "lastEndUnixSeconds": round(self.last_end_unix_s, 3),
                "lastDurationSeconds": round(self.last_duration_s, 6),
                "lastError": self.last_error,
                "progress": self.progress,
            }


class _Tick:
    """One run of a job: duration + lag + streak accounting.  Exceptions
    re-raise after being recorded; `note_error` calls inside the scope
    mark the tick failed without double-counting the run; `skip()` makes
    the tick NEUTRAL — neither a run nor a streak reset."""

    def __init__(self, handle: JobHandle):
        self.handle = handle
        self._skipped = False

    def skip(self) -> None:
        """This tick attempted no work (every target was in backoff,
        nothing to do after an error): complete neutrally.  Without
        this, a loop whose only failing target is backing off would
        record empty passes as successes and reset the consecutive-
        error streak the health verdict depends on — a permanently
        broken critical job could never flip /ready."""
        self._skipped = True

    def __enter__(self):
        h = self.handle
        now = time.time()
        h._note_lag(now)
        self._errors0 = h.errors
        self._t0 = time.perf_counter()
        with h._lock:
            h.last_start_unix_s = now
            h.running = True
        return self

    def __exit__(self, exc_type, exc, tb):
        h = self.handle
        dur = time.perf_counter() - self._t0
        failed_inside = h.errors > self._errors0
        with h._lock:
            h.running = False
        if exc is not None:
            h.note_error(exc, duration_s=dur)
        elif failed_inside or self._skipped:
            # failed: note_error already counted the run.  skipped:
            # neutral — record the timing, leave runs/streak untouched
            with h._lock:
                h.last_duration_s = dur
                h.last_end_unix_s = time.time()
        else:
            h.note_ok(duration_s=dur)
        return False


class JobRegistry:
    """Process-wide registry keyed by (name, dataset).  Bounded: past
    MAX_JOBS, register() returns a working but UNRETAINED handle (and
    counts the overflow) so hostile/buggy name churn can neither grow
    this table nor the metric registry's tag space without bound."""

    MAX_JOBS = 256

    def __init__(self):
        self._lock = threading.Lock()
        self._jobs: Dict[Tuple[str, str], JobHandle] = {}

    def register(self, name: str, interval_s: float = 0.0,
                 dataset: str = "", critical: bool = False) -> JobHandle:
        key = (name, dataset)
        with self._lock:
            h = self._jobs.get(key)
            if h is not None:
                # re-registration (scheduler restart, ruler reload):
                # same handle, refreshed schedule — history carries over
                h.interval_s = float(interval_s) or h.interval_s
                h.critical = h.critical or critical
                return h
            retained = len(self._jobs) < self.MAX_JOBS
            h = JobHandle(name, interval_s, dataset, critical,
                          exported=retained)
            if retained:
                self._jobs[key] = h
            else:
                from filodb_tpu_torch.utils.metrics import registry
                registry.counter("job_registry_overflow").increment()
        return h

    def unregister(self, name: str, dataset: str = "") -> None:
        with self._lock:
            self._jobs.pop((name, dataset), None)

    def get(self, name: str, dataset: str = "") -> Optional[JobHandle]:
        with self._lock:
            return self._jobs.get((name, dataset))

    def clear(self) -> None:
        with self._lock:
            self._jobs.clear()

    def snapshot(self) -> List[dict]:
        with self._lock:
            handles = list(self._jobs.values())
        out = [h.snapshot() for h in handles]
        out.sort(key=lambda j: (j["job"], j["dataset"]))
        return out


# process-wide instance (schedulers, the health evaluator, and the
# /admin/jobs route share it — like metrics.registry and usage.usage)
jobs = JobRegistry()
