"""Background flush scheduling, ingest/persist overlap (port of
filodb_tpu/core/flush.py; a background pass batches small partitions at
the shard's `store.min_flush_samples`, read at each flush).

The reference drives flushes from a dedicated stream: each shard cycles
through its flush groups on a timer, sealing write buffers and persisting
chunks while ingest continues on other groups (ref:
core/.../memstore/TimeSeriesShard.scala createFlushTask / prepareFlushGroup,
doc/ingestion.md flush-interval semantics).  This keeps the same shape:
a daemon thread rotates groups round-robin so each group flushes once
per `interval_s`, and every flush serializes with ingest via the shard's
write_lock while queries keep reading through the seqlock.

The same thread doubles as the headroom task (ref:
TimeSeriesShard.startHeadroomTask:1665): after each full rotation it runs
enforce_memory() so dense-tier pressure is relieved without a caller having
to remember to.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional

_log = logging.getLogger("filodb.flush")


class FlushScheduler:
    """Rotates flush groups of every shard of a dataset on a timer.

    Failure domain: a shard whose flushes keep failing (store
    down, disk full) backs off EXPONENTIALLY — base one tick, doubling
    per consecutive error up to `backoff_max_s` — instead of hammering
    the broken store at full tick rate forever; the first success
    resets it.  Observable at /metrics: `flush_errors` (per shard) and
    the `flush_backoff_active` gauge (shards currently backing off) —
    previously `self.errors` was only an attribute nobody exported."""

    def __init__(self, memstore, dataset: str, interval_s: float = 60.0,
                 headroom: bool = True, backoff_max_s: Optional[float] = None,
                 wal=None):
        self.memstore = memstore
        self.dataset = dataset
        self.interval_s = interval_s
        self.headroom = headroom
        self.backoff_max_s = (8 * interval_s if backoff_max_s is None
                              else backoff_max_s)
        # WAL manager (wal/WalManager) to report persisted append
        # horizons to after each full rotation: every group checkpoint
        # of a shard at or past offset X means all its WAL records with
        # seq <= X are in the column store, so segments wholly below the
        # min across shards are tombstoned (doc/operations.md WAL
        # runbook).  None when the dataset is not WAL-fronted.
        self.wal = wal
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.flushes = 0
        self.errors = 0
        # per-shard consecutive-failure streaks and monotonic backoff
        # horizons (only the flush thread touches them)
        self._err_streak: Dict[int, int] = {}
        self._backoff_until: Dict[int, float] = {}
        # unified job registry (utils/jobs): last tick / duration / lag /
        # error streak at GET /admin/jobs; critical — a flush scheduler
        # failing across shards flips /ready (data is not persisting)
        from filodb_tpu_torch.utils.jobs import jobs
        self.job = jobs.register("flush", interval_s=interval_s,
                                 dataset=dataset, critical=True)

    # ------------------------------------------------------------------ control

    def start(self) -> "FlushScheduler":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"flush-{self.dataset}")
        self._thread.start()
        return self

    def stop(self, final_flush: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        if final_flush:
            for shard in self.memstore.shards_for(self.dataset):
                try:
                    shard.flush_all_groups()
                except Exception:  # noqa: BLE001
                    _log.exception("final flush failed shard=%d",
                                   shard.shard_num)

    # ------------------------------------------------------------------- loop

    def _note_flush_error(self, shard, tick: float) -> None:
        from filodb_tpu_torch.utils.metrics import registry
        self.errors += 1
        registry.counter("flush_errors", dataset=self.dataset,
                         shard=str(shard.shard_num)).increment()
        streak = self._err_streak.get(shard.shard_num, 0) + 1
        self._err_streak[shard.shard_num] = streak
        # exponential: one tick after the first failure, doubling per
        # consecutive failure, capped so a recovered store is retried
        # within a bounded window
        delay = min(max(tick, 0.01) * (2 ** (streak - 1)),
                    self.backoff_max_s)
        self._backoff_until[shard.shard_num] = time.monotonic() + delay
        registry.gauge("flush_backoff_active", dataset=self.dataset
                       ).update(len(self._backoff_until))
        if streak == 1:
            # journal the ok->backing-off edge only (a broken store must
            # not flood the flight recorder once per tick)
            from filodb_tpu_torch.utils.events import journal
            journal.emit("flush_backoff", subsystem="flush",
                         dataset=self.dataset, shard=shard.shard_num,
                         delay_s=round(delay, 3))

    def _note_flush_ok(self, shard) -> None:
        if self._err_streak.pop(shard.shard_num, None) is not None:
            from filodb_tpu_torch.utils.metrics import registry
            self._backoff_until.pop(shard.shard_num, None)
            registry.gauge("flush_backoff_active", dataset=self.dataset
                           ).update(len(self._backoff_until))

    def _run(self) -> None:
        group = 0
        while not self._stop.is_set():
            shards = self.memstore.shards_for(self.dataset)
            live = {s.shard_num for s in shards}
            stale = [sn for sn in (self._backoff_until.keys()
                                   | self._err_streak.keys())
                     if sn not in live]
            if stale:
                # a shard torn down / reassigned away mid-backoff must
                # not count in flush_backoff_active forever
                from filodb_tpu_torch.utils.metrics import registry
                for sn in stale:
                    self._backoff_until.pop(sn, None)
                    self._err_streak.pop(sn, None)
                registry.gauge("flush_backoff_active", dataset=self.dataset
                               ).update(len(self._backoff_until))
            n_groups = max((s._groups for s in shards), default=1)
            # one group per tick across all shards -> every group flushes
            # once per interval_s, like the reference's flush stream
            tick = self.interval_s / max(n_groups, 1)
            # per-pass job accounting: a pass is one group across every
            # shard, so the declared schedule the lag histogram measures
            # against is the per-group tick, not the full rotation
            self.job.interval_s = tick
            with self.job.tick() as jt:
                self.job.set_progress(
                    f"group {group + 1}/{n_groups}, "
                    f"{len(shards)} shard(s)")
                wrote = 0
                for shard in shards:
                    if self._stop.is_set():
                        return
                    until = self._backoff_until.get(shard.shard_num)
                    if until is not None and time.monotonic() < until:
                        continue        # shard backing off after errors
                    try:
                        if group < shard._groups:
                            # background flushes batch small partitions
                            # (the write-buffer behavior); direct flush
                            # calls seal all
                            wrote += shard.flush_group(
                                group, min_samples=shard.config.store
                                .min_flush_samples)
                            self.flushes += 1
                            self._note_flush_ok(shard)
                    except Exception as e:  # noqa: BLE001
                        self._note_flush_error(shard, tick)
                        self.job.note_error(e)
                        _log.exception(
                            "background flush failed shard=%d group=%d "
                            "(streak=%d, backing off)",
                            shard.shard_num, group,
                            self._err_streak[shard.shard_num])
                if wrote == 0:
                    # a pass that PERSISTED nothing is NEUTRAL for the
                    # job streak: empty groups and backed-off shards
                    # prove nothing about the store, and counting them
                    # as successes would reset the consecutive-error
                    # streak while persists are still failing — the
                    # /ready flip for a broken store could never engage
                    # (per-shard streaks/backoff are tracked separately
                    # above and unaffected)
                    jt.skip()
            group += 1
            if group >= n_groups:
                group = 0
                if self.headroom:
                    for shard in shards:
                        try:
                            shard.enforce_memory()
                        except Exception:  # noqa: BLE001
                            self.errors += 1
                            _log.exception("headroom task failed shard=%d",
                                           shard.shard_num)
                if self.wal is not None:
                    self._report_wal_horizons(shards)
            self._stop.wait(tick)

    def _report_wal_horizons(self, shards) -> None:
        """After a full rotation every group has had a flush pass: report
        each shard's persisted horizon (min over its group checkpoints —
        the only offset every group's data is guaranteed on disk past)
        so the WAL can tombstone fully-covered segments."""
        for shard in shards:
            try:
                horizon = shard.meta_store.read_earliest_checkpoint(
                    self.dataset, shard.shard_num)
                if horizon >= 0:
                    self.wal.note_persisted(shard.shard_num, horizon)
            except Exception:  # noqa: BLE001 — pruning is best-effort;
                _log.exception("WAL horizon report failed shard=%d",
                               shard.shard_num)
