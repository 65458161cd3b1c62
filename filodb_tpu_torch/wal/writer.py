"""Group-committed WAL writer: append, wait for the fsync, get the ack
(port of filodb_tpu/wal/writer.py).

The commit protocol (ref: the group-commit design every durable log
converges on — Kafka's log flush, Postgres WAL, Gorilla §4.2):

  * `append(body)` assigns the next sequence number, frames the record
    (snappy + CRC32, wal/segment.py) and buffers it into the ACTIVE
    segment file under the append lock — cheap, no I/O wait.
  * a single committer thread flushes + fsyncs whenever uncommitted
    appends exist; every writer blocked in `wait_committed` for a seq at
    or below the committed watermark is released together — one fsync
    acknowledges the whole group.  Writers that arrive while an fsync is
    in flight batch into the next one automatically, so concurrency
    amortizes fsyncs without any added latency knob.
  * `commit_interval_ms > 0` additionally SPACES fsyncs: the committer
    sleeps the remainder of the interval after each commit unless
    `commit_bytes` of uncommitted appends force an early one — fewer,
    bigger commits, at the cost of up to one interval of ack latency.

Segments rotate once the active file passes `segment_max_bytes`
(checked at commit, so one commit group never spans a rotation
boundary's fsync ordering).  `prune(horizon_seq)` unlinks every sealed
segment whose LAST record is at or below the horizon — the flush
scheduler reports the persisted horizon (min over shards of their
checkpoint offsets) and tombstoned segments disappear.

A group-commit FAILURE (disk full, injected wal.fsync fault) fails every
writer waiting on that group: their data's durability cannot be claimed,
so their acks must not happen.
"""
from __future__ import annotations

import logging
import os
import threading
from typing import List, Optional, Tuple

from filodb_tpu_torch.utils.faults import faults
from filodb_tpu_torch.utils.metrics import registry as metrics_registry
from filodb_tpu_torch.utils.metrics import span as metrics_span
from filodb_tpu_torch.wal.segment import (frame_record, list_segments,
                                          read_records, segment_path,
                                          write_segment_header, WalRecord)

_log = logging.getLogger("filodb.wal")


class WalWriteError(IOError):
    """Group commit failed — the append was NOT made durable."""


class WalWriter:

    def __init__(self, dir_path: str, dataset: str = "",
                 commit_interval_ms: float = 0.0,
                 commit_bytes: int = 1 << 20,
                 segment_max_bytes: int = 64 << 20,
                 fsync: bool = True, start_seq: int = 0):
        self.dir = dir_path
        self.dataset = dataset
        self.commit_interval_s = max(commit_interval_ms, 0.0) / 1000.0
        self.commit_bytes = commit_bytes
        self.segment_max_bytes = segment_max_bytes
        self.fsync = fsync
        os.makedirs(dir_path, exist_ok=True)
        # seq of the NEXT append; callers recovering an existing log pass
        # start_seq = last replayed seq + 1
        self._next_seq = start_seq
        self._written_seq = start_seq - 1     # newest buffered append
        self._committed_seq = start_seq - 1   # newest DURABLE append
        # highest seq whose group commit FAILED: acks at or below it are
        # permanently withheld (monotone — even if a later commit lands
        # the same bytes, the writer that observed no ack must re-send;
        # replay dedup makes the re-send harmless)
        self._failed_through = start_seq - 1
        self._pending_bytes = 0
        # RLock: the committer notifies the condition (same lock) while
        # still inside its locked commit section
        self._lock = threading.RLock()
        self._commit_cv = threading.Condition(self._lock)
        self._work = threading.Event()
        self._stop = threading.Event()
        # sealed segments: (first_seq, last_seq, path); the active segment
        # is rotated into this list at commit time
        self._sealed: List[Tuple[int, int, str]] = []
        self._active_first = self._next_seq
        self._active_last = self._next_seq - 1
        # key-table hashes already written INLINE into the active
        # segment (cleared at rotation: every segment self-contained)
        self._seg_tables: set = set()
        self._file = self._open_segment(self._active_first)
        # unified job registry: the committer is the durability heart —
        # a failing group commit means acks are being withheld, so it is
        # critical for the readiness verdict (utils/health.py)
        from filodb_tpu_torch.utils.jobs import jobs
        self.job = jobs.register("wal_commit", dataset=dataset,
                                 critical=True)
        self._committer = threading.Thread(
            target=self._run_committer, daemon=True,
            name=f"wal-commit-{dataset or os.path.basename(dir_path)}")
        self._committer.start()

    # ------------------------------------------------------------- append

    def append_record(self, rec: WalRecord) -> int:
        """Assign rec.seq, buffer the framed record, return the seq
        WITHOUT waiting for durability (callers batch several appends,
        then `wait_committed` once for the last seq)."""
        faults.fire("wal.append")
        # write-path trace: one span per buffered append (encode + frame
        # + buffer write; the fsync is the committer's and shows up as
        # the caller's wal_commit_wait span instead)
        with metrics_span("wal_append", dataset=self.dataset):
            return self._append_record(rec)

    def _append_record(self, rec: WalRecord) -> int:
        from filodb_tpu_torch.wal.segment import (TABLE_INLINE, TABLE_REF,
                                                  key_table_entry)
        # blob+hash come from the identity memo OUTSIDE the lock (the
        # only per-series work on this path)
        blob, h = key_table_entry(rec.part_keys)
        with self._lock:
            if self._stop.is_set():
                raise WalWriteError("WAL writer is closed")
            rec.seq = self._next_seq
            self._next_seq += 1
            # within-segment key-table interning: the steady scrape
            # stream writes its series table once per segment, then
            # 9-byte references — not a multi-MB copy per append
            mode = TABLE_REF if h in self._seg_tables else TABLE_INLINE
            body = rec.encode(table=(mode, blob, h))
            frame = frame_record(body)
            self._file.write(frame)
            if mode == TABLE_INLINE:
                self._seg_tables.add(h)
            self._written_seq = rec.seq
            self._active_last = rec.seq
            self._pending_bytes += len(frame)
        self._work.set()
        metrics_registry.counter("wal_appends",
                                 dataset=self.dataset).increment()
        metrics_registry.counter("wal_append_bytes",
                                 dataset=self.dataset).increment(len(frame))
        return rec.seq

    def append(self, rec: WalRecord) -> int:
        """append_record + wait for its group commit (the common path)."""
        seq = self.append_record(rec)
        self.wait_committed(seq)
        return seq

    def wait_committed(self, seq: int, timeout_s: float = 30.0) -> None:
        """Block until `seq` is durable; WalWriteError if its group's
        commit failed or the wait times out (a wedged disk must surface
        as a failed ack, not an ingest hang)."""
        # the group-commit fsync wait: THE write-path latency suspect,
        # so it gets its own span (stitches under the batch's trace) on
        # top of the committer's wal_fsync_seconds histogram
        with metrics_span("wal_commit_wait", dataset=self.dataset):
            self._wait_committed(seq, timeout_s)

    def _wait_committed(self, seq: int, timeout_s: float = 30.0) -> None:
        with self._commit_cv:
            ok = self._commit_cv.wait_for(
                lambda: self._committed_seq >= seq
                or self._failed_through >= seq
                or self._stop.is_set(),
                timeout=timeout_s)
            # failure wins over a later successful re-commit of the same
            # bytes: once a group's fsync failed, its acks are withheld
            # deterministically (the client re-sends; dedup absorbs it)
            if self._failed_through >= seq:
                raise WalWriteError(
                    f"WAL group commit failed at or before seq {seq} — "
                    "append not durable, ack withheld")
            if self._committed_seq >= seq:
                return
            if not ok:
                raise WalWriteError(
                    f"WAL commit wait timed out after {timeout_s}s "
                    f"(seq {seq}, committed {self._committed_seq})")
            raise WalWriteError(
                f"WAL writer closed before seq {seq} committed")

    @property
    def committed_seq(self) -> int:
        return self._committed_seq

    @property
    def next_seq(self) -> int:
        return self._next_seq

    # -------------------------------------------------------------- commit

    def _open_segment(self, first_seq: int):
        path = segment_path(self.dir, first_seq)
        f = open(path, "ab", buffering=1 << 20)
        if f.tell() == 0:
            write_segment_header(f)
            # header lands immediately: replay may scan the directory
            # while this (still-empty) segment is active, and a
            # buffered-only header would read as a corrupt file
            f.flush()
        return f

    def _run_committer(self) -> None:
        while True:
            self._work.wait(timeout=0.25)
            self._work.clear()
            if self._stop.is_set():
                with self._lock:
                    dirty = self._written_seq > self._committed_seq
                if dirty:
                    self._commit_once()      # drain on close
                return
            with self._lock:
                dirty = self._written_seq > self._committed_seq
            if not dirty:
                continue
            self._commit_once()
            if self.commit_interval_s > 0:
                # pacing: space fsyncs unless enough bytes pile up
                waited = 0.0
                step = min(self.commit_interval_s, 0.005)
                while waited < self.commit_interval_s \
                        and not self._stop.is_set():
                    with self._lock:
                        if self._pending_bytes >= self.commit_bytes:
                            break
                    self._stop.wait(step)
                    waited += step

    def _commit_once(self) -> None:
        """One group commit.  The flush+fsync runs OUTSIDE the append
        lock: concurrent appenders keep buffering into the (internally
        thread-safe) BufferedWriter while the fsync is in flight and
        batch into the next commit — holding the lock here would
        serialize every append behind the disk.  The batch watermark is
        snapshotted first, so the fsync provably covers it; later
        appends riding the same fsync are simply committed early by the
        next round."""
        import time as _time
        with self._lock:
            batch_end = self._written_seq
            if batch_end <= self._committed_seq:
                return
            f = self._file
        try:
            # the fault point sits INSIDE the timed window: an injected
            # wal.fsync delay must show in the fsync-latency histogram
            # exactly like a real disk stall would
            t0 = _time.perf_counter()
            faults.fire("wal.fsync")
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
            fsync_s = _time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — disk/injected failure
            with self._lock:
                # every writer in the group must see the failure: their
                # appends may or may not be on disk, so no ack
                self._failed_through = max(self._failed_through, batch_end)
                with self._commit_cv:
                    self._commit_cv.notify_all()
            metrics_registry.counter(
                "wal_commit_errors", dataset=self.dataset).increment()
            self.job.note_error(e)
            from filodb_tpu_torch.utils.events import journal
            journal.emit("wal_commit_failed", subsystem="wal",
                         dataset=self.dataset,
                         first_seq=self._committed_seq + 1,
                         last_seq=batch_end, error=f"{e}")
            _log.error("WAL group commit failed (seqs %d..%d): %s",
                       self._committed_seq + 1, batch_end, e)
            return
        with self._lock:
            self._committed_seq = max(self._committed_seq, batch_end)
            self._pending_bytes = 0
            # rotate only when the active segment is FULLY committed —
            # an append that raced the fsync stays in the current
            # segment and the next commit covers (and may rotate) it
            if (self._file is f
                    and self._committed_seq >= self._active_last
                    and self._active_last >= self._active_first
                    and f.tell() >= self.segment_max_bytes):
                f.close()
                self._sealed.append((
                    self._active_first, self._active_last,
                    segment_path(self.dir, self._active_first)))
                self._active_first = self._committed_seq + 1
                self._active_last = self._committed_seq
                self._seg_tables = set()
                self._file = self._open_segment(self._active_first)
                metrics_registry.counter(
                    "wal_segment_rotations", dataset=self.dataset
                ).increment()
                from filodb_tpu_torch.utils.events import journal
                journal.emit("wal_segment_rotated", subsystem="wal",
                             dataset=self.dataset,
                             sealed_first_seq=self._sealed[-1][0],
                             sealed_last_seq=self._sealed[-1][1],
                             sealed_segments=len(self._sealed))
            with self._commit_cv:
                self._commit_cv.notify_all()
        metrics_registry.counter("wal_commits",
                                 dataset=self.dataset).increment()
        metrics_registry.histogram("wal_fsync_seconds",
                                   dataset=self.dataset).record(fsync_s)
        self.job.note_ok(duration_s=fsync_s)

    # --------------------------------------------------------------- prune

    def prune(self, horizon_seq: int) -> int:
        """Unlink sealed segments whose last record <= horizon_seq (the
        flush-reported persisted horizon).  Returns segments removed."""
        removed = 0
        with self._lock:
            keep = []
            for first, last, path in self._sealed:
                if last <= horizon_seq:
                    try:
                        os.unlink(path)
                        removed += 1
                    except OSError as e:
                        _log.warning("WAL prune failed for %s: %s", path, e)
                        keep.append((first, last, path))
                else:
                    keep.append((first, last, path))
            self._sealed = keep
        if removed:
            metrics_registry.counter("wal_segments_pruned",
                                     dataset=self.dataset).increment(removed)
            from filodb_tpu_torch.utils.events import journal
            journal.emit("wal_segments_pruned", subsystem="wal",
                         dataset=self.dataset, removed=removed,
                         horizon_seq=horizon_seq)
        return removed

    def segment_count(self) -> int:
        with self._lock:
            return len(self._sealed) + 1

    def snapshot_segments(self) -> Tuple[List[Tuple[int, int, str, int]], int]:
        """Read snapshot for replication catch-up streaming
        (replication/service.py `fetch_wal`): ([(first_seq, last_seq,
        path, safe_bytes)], committed_seq).  The active segment's
        buffered frames are flushed to the OS first — appends hold the
        same lock, so every frame within `safe_bytes` is whole (a
        reader must still stop at `safe_bytes`: bytes past it may be a
        frame mid-write).  Records past `committed_seq` may ride along;
        they were never acknowledged, and the replica's replay is
        idempotent either way."""
        with self._lock:
            try:
                self._file.flush()
            except (OSError, ValueError):
                pass
            out = []
            for first, last, path in self._sealed:
                try:
                    out.append((first, last, path, os.path.getsize(path)))
                except OSError:
                    continue             # pruned underneath us
            if self._active_last >= self._active_first:
                out.append((self._active_first, self._active_last,
                            segment_path(self.dir, self._active_first),
                            self._file.tell()))
            return out, self._committed_seq

    # --------------------------------------------------------------- close

    def close(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        self._work.set()
        self._committer.join(timeout=10)
        with self._lock:
            try:
                self._file.flush()
                if self.fsync:
                    os.fsync(self._file.fileno())
            except Exception:  # noqa: BLE001 — closing best-effort drain
                pass
            self._file.close()
        with self._commit_cv:
            self._commit_cv.notify_all()


def recover_writer_state(dir_path: str):
    """Scan an existing WAL directory -> (next_seq, sealed_segments) so a
    restarted writer continues the sequence instead of reusing seqs (a
    reused seq would defeat replay idempotence ordering).  Decodes only
    the record headers' seq field implicitly via full decode — restart is
    off the hot path.  Existing segments are treated as sealed (the new
    writer opens a fresh segment past them) so prune can reclaim them."""
    next_seq = 0
    sealed: List[Tuple[int, int, str]] = []
    for first, path in list_segments(dir_path):
        last = first - 1
        tables: dict = {}
        try:
            for body in read_records(path):
                last = max(last, WalRecord.decode(body, tables).seq)
        except Exception:  # noqa: BLE001 — replay handles/reports corruption
            pass
        if last < first:
            # header-only or torn-first-record segment: nothing in it was
            # ever acknowledged (acks wait for a complete fsynced frame),
            # and keeping it would collide with the restarted writer's
            # fresh active segment at the same first_seq
            try:
                os.unlink(path)
            except OSError:
                pass
            continue
        sealed.append((first, last, path))
        next_seq = max(next_seq, last + 1)
    return next_seq, sealed
