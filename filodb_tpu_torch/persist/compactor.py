"""Segment compaction and retention (port of
filodb_tpu/persist/compactor.py): the background job that makes the
historical tier scan-fast.

Each pass walks every shard's persisted chunkset frames, groups them into
aligned time windows (`store.segment_window_ms`), and rewrites closed
windows (the window's end at least `closed_lag_ms` in the past, so late
flushes for it have landed) into columnar segments (persist/segments.py).
A window is (re)compacted when no segment covers it yet or when chunk
frames landed since its segment was written (`source_chunks` drift); an
existing segment is merged in, so frames retention already pruned are
never lost.  The segment bytes are the reference's for the same frames.

Retention: once a window is covered by a segment, raw chunk frames older
than `retain_raw_ms` are aged out of the chunk log
(LocalDiskColumnStore.prune_chunks_before), never a frame ingested after
the last compaction pass started.

CompactionScheduler runs compaction and retention on an interval as the
`compaction` job of utils/jobs.py.  With a SegmentUploader
(persist/objectstore.py) each pass uploads between compaction and
retention, and retention never prunes past a window whose covering
segment the shared tier has not acknowledged.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.schemas import Schemas, DEFAULT_SCHEMAS
from filodb_tpu_torch.memory.chunks import decode_chunkset
from filodb_tpu_torch.persist.segments import SegmentStore, encode_segment

_log = logging.getLogger("filodb.compactor")


class SegmentCompactor:
    """Rewrites flushed chunkset frames into columnar segments."""

    def __init__(self, column_store, segment_store: SegmentStore,
                 dataset: str, num_shards: int,
                 window_ms: int = 6 * 3600 * 1000,
                 closed_lag_ms: int = 60 * 60 * 1000,
                 schemas: Schemas = DEFAULT_SCHEMAS,
                 tier=None, uploader=None):
        self.column_store = column_store
        self.segment_store = segment_store
        self.dataset = dataset
        self.num_shards = num_shards
        self.window_ms = window_ms
        # a window is closed once its end is this far in the past — late
        # flushes for it have landed (>= the flush interval)
        self.closed_lag_ms = closed_lag_ms
        self.schemas = schemas
        self.tier = tier                 # PersistedTier (range invalidation)
        # SegmentUploader (persist/objectstore.py): when the shared cold
        # tier is configured, retention refuses to advance past windows
        # whose covering segment is not yet upload-acked
        self.uploader = uploader
        self.segments_written = 0
        self.windows_skipped = 0
        # per-shard wall time at which the last compaction pass STARTED:
        # retention may only prune frames ingested before it — a late
        # backfill frame flushed after the pass read the index is not in
        # any segment yet (the next pass recompacts via source_chunks
        # drift, then it becomes prunable)
        self._last_pass_start_ms: Dict[int, int] = {}

    # ---------------------------------------------------------- compaction

    def _frame_windows(self, shard: int
                       ) -> Dict[Tuple[str, int], Tuple[int, Dict[bytes,
                                                                  None]]]:
        """(schema_name, window_start) -> (frame count, ordered partition
        set), from ONE pass over the index metadata (no payload decode) —
        a per-window re-scan of the whole frame index would make a
        months-deep backlog sweep O(windows x frames)."""
        out: Dict[Tuple[str, int], Tuple[int, Dict[bytes, None]]] = {}
        for pk_bytes, ref in self.column_store.iter_chunk_refs(self.dataset,
                                                               shard):
            w0 = (ref.start_ms // self.window_ms) * self.window_ms
            # a chunk spanning windows is folded into EVERY window it
            # overlaps (clipped at decode), so coverage stays exact
            while w0 < ref.end_ms + 1:
                key = (ref.schema_name, w0)
                ent = out.get(key)
                if ent is None:
                    ent = out[key] = (0, {})
                out[key] = (ent[0] + 1, ent[1])
                ent[1][pk_bytes] = None
                w0 += self.window_ms
        return out

    def compact_shard(self, shard: int,
                      now_ms: Optional[int] = None) -> int:
        """Compact every closed, stale window of one shard; returns
        segments written."""
        if not hasattr(self.column_store, "iter_chunk_refs"):
            return 0                     # store without a frame index
        now_ms = now_ms if now_ms is not None else int(time.time() * 1000)
        self._last_pass_start_ms[shard] = int(time.time() * 1000)
        windows = self._frame_windows(shard)
        if not windows:
            return 0
        have = {(m.schema_name, m.start_ms): m
                for m in self.segment_store.list(self.dataset, shard)}
        written = 0
        for (schema_name, w0), (n_frames, pk_set) in sorted(
                windows.items(), key=lambda kv: kv[0][1]):
            w1 = w0 + self.window_ms
            if w1 > now_ms - self.closed_lag_ms:
                continue                 # window still open
            schema = self.schemas[schema_name]
            if any(c.col_type == "hist" for c in schema.data_columns):
                continue                 # hist schemas: chunk paging path
            seg = have.get((schema_name, w0))
            if seg is not None and seg.source_chunks == n_frames:
                self.windows_skipped += 1
                continue                 # covered and unchanged
            if self._compact_window(shard, schema_name, w0, w1, n_frames,
                                    list(pk_set), existing=seg):
                written += 1
        if written and self.tier is not None:
            self.tier.invalidate_range()
        return written

    def _compact_window(self, shard: int, schema_name: str, w0: int,
                        w1: int, n_frames: int,
                        pk_bytes_list: List[bytes],
                        existing=None) -> bool:
        """Decode every partition's chunks overlapping [w0, w1) into one
        rectangular [S, T] block and write the segment.  An `existing`
        segment for the window is MERGED in: retention may already have
        pruned the frames it was built from, so a rewrite driven by late
        frames must never rebuild from the surviving frames alone (that
        would silently drop the pruned history)."""
        schema = self.schemas[schema_name]
        col_names = [c.name for c in schema.data_columns]
        pks = [PartKey.from_bytes(b) for b in pk_bytes_list]
        # seed per-partition samples from the existing segment
        seeded: Dict[bytes, Tuple[np.ndarray, Dict[str, np.ndarray]]] = {}
        if existing is not None:
            try:
                hdr, seg_ts, seg_cols = self.segment_store.load(existing)
                for row, pkb in enumerate(hdr["pk_bytes"]):
                    n = int(hdr["counts"][row])
                    if n:
                        seeded[bytes(pkb)] = (
                            seg_ts[row, :n],
                            {k: v[row, :n] for k, v in seg_cols.items()})
            except (OSError, ValueError):
                seeded = {}             # unreadable: rebuild from frames
        pk_index = {pk.to_bytes(): pk for pk in pks}
        for pkb in seeded:
            if pkb not in pk_index:
                pk_index[pkb] = PartKey.from_bytes(pkb)
        requests = [(pk_index[pkb], w0, w1 - 1) for pkb in pk_index]
        per_part = self.column_store.read_chunks_multi(self.dataset, shard,
                                                       requests)
        series: List[Tuple[PartKey, np.ndarray, Dict[str, np.ndarray]]] = []
        for pkb, chunks in zip(list(pk_index), per_part):
            pk = pk_index[pkb]
            ts_parts, col_parts = [], []
            seed = seeded.get(pkb)
            if seed is not None:
                ts_parts.append(seed[0])
                col_parts.append(seed[1])
            for cs in sorted(chunks, key=lambda c: c.info.start_time_ms):
                decoded = decode_chunkset(cs)
                ts = decoded.pop("timestamp")
                keep = (ts >= w0) & (ts < w1)
                if not keep.any():
                    continue
                ts_parts.append(ts[keep])
                col_parts.append({k: v[keep] for k, v in decoded.items()})
            if not ts_parts:
                continue
            ts_all = np.concatenate(ts_parts)
            cols_all = {k: np.concatenate([cp.get(k, np.zeros(0))
                                           for cp in col_parts])
                        for k in col_names if k in col_parts[0]}
            # sort + dedupe on ts (idempotent frame rewrites, seed overlap)
            order = np.argsort(ts_all, kind="stable")
            ts_all = ts_all[order]
            uniq = np.ones(len(ts_all), dtype=bool)
            uniq[1:] = ts_all[1:] != ts_all[:-1]
            ts_all = ts_all[uniq]
            cols_all = {k: v[order][uniq] for k, v in cols_all.items()}
            series.append((pk, ts_all, cols_all))
        if not series:
            return False
        S = len(series)
        T = max(len(ts) for _, ts, _ in series)
        counts = np.asarray([len(ts) for _, ts, _ in series],
                            dtype=np.int32)
        ts_grid = np.zeros((S, T), dtype=np.int64)
        col_grids = {name: np.full((S, T), np.nan)
                     for name in series[0][2]}
        for i, (_, ts, cols) in enumerate(series):
            ts_grid[i, :len(ts)] = ts
            for name, v in cols.items():
                if name in col_grids:
                    col_grids[name][i, :len(v)] = v
        payload = encode_segment(schema_name, w0, w1,
                                 [pk for pk, _, _ in series], counts,
                                 ts_grid, col_grids,
                                 source_chunks=n_frames)
        self.segment_store.write(self.dataset, shard, schema_name, w0, w1,
                                 payload)
        self.segments_written += 1
        from filodb_tpu_torch.utils.metrics import registry
        registry.counter("segments_compacted",
                         dataset=self.dataset).increment()
        registry.counter("segment_samples_compacted",
                         dataset=self.dataset).increment(int(counts.sum()))
        return True

    def compact_all(self, now_ms: Optional[int] = None) -> int:
        return sum(self.compact_shard(s, now_ms)
                   for s in range(self.num_shards))

    # ----------------------------------------------------------- retention

    def enforce_retention(self, retain_raw_ms: int,
                          now_ms: Optional[int] = None) -> int:
        """Age raw chunk frames out of the chunk logs once (a) a covering
        segment exists and (b) they are older than `retain_raw_ms`.
        Returns frames pruned across shards."""
        if retain_raw_ms <= 0 or not hasattr(self.column_store,
                                             "prune_chunks_before"):
            return 0
        now_ms = now_ms if now_ms is not None else int(time.time() * 1000)
        pruned = 0
        for shard in range(self.num_shards):
            segs = self.segment_store.list(self.dataset, shard)
            if not segs:
                continue
            # contiguously-covered ceiling from the oldest segment up: a
            # frame is only prunable when a segment actually covers it
            segs.sort(key=lambda m: m.start_ms)
            ceil = segs[0].start_ms
            for m in segs:
                if m.start_ms <= ceil:
                    ceil = max(ceil, m.end_ms)
                else:
                    break               # coverage gap: stop
            cutoff = min(ceil, now_ms - retain_raw_ms)
            if cutoff <= segs[0].start_ms:
                continue
            # late-frame guard: never prune a frame ingested after the
            # last compact pass started — it may not be in a segment yet
            ingested_before = self._last_pass_start_ms.get(shard)
            if ingested_before is None:
                continue                # no compact pass yet this process
            if self.uploader is not None:
                # durability ordering: upload-acked windows only; a
                # window whose segment has not landed in the shared tier
                # keeps its raw frames (the gate journals
                # retention_blocked_on_upload when it holds back)
                cutoff = min(cutoff,
                             self.uploader.allowed_prune_cutoff(shard,
                                                                cutoff))
            n = self.column_store.prune_chunks_before(
                self.dataset, shard, cutoff,
                ingested_before_ms=ingested_before)
            pruned += n
            if n:
                from filodb_tpu_torch.utils.metrics import registry
                registry.counter("segment_retention_frames_pruned",
                                 dataset=self.dataset).increment(n)
        return pruned


class CompactionScheduler:
    """Daemon thread running compaction + retention on an interval — the
    flush-scheduler shape, with the same loud-error stance."""

    def __init__(self, compactor: SegmentCompactor, interval_s: float,
                 retain_raw_ms: int = 0, uploader=None):
        self.compactor = compactor
        self.interval_s = interval_s
        self.retain_raw_ms = retain_raw_ms
        # shared-tier uploads ride the compaction pass, between compact
        # and retention: upload before prune is the durability ordering
        self.uploader = uploader
        if uploader is not None and compactor.uploader is None:
            compactor.uploader = uploader
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.passes = 0
        self.errors = 0
        from filodb_tpu_torch.utils.jobs import jobs
        self.job = jobs.register("compaction", interval_s=interval_s,
                                 dataset=compactor.dataset)

    def start(self) -> "CompactionScheduler":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"compactor-{self.compactor.dataset}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def run_once(self) -> int:
        with self.job.tick():
            self.job.set_progress("compacting")
            n = self.compactor.compact_all()
            if self.uploader is not None:
                self.job.set_progress("uploading")
                self.uploader.run_once()
            pruned = 0
            if self.retain_raw_ms > 0:
                self.job.set_progress("retention")
                pruned = self.compactor.enforce_retention(
                    self.retain_raw_ms)
            self.passes += 1
            self.job.set_progress(
                f"pass {self.passes}: {n} segment(s), "
                f"{pruned} frame(s) pruned")
        if n or pruned:
            from filodb_tpu_torch.utils.events import journal
            journal.emit("compaction_run", subsystem="compaction",
                         dataset=self.compactor.dataset,
                         segments_written=n, frames_pruned=pruned)
        return n

    def _run(self) -> None:
        from filodb_tpu_torch.utils.metrics import registry
        while not self._stop.is_set():
            self._stop.wait(self.interval_s)
            if self._stop.is_set():
                return
            try:
                self.run_once()
            except Exception:  # noqa: BLE001 — keep the loop alive
                self.errors += 1
                registry.counter(
                    "compaction_errors",
                    dataset=self.compactor.dataset).increment()
                _log.exception("compaction pass failed dataset=%s",
                               self.compactor.dataset)
