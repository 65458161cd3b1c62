"""DenseSeriesStore — the TPU-native working set for one (shard, schema).

The reference keeps per-partition append buffers + immutable encoded chunks in
off-heap block memory (ref: core/.../memstore/TimeSeriesPartition.scala:137-165,
memory/.../BlockManager.scala).  TPUs want dense vectorized math over large
arrays, so the rebuild keeps the query-hot working set as ONE dense
[series, time] SoA matrix per schema per shard (SURVEY.md section 7 step 1-2):

  ts      int64  [S_cap, T_cap]   sample timestamps (ms), per-series prefix-packed
  col[x]  f64    [S_cap, T_cap]   values (or [S_cap, T_cap, B] for histograms)
  counts  int32  [S_cap]          valid samples per series

Appends are vectorized scatter writes; queries hand full rows to the device
kernels which do window masking/searchsorted on-TPU.  Encoded chunks are
produced at flush boundaries for persistence only (memory/chunks.py).
Eviction drops the oldest samples per series in bulk (the BlockManager
time-ordered reclaim analogue, ref: BlockManager.scala:16 reclaim ordering).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from filodb_tpu_torch.core.schemas import Schema

_PAD_TS = np.iinfo(np.int64).max
_NEG_TS = np.iinfo(np.int64).min


class _MutationToken:
    __slots__ = ("cancelled",)

    def __init__(self):
        self.cancelled = False

    def cancel(self):
        self.cancelled = True


class DenseSeriesStore:

    def __init__(self, schema: Schema, initial_series: int = 1024,
                 initial_time: int = 128, max_time_cap: int = 4096):
        self.schema = schema
        self.max_time_cap = max_time_cap
        self._s_cap = initial_series
        self._t_cap = initial_time
        self.num_series = 0
        # seqlock-style version counter: odd while a mutation is in
        # progress, even when stable.  Lock-free readers (query gathers,
        # the device mirror) snapshot an even generation, copy, and retry
        # if it moved — the TPU-native replacement for the reference's
        # per-partition Latch/ChunkMap reader-writer protocol
        # (ref: memory/.../Latch.scala, TimeSeriesShard.scala:817).
        self.generation = 0
        self._mut_depth = 0
        # bumped by mutations that REARRANGE existing cells (prepend,
        # eviction shifts, histogram scheme widening) as opposed to pure
        # appends and capacity changes.  The device mirror uses it to
        # decide whether an incremental tail upload is sound or a full
        # re-upload is required.
        self.shift_version = 0
        self.num_buckets = 0
        self.bucket_les: Optional[np.ndarray] = None
        self.ts = np.full((self._s_cap, self._t_cap), _PAD_TS, dtype=np.int64)
        self.counts = np.zeros(self._s_cap, dtype=np.int32)
        self.sealed = np.zeros(self._s_cap, dtype=np.int32)  # flushed watermark
        # dense per-row newest-sample cache: the ingest out-of-order check
        # reads this contiguous [S] array instead of the strided
        # ts[rows, counts-1] gather (~1 cache line per row, measured 38 ms
        # per 1M-series batch).  Valid only where counts > 0 — consumers
        # mask by that, so eviction-to-empty needs no invalidation.
        self.last_ts = np.full(self._s_cap, _NEG_TS, dtype=np.int64)
        # ODP coverage bookkeeping (see TimeSeriesShard.ensure_paged).  Lives
        # here — not on PartitionInfo — so eviction can invalidate it:
        #   paged_floor: disk consulted AND resident down to this time
        #                (_PAD_TS sentinel = never consulted)
        #   paged_ceil:  for page-only rows, disk consulted up to this time
        #                above the in-memory top (-1 = none)
        #   page_only:   row has never received live appends (recovered /
        #                query-only partitions)
        self.paged_floor = np.full(self._s_cap, _PAD_TS, dtype=np.int64)
        self.paged_ceil = np.full(self._s_cap, -1, dtype=np.int64)
        self.page_only = np.ones(self._s_cap, dtype=bool)
        self.cols: Dict[str, np.ndarray] = {}
        for c in schema.data_columns:
            if c.col_type == "hist":
                self.cols[c.name] = None  # allocated on first batch (needs B)
            else:
                self.cols[c.name] = np.full((self._s_cap, self._t_cap), np.nan)
        self.dropped_out_of_order = 0
        # per-POSITION timestamp bounds over all rows holding that position
        # (maintained by writers: appends via conservative slice updates,
        # eviction by recompute, page-in prepends row-wise).  Queries derive
        # safe column bounds from these so a windowed gather copies only
        # the asked time span — the full-row gather under the seqlock was
        # the soak's query-vs-ingest disaster (SOAK r4: every torn read
        # re-paid a full [S, T_cap] copy).  Conservative by construction:
        # bounds may be wider than live data, never narrower.
        self.pos_ts_max = np.full(self._t_cap, _NEG_TS, dtype=np.int64)
        self.pos_ts_min = np.full(self._t_cap, _PAD_TS, dtype=np.int64)

    # ---- mutation protocol ----

    @contextlib.contextmanager
    def mutation(self):
        """Bracket any in-place change to the SoA arrays.  Nest-safe.
        The yielded token's cancel() marks the outermost mutation a no-op
        (nothing visible changed), reverting the generation so readers and
        the device mirror aren't spuriously invalidated — e.g. an append
        whose samples were all dropped as out-of-order re-delivery."""
        outer = self._mut_depth == 0
        if outer:
            self.generation += 1          # odd: mutation in progress
        self._mut_depth += 1
        tok = _MutationToken()
        try:
            yield tok
        finally:
            self._mut_depth -= 1
            if self._mut_depth == 0:
                if tok.cancelled:
                    self.generation -= 1  # back to the prior even value
                else:
                    self.generation += 1  # new even value: data changed

    # ---- capacity management ----

    def new_row(self) -> int:
        if self.num_series >= self._s_cap:
            self._grow_series(max(self._s_cap * 2, self.num_series + 1))
        row = self.num_series
        self.num_series += 1
        return row

    def _grow_series(self, new_cap: int) -> None:
        def grow(arr, fill):
            if arr is None:
                return None
            shape = (new_cap,) + arr.shape[1:]
            out = np.full(shape, fill, dtype=arr.dtype)
            out[: arr.shape[0]] = arr
            return out
        self.ts = grow(self.ts, _PAD_TS)
        self.counts = grow(self.counts, 0)
        self.sealed = grow(self.sealed, 0)
        self.last_ts = grow(self.last_ts, _NEG_TS)
        self.paged_floor = grow(self.paged_floor, _PAD_TS)
        self.paged_ceil = grow(self.paged_ceil, -1)
        self.page_only = grow(self.page_only, True)
        for name, arr in self.cols.items():
            self.cols[name] = grow(arr, np.nan)
        self._s_cap = new_cap

    def _grow_time(self, need: int) -> None:
        new_cap = self._t_cap
        while new_cap < need:
            new_cap *= 2
        if new_cap > self.max_time_cap:
            # past the cap, grow in chunks beyond bare need: a per-append
            # realloc of the whole [S, T] matrix (multi-second at scale,
            # holding the write lock) was a soak-measured query stall
            new_cap = max(need + max(self.max_time_cap // 8, 64),
                          self.max_time_cap)

        def grow(arr, fill):
            if arr is None:
                return None
            shape = (arr.shape[0], new_cap) + arr.shape[2:]
            # np.empty + two region writes, NOT np.full: full writes every
            # cell and the copy then overwrites most of them — measured as
            # half the grow cost at 65k x 2048
            out = np.empty(shape, dtype=arr.dtype)
            out[:, : arr.shape[1]] = arr
            out[:, arr.shape[1]:] = fill
            return out
        self.ts = grow(self.ts, _PAD_TS)
        for name, arr in self.cols.items():
            self.cols[name] = grow(arr, np.nan)
        ext = new_cap - self._t_cap
        self.pos_ts_max = np.concatenate(
            [self.pos_ts_max, np.full(ext, _NEG_TS, dtype=np.int64)])
        self.pos_ts_min = np.concatenate(
            [self.pos_ts_min, np.full(ext, _PAD_TS, dtype=np.int64)])
        self._t_cap = new_cap

    def _ensure_hist(self, num_buckets: int, les: Optional[np.ndarray]) -> None:
        for c in self.schema.data_columns:
            if c.col_type == "hist" and self.cols[c.name] is None:
                self.cols[c.name] = np.full(
                    (self._s_cap, self._t_cap, num_buckets), np.nan)
                self.num_buckets = num_buckets
                self.bucket_les = None if les is None else np.asarray(les, float)

    def ensure_scheme(self, num_buckets: int,
                      les: Optional[np.ndarray]) -> bool:
        """Adopt or widen the store's bucket scheme for incoming data with
        (num_buckets, les).  A scheme CHANGE widens the store to the union
        of boundaries and rebuckets resident data, instead of crashing the
        write or dropping chunks (ref: HistogramBuckets.scala:340 scheme
        evolution).  Returns True when the incoming payload itself must be
        rebucketed to the (possibly widened) store scheme before writing."""
        if not any(c.col_type == "hist" for c in self.schema.data_columns):
            return False
        self._ensure_hist(num_buckets, les)
        if les is None or self.bucket_les is None:
            # width-only information: identical widths are assumed to be the
            # same scheme (legacy callers); mismatched widths cannot be
            # mapped without boundaries
            if num_buckets != self.num_buckets:
                raise ValueError(
                    f"histogram width changed {self.num_buckets} -> "
                    f"{num_buckets} with no bucket boundaries to re-map by")
            return False
        inc = np.asarray(les, np.float64)
        if inc.shape[0] == self.num_buckets \
                and np.array_equal(inc, self.bucket_les):
            return False
        from filodb_tpu_torch.memory.histogram import rebucket, union_les
        union = union_les(self.bucket_les, inc)
        if not np.array_equal(union, self.bucket_les):
            with self.mutation():       # nest-safe under an ongoing append
                for c in self.schema.data_columns:
                    if c.col_type == "hist" and self.cols[c.name] is not None:
                        self.cols[c.name] = rebucket(
                            self.cols[c.name], self.bucket_les, union)
                self.bucket_les = union
                self.num_buckets = len(union)
                self.shift_version += 1
        return not np.array_equal(inc, self.bucket_les)

    # ---- ingest ----

    def append_batch(self, rows: np.ndarray, ts: np.ndarray,
                     columns: Dict[str, np.ndarray],
                     bucket_les: Optional[np.ndarray] = None) -> int:
        """Vectorized multi-sample append.  `rows[i]` is the store row for
        sample i; samples for a given series must be time-ascending within the
        batch.  Out-of-order samples (vs what is already stored) are dropped,
        matching the reference's ingest behavior.  Returns samples ingested."""
        with self.mutation() as mut:
            n = self._append_batch(rows, ts, columns, bucket_les)
            if n == 0:
                mut.cancel()
            return n

    def _append_batch(self, rows, ts, columns, bucket_les) -> int:
        rows = np.asarray(rows, dtype=np.int64)
        ts = np.asarray(ts, dtype=np.int64)
        n = len(rows)
        if n == 0:
            return 0
        # per-row occurrence number within this batch (vectorized cumcount)
        order = np.argsort(rows, kind="stable")
        sorted_rows = rows[order]
        boundaries = np.concatenate([[0], np.flatnonzero(np.diff(sorted_rows)) + 1])
        occ_sorted = np.arange(n) - np.repeat(boundaries, np.diff(
            np.concatenate([boundaries, [n]])))
        occ = np.empty(n, dtype=np.int64)
        occ[order] = occ_sorted

        pos = self.counts[rows].astype(np.int64) + occ

        # drop out-of-order: sample ts must be > last stored ts for its series
        last_ts = np.where(self.counts[rows] > 0, self.last_ts[rows],
                           np.iinfo(np.int64).min)
        ok = ts > last_ts
        # also drop non-monotonic within batch (per series): ts must increase
        # with occurrence; verify via sorted view
        ts_sorted = ts[order]
        ok_sorted = np.ones(n, dtype=bool)
        same_series = np.zeros(n, dtype=bool)
        same_series[1:] = sorted_rows[1:] == sorted_rows[:-1]
        ok_sorted[1:] &= ~same_series[1:] | (ts_sorted[1:] > ts_sorted[:-1])
        ok2 = np.empty(n, dtype=bool)
        ok2[order] = ok_sorted
        keep = ok & ok2
        if not keep.all():
            self.dropped_out_of_order += int((~keep).sum())
            rows, ts, pos = rows[keep], ts[keep], pos[keep]
            columns = {k: v[keep] for k, v in columns.items()}
            if len(rows) == 0:
                return 0
            # recompute positions after drop
            order = np.argsort(rows, kind="stable")
            sr = rows[order]
            b = np.concatenate([[0], np.flatnonzero(np.diff(sr)) + 1])
            occ_s = np.arange(len(rows)) - np.repeat(
                b, np.diff(np.concatenate([b, [len(rows)]])))
            occ = np.empty(len(rows), dtype=np.int64)
            occ[order] = occ_s
            pos = self.counts[rows].astype(np.int64) + occ

        # hist column allocation AFTER the drop filter: a fully-dropped
        # batch must leave no visible state change (cancel invariant of
        # mutation(); see _MutationToken)
        if bucket_les is not None or any(
                c.col_type == "hist" for c in self.schema.data_columns):
            hist_col = next(c.name for c in self.schema.data_columns
                            if c.col_type == "hist")
            nb = columns[hist_col].shape[1] if columns[hist_col].ndim == 2 else 0
            if self.ensure_scheme(nb, bucket_les):
                from filodb_tpu_torch.memory.histogram import rebucket
                columns = {**columns,
                           hist_col: rebucket(columns[hist_col],
                                              bucket_les, self.bucket_les)}

        need_t = int(pos.max()) + 1
        if need_t > self._t_cap:
            if need_t > self.max_time_cap:
                self.evict_oldest(need_t - self.max_time_cap
                                  + self.max_time_cap // 4)
                pos = self.counts[rows].astype(np.int64) + occ
                need_t = int(pos.max()) + 1
            if need_t > self._t_cap:
                self._grow_time(need_t)

        self.ts[rows, pos] = ts
        # conservative slice update, NOT ufunc.at (np.maximum.at costs
        # ~0.5us/element — it alone would halve ingest throughput): every
        # touched position absorbs the batch's global ts min/max.  Widens
        # bounds by at most the batch's own time span (a scrape interval
        # or two), which the windowed gather tolerates by design.
        p0, p1 = int(pos.min()), int(pos.max()) + 1
        tmin, tmax = int(ts.min()), int(ts.max())
        np.minimum(self.pos_ts_min[p0:p1], tmin,
                   out=self.pos_ts_min[p0:p1])
        np.maximum(self.pos_ts_max[p0:p1], tmax,
                   out=self.pos_ts_max[p0:p1])
        for c in self.schema.data_columns:
            arr = columns[c.name]
            if c.col_type == "hist":
                self.cols[c.name][rows, pos, :] = arr
            else:
                self.cols[c.name][rows, pos] = arr
        # per-row newest sample: the last occurrence of each row in the
        # sorted view (within-row ts are ascending by the ok2 filter)
        sr = rows[order]
        run_starts = np.concatenate(
            [[0], np.flatnonzero(np.diff(sr)) + 1])
        run_ends = np.concatenate([run_starts[1:], [len(rows)]]) - 1
        self.last_ts[sr[run_ends]] = ts[order][run_ends]
        # bincount, not np.add.at (the unbuffered ufunc.at path is ~10x
        # slower and was the single largest ingest cost at scale)
        inc = np.bincount(rows, minlength=self.counts.shape[0])
        self.counts += inc.astype(self.counts.dtype)
        # live data now tops these rows: upper disk coverage is governed by
        # the checkpoint/replay invariant, not paged_ceil (duplicate
        # scatter writes are idempotent — cheaper than np.unique)
        self.page_only[rows] = False
        return len(rows)

    def append_grid(self, rows: np.ndarray, ts: np.ndarray,
                    columns: Dict[str, np.ndarray],
                    bucket_les: Optional[np.ndarray] = None) -> int:
        """Columnar grid append: `rows` [S] are UNIQUE store rows, `ts` is
        [S, k] time-ascending per row, columns map to [S, k] (or [S, k, B])
        matrices.  The common steady-state shape — every series advances by
        the same k new samples — lands as ONE rectangular slice write per
        column with zero per-sample index math (no argsort, no cumcount, no
        np.unique), which is what lets ingest keep up with the scan path.
        Rows whose samples are out-of-order against stored data degrade to
        the flat per-sample path; the clean rows still take the fast lane.
        Returns samples ingested."""
        with self.mutation() as mut:
            n = self._append_grid(rows, ts, columns, bucket_les)
            if n == 0:
                mut.cancel()
            return n

    def _append_grid(self, rows, ts, columns, bucket_les) -> int:
        rows = np.asarray(rows, dtype=np.int64)
        ts = np.asarray(ts, dtype=np.int64)
        S, k = ts.shape
        if S == 0 or k == 0:
            return 0
        # shared scrape grid: a broadcast ts (stride-0 rows) means every
        # row carries the SAME k timestamps — the within-row monotonicity
        # check collapses to one k-element pass instead of [S, k]
        shared_row = ts.strides[0] == 0
        cnt = self.counts[rows]
        last_ts = np.where(cnt > 0, self.last_ts[rows],
                           np.iinfo(np.int64).min)
        row_ok = ts[:, 0] > last_ts
        if k > 1:
            if shared_row:
                if not bool((np.diff(ts[0]) > 0).all()):
                    row_ok[:] = False
            else:
                row_ok &= (np.diff(ts, axis=1) > 0).all(axis=1)
        ingested = 0
        if not row_ok.all():
            # mixed batch: route the dirty rows through the flat path
            # (per-sample drop semantics), keep the clean rows on the grid
            bad = ~row_ok
            flat_rows = np.repeat(rows[bad], k)
            flat_cols = {c: v[bad].reshape((-1,) + v.shape[2:])
                         for c, v in columns.items()}
            ingested += self._append_batch(flat_rows, ts[bad].reshape(-1),
                                           flat_cols, bucket_les)
            rows, ts = rows[row_ok], ts[row_ok]
            columns = {c: v[row_ok] for c, v in columns.items()}
            S = len(rows)
            if S == 0:
                return ingested
            # re-gather: the flat fallback can trigger evict_oldest, which
            # shifts EVERY row's count — stale positions would write the
            # clean rows outside their live window (silent data loss)
            cnt = self.counts[rows]

        if bucket_les is not None or any(
                c.col_type == "hist" for c in self.schema.data_columns):
            hist_col = next(c.name for c in self.schema.data_columns
                            if c.col_type == "hist")
            nb = columns[hist_col].shape[2] if columns[hist_col].ndim == 3 \
                else 0
            if self.ensure_scheme(nb, bucket_les):
                from filodb_tpu_torch.memory.histogram import rebucket
                columns = {**columns,
                           hist_col: rebucket(columns[hist_col],
                                              bucket_les, self.bucket_les)}

        pos0 = cnt.astype(np.int64)            # reuse the OOO-check gather
        need_t = int(pos0.max()) + k
        if need_t > self._t_cap:
            if need_t > self.max_time_cap:
                self.evict_oldest(need_t - self.max_time_cap
                                  + self.max_time_cap // 4)
                pos0 = self.counts[rows].astype(np.int64)
                need_t = int(pos0.max()) + k
            if need_t > self._t_cap:
                self._grow_time(need_t)

        c0 = int(pos0[0])
        uniform = bool((pos0 == c0).all())
        contig = bool(rows[-1] - rows[0] == S - 1
                      and (np.diff(rows) == 1).all()) if S > 1 else True
        hist_cols = {c.name for c in self.schema.data_columns
                     if c.col_type == "hist"}
        if uniform and contig:
            r0 = int(rows[0])
            self.ts[r0:r0 + S, c0:c0 + k] = ts
            for name, arr in columns.items():
                self.cols[name][r0:r0 + S, c0:c0 + k] = arr
        elif uniform:
            self.ts[rows, c0:c0 + k] = ts
            for name, arr in columns.items():
                self.cols[name][rows, c0:c0 + k] = arr
        else:
            pos = pos0[:, None] + np.arange(k, dtype=np.int64)
            self.ts[rows[:, None], pos] = ts
            for name, arr in columns.items():
                if name in hist_cols:
                    self.cols[name][rows[:, None], pos, :] = arr
                else:
                    self.cols[name][rows[:, None], pos] = arr
        if uniform and shared_row and ts.strides[0] == 0:
            # one shared grid at one position: slot c0 + j holds ts[0, j]
            # in every row, an exact bound in O(k), so a windowed gather
            # copies only the slots its window can reach
            np.minimum(self.pos_ts_min[c0:c0 + k], ts[0],
                       out=self.pos_ts_min[c0:c0 + k])
            np.maximum(self.pos_ts_max[c0:c0 + k], ts[0],
                       out=self.pos_ts_max[c0:c0 + k])
        else:
            # conservative per-position bounds, as in _append_batch; rows
            # are time-ascending so the edge columns bound the whole grid
            # (one [S] pass each)
            p0, p1 = int(pos0.min()), int(pos0.max()) + k
            if shared_row and ts.strides[0] == 0:
                tmin, tmax = int(ts[0, 0]), int(ts[0, -1])
            else:
                tmin, tmax = int(ts[:, 0].min()), int(ts[:, -1].max())
            np.minimum(self.pos_ts_min[p0:p1], tmin,
                       out=self.pos_ts_min[p0:p1])
            np.maximum(self.pos_ts_max[p0:p1], tmax,
                       out=self.pos_ts_max[p0:p1])
        self.counts[rows] += k            # rows unique: fancy += is exact
        self.last_ts[rows] = ts[:, -1]
        self.page_only[rows] = False
        return ingested + S * k

    def prepend_row(self, row: int, ts: np.ndarray,
                    columns: Dict[str, np.ndarray]) -> int:
        """Insert samples strictly OLDER than the oldest stored sample for
        `row` — the ODP page-in path (ref: DemandPagedChunkStore populating
        TSPartitions from persisted chunks, OnDemandPagingShard.scala:27-39).
        Paged-in data is already persisted, so the sealed watermark advances
        with it (it is reclaimable, like ODP-flagged blocks).  If the row
        would exceed max_time_cap, the OLDEST part of the payload is trimmed
        to fit (the capDataScannedPerShardCheck spirit of ref:
        OnDemandPagingShard.scala:55); callers must set paged_floor from what
        is actually resident, so a trimmed page-in is re-consulted rather than
        trusted."""
        with self.mutation() as mut:
            n = self._prepend_row(row, ts, columns)
            if n == 0:
                mut.cancel()
            return n

    def _prepend_row(self, row, ts, columns) -> int:
        n = len(ts)
        if n == 0:
            return 0
        cnt = int(self.counts[row])
        room = self.max_time_cap - cnt
        if n > room:
            if room <= 0:
                return 0
            ts = ts[-room:]
            columns = {k: v[-room:] for k, v in columns.items()}
            n = room
        need = cnt + n
        if need > self._t_cap:
            self._grow_time(need)
        self.ts[row, n:need] = self.ts[row, :cnt].copy()
        self.ts[row, :n] = ts
        for c in self.schema.data_columns:
            arr = self.cols[c.name]
            if arr is None:
                continue
            vals = columns.get(c.name)
            if arr.ndim == 3:
                arr[row, n:need, :] = arr[row, :cnt, :].copy()
                arr[row, :n, :] = np.nan if vals is None else vals
            else:
                arr[row, n:need] = arr[row, :cnt].copy()
                arr[row, :n] = np.nan if vals is None else vals
        if cnt == 0:
            self.last_ts[row] = int(ts[-1])   # row was empty: payload tops it
        self.counts[row] += n
        self.sealed[row] += n
        # position bounds: the right shift leaves stale entries that are
        # only ever CONSERVATIVE (older content lowers the true max, so a
        # stale-high max never wrongly excludes); the row's new cell
        # values still widen the mins/maxes they touch
        newcnt = int(self.counts[row])
        np.minimum(self.pos_ts_min[:newcnt], self.ts[row, :newcnt],
                   out=self.pos_ts_min[:newcnt])
        np.maximum(self.pos_ts_max[:newcnt], self.ts[row, :newcnt],
                   out=self.pos_ts_max[:newcnt])
        self.shift_version += 1
        return n

    def append_row(self, row: int, ts: np.ndarray,
                   columns: Dict[str, np.ndarray]) -> int:
        """ODP page-in ABOVE the in-memory data for one row (samples strictly
        newer than the row's last).  Unlike append_batch this never triggers
        store-wide eviction — a query's page-in must not evict samples another
        row of the same query just loaded; the NEWEST part of the payload is
        trimmed to fit max_time_cap instead, and callers set paged_ceil from
        what is actually resident."""
        with self.mutation() as mut:
            n = self._append_row(row, ts, columns)
            if n == 0:
                mut.cancel()
            return n

    def _append_row(self, row, ts, columns) -> int:
        n = len(ts)
        if n == 0:
            return 0
        cnt = int(self.counts[row])
        room = self.max_time_cap - cnt
        if n > room:
            if room <= 0:
                return 0
            ts = ts[:room]
            columns = {k: v[:room] for k, v in columns.items()}
            n = room
        need = cnt + n
        if need > self._t_cap:
            self._grow_time(need)
        self.ts[row, cnt:need] = ts
        np.minimum(self.pos_ts_min[cnt:need], ts,
                   out=self.pos_ts_min[cnt:need])
        np.maximum(self.pos_ts_max[cnt:need], ts,
                   out=self.pos_ts_max[cnt:need])
        for c in self.schema.data_columns:
            arr = self.cols[c.name]
            if arr is None:
                continue
            vals = columns.get(c.name)
            if arr.ndim == 3:
                arr[row, cnt:need, :] = np.nan if vals is None else vals
            else:
                arr[row, cnt:need] = np.nan if vals is None else vals
        self.counts[row] += n
        self.sealed[row] += n
        self.last_ts[row] = int(ts[n - 1])
        return n

    # ---- eviction ----

    def evict_oldest(self, nsamples) -> None:
        """Evict up to `nsamples` (scalar, or per-series [S] array) of the
        oldest samples per series —
        time-ordered reclaim, but NEVER beyond a series' sealed (persisted)
        watermark: unflushed data must not be destroyed by another series
        overflowing (the BlockManager reclaim-only-flushed-blocks guarantee,
        ref: memory/.../BlockManager.scala reclaim ordering).  Series that have
        nothing sealed are left intact; callers fall back to growing time
        capacity instead."""
        with self.mutation() as mut:
            if not self._evict_oldest(nsamples):
                mut.cancel()

    def _evict_oldest(self, nsamples) -> bool:
        k = np.minimum(nsamples, self.sealed).astype(np.int64)   # per-series
        if not k.any():
            return False
        S, T = self.ts.shape
        idx = np.arange(T, dtype=np.int64)[None, :] + k[:, None]
        valid = idx < T
        idx_c = np.where(valid, idx, T - 1)
        rowi = np.arange(S, dtype=np.int64)[:, None]
        self.ts = np.where(valid, self.ts[rowi, idx_c], _PAD_TS)
        for name, arr in self.cols.items():
            if arr is None:
                continue
            if arr.ndim == 3:
                shifted = arr[rowi, idx_c, :]
                shifted[~valid] = np.nan
                self.cols[name] = shifted
            else:
                self.cols[name] = np.where(valid, arr[rowi, idx_c], np.nan)
        self.counts = (self.counts - k).astype(np.int32)
        self.sealed = (self.sealed - k).astype(np.int32)
        # evicted rows no longer hold everything disk was consulted for:
        # force re-paging on the next query (floor AND ceil — a fully
        # evicted page-only row must not keep stale upper coverage either)
        self.paged_floor[k > 0] = _PAD_TS
        self.paged_ceil[k > 0] = -1
        self._recompute_pos_bounds()
        self.shift_version += 1
        return True

    def compact_time(self, slack: int = 64) -> int:
        """Shrink the time capacity down to the live extent (+slack) so
        evicted history actually releases host RAM — evict_oldest only
        shifts within the allocation.  Returns bytes released."""
        with self.mutation() as mut:
            t_used = self.time_used
            target = max(t_used + slack, 1)
            if target >= self._t_cap:
                mut.cancel()
                return 0
            before = self.nbytes
            self.ts = np.ascontiguousarray(self.ts[:, :target])
            for name, arr in self.cols.items():
                if arr is not None:
                    self.cols[name] = np.ascontiguousarray(arr[:, :target])
            # NOTE: no shift_version bump — compaction only truncates
            # unused capacity past time_used; live cell positions are
            # untouched, so incremental mirror updates remain sound
            self.pos_ts_max = np.ascontiguousarray(self.pos_ts_max[:target])
            self.pos_ts_min = np.ascontiguousarray(self.pos_ts_min[:target])
            self._t_cap = target
            return before - self.nbytes

    # ---- query gather ----

    @property
    def nbytes(self) -> int:
        n = self.ts.nbytes + self.counts.nbytes + self.sealed.nbytes
        n += self.last_ts.nbytes
        n += self.paged_floor.nbytes + self.paged_ceil.nbytes
        n += self.page_only.nbytes
        for arr in self.cols.values():
            if arr is not None:
                n += arr.nbytes
        return n

    @property
    def time_used(self) -> int:
        return int(self.counts.max()) if self.num_series else 0

    def _recompute_pos_bounds(self) -> None:
        """Rebuild the per-position bounds from live cells — called by
        mutations that REARRANGE positions (evict shifts); the pass is
        O(S x T), which those mutations already pay."""
        T = self._t_cap
        S = self.num_series
        if S == 0:
            self.pos_ts_max = np.full(T, _NEG_TS, dtype=np.int64)
            self.pos_ts_min = np.full(T, _PAD_TS, dtype=np.int64)
            return
        live = np.arange(T, dtype=np.int64)[None, :] < \
            self.counts[:S, None]
        t = self.ts[:S]
        self.pos_ts_max = np.where(live, t, _NEG_TS).max(axis=0)
        self.pos_ts_min = np.where(live, t, _PAD_TS).min(axis=0)

    def window_positions(self, t_lo_ms: int, t_hi_ms: int
                         ) -> Tuple[int, int]:
        """Column range [p_lo, p_hi) guaranteed to contain every live
        cell with t_lo <= ts <= t_hi, in EVERY row (conservative: may be
        wider).  Prefix exclusion: positions whose running max over rows
        stays < t_lo hold only pre-window samples; suffix likewise via
        the from-the-right running min vs t_hi."""
        t_used = max(self.time_used, 1)
        mx = np.maximum.accumulate(self.pos_ts_max[:t_used])
        p_lo = int(np.searchsorted(mx, t_lo_ms))
        mn = np.minimum.accumulate(
            self.pos_ts_min[:t_used][::-1])[::-1]
        p_hi = int(np.searchsorted(mn, t_hi_ms, side="right"))
        # never an empty slice: a window entirely outside the data still
        # returns one (pad-masked) column, not a 0-width matrix
        p_lo = min(p_lo, t_used - 1)
        p_hi = min(max(p_hi, p_lo + 1), t_used)
        return p_lo, p_hi

    def gather_rows(self, rows: np.ndarray,
                    t_lo_ms: Optional[int] = None,
                    t_hi_ms: Optional[int] = None,
                    positions: Optional[Tuple[int, int]] = None,
                    columns: Optional[Sequence[str]] = None
                    ) -> Tuple[np.ndarray, Dict[str, np.ndarray], np.ndarray]:
        """Fancy-index series rows for the device kernels, optionally
        restricted to the [t_lo_ms, t_hi_ms] time window (the planner's
        chunk-scan bounds): the copy then covers only the asked span —
        at a 4096-capacity store and a 2h dashboard query that is ~5x
        less copy, and proportionally less seqlock-tear exposure under
        live ingest.  Returns (ts [S, W], cols, counts [S]) where counts
        are RELATIVE to the returned slice.  `positions` gives the column
        range [p_lo, p_hi) itself (window_positions' answer, computed once
        for a gather made in row blocks); `columns` names the value
        columns to copy (default: all)."""
        t_used = max(self.time_used, 1)
        p_lo = 0
        p_hi = t_used
        if positions is not None:
            p_lo, p_hi = positions
        elif t_lo_ms is not None and t_hi_ms is not None:
            p_lo, p_hi = self.window_positions(t_lo_ms, t_hi_ms)
        ts = self.ts[rows, p_lo:p_hi]
        cols = {name: (arr[rows, p_lo:p_hi] if arr is not None else None)
                for name, arr in self.cols.items()
                if columns is None or name in columns}
        counts = np.clip(self.counts[rows] - p_lo, 0,
                         p_hi - p_lo).astype(np.int32)
        return ts, cols, counts

    # ---- flush support ----

    def unsealed_range(self, row: int) -> Tuple[int, int]:
        return int(self.sealed[row]), int(self.counts[row])

    def mark_sealed(self, row: int, upto: int) -> None:
        self.sealed[row] = upto

    def series_slice(self, row: int, lo: int, hi: int) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        ts = self.ts[row, lo:hi].copy()
        cols = {}
        for c in self.schema.data_columns:
            arr = self.cols[c.name]
            if arr is None:
                cols[c.name] = np.zeros((hi - lo, 0))
            elif c.col_type == "hist":
                cols[c.name] = arr[row, lo:hi, :].copy()
            else:
                cols[c.name] = arr[row, lo:hi].copy()
        return ts, cols
