"""Step-aligned incremental PromQL result cache (port of
filodb_tpu/query/resultcache.py).

A result block's values may be a device tensor in the port; the cache
reads every block through `host_values`, so its entries hold f64 numpy
rows only: no device memory is kept across queries, and every block it
builds is numpy.

The Thanos/Cortex query-frontend pattern (ref: cortexproject
queryrange/results_cache.go, thanos-io queryfrontend — PAPERS.md survey
of serving stacks), adapted to this store's consistency machinery: a
dashboard re-poll of `query_range` recomputes only the windows the
append horizon hasn't frozen yet and merges them with the cached prefix,
instead of rescanning the full range: for a 30-window re-poll where 28
windows are cache-final, 30 windows of work become 2.

Soundness model (why a cached window can be reused at all):

  * Appends are strictly in-order per series (DenseSeriesStore drops
    out-of-order samples: ingest checks ts > last_ts), so every FUTURE
    sample of row r lands after last_ts[r].  Windows ending at or before
    ``horizon = min over live rows of last_ts`` can never change under
    ingest — that horizon is the entry's ``immutable_upto``.
  * Changes to the SERIES SET (new partitions, eviction, pid recycling)
    move `index.mutations` / `keys_epoch`; both ride in the entry's
    ``token`` and any mismatch drops the entry.  This is what lets the
    cache survive eviction-driven `shift_version` bumps without ever
    serving rows keyed to a dead mirror snapshot: the cache stores final
    RESULT windows, not device state, and the only store facts it relies
    on (in-order appends, series-set identity) are exactly the ones the
    token tracks.
  * Queries whose value at window w depends on anything other than data
    in (-inf, w] are never cached: `@ start()/end()` pins, negative
    offsets (windows reading the future), and the arbitrary-choice
    limitk family.  See `_plan_cacheable`.

Entries hold per-series float64 rows on the query's step grid.  Grid
identity is (promql, step, start mod step, planner-params repr): two
polls of one dashboard panel share a grid even as start/end slide.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from filodb_tpu_torch.ops.timewindow import make_window_ends
from filodb_tpu_torch.query.rangevector import (QueryResult, QueryStats,
                                                RangeVectorKey, ResultBlock,
                                                host_values,
                                                remove_nan_series)

# functions excluded from caching: limitk/limit_ratio keep an ARBITRARY
# series subset, so a prefix chosen on one poll need not match the
# subset a full recompute would choose
_UNCACHEABLE_CALLS = frozenset({"limitk", "limit_ratio"})


def _plan_cacheable(promql: str) -> bool:
    """True when per-window results are immutable under in-order appends:
    no @-pinning, no negative offsets, no arbitrary-subset functions.
    Parse failures return False — the engine will surface the error."""
    from filodb_tpu_torch.promql import ast as A
    from filodb_tpu_torch.promql.parser import parse_query_cached

    try:
        expr = parse_query_cached(promql)
    except Exception:  # noqa: BLE001 — parse errors: engine reports them
        return False

    def walk(node) -> bool:
        if isinstance(node, A.Expr):
            if getattr(node, "at_ms", None) is not None:
                return False
            if getattr(node, "offset_ms", 0) < 0:
                return False
            if isinstance(node, A.Subquery):
                # the converter builds the inner grid from the QUERY start
                # (parser._conv: `start - off - window`), not an absolute
                # alignment — two polls sharing an outer grid phase can
                # sample the subquery at different inner timestamps, so a
                # cached window need not equal a fresh recompute
                return False
            if isinstance(node, A.Call) and node.name in _UNCACHEABLE_CALLS:
                return False
        if dataclasses.is_dataclass(node):
            return all(walk(getattr(node, f.name))
                       for f in dataclasses.fields(node))
        if isinstance(node, (list, tuple)):
            return all(walk(x) for x in node)
        return True

    return walk(expr)


@dataclasses.dataclass
class _Entry:
    wends: np.ndarray                          # int64 ms grid, contiguous
    series: Dict[RangeVectorKey, np.ndarray]   # f64 [W] per series
    immutable_upto: int                        # wends <= this are final
    token: Tuple                               # shard series-set identity
    nbytes: int
    ws: str = ""                               # owning tenant workspace


def _series_map(res: QueryResult, width: int) -> Optional[
        Dict[RangeVectorKey, np.ndarray]]:
    """Flatten result blocks to a per-key row map, or None when the shape
    is uncacheable (histogram-valued blocks, duplicate keys, rows not on
    the expected window grid — a clamped/split grid must bypass, not
    crash the merge)."""
    out: Dict[RangeVectorKey, np.ndarray] = {}
    for b in res.blocks:
        vals = np.asarray(host_values(b.values), dtype=np.float64)
        if vals.ndim != 2 or vals.shape[1] != width:
            return None
        for i, k in enumerate(b.keys):
            if k in out:
                return None              # ambiguous identity: don't cache
            out[k] = vals[i]
    return out


class ResultCache:

    def __init__(self, max_entries: int = 256,
                 max_entry_bytes: int = 32 << 20,
                 max_total_bytes: int = 256 << 20,
                 tenant_quota_bytes: int = 0):
        self.max_entries = max_entries
        self.max_entry_bytes = max_entry_bytes
        self.max_total_bytes = max_total_bytes
        # per-tenant (_ws_) byte quota — the cache half of noisy-
        # neighbor isolation (query.result_cache_tenant_quota_bytes):
        # inserting past it evicts the tenant's OWN oldest entries, and
        # an entry that cannot fit inside the quota is rejected outright
        # — another tenant's entry is NEVER evicted to make room for an
        # over-quota one.  0 disables (global LRU only).
        self.tenant_quota_bytes = tenant_quota_bytes
        self._lock = threading.Lock()
        self._entries: Dict[Tuple, _Entry] = {}
        self._total_bytes = 0
        self._tenant_bytes: Dict[str, int] = {}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._total_bytes = 0
            self._tenant_bytes.clear()

    def tenant_bytes(self, ws: str) -> int:
        with self._lock:
            return self._tenant_bytes.get(ws, 0)

    def __len__(self) -> int:
        return len(self._entries)

    # ------------------------------------------------------------- serve

    def query_range(self, run, promql: str, start_s: int, step_s: int,
                    end_s: int, pp_key: str,
                    state: Optional[Tuple[Tuple, int]]) -> QueryResult:
        """Serve (promql, start, step, end) through the cache.  `run(s, e)`
        executes the underlying engine over [s, e] seconds on the same
        step; `state` is (token, horizon_ms) from the owning shards, or
        None to bypass (remote/unknown sources)."""
        from filodb_tpu_torch.utils.metrics import registry
        if state is None:
            return run(start_s, end_s)
        token, horizon_ms = state
        step_ms = max(int(step_s), 1) * 1000
        start_ms, end_ms = int(start_s) * 1000, int(end_s) * 1000
        wends_new = make_window_ends(start_ms, end_ms, step_ms)
        if wends_new.size == 0:
            return run(start_s, end_s)
        key = (promql, step_ms, start_ms % step_ms, pp_key)
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:          # LRU touch
                self._entries[key] = self._entries.pop(key)
        if ent is not None and ent.token != token:
            registry.counter("query_result_cache_invalidations").increment()
            self._drop(key, ent)
            ent = None
        n_reuse = 0
        if ent is not None:
            # reusable prefix: new windows covered by the entry AND final.
            # The grids share a phase, so coverage is a contiguous prefix
            # of wends_new unless the request reaches back before the
            # entry's own start (then: plain miss).
            lim = min(int(ent.wends[-1]), ent.immutable_upto)
            if int(wends_new[0]) >= int(ent.wends[0]):
                n_reuse = int(np.searchsorted(wends_new, lim, side="right"))
        if n_reuse == 0:
            registry.counter("query_result_cache_misses").increment()
            res = run(start_s, end_s)
            res.stats.result_cache = "miss"
            self._store(key, wends_new, res, token, horizon_ms)
            return res
        if n_reuse == wends_new.size:
            registry.counter("query_result_cache_hits").increment()
            res = self._from_cache(ent, wends_new)
            res.stats.result_cache = "hit"
            return res
        # partial hit: compute only the non-final tail and merge
        registry.counter("query_result_cache_partial_hits").increment()
        tail_start_s = int(wends_new[n_reuse]) // 1000
        tail = run(tail_start_s, end_s)
        if tail.error is not None and tail.error.startswith(
                "tenant_overloaded"):
            # the scheduler SHED the tail run: the cached prefix is
            # still perfectly valid (nothing about the data changed) —
            # keep it, surface the 429 as-is, and do NOT burn a second
            # full run through the very admission gate that just shed
            # us (that would amplify load exactly when shedding it)
            return tail
        if tail.error is not None or tail.partial or tail.data is not None:
            # errors/partials must surface exactly as a full run would —
            # and never be merged into or stored over good windows.  Drop
            # the entry so a degraded system pays ONE full run per poll
            # from here on, not tail + full every time
            self._drop(key, ent)
            res = run(start_s, end_s)
            res.stats.result_cache = "miss"
            return res
        tail_map = _series_map(tail, wends_new.size - n_reuse)
        if tail_map is None:
            self._drop(key, ent)
            res = run(start_s, end_s)
            res.stats.result_cache = "miss"
            return res
        merged: Dict[RangeVectorKey, np.ndarray] = {}
        W = wends_new.size
        off = int(np.searchsorted(ent.wends, wends_new[0]))
        for k, row in ent.series.items():
            out = np.full(W, np.nan)
            out[:n_reuse] = row[off:off + n_reuse]
            merged[k] = out
        for k, row in tail_map.items():
            out = merged.get(k)
            if out is None:
                out = merged[k] = np.full(W, np.nan)
            out[n_reuse:] = row
        res = self._build_result(merged, wends_new, tail.stats)
        res.stats.result_cache = "partial"
        res.trace_id = tail.trace_id
        self._insert(key, _Entry(
            wends_new, merged, min(horizon_ms, int(wends_new[-1])), token,
            sum(r.nbytes for r in merged.values())))
        return res

    # ----------------------------------------------------------- helpers

    def _from_cache(self, ent: _Entry, wends_new: np.ndarray) -> QueryResult:
        off = int(np.searchsorted(ent.wends, wends_new[0]))
        W = wends_new.size
        series = {k: row[off:off + W] for k, row in ent.series.items()}
        return self._build_result(series, wends_new, QueryStats())

    @staticmethod
    def _build_result(series: Dict[RangeVectorKey, np.ndarray],
                      wends: np.ndarray, stats: QueryStats) -> QueryResult:
        if not series:
            return QueryResult([], stats)
        keys = list(series)
        vals = np.stack([series[k] for k in keys])
        block = remove_nan_series(ResultBlock(keys, wends, vals))
        # keep the tail run's phase/resource attribution (that IS the
        # cost this poll paid) — only the result-shape counters change
        st = dataclasses.replace(stats, result_samples=int(vals.size),
                                 result_bytes=int(vals.nbytes))
        return QueryResult([block] if block is not None else [], st)

    def _drop(self, key, ent: _Entry) -> None:
        with self._lock:
            if self._entries.get(key) is ent:
                del self._entries[key]
                self._uncount_locked(ent)

    def _uncount_locked(self, ent: _Entry) -> None:
        self._total_bytes -= ent.nbytes
        left = self._tenant_bytes.get(ent.ws, 0) - ent.nbytes
        if left > 0:
            self._tenant_bytes[ent.ws] = left
        else:
            self._tenant_bytes.pop(ent.ws, None)

    def _store(self, key, wends: np.ndarray, res: QueryResult, token,
               horizon_ms: int) -> None:
        if res.error is not None or res.partial or res.data is not None:
            return
        smap = _series_map(res, wends.size)
        if smap is None:
            return
        nbytes = sum(r.nbytes for r in smap.values())
        if nbytes > self.max_entry_bytes:
            return
        self._insert(key, _Entry(wends, smap,
                                 min(horizon_ms, int(wends[-1])), token,
                                 nbytes))

    def _insert(self, key, ent: _Entry) -> None:
        if ent.nbytes > self.max_entry_bytes:
            return
        # the owning tenant: the query's _ws_ shard key (memoized parse)
        from filodb_tpu_torch.utils.usage import tenant_of
        ent.ws = tenant_of(key[0])[0]
        quota = self.tenant_quota_bytes
        if quota and ent.nbytes > quota:
            # over-quota entries are REJECTED, never fitted by evicting
            # someone else (isolation invariant: a tenant's churn only
            # ever costs that tenant's entries under the quota rule)
            from filodb_tpu_torch.utils.metrics import registry
            registry.counter("result_cache_tenant_quota_rejections",
                             ws=ent.ws).increment()
            return
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._uncount_locked(old)
            if quota:
                # evict this tenant's OWN oldest entries until the new
                # one fits inside its quota — other tenants' entries are
                # untouchable here by construction
                while self._tenant_bytes.get(ent.ws, 0) + ent.nbytes \
                        > quota:
                    victim = next((k for k, e in self._entries.items()
                                   if e.ws == ent.ws), None)
                    if victim is None:
                        break
                    self._uncount_locked(self._entries.pop(victim))
                    from filodb_tpu_torch.utils.metrics import registry
                    registry.counter("result_cache_tenant_quota_evictions",
                                     ws=ent.ws).increment()
            self._entries[key] = ent
            self._total_bytes += ent.nbytes
            self._tenant_bytes[ent.ws] = \
                self._tenant_bytes.get(ent.ws, 0) + ent.nbytes
            while self._entries and (
                    len(self._entries) > self.max_entries
                    or self._total_bytes > self.max_total_bytes):
                if len(self._entries) == 1:
                    break                # always keep the newest entry
                k = next(iter(self._entries))
                self._uncount_locked(self._entries.pop(k))
