"""The shard-local leaf: scan cap, index lookup, the router, the
device-mirror gather or the windowed host gather, and the fused peephole
(port of filodb_tpu/query/leafexec.py); and the scalar leaves (time(),
literals and scalar arithmetic).

The leaf first refuses a scan over PlannerParams.scan_limit, as the
reference does over its resident data; then demand paging brings back
sealed history the dense tier dropped (at most scan_limit samples, else
QueryError("paged_limit_exceeded")), and the scan check runs again over
what is now resident.  Then its rows come from one of two places:

- the device mirror, which holds counter columns reset-corrected: any
  gauge column, and a counter column under a counter function (rate,
  increase, irate);
- the windowed host gather (numpy), which reads the raw values: a
  non-counter function over a counter column (changes, resets,
  max_over_time, an instant selector, a native histogram's instant
  form), every working set the router sends to the host, and a query
  that meets a mirror being rebuilt in the background after cells were
  rearranged (corrected as the mirror would be; counted as
  device_mirror_query_fallbacks).

The router (the process settings' `query.host_route_max_samples`) sends a
working set of at most that many estimated samples to the host, only
where the environment sets
FILODB_TPU_FORCE_HOST_ROUTE: on the card the mirror and its kernels
answer a small set faster than the host does.

A range function followed by an aggregate over one shared scrape grid
is answered in one of five ways, as in the reference (:174-214):

- an instant selector is last_over_time over the stale lookback;
- on dense data, count_over_time and the count aggregate are host math
  (every series has the same samples per window);
- a host-routed dense set under sum/avg/count/min/max is numpy
  (ops/hostleaf.py);
- min/max_over_time run as windowed torch reductions (ops/minmax.py);
- everything else is one fused kernel launch (ops/fused.py).

A native histogram column [S, T, B] takes the fused path only as
sum(rate|increase): its S*B bucket rows, bucket-major within a series,
go through the same kernels with one slot per (group, bucket).

A leaf over the downsample gauge schema (ds-gauge) reads the column its
range function names and may swap the function (core/schemas.py
DS_GAUGE_FN_SUBSTITUTION: min_over_time reads `min`, count_over_time
becomes sum_over_time over `count`), as per-execution transformer
overrides, so the plan stays reusable.

In a dashboard batch (engine.query_range_batch, query/exprfuse.py) the
leaf runs in three phases: prepare_fused gathers and takes the peephole
without launching (a kernel evaluation comes back as its FusedCall), the
batch launches every leaf's FusedCall merged, and the node's execution
picks up what was parked.  Inside a batch the windowed host gather and
the host route share their work through the batch gather memo
(ops/hostleaf.py).  A killed query raises query_canceled before any
launch, and the host gather stops between row blocks on a kill or an
expired deadline.

Every other leaf — the cases where the reference's _try_fused returns
None — runs its transformers' general path on the engine's device
(query/transformers.py); a host block is uploaded for it once.  Not
carried over, on purpose: the reference's broad `except` that degrades a
failed fused evaluation to the general path, and the interpret-unless-
TPU gate.

SelectPersistedSegmentsExec is the leaf of the persisted-segment tier:
its rows come from the cold region's segment blocks, and from there the
same peephole and transformers run.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from filodb_tpu_torch.config import settings
from filodb_tpu_torch.core.index import ColumnFilter
from filodb_tpu_torch.core.schemas import DS_GAUGE_FN_SUBSTITUTION
from filodb_tpu_torch.core.shard import PagedLimitExceeded
from filodb_tpu_torch.ops import counter, fused, hostleaf, minmax
from filodb_tpu_torch.ops import hist as hist_ops
from filodb_tpu_torch.ops.instant import INSTANT_FUNCTIONS, apply_binary_op
from filodb_tpu_torch.ops.timewindow import (PAD_TS, make_window_ends,
                                             to_offsets)
from filodb_tpu_torch.query.execbase import (
    AggPartial, GroupCardinalityError, LazyKeys, LeafExecPlan, RawBlock,
    ScalarResult,
    _FUSED_CACHE_LOCK, _FUSED_MINMAX_PAD_CACHE, _FUSED_PLAN_CACHE,
    _FUSED_VALS_CACHE, _group_cache_insert, _group_cache_lookup, _lru_touch,
    QueryError, _note_mirror_limit, _vals_cache_insert, agg_token,
    fold_tally)
from filodb_tpu_torch.query.fusedbatch import FusedCall, finish_fused_calls
from filodb_tpu_torch.query.rangevector import QueryContext, QueryStats
from filodb_tpu_torch.query.transformers import (AggregateMapReduce,
                                                 PeriodicSamplesMapper,
                                                 RepeatToGridMapper,
                                                 _group_ids_cached)
from filodb_tpu_torch.utils.counters import counters
from filodb_tpu_torch.utils.devicetelem import telem
from filodb_tpu_torch.utils.metrics import exec_tally, trace_context

# range functions with counter semantics (the reference's RANGE_FUNCTIONS
# is_counter flag): on a counter column they read the reset-corrected
# values the mirror holds; any other function needs the raw ones
COUNTER_FNS = ("rate", "increase", "irate")

class MultiSchemaPartitionsExec(LeafExecPlan):
    """Leaf: index lookup + device gather on the owning shard."""

    def __init__(self, ctx: QueryContext, dataset: str, shard: int,
                 filters: Sequence[ColumnFilter], chunk_start_ms: int,
                 chunk_end_ms: int, columns: Sequence[str] = (),
                 schema: Optional[str] = None):
        super().__init__(ctx)
        self.dataset = dataset
        self.shard = shard
        self.filters = list(filters)
        self.chunk_start_ms = chunk_start_ms
        self.chunk_end_ms = chunk_end_ms
        self.columns = list(columns)
        self.schema = schema
        # per-execution transformer substitutions (the ds-gauge schema's
        # column and range-function swap, _do_execute): set, cleared and
        # consulted per execution so the plan stays reusable
        self._transformer_overrides: Dict[int, object] = {}
        self._fused_cache_key = None
        # phase 1 of a batch parks (data, stats, fused outcome,
        # transformers consumed) here for phase 3 (prepare_fused)
        self._prefused = None
        # "host" once the router's host route answered (explain-analyze
        # prints it)
        self.route = None

    def args_str(self):
        fs = ",".join(str(f) for f in self.filters)
        return (f"dataset={self.dataset}, shard={self.shard}, "
                f"chunkMethod=TimeRangeChunkScan({self.chunk_start_ms},"
                f"{self.chunk_end_ms}), filters=[{fs}], "
                f"colName={self.columns}"
                + (f", route={self.route}" if self.route else ""))

    def _execute_impl(self, source):
        pre = self._prefused
        if pre is not None:
            # phase 3 of engine.query_range_batch: the gather and the
            # fused preflight already ran in prepare_fused, and the kernel
            # work was batched (inject_fused) or is still parked
            self._prefused = None
            data, stats, out, start = pre
            if isinstance(out, FusedCall):
                out = self._finish_or_degrade(out)
        else:
            self._transformer_overrides = {}
            self._fused_cache_key = None
            data, stats = self._do_execute(source)
            out, start = self._try_fused(data, stats)
        if out is not None:
            data = out
        for i, t in enumerate(self.transformers[start:], start):
            t = self._transformer_overrides.get(i, t)
            self._check_live(type(t).__name__)
            data = t.apply(data, self.ctx, stats, source)
        return data, stats

    def prepare_fused(self, source):
        """Phase 1 of engine.query_range_batch: the gather and the fused
        preflight, but NOT the kernel.  Returns a FusedCall when this
        leaf's kernel work can merge with other panels'
        (finish_fused_calls), else None.  Either way the outcome is
        parked on the leaf, so phase 3 never gathers again: the gathered
        block only where the general path still needs it (a fused answer
        never reads it again, and on the card it is a full device copy
        of the working set).  Errors propagate: exprfuse.compile_tree
        then resets the leaf, which runs standalone in phase 3."""
        self._prefused = None
        self._transformer_overrides = {}
        self._fused_cache_key = None
        # this work is the leaf's own, done ahead of its node: its host
        # time and what the exec tally gathers (the mirror gather, uploads)
        # go into its stats, under its query's trace id
        snap = exec_tally.snapshot()
        t0 = time.perf_counter()
        try:
            with trace_context(self.ctx.query_id):
                data, stats = self._do_execute(source)
                out, start = self._try_fused(data, stats, defer=True)
            fold_tally(stats, max(time.perf_counter() - t0
                                  - exec_tally.device_s
                                  - exec_tally.transfer_s, 0.0))
        finally:
            exec_tally.restore(snap, 0.0)
        if isinstance(out, FusedCall):
            # the merged launch's device seconds are booked to this leaf
            out.stats, out.origin = stats, self.ctx.query_id
        self._prefused = (None if out is not None else data, stats, out,
                          start)
        return out if isinstance(out, FusedCall) else None

    def inject_fused(self, partial) -> None:
        """Phase 2 hand-off: replace the parked FusedCall with its batched
        result (an AggPartial)."""
        data, stats, _, start = self._prefused
        self._prefused = (data, stats, partial, start)

    def _finish_or_degrade(self, fc):
        """Launch a parked FusedCall the batch never finished (a killed
        query's, or every call of a batch whose merged launch failed).
        The cancellation check comes first, so a killed query's kernel
        never runs.  Unlike the reference, a failure here raises: the
        port never degrades a failed kernel to the general path."""
        self._check_cancel("fused kernel dispatch")
        return finish_fused_calls([fc])[0]

    def _check_cancel(self, where: str) -> None:
        """Cooperative cancellation between the node-boundary checks,
        before a kernel launch."""
        tok = getattr(self.ctx, "cancel", None)
        if tok is not None and tok.cancelled:
            tok.raise_if_cancelled(f"before {where} (shard {self.shard})")

    def _try_fused(self, data, stats=None, defer: bool = False):
        """Peephole: PeriodicSamplesMapper (a fusable range function, or
        an instant selector) followed by AggregateMapReduce (sum, avg,
        count, min or max) over a shared-grid working set collapses into
        one fused evaluation: on the host when the router sent the block
        there and the host route takes it, else on the device (a host
        block is uploaded first).  An `@` pin between the two
        (RepeatToGridMapper) commutes with the per-step aggregate: the
        pinned step is evaluated fused and its partial repeated across
        the grid.  -> (AggPartial, transformers consumed), or (None, 0)
        where the reference's peephole returns None: then the
        transformers run the general path.  With defer=True a kernel
        evaluation comes back as its unlaunched FusedCall, for the
        batch to merge (not under an `@` pin: that one is finished at
        once)."""
        ts = [self._transformer_overrides.get(i, t)
              for i, t in enumerate(self.transformers)]
        repeat = None
        if len(ts) >= 3 and isinstance(ts[1], RepeatToGridMapper):
            repeat = ts.pop(1)
        if len(ts) < 2 or not isinstance(data, RawBlock) \
                or not data.keys or data.shared_ts_row is None:
            return None, 0
        t0, t1 = ts[:2]
        if not isinstance(t0, PeriodicSamplesMapper) \
                or not isinstance(t1, AggregateMapReduce):
            return None, 0
        out = self._fuse(data, t0, t1, stats,
                         defer=defer and repeat is None)
        if out is None:
            return None, 0
        if repeat is None:
            return out, 2
        wends = make_window_ends(repeat.start_ms, repeat.end_ms,
                                 repeat.step_ms)
        return dataclasses.replace(
            out, wends=wends,
            comp=np.repeat(out.comp, len(wends), axis=1)), 3

    def _fuse(self, data, t0, t1, stats, defer: bool = False):
        """The peephole's evaluation of t0 then t1 over `data` (see
        _try_fused) -> the AggPartial (with defer, a kernel evaluation's
        FusedCall), or None."""
        is_hist = data.values.ndim == 3
        if t0.window_ms is None:
            # instant-vector selector (`sum by (x) (metric)`): lookback
            # sampling IS last_over_time over the stale-lookback window
            if t0.function is not None:
                return None
            t0 = dataclasses.replace(t0, window_ms=t0.lookback_ms,
                                     function="last_over_time")
        fn = t0.function or ""
        dense = data.dense
        if t0.function_args or t1.params \
                or not fused.can_fuse(fn, t1.op, True, dense):
            return None
        if is_hist and (fn not in ("rate", "increase") or t1.op != "sum"
                        or data.bucket_les is None):
            return None
        wends = make_window_ends(t0.start_ms, t0.end_ms, t0.step_ms)
        eval_wends = wends - t0.offset_ms - data.base_ms
        if eval_wends.size == 0 or abs(eval_wends).max() >= (1 << 30):
            return None
        # host-only answers: under the dense shared grid every series has
        # the same samples per window, so count_over_time and the count
        # aggregate never need the values
        if dense and fn == "count_over_time" and not is_hist:
            return self._fused_count_over_time(data, t0, t1)
        if dense and t1.op == "count" and not is_hist:
            return self._fused_count_agg(data, t0, t1)
        routed = self._try_host_routed(data, t0, t1, wends, eval_wends, fn,
                                       dense, is_hist)
        if routed is not None:
            return routed
        # a host block the host route declined goes on to the device
        # paths with its values uploaded (once: the general path reuses
        # the copy)
        data = data.on_device(self.ctx.device, stats)
        if fn in fused.MINMAX_FNS:
            return self._fused_minmax(data, t0, t1, wends, eval_wends)
        if fn in ("rate", "increase") and not data.precorrected:
            # the reference leaf sends these to its general path too
            # (filodb_tpu/query/leafexec.py:220), never to in-kernel drops
            return None
        # plan + padded-values + group caches: a repeat query over an
        # unchanged snapshot skips the plan build, the padded device copy
        # and the per-series grouping
        key = self._fused_cache_key
        plan = padded_vals = groups = gkeys = None
        plan_key = None
        if key is not None:
            plan_key = key[:3] + (t0.start_ms, t0.step_ms, t0.end_ms,
                                  t0.offset_ms, t0.window_ms, data.base_ms)
            with _FUSED_CACHE_LOCK:
                plan = _lru_touch(_FUSED_PLAN_CACHE, plan_key)
                padded_vals = _lru_touch(_FUSED_VALS_CACHE, key)
            groups, gkeys = _group_cache_lookup(key, t1.by, t1.without)
            if padded_vals is not None:
                counters.inc("leaf_fused_prep_hits")
        if plan is None:
            plan = fused.build_plan(data.shared_ts_row.astype(np.int64),
                                    eval_wends, t0.window_ms)
            if plan_key is not None:
                with _FUSED_CACHE_LOCK:
                    for k in [k for k in _FUSED_PLAN_CACHE
                              if k[0] == key[0] and k[1] != key[1]]:
                        del _FUSED_PLAN_CACHE[k]
                    _FUSED_PLAN_CACHE[plan_key] = plan
                    while len(_FUSED_PLAN_CACHE) > 8:
                        _FUSED_PLAN_CACHE.pop(next(iter(_FUSED_PLAN_CACHE)))
        if gkeys is None:
            gids, gkeys = _group_ids_cached(data.cache_token, data.keys,
                                            t1.by, t1.without)
        self._check_group_limit(gkeys)
        vals = data.values
        S = vals.shape[0]
        B = vals.shape[2] if is_hist else 1
        # the kernels' index-space limits (the reference's VMEM guard):
        # a shape they do not take is the general path's, decided before
        # the padded device copy
        try:
            fused.check_kernel_shape(
                S * B, plan.Tp, plan.W,
                fused.pad_group_count(len(gkeys) * B))
        except ValueError:
            return None
        if padded_vals is None:
            if is_hist:
                flat = hist_ops.bucket_rows(vals)
                padded_vals = fused.pad_values(flat, data.vbase.reshape(-1),
                                               plan)
                del flat            # the padded copy holds it now
            else:
                padded_vals = fused.pad_values(vals, data.vbase, plan)
            if key is not None:
                # a new snapshot generation obsoletes this mirror's older
                # entries — each pins a full padded copy on the device
                with _FUSED_CACHE_LOCK:
                    for k in [k for k in _FUSED_VALS_CACHE
                              if k[0] == key[0] and k[1] != key[1]]:
                        del _FUSED_VALS_CACHE[k]
                    _vals_cache_insert(key, padded_vals)
        if groups is None:
            if is_hist:
                gids = hist_ops.bucket_slots(gids, B)
            groups = fused.pad_groups(gids, S * B, len(gkeys) * B,
                                      device=vals.device)
            _group_cache_insert(key, t1.by, t1.without, groups, gkeys)
        counters.inc("leaf_fused_kernel")
        ck = None if key is None else key + (
            t0.start_ms, t0.step_ms, t0.end_ms, t0.offset_ms,
            t0.window_ms, data.base_ms) + (("hist", B) if is_hist else ())
        fc = FusedCall(
            plan=plan, values=padded_vals, groups=groups, gkeys=gkeys,
            wends=wends, fn=fn, op=t1.op, precorrected=data.precorrected,
            ragged=not dense, num_series=S * B, cache_key=ck,
            bucket_les=data.bucket_les if is_hist else None,
            num_buckets=B,
            cache_token=agg_token("hist_sum" if is_hist else t1.op, t1.by,
                                  t1.without, data.cache_token))
        if defer:
            return fc
        self._check_cancel("fused kernel dispatch")
        return finish_fused_calls([fc])[0]

    def _try_host_routed(self, data, t0, t1, wends, eval_wends, fn, dense,
                         is_hist):
        """Host evaluation of a working set the router sent to the host
        (RawBlock.route_host): dense, shared grid, not a histogram, one of
        the five fusable aggregates.  Returns the AggPartial, or None to
        go on to the device paths."""
        if not (data.route_host and dense and not is_hist
                and data.shared_ts_row is not None
                and t1.op in ("sum", "avg", "count", "min", "max")
                and isinstance(data.values, np.ndarray)):
            return None
        if fn in ("rate", "increase") and not data.precorrected:
            return None
        # the batch's finished-partial memo: a dashboard repeats whole
        # subexpressions (one panel alone, as a ratio operand, under
        # topk), and within one memo scope an identical (working set, fn,
        # aggregate, grouping, grid) key means identical inputs, so the
        # evaluation is shared like the scan.  Inert outside a batch
        mkey = None
        if data.cache_token is not None:
            mkey = ("hpartial", data.cache_token, fn, t1.op, tuple(t1.by),
                    tuple(t1.without), t0.start_ms, t0.step_ms, t0.end_ms,
                    t0.offset_ms, t0.window_ms, data.base_ms)
            hit = hostleaf.memo_get(mkey)
            if hit is not None:
                self._check_group_limit(hit.group_keys)
                counters.inc("leaf_host_routed")
                self.route = "host"
                return dataclasses.replace(hit)
        plan = fused.build_plan(np.asarray(data.shared_ts_row, np.int64),
                                eval_wends, t0.window_ms)
        gids, gkeys = _group_ids_cached(data.cache_token, data.keys,
                                        t1.by, t1.without)
        self._check_group_limit(gkeys)
        comp = hostleaf.host_leaf_agg(plan, data.values, data.vbase,
                                      np.asarray(gids), len(gkeys), fn,
                                      t1.op)
        counters.inc("leaf_host_routed")
        self.route = "host"
        p = AggPartial(t1.op, gkeys, wends, comp=comp,
                       cache_token=agg_token(t1.op, t1.by, t1.without,
                                             data.cache_token))
        if mkey is not None:
            hostleaf.memo_put(mkey, p)
        return p

    def _window_counts_groups(self, data, t0, t1):
        """Host math shared by the no-device answers: per-window sample
        counts on the dense shared grid, group keys and group sizes."""
        wends = make_window_ends(t0.start_ms, t0.end_ms, t0.step_ms)
        eval_wends = wends - t0.offset_ms - data.base_ms
        gids, gkeys = _group_ids_cached(data.cache_token, data.keys,
                                        t1.by, t1.without)
        self._check_group_limit(gkeys)
        n = fused.window_counts(data.shared_ts_row.astype(np.int64),
                                eval_wends, t0.window_ms).astype(np.float64)
        gsize = np.bincount(np.asarray(gids),
                            minlength=len(gkeys))[:len(gkeys)]
        return wends, gkeys, n, gsize.astype(np.float64)

    def _fused_count_over_time(self, data, t0, t1):
        """agg (count_over_time(...)) on a dense shared grid: each series'
        value at window w is n[w], so the whole result is host math over
        (gsize, n), for all five aggregates."""
        wends, gkeys, n, gsize = self._window_counts_groups(data, t0, t1)
        valid = (n >= 1).astype(np.float64)
        op = t1.op
        if op in ("sum", "avg"):
            comp = np.stack([gsize[:, None] * n[None, :] * valid,
                             gsize[:, None] * valid[None, :]], axis=-1)
        elif op == "count":
            comp = (gsize[:, None] * valid[None, :])[..., None]
        else:                            # min/max: every series agrees on n
            absent = np.inf if op == "min" else -np.inf
            per = np.where(valid > 0, n, absent)
            comp = np.stack(
                [np.broadcast_to(per[None, :], (len(gkeys), len(n))),
                 gsize[:, None] * valid[None, :]], axis=-1)
        counters.inc("leaf_fused_count_host")
        return AggPartial(op, gkeys, wends, comp=comp,
                          cache_token=agg_token(op, t1.by, t1.without,
                                                data.cache_token))

    def _fused_count_agg(self, data, t0, t1):
        """count by (fn(...)) on a dense shared grid: the count of series
        emitting a value at window w is gsize * 1{n[w] >= minsamp} (two
        samples for the rate family, one otherwise) — host math, no
        device work (the values never matter)."""
        wends, gkeys, n, gsize = self._window_counts_groups(data, t0, t1)
        minsamp = 2 if t0.function in fused.RATE_FNS else 1
        valid = (n >= minsamp).astype(np.float64)
        counters.inc("leaf_fused_count_host")
        comp = (gsize[:, None] * valid[None, :])[..., None]
        return AggPartial("count", gkeys, wends, comp=comp,
                          cache_token=agg_token("count", t1.by, t1.without,
                                                data.cache_token))

    def _fused_minmax(self, data, t0, t1, wends, eval_wends):
        """min/max_over_time + any aggregate as windowed torch reductions
        on the mirror's device (ops/minmax.py).  Needs windows that are a
        uniform stride of the grid reaching at most one grid length past
        its right edge; anything else is the general path (None)."""
        ts_row0 = np.asarray(data.shared_ts_row)
        real = ts_row0[ts_row0 < PAD_TS]
        geom = minmax.uniform_window_geometry(real.astype(np.int64),
                                              eval_wends, t0.window_ms)
        if geom is None:
            return None
        f0, stride, width, t_needed = geom
        if t_needed > 2 * real.size:
            return None
        key = self._fused_cache_key
        groups, gkeys = _group_cache_lookup(key, t1.by, t1.without)
        vals = data.values
        S = vals.shape[0]
        if gkeys is None:
            gids, gkeys = _group_ids_cached(data.cache_token, data.keys,
                                            t1.by, t1.without)
            self._check_group_limit(gkeys)      # reject BEFORE caching
            groups = fused.pad_groups(gids, S, len(gkeys),
                                      device=vals.device)
            _group_cache_insert(key, t1.by, t1.without, groups, gkeys)
        else:
            self._check_group_limit(gkeys)
        ragged = not data.dense
        if t_needed > real.size:
            # windows hang past the data's right edge (end=now queries):
            # NaN columns extend the grid and the ragged variant masks
            # them; cached per (working set, t_needed), or each dashboard
            # poll would copy the whole working set again
            pad_key = None if key is None else key + ("minmax_pad",
                                                      t_needed)
            padded = None
            if pad_key is not None:
                with _FUSED_CACHE_LOCK:
                    padded = _lru_touch(_FUSED_MINMAX_PAD_CACHE, pad_key)
            if padded is None:
                padded = torch.full((S, t_needed), float("nan"),
                                    dtype=vals.dtype, device=vals.device)
                padded[:, :real.size] = vals[:, :real.size]
                if pad_key is not None:
                    with _FUSED_CACHE_LOCK:
                        for k in [k for k in _FUSED_MINMAX_PAD_CACHE
                                  if k[0] == pad_key[0]
                                  and k[1] != pad_key[1]]:
                            del _FUSED_MINMAX_PAD_CACHE[k]
                        _FUSED_MINMAX_PAD_CACHE[pad_key] = padded
                        while len(_FUSED_MINMAX_PAD_CACHE) > 2:
                            _FUSED_MINMAX_PAD_CACHE.pop(
                                next(iter(_FUSED_MINMAX_PAD_CACHE)))
            vals = padded
            ragged = True
        d0 = time.perf_counter()
        comp = minmax.fused_minmax_agg(
            vals, data.vbase, groups.gids_p[:S], f0, stride, width,
            int(eval_wends.size), t0.function, t1.op, len(gkeys), ragged,
            csr=groups.csr)
        comp_np = comp.cpu().numpy()             # synchronizing readback
        telem.record_dispatch(
            "fused_minmax", device=vals.device,
            shape=f"S{vals.shape[0]}xW{int(eval_wends.size)}xG{len(gkeys)}",
            seconds=time.perf_counter() - d0,
            bytes_in=int(vals.numel() * vals.element_size()),
            bytes_out=comp_np.nbytes)
        counters.inc("leaf_fused_minmax")
        return AggPartial(t1.op, gkeys, wends, comp=comp_np,
                          cache_token=agg_token(t1.op, t1.by, t1.without,
                                                data.cache_token))

    def _check_group_limit(self, gkeys) -> None:
        limit = self.ctx.planner_params.group_by_cardinality_limit
        if limit and len(gkeys) > limit:
            raise GroupCardinalityError(
                f"group-by cardinality limit {limit} exceeded "
                f"({len(gkeys)} groups)")

    def _do_execute(self, source):
        stats = QueryStats(shards_queried=1)
        shard = source.get_shard(self.dataset, self.shard)
        if shard is None:
            return None, stats
        lookup = shard.lookup_partitions(self.filters, self.chunk_start_ms,
                                         self.chunk_end_ms)
        schema_name = self.schema or lookup.first_schema
        if schema_name is None:
            return None, stats
        pids = lookup.pids_by_schema.get(schema_name)
        if pids is None or pids.size == 0:
            return None, stats
        store = shard.stores[schema_name]
        rows = shard.rows_for(pids)
        # the scan cap, before anything is gathered or paged: a
        # pathological selector fails fast instead of filling memory
        # first.  The estimate clips each series to the chunk range under
        # uniform spacing, over the resident data; it is memoized with the
        # lookup per store generation (at 1M series one estimate reads 2M
        # scattered timestamps).  Checked again after demand paging
        limit = self.ctx.planner_params.scan_limit
        enforced = bool(limit and self.ctx.planner_params.enforced_limits)

        def check_scan_cap(when: str) -> int:
            est_key = (schema_name, store.generation)
            est = lookup.scan_estimates.get(est_key)
            if est is None:
                est = lookup.scan_estimates[est_key] = _estimate_scan(
                    store, rows, self.chunk_start_ms, self.chunk_end_ms)
            if enforced and est > limit:
                raise ValueError(
                    f"shard {self.shard}: query would scan ~{est} samples "
                    f"({when}), over the scan limit {limit} — narrow the "
                    f"filters or time range")
            return est

        est = check_scan_cap("resident")
        # demand paging: sealed history the dense tier dropped comes back
        # from the resident tier or the column store, at most `limit`
        # samples of it (the work already paged is kept); a killed query
        # stops paging between partitions
        tok = getattr(self.ctx, "cancel", None)
        try:
            paged = shard.ensure_paged_pids(
                schema_name, pids, self.chunk_start_ms, self.chunk_end_ms,
                max_samples=limit if enforced else None,
                cancel=(None if tok is None else
                        lambda: self._check_cancel("demand paging")))
        except PagedLimitExceeded as e:
            raise QueryError("paged_limit_exceeded", str(e)) from None
        if paged:
            stats.samples_paged += int(paged)
            est = check_scan_cap("after demand paging")
        schema = shard.schemas[schema_name]
        col_name = self.columns[0] if self.columns else schema.value_column
        # schema-specific column + range-function substitution for the
        # downsample gauge schema: min_over_time reads the `min` column,
        # count_over_time becomes sum_over_time over `count`, etc.  Applied
        # as per-execution overrides so the plan stays reusable
        # (ref: MultiSchemaPartitionsExec.finalizePlan schema substitutions;
        # Schemas DS_GAUGE_FN_SUBSTITUTION)
        if schema.name == "ds-gauge" and not self.columns:
            for i, t in enumerate(self.transformers):
                if isinstance(t, PeriodicSamplesMapper):
                    sub = DS_GAUGE_FN_SUBSTITUTION.get(t.function)
                    if sub is not None:
                        col_name = sub[0]
                        if sub[1] != t.function:
                            self._transformer_overrides[i] = \
                                dataclasses.replace(t, function=sub[1])
                    break
        col_def = next((c for c in schema.data_columns
                        if c.name == col_name), None)
        if col_def is None:
            # a column the schema lacks fails the query as the
            # reference's gather does, on the column's lookup
            raise KeyError(col_name)
        counter_col = col_def.detect_drops or col_def.counter
        fn_is_counter = periodic = False
        for t in self.transformers:
            if isinstance(t, PeriodicSamplesMapper):
                fn_is_counter = t.function in COUNTER_FNS
                periodic = True
                break
        # the cost-based router, on only where the environment sets
        # FILODB_TPU_FORCE_HOST_ROUTE: a working set of at most
        # query.host_route_max_samples samples (0: the router is off) is
        # gathered on the host and, where _try_fused's host route takes
        # it, evaluated there
        route_host = False
        route_cap = settings().query.host_route_max_samples
        if route_cap > 0 and os.environ.get("FILODB_TPU_FORCE_HOST_ROUTE"):
            route_est = est
            if counter_col and fn_is_counter:
                # its reset correction also reads each row's history
                # before the window: count every sample up to the window's
                # last column
                p_hi = store.window_positions(self.chunk_start_ms,
                                              self.chunk_end_ms)[1]
                route_est = int(np.minimum(store.counts[rows], p_hi).sum())
            route_host = 0 < route_est <= route_cap
        shared_ts_row = None
        mirrored = None
        if (not route_host and shard.config.store.device_mirror_enabled
                and (not counter_col or fn_is_counter)):
            mirrored = self._mirror_gather(shard, store, rows, col_name)
        if mirrored is not None:
            ts_off, vals, vbase, base, counts, shared_ts_row, dense = \
                mirrored
            precorrected = counter_col
        else:
            # the mirror holds counters reset-corrected, so a non-counter
            # function over a counter column reads the raw values here; a
            # counter function (the router's, or a query falling back
            # during a mirror rebuild) gets them corrected as the mirror
            # would
            precorrected = counter_col and fn_is_counter
            base = self.chunk_start_ms
            # f32, the type the device computes in, where the values go
            # on to the device; f64 for the numpy host route and for a
            # raw range vector, which the root returns as it is
            ts_off, vals, vbase, counts, dense = self._host_gather(
                shard, store, rows, col_name, precorrected,
                np.float32 if periodic and not route_host else np.float64)
            if route_host:
                shared_ts_row = _host_shared_row(ts_off, counts)
        keys = LazyKeys(shard, pids)
        stats.series_scanned = int(pids.size)
        stats.samples_scanned = int(counts.sum())
        les = store.bucket_les if vals.ndim == 3 else None
        return RawBlock(keys, ts_off, vals, base, les,
                        samples=stats.samples_scanned, vbase=vbase,
                        precorrected=precorrected,
                        shared_ts_row=shared_ts_row, dense=dense,
                        cache_token=(shard.keys_serial, shard.keys_epoch,
                                     pids.tobytes()),
                        route_host=route_host), stats

    def _create_mirror(self, shard, store):
        """The store's DeviceMirror, made once under mirror_create_lock
        (two concurrent first queries would otherwise each reserve a
        device with the placer).  In the sharded mode
        (devicecache.sharded_mirrors_enabled) the mirror goes to the
        device the MirrorPlacer assigns this shard, with the placer's
        reservation, so a multi-shard query runs each shard's kernel on
        its own card; otherwise to the shard's device."""
        from filodb_tpu_torch.core.devicecache import (
            DeviceMirror, mirror_create_lock, placer,
            sharded_mirrors_enabled, store_nbytes)
        cfg = shard.config.store
        with mirror_create_lock:
            mirror = getattr(store, "device_mirror", None)
            if mirror is None:
                limit = cfg.device_mirror_hbm_limit
                device, est, placed = shard.device, 0, False
                if sharded_mirrors_enabled(cfg, shard.device):
                    est = store_nbytes(store)
                    device = placer.assign(self.shard, est, limit,
                                           like=shard.device)
                    placed = True
                mirror = store.device_mirror = DeviceMirror(
                    limit, device=device, shard_num=self.shard,
                    reserved_bytes=est, placed=placed)
                _note_mirror_limit(mirror.hbm_limit_bytes, mirror.device)
        return mirror

    def _mirror_gather(self, shard, store, rows, col_name):
        """The rows from the device mirror, or None when this query is
        served by the host gather instead.  A stale mirror is refreshed
        under the write lock, so it cannot race ingest: inline when only
        appends happened (the incremental upload) or on the first build.
        When cells were rearranged (eviction, paging: shift_version
        moved), the full re-upload runs on a background thread and this
        query falls back (device_mirror_query_fallbacks), unless the
        context or the shard's `store.mirror_background_rebuild` turns
        the background rebuild off, the upload would exceed
        the mirror's cap or the last background rebuild failed: then it
        runs inline and its error (MirrorCapExceeded) reaches the query.
        The row gather then reads only the immutable device snapshot."""
        mirror = getattr(store, "device_mirror", None)
        if mirror is None:
            mirror = self._create_mirror(shard, store)
        if not mirror.is_fresh(store):
            bg = (self.ctx.mirror_background_rebuild
                  and shard.config.store.mirror_background_rebuild
                  and mirror.may_rebuild_in_background(store))
            ok = False
            if mirror.can_update_inline(store) or not bg:
                with shard._write_locked("mirror_refresh"):
                    # re-check under the lock: an eviction may move
                    # shift_version between the check and the lock
                    if not bg or mirror.can_update_inline(store):
                        ok = mirror.ensure_fresh(store)
            if not ok:
                mirror.request_background_refresh(shard, store)
                counters.inc("device_mirror_query_fallbacks")
                return None
        # one snapshot read serves gather AND fused eligibility
        snap = mirror.snapshot()
        g0 = time.perf_counter()
        ts_off, dev_cols, dev_vbases, base = mirror.gather_cached(rows, snap)
        # enqueue time: the gathered tensors are not read back here
        telem.record_dispatch("mirror_gather", device=mirror.device,
                              shape=f"rows{len(rows)}",
                              seconds=time.perf_counter() - g0)
        shared_ts_row = mirror.fused_eligible(col_name, snap,
                                              allow_ragged=True)
        if shared_ts_row is not None:
            # cache identity for the fused path's padded-input reuse
            # (mirror.serial, not id(); raw rows bytes, not a hash)
            self._fused_cache_key = (mirror.serial, snap.gen, col_name,
                                     rows.tobytes())
        return (ts_off, dev_cols[col_name], dev_vbases.get(col_name), base,
                snap.counts[rows], shared_ts_row,
                mirror.col_dense(col_name, snap))

    def _host_gather(self, shard, store, rows, col_name, precorrected,
                     dtype):
        """The windowed host gather: only the chunk-scan span of the rows
        is copied, its timestamps become int32 offsets from chunk_start_ms
        and the values are rebased per series in f64, then stored as
        `dtype`.  When `precorrected` the values are reset-corrected as
        the mirror corrects them, from each row's first sample: the
        correction of the row's history before the span is carried in.
        A histogram column gathers [S, T, B].  Row blocks run on a thread
        pool, inside one seqlock snapshot of the store; the blocking
        changes no output bit.  A kill or an expired deadline stops the
        remaining blocks.  -> (ts_off, vals, vbase, counts, dense),
        numpy.

        Under a query_range_batch's memo scope (ops/hostleaf.py) the
        panels over one working set share the work: the processed arrays
        by (span, column, correction, dtype, rows, keys epoch); the raw
        gathered values by (span, column, rows), for a panel that reads
        the same column with another correction or type; the offsets by
        (span, rows), for one that reads another column.  Every consumer
        reads these arrays and never writes them."""
        start = self.chunk_start_ms
        span = (shard.keys_serial, shard.keys_epoch, self.dataset,
                self.shard, start, self.chunk_end_ms)
        rows_b = rows.tobytes()
        memo_key = span + (col_name, precorrected, np.dtype(dtype).str,
                           rows_b)
        hit = hostleaf.memo_get(memo_key)
        if hit is not None:
            return hit
        raw_key = ("raw",) + span + (col_name, rows_b)
        off_key = ("off",) + span + (rows_b,)
        raw = hostleaf.memo_get(raw_key)
        ts_memo = hostleaf.memo_get(off_key)
        keep_raw = raw is None and hostleaf.memo_active()

        def gather():
            pos = raw[0] if raw is not None else \
                store.window_positions(start, self.chunk_end_ms)
            width = pos[1] - pos[0]
            col = store.cols[col_name]
            S = len(rows)
            ts_off = ts_memo if ts_memo is not None else \
                np.empty((S, width), np.int32)
            vals = np.empty((S, width) + col.shape[2:], dtype)
            vbase = np.empty((S,) + col.shape[2:], np.float64)
            counts = np.empty(S, np.int32)
            nblk = -(-S // HOST_GATHER_BLOCK_ROWS)
            raw_blocks = raw[1] if raw is not None else [None] * nblk

            def block(b):
                if self._stopped():
                    return False
                sl = slice(b * HOST_GATHER_BLOCK_ROWS,
                           min((b + 1) * HOST_GATHER_BLOCK_ROWS, S))
                if raw is not None:
                    v, cnt = raw_blocks[b], raw[2][sl]
                else:
                    ts, cols, cnt = store.gather_rows(
                        rows[sl], positions=pos, columns=(col_name,))
                    v = cols[col_name]
                    if ts_memo is None:
                        ts_off[sl] = to_offsets(ts, cnt, start)
                    if keep_raw:
                        raw_blocks[b] = v
                if precorrected:
                    v = counter.host_counter_correct_after(
                        col[rows[sl], :pos[0]], v)
                v, vbase[sl] = counter.rebase_values(v, False)
                vals[sl] = v
                counts[sl] = cnt
                # NaN anywhere (staleness markers or ragged-length
                # padding) routes the rate family onto its valid-boundary
                # variant
                return bool(np.isnan(v).any())

            holes = list(_gather_pool().map(block, range(nblk)))
            self._check_live("host gather")
            return (ts_off, vals, vbase, counts, not any(holes)), pos, \
                raw_blocks

        # the memo takes only a consistent snapshot's arrays (a torn
        # attempt's are dropped by snapshot_read's retry)
        out, pos, raw_blocks = shard.snapshot_read(store, gather)
        if keep_raw:
            hostleaf.memo_put(raw_key, (pos, raw_blocks, out[3]))
        if ts_memo is None:
            hostleaf.memo_put(off_key, out[0])
        hostleaf.memo_put(memo_key, out)
        return out

    def _stopped(self) -> bool:
        """The query was killed or ran out of its deadline (the host
        gather's blocks test it; _check_live raises)."""
        tok = getattr(self.ctx, "cancel", None)
        if tok is not None and tok.cancelled:
            return True
        dl = getattr(self.ctx, "deadline_unix_s", 0.0)
        return bool(dl and time.time() >= dl)


HOST_GATHER_BLOCK_ROWS = 16_384
"""Rows a worker of the host gather copies and processes at a time."""

_GATHER_POOL: Optional[ThreadPoolExecutor] = None
_GATHER_POOL_LOCK = threading.Lock()


def _gather_pool() -> ThreadPoolExecutor:
    """The host gather's worker threads (numpy releases the GIL in the
    copies and ufuncs), created at first use: one a core, at most 8."""
    global _GATHER_POOL
    with _GATHER_POOL_LOCK:
        if _GATHER_POOL is None:
            _GATHER_POOL = ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1),
                thread_name_prefix="host-gather")
        return _GATHER_POOL


def _host_shared_row(ts_off: np.ndarray, counts: np.ndarray
                     ) -> Optional[np.ndarray]:
    """The shared-grid row of a host gather, derived as the mirror
    certifies it (every row has the same count and the same offsets over
    its samples), so small dense sets stay fusable; else None."""
    if not (ts_off.size and counts.size and (counts == counts[0]).all()):
        return None
    n = max(int(counts[0]), 1)
    if not (ts_off[:, :n] == ts_off[0, :n]).all():
        return None
    return ts_off[0, :int(counts[0])]


def _estimate_scan(store, rows: np.ndarray, start_ms: int,
                   end_ms: int) -> int:
    """Estimated samples in [start_ms, end_ms] across the given store rows,
    from per-series extents under a uniform-spacing assumption — O(S), no
    [S, T] materialization."""
    cnt = store.counts[rows].astype(np.int64)
    if store.ts.shape[1] == 0 or not cnt.any():
        return 0
    first = store.ts[rows, 0]
    last = store.ts[rows, np.maximum(cnt - 1, 0)]
    lo = np.maximum(first, start_ms)
    hi = np.minimum(last, end_ms)
    span = np.maximum(last - first, 1).astype(np.float64)
    frac = np.clip((hi - lo).astype(np.float64) / span, 0.0, 1.0)
    est = np.where((cnt > 0) & (hi >= lo), np.maximum(cnt * frac, 1.0), 0.0)
    return int(est.sum())


class SelectPersistedSegmentsExec(MultiSchemaPartitionsExec):
    """Leaf of the persisted-segment (historical) tier: gathers rows from
    the cold region's segment blocks (persist/segments.ColdBlock) instead
    of the shard's dense store, then runs the same transformer and fused
    pipeline as the hot leaf, so a cold rate panel is K1 over the cold
    blocks.

    Over several segments the rows are unioned by part key and packed
    (_merge_cold): each union row's samples contiguous, the counter
    correction carried across segment boundaries.  On the card the gather
    is index_select and the merge torch ops on the blocks' device; a
    block the cold region built on the host (its over-budget degrade)
    merges in numpy.  A non-counter function over a counter column reads
    raw values: the segments are decoded again on the host
    (_gather_cold_raw).

    `tier` is the persist.segments.PersistedTier PersistedClusterPlanner
    binds at plan time."""

    def __init__(self, ctx: QueryContext, dataset: str, shard: int,
                 filters: Sequence[ColumnFilter], chunk_start_ms: int,
                 chunk_end_ms: int, tier, columns: Sequence[str] = (),
                 schema: Optional[str] = None):
        super().__init__(ctx, dataset, shard, filters, chunk_start_ms,
                         chunk_end_ms, columns=columns, schema=schema)
        self.tier = tier

    def args_str(self):
        fs = ",".join(str(f) for f in self.filters)
        return (f"dataset={self.dataset}, shard={self.shard}, tier=cold, "
                f"chunkMethod=TimeRangeChunkScan({self.chunk_start_ms},"
                f"{self.chunk_end_ms}), filters=[{fs}]")

    def _do_execute(self, source):
        # a dead or corrupt object store under the tier is a typed
        # shard_unavailable: the gather drops the leaf under the
        # partial-results gate (a flagged partial), as for a dead peer
        try:
            return self._cold_execute(source)
        except Exception as e:  # noqa: BLE001 - re-raise non-store errors
            from filodb_tpu_torch.persist.objectstore import ObjectStoreError
            if not isinstance(e, ObjectStoreError):
                raise
            raise QueryError(
                "shard_unavailable",
                f"shard {self.shard}: cold tier unavailable ({e})")

    def _cold_execute(self, source):
        stats = QueryStats(shards_queried=1)
        segs = self.tier.covering(self.shard, self.chunk_start_ms,
                                  self.chunk_end_ms, self.schema)
        if not segs:
            return None, stats
        by_schema = {}
        for m in segs:
            by_schema.setdefault(m.schema_name, []).append(m)
        # the first schema (in coverage order) whose segments hold a
        # matching row: the reference reads only the first schema's, so
        # a metric of another schema in the same shard answered nothing
        verdict = "cold_hit"
        picked = []                       # (block, rows)
        for schema_name, metas in by_schema.items():
            picked, paged = self._page_schema(
                sorted(metas, key=lambda m: m.start_ms), stats)
            if paged:
                verdict = "cold_paged"
            if picked:
                break
        col_name = (self.columns[0] if self.columns
                    else self.tier.schemas[schema_name].value_column)
        stats.cold_tier = verdict
        if not picked:
            return None, stats
        # the scan cap over the filter-matched rows (what this query
        # scans, not the shard's segment volume), before the gather
        limit = self.ctx.planner_params.scan_limit
        if limit and self.ctx.planner_params.enforced_limits:
            est = sum(int(b.counts[r].sum()) for b, r in picked)
            if est > limit:
                raise ValueError(
                    f"shard {self.shard}: persisted-tier query would scan "
                    f"~{est} samples, over the scan limit {limit} — "
                    f"narrow the filters or time range")
        base_ms = picked[0][0].meta.start_ms
        span = max(b.meta.end_ms for b, _ in picked) - base_ms
        if span >= (1 << 30):
            raise ValueError(
                "persisted-tier slice spans >2^30 ms — the planner must "
                "split long ranges (PersistedClusterPlanner.plan_split_ms)")
        return self._gather_cold(picked, col_name, base_ms, stats), stats

    def _page_schema(self, metas, stats):
        """Page one schema's segments into the cold region (concurrently:
        decode and upload overlap, so the cold wall is about one
        segment's) and match the filters -> ([(block, rows)] with rows,
        whether a block was paged now)."""
        self._check_cancel("cold-segment page-in")
        if len(metas) > 1:

            def fetch(m):
                # a killed scan stops between page-ins
                self._check_cancel("cold-segment page-in")
                return self.tier.get_block(m)

            with ThreadPoolExecutor(max_workers=min(4, len(metas))) as pool:
                fetched = list(pool.map(fetch, metas))
        else:
            fetched = [self.tier.get_block(metas[0])]
        self._check_cancel("cold-segment gather")
        paged = False
        picked = []
        for block, v in fetched:
            rows = block.match_rows(self.filters, self.chunk_start_ms,
                                    self.chunk_end_ms)
            if v == "cold_paged":
                paged = True
                stats.samples_paged += int(block.counts.sum())
                stats.bytes_paged += int(block.nbytes)
            if rows.size:
                picked.append((block, rows))
        return picked, paged

    def _gather_cold(self, picked, col_name: str, base_ms: int, stats):
        counter_col = col_name in picked[0][0].counter_cols
        fn_is_counter = False
        for t in self.transformers:
            if isinstance(t, PeriodicSamplesMapper):
                fn_is_counter = t.function in COUNTER_FNS
                break
        if counter_col and not fn_is_counter:
            # resets/changes/... read raw counter values: decode the
            # segments again on the host (uncached, the rare path), as
            # the hot leaf bypasses the corrected mirror
            return self._gather_cold_raw(picked, col_name, base_ms, stats)
        host = any(b.is_host for b, _ in picked)
        seg_inputs = []
        for block, rows in picked:
            vals = block.cols[col_name]
            vbase = block.vbase[col_name][rows]
            if host:
                ts_g = np.asarray(block.ts_off)[rows]
                v_g = np.asarray(vals)[rows]
            else:
                idx = torch.from_numpy(rows).to(vals.device)
                ts_g = block.ts_off.index_select(0, idx)
                v_g = vals.index_select(0, idx)
            seg_inputs.append({
                "block": block, "rows": rows, "ts_off": ts_g, "vals": v_g,
                "counts": block.counts[rows], "t0": block.meta.start_ms,
                "vbase": vbase})
        samples = int(sum(int(si["counts"].sum()) for si in seg_inputs))
        stats.samples_scanned = samples
        if len(seg_inputs) == 1:
            si = seg_inputs[0]
            block, rows = picked[0]
            stats.series_scanned = int(rows.size)
            self._fused_cache_key = (("cold", block.serial), 0, col_name,
                                     rows.tobytes())
            return RawBlock(
                block.keys_for(rows), si["ts_off"], si["vals"], si["t0"],
                None, samples=samples,
                vbase=_vbase_like(si["vbase"], si["vals"]),
                precorrected=counter_col,
                shared_ts_row=block.ts_row0 if block.uniform else None,
                dense=block.dense.get(col_name, False),
                cache_token=("cold", block.serial, rows.tobytes()))
        return self._merge_cold(seg_inputs, picked, col_name, counter_col,
                                base_ms, stats, samples, host)

    def _merge_cold(self, seg_inputs, picked, col_name: str,
                    counter_col: bool, base_ms: int, stats, samples: int,
                    host: bool):
        """Stitch K time-ordered segment gathers into one packed [Su, Tt]
        RawBlock: union the row sets by part key, chain the counter
        correction across segment boundaries (a row whose first raw value
        in a segment is below its last raw value in the one before was
        reset there), and pack each union row's samples contiguously
        (the general windowing path needs per-row sorted offsets with the
        pads at the end).  The packed arrays are cached on the tier, so
        a repeat query over the same cold row set reuses them."""
        serials = tuple(b.serial for b, _ in picked)
        rows_token = b"".join(r.tobytes() for _, r in picked)
        mkey = (serials, col_name, rows_token, base_ms)
        self._fused_cache_key = (("cold",) + serials, 0, col_name,
                                 rows_token)
        cached = self.tier.merged_get(mkey)
        if cached is None:
            cached = self._pack_merged(seg_inputs, picked, col_name,
                                       counter_col, base_ms, host)
            self.tier.merged_put(mkey, cached)
        union_keys, ts_out, v_out, out_vbase, shared, dense, Su = cached
        stats.series_scanned = Su
        return RawBlock(union_keys, ts_out, v_out, base_ms, None,
                        samples=samples, vbase=out_vbase,
                        precorrected=counter_col, shared_ts_row=shared,
                        dense=dense,
                        cache_token=("cold", serials, rows_token))

    def _pack_merged(self, seg_inputs, picked, col_name, counter_col,
                     base_ms, host):
        union = {}
        union_keys = []
        urows_per = []
        for block, rows in picked:
            pk_bytes = block.identity.pk_bytes
            urows = np.empty(len(rows), dtype=np.int64)
            new_local = []
            for i, r in enumerate(rows.tolist()):
                u = union.get(pk_bytes[r])
                if u is None:
                    u = union[pk_bytes[r]] = len(union)
                    new_local.append(i)
                urows[i] = u
            if new_local:
                union_keys.extend(block.keys_for(rows[np.asarray(new_local)]))
            urows_per.append(urows)
        Su = len(union)
        # per union row: the packed layout and the cross-segment carry
        out_vbase = np.full(Su, np.nan)
        carry = np.zeros(Su)
        prev_last = np.full(Su, np.nan)
        flat_ts, flat_v = [], []
        flat_base = 0
        src_of = []                      # (flat_base, Tk, urows, counts)
        for si, ur in zip(seg_inputs, urows_per):
            block = si["block"]
            cnt = np.asarray(si["counts"], dtype=np.int64)
            vb = np.asarray(si["vbase"], np.float64)
            first_seen = np.isnan(out_vbase[ur])
            out_vbase[ur] = np.where(first_seen, vb, out_vbase[ur])
            if counter_col:
                fr = block.first_raw[col_name][si["rows"]]
                boundary = (~np.isnan(prev_last[ur])) & np.less(
                    fr, prev_last[ur],
                    where=~np.isnan(fr) & ~np.isnan(prev_last[ur]),
                    out=np.zeros(len(ur), dtype=bool))
                carry[ur] += np.where(boundary, prev_last[ur], 0.0)
            adj = vb + carry[ur] - out_vbase[ur]          # f64 [Rk]
            if counter_col:
                carry[ur] += block.cum_drop[col_name][si["rows"]]
                lr = block.last_raw[col_name][si["rows"]]
                prev_last[ur] = np.where(np.isnan(lr), prev_last[ur], lr)
            Tk = int(si["ts_off"].shape[1])
            delta = int(si["t0"] - base_ms)
            ts_k, v_k = si["ts_off"], si["vals"]
            if host:
                ts_adj = np.where(ts_k == PAD_TS, PAD_TS,
                                  ts_k + np.int32(delta))
                # the device branch's f32 add, so a degraded block
                # answers to the bit as a resident one does
                v_adj = v_k + adj[:, None].astype(v_k.dtype)
            else:
                ts_adj = torch.where(ts_k == PAD_TS, ts_k, ts_k + delta)
                v_adj = v_k + torch.from_numpy(adj[:, None]).to(
                    v_k.device, v_k.dtype)
            flat_ts.append(ts_adj.reshape(-1))
            flat_v.append(v_adj.reshape(-1))
            src_of.append((flat_base, Tk, ur, cnt))
            flat_base += len(ur) * Tk
        ct = np.zeros(Su, dtype=np.int64)
        for _, _, ur, cnt in src_of:
            ct[ur] += cnt
        Tmax = int(ct.max()) if Su else 0
        # one sentinel slot (PAD_TS, NaN) is appended for the pads
        out_idx = np.full((Su, Tmax), flat_base,
                          dtype=np.int32 if flat_base < (1 << 31) - 1
                          else np.int64)
        write_pos = np.zeros(Su, dtype=np.int64)
        for base_k, Tk, ur, cnt in src_of:
            jj = np.arange(Tk)
            valid = jj[None, :] < cnt[:, None]
            src = base_k + np.arange(len(ur))[:, None] * Tk + jj[None, :]
            rows_rep = np.repeat(ur, cnt)
            cols_rep = (write_pos[ur][:, None] + jj[None, :])[valid]
            out_idx[rows_rep, cols_rep] = src[valid]
            write_pos[ur] += cnt
        if host:
            ts_all = np.concatenate(flat_ts + [np.asarray([PAD_TS],
                                                          np.int32)])
            v_all = np.concatenate(flat_v + [np.asarray([np.nan],
                                                        flat_v[0].dtype)])
            ts_out, v_out = ts_all[out_idx], v_all[out_idx]
            vbase = out_vbase
        else:
            dev = flat_v[0].device
            ts_all = torch.cat(flat_ts + [torch.full(
                (1,), PAD_TS, dtype=torch.int32, device=dev)])
            v_all = torch.cat(flat_v + [torch.full(
                (1,), float("nan"), dtype=flat_v[0].dtype, device=dev)])
            idx = torch.from_numpy(out_idx.reshape(-1)).to(dev)
            ts_out = ts_all.index_select(0, idx).reshape(Su, Tmax)
            v_out = v_all.index_select(0, idx).reshape(Su, Tmax)
            vbase = torch.from_numpy(out_vbase).to(dev)
        dense = all(b.dense.get(col_name, False) for b, _ in picked)
        # the shared grid survives the merge only when every union row
        # took every segment's full uniform grid
        shared = None
        if all(b.uniform for b, _ in picked) \
                and all(len(ur) == Su for _, _, ur, _ in src_of) \
                and Su > 0 and (ct == ct[0]).all():
            cat = np.concatenate([
                (b.ts_row0[:int(b.counts[0])].astype(np.int64)
                 + (b.meta.start_ms - base_ms)).astype(np.int32)
                for b, _ in picked])
            if cat.size == Tmax:
                shared = cat
        return union_keys, ts_out, v_out, vbase, shared, dense, Su

    def _gather_cold_raw(self, picked, col_name: str, base_ms: int,
                         stats):
        """The raw-value host path (a non-counter function over a counter
        column): decode the segments again and merge uncorrected values
        (f64 numpy; the transformers upload it)."""
        series = {}
        keys = {}
        for block, rows in picked:
            hdr, ts, cols = self.tier.store.load(block.meta)
            vals = cols.get(col_name)
            if vals is None:
                continue
            for r in rows.tolist():
                kb = block.part_keys[r].to_bytes()
                n = int(hdr["counts"][r])
                series.setdefault(kb, []).append((ts[r, :n], vals[r, :n]))
                keys.setdefault(kb, block.keys_for(np.asarray([r]))[0])
        if not series:
            return None
        Su = len(series)
        merged = []
        for parts in series.values():
            parts.sort(key=lambda p: p[0][0] if len(p[0]) else 0)
            merged.append((np.concatenate([p[0] for p in parts]),
                           np.concatenate([p[1] for p in parts])))
        Tmax = max(len(t) for t, _ in merged)
        counts = np.asarray([len(t) for t, _ in merged], dtype=np.int64)
        ts_grid = np.zeros((Su, Tmax), dtype=np.int64)
        v_grid = np.full((Su, Tmax), np.nan)
        for i, (t, v) in enumerate(merged):
            ts_grid[i, :len(t)] = t
            v_grid[i, :len(v)] = v
        stats.series_scanned = Su
        stats.samples_scanned = int(counts.sum())
        ts_off = to_offsets(ts_grid, counts, base_ms)
        vals, vbase = counter.rebase_values(v_grid, False)
        dense = not bool(np.isnan(
            vals[np.arange(Tmax)[None, :] < counts[:, None]]).any())
        return RawBlock(list(keys.values()), ts_off, vals, base_ms, None,
                        samples=stats.samples_scanned, vbase=vbase,
                        precorrected=False, shared_ts_row=None,
                        dense=dense)


def _vbase_like(vbase: np.ndarray, vals):
    """A cold gather's per-row f64 bases beside its values: a tensor on
    their device, or the numpy array for a host block."""
    if isinstance(vals, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(vbase)).to(vals.device)
    return vbase


# ------------------------------------------------------------- scalar execs

class TimeScalarGeneratorExec(LeafExecPlan):
    """time(), hour(), ... of the step timestamps."""

    def __init__(self, ctx, start_ms, step_ms, end_ms, function="time"):
        super().__init__(ctx)
        self.start_ms, self.step_ms, self.end_ms = start_ms, step_ms, end_ms
        self.function = function

    def args_str(self):
        return f"function={self.function}"

    def _do_execute(self, source):
        wends = make_window_ends(self.start_ms, self.end_ms, self.step_ms)
        secs = wends / 1000.0
        if self.function == "time":
            vals = secs
        else:
            # the date functions read their values as epoch seconds
            vals = INSTANT_FUNCTIONS[self.function](
                torch.from_numpy(secs).to(self.ctx.device)).cpu().numpy()
        return ScalarResult(wends, np.asarray(vals, dtype=float)), \
            QueryStats()


class ScalarFixedDoubleExec(LeafExecPlan):
    """A literal scalar."""

    def __init__(self, ctx, start_ms, step_ms, end_ms, value: float):
        super().__init__(ctx)
        self.start_ms, self.step_ms, self.end_ms = start_ms, step_ms, end_ms
        self.value = value

    def args_str(self):
        return f"value={self.value}"

    def _do_execute(self, source):
        wends = make_window_ends(self.start_ms, self.end_ms, self.step_ms)
        return ScalarResult(wends, np.full(len(wends), self.value)), \
            QueryStats()


class ScalarBinaryOperationExec(LeafExecPlan):
    """scalar op scalar; a comparison always acts as `bool` (PromQL)."""

    def __init__(self, ctx, start_ms, step_ms, end_ms, operator, lhs, rhs):
        super().__init__(ctx)
        self.start_ms, self.step_ms, self.end_ms = start_ms, step_ms, end_ms
        self.operator = operator
        self.lhs = lhs          # float or ScalarBinaryOperationExec
        self.rhs = rhs

    def args_str(self):
        return f"operator={self.operator}"

    def _eval(self, x, source):
        if isinstance(x, ScalarBinaryOperationExec):
            return x._do_execute(source)[0].values
        return float(x)

    def _do_execute(self, source):
        wends = make_window_ends(self.start_ms, self.end_ms, self.step_ms)

        def side(x):
            a = np.broadcast_to(self._eval(x, source), wends.shape)
            return torch.from_numpy(a.astype(float)).to(self.ctx.device)
        out = apply_binary_op(side(self.lhs), side(self.rhs),
                              op=self.operator, bool_modifier=True)
        return ScalarResult(wends, out.cpu().numpy()), QueryStats()
