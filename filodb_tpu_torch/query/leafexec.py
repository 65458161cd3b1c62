"""The shard-local leaf: index lookup, device-mirror gather and the fused
peephole (port of filodb_tpu/query/leafexec.py, the mirror branch), and
the scalar leaves (time(), literals and scalar arithmetic).

A range function followed by an aggregate over one shared scrape grid
is answered in one of four ways, as in the reference (:174-214):

- an instant selector is last_over_time over the stale lookback;
- on dense data, count_over_time and the count aggregate are host math
  (every series has the same samples per window);
- min/max_over_time run as windowed torch reductions (ops/minmax.py);
- everything else is one fused kernel launch (ops/fused.py).

A native histogram column [S, T, B] takes the fused path only as
sum(rate|increase): its S*B bucket rows, bucket-major within a series,
go through the same kernels with one slot per (group, bucket).

Every other leaf — the cases where the reference's _try_fused returns
None — runs its transformers' general path on the mirror's device
(query/transformers.py).  Not carried over, on purpose: the reference's
broad `except` that degrades a failed fused evaluation to the general
path, the interpret-unless-TPU gate, the host router, demand paging and
the cold tier.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from filodb_tpu_torch.core.index import ColumnFilter
from filodb_tpu_torch.ops import fused, minmax
from filodb_tpu_torch.ops import hist as hist_ops
from filodb_tpu_torch.ops.instant import INSTANT_FUNCTIONS, apply_binary_op
from filodb_tpu_torch.ops.timewindow import PAD_TS, make_window_ends
from filodb_tpu_torch.query.execbase import (
    AggPartial, GroupCardinalityError, LazyKeys, LeafExecPlan, RawBlock,
    ScalarResult,
    _FUSED_CACHE_LOCK, _FUSED_MINMAX_PAD_CACHE, _FUSED_PLAN_CACHE,
    _FUSED_VALS_CACHE, _group_cache_insert, _group_cache_lookup, _lru_touch,
    _vals_cache_insert, agg_token, not_ported)
from filodb_tpu_torch.query.fusedbatch import FusedCall, finish_fused_calls
from filodb_tpu_torch.query.rangevector import QueryContext, QueryStats
from filodb_tpu_torch.query.transformers import (AggregateMapReduce,
                                                 PeriodicSamplesMapper,
                                                 _group_ids_cached)
from filodb_tpu_torch.utils.counters import counters

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
        self._fused_cache_key = None

    def execute_internal(self, source):
        self._fused_cache_key = None
        data, stats = self._do_execute(source)
        fused_out = self._try_fused(data)
        start = 0
        if fused_out is not None:
            data, start = fused_out, 2
        for t in self.transformers[start:]:
            data = t.apply(data, self.ctx, stats, source)
        return data, stats

    def _try_fused(self, data):
        """Peephole: PeriodicSamplesMapper (a fusable range function, or
        an instant selector) followed by AggregateMapReduce (sum, avg,
        count, min or max) over a shared-grid working set collapses into
        one fused evaluation.  Returns the AggPartial, or None where the
        reference's peephole returns None too: then the transformers run
        the general path."""
        if len(self.transformers) < 2 or not isinstance(data, RawBlock) \
                or not data.keys or data.shared_ts_row is None:
            return None
        t0, t1 = self.transformers[:2]
        if not isinstance(t0, PeriodicSamplesMapper) \
                or not isinstance(t1, AggregateMapReduce):
            return None
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
        return finish_fused_calls([fc])[0]

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
        comp = minmax.fused_minmax_agg(
            vals, data.vbase, groups.gids_p[:S], f0, stride, width,
            int(eval_wends.size), t0.function, t1.op, len(gkeys), ragged,
            csr=groups.csr)
        counters.inc("leaf_fused_minmax")
        return AggPartial(t1.op, gkeys, wends, comp=comp.cpu().numpy(),
                          cache_token=agg_token(t1.op, t1.by, t1.without,
                                                data.cache_token))

    def _check_group_limit(self, gkeys) -> None:
        limit = self.ctx.planner_params.group_by_cardinality_limit
        if limit and len(gkeys) > limit:
            raise GroupCardinalityError(
                f"group-by cardinality limit {limit} exceeded "
                f"({len(gkeys)} groups)")

    def _do_execute(self, source):
        from filodb_tpu_torch.core.devicecache import DeviceMirror
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
        schema = shard.schemas[schema_name]
        col_name = self.columns[0] if self.columns else schema.value_column
        col_def = next((c for c in schema.data_columns
                        if c.name == col_name), None)
        if col_def is None:
            raise not_ported(f"column {col_name} of schema {schema_name}")
        counter_col = col_def.detect_drops or col_def.counter
        fn_is_counter = False
        for t in self.transformers:
            if isinstance(t, PeriodicSamplesMapper):
                fn_is_counter = t.function in COUNTER_FNS
                break
        if counter_col and not fn_is_counter:
            raise not_ported("a non-counter function over a counter column "
                             "(needs raw values: the host gather path)")
        # the device mirror: one full upload per store generation, under
        # the write lock so it cannot race ingest; the row gather then
        # reads only the immutable device copy
        mirror = getattr(store, "device_mirror", None)
        if mirror is None:
            with shard._write_locked("mirror_create"):
                mirror = getattr(store, "device_mirror", None)
                if mirror is None:
                    mirror = store.device_mirror = DeviceMirror(
                        device=shard.device, shard_num=self.shard)
        if not mirror.is_fresh(store):
            with shard._write_locked("mirror_refresh"):
                mirror.ensure_fresh(store)
        # one snapshot read serves gather AND fused eligibility
        snap = mirror.snapshot()
        ts_off, dev_cols, dev_vbases, base = mirror.gather_cached(rows, snap)
        vals = dev_cols[col_name]
        vbase = dev_vbases.get(col_name)
        counts = snap.counts[rows]
        shared_ts_row = mirror.fused_eligible(col_name, snap,
                                              allow_ragged=True)
        dense = mirror.col_dense(col_name, snap)
        if shared_ts_row is not None:
            # cache identity for the fused path's padded-input reuse
            # (mirror.serial, not id(); raw rows bytes, not a hash)
            self._fused_cache_key = (mirror.serial, snap.gen, col_name,
                                     rows.tobytes())
        keys = LazyKeys(shard, pids)
        stats.series_scanned = int(pids.size)
        stats.samples_scanned = int(counts.sum())
        les = store.bucket_les if vals.ndim == 3 else None
        return RawBlock(keys, ts_off, vals, base, les,
                        samples=stats.samples_scanned, vbase=vbase,
                        precorrected=counter_col,
                        shared_ts_row=shared_ts_row, dense=dense,
                        cache_token=(shard.keys_serial, shard.keys_epoch,
                                     pids.tobytes())), stats


# ------------------------------------------------------------- scalar execs

class TimeScalarGeneratorExec(LeafExecPlan):
    """time(), hour(), ... of the step timestamps."""

    def __init__(self, ctx, start_ms, step_ms, end_ms, function="time"):
        super().__init__(ctx)
        self.start_ms, self.step_ms, self.end_ms = start_ms, step_ms, end_ms
        self.function = function

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
