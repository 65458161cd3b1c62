"""Range-vector transformers (port of filodb_tpu/query/transformers.py):
PeriodicSamplesMapper, the aggregation map and present phases, instant
functions (histogram_quantile over native [S, W, B] blocks and over
classic `le`-bucket series, histogram_bucket), scalar operations, and
the plan nodes' mappers: the `@` repeat, absent, sort, label_replace /
label_join, limitk, scalar() and vector().  Those run on the host over
a block's keys (and, for absent, sort and the label merge, its values
read back); the values otherwise stay where they are.

PeriodicSamplesMapper and AggregateMapReduce also carry the query's
window grid, function and grouping down to the leaf, whose fused path
consumes both (query/leafexec.py).  Their apply() is the general path:
a range function over every series on the values' device
(ops/rangefns.py), then a map phase (ops/agg.py).
"""
from __future__ import annotations

import dataclasses
import math
import re
import threading
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from filodb_tpu_torch.core.index import ColumnFilter, Equals
from filodb_tpu_torch.ops import agg as agg_ops
from filodb_tpu_torch.ops import fused
from filodb_tpu_torch.ops import hist as hist_ops
from filodb_tpu_torch.ops import sketch as sketch_ops
from filodb_tpu_torch.ops.instant import INSTANT_FUNCTIONS, apply_binary_op
from filodb_tpu_torch.ops.rangefns import evaluate_range_function
from filodb_tpu_torch.ops.timewindow import make_window_ends
from filodb_tpu_torch.query.execbase import (AggPartial, Data,
                                             GroupCardinalityError, RawBlock,
                                             ScalarResult, _block_empty,
                                             _lru_touch, agg_token,
                                             present_partial)
from filodb_tpu_torch.query.rangevector import (QueryContext, QueryStats,
                                                RangeVectorKey, ResultBlock,
                                                device_values, host_values)


class RangeVectorTransformer:

    def apply(self, data: Data, ctx: QueryContext, stats: QueryStats,
              source=None) -> Data:
        raise NotImplementedError

    def args_str(self) -> str:
        return ""

    def __str__(self):
        return f"{type(self).__name__}({self.args_str()})"


@dataclasses.dataclass
class PeriodicSamplesMapper(RangeVectorTransformer):
    """Raw samples -> regular step grid, optional range function."""
    start_ms: int
    step_ms: int
    end_ms: int
    window_ms: Optional[int] = None     # None => plain lookback sampling
    function: Optional[str] = None
    function_args: Tuple[float, ...] = ()
    offset_ms: int = 0
    lookback_ms: int = 5 * 60 * 1000

    def args_str(self):
        return (f"start={self.start_ms}, step={self.step_ms}, end={self.end_ms}, "
                f"window={self.window_ms}, functionId={self.function}, "
                f"offset={self.offset_ms}")

    def apply(self, data: Data, ctx: QueryContext, stats: QueryStats,
              source=None) -> Data:
        wends = make_window_ends(self.start_ms, self.end_ms, self.step_ms)
        if data is None or (isinstance(data, RawBlock) and not data.keys):
            return _block_empty(wends)
        if not isinstance(data, RawBlock):
            raise TypeError("PeriodicSamplesMapper needs raw data")
        # a host gather (per-series offsets, no shared row) is evaluated
        # on the engine's device like a mirror block
        data = data.on_device(ctx.device, stats)
        window = self.window_ms if self.window_ms else self.lookback_ms
        fn = self.function
        base = data.base_ms
        # timestamp(): offset seconds in the value dtype, the epoch base
        # added back in f64 below (f32 cannot hold epoch seconds)
        kernel_base = 0 if fn == "timestamp" else base
        # offset: shift the window grid back, keep the original stamps
        eval_wends = wends - self.offset_ms
        dev = data.values.device
        wends_off = torch.from_numpy(
            (eval_wends - base).astype(np.int32)).to(dev)
        shared = data.shared_ts_row is not None
        ts_in = data.ts_off[:1] if shared else data.ts_off
        vals, vbase = data.values, data.vbase
        hist = vals.ndim == 3
        if hist:
            # each bucket a series, evaluated as one block of S*B rows
            B = vals.shape[2]
            vals = hist_ops.bucket_rows(vals)
            if not shared:
                ts_in = ts_in.repeat_interleave(B, dim=0)
            if vbase is not None:
                vbase = vbase.reshape(-1)
        out = evaluate_range_function(
            ts_in, vals, wends_off, window, fn,
            tuple(self.function_args), base_ms=kernel_base,
            vbase=vbase, precorrected=data.precorrected,
            shared_grid=shared, dense=data.dense)
        if hist:
            out = hist_ops.from_bucket_rows(out, B)
        if fn == "timestamp":
            out = out.double() + base / 1000.0
        return ResultBlock(data.keys, wends, out, data.bucket_les,
                           cache_token=data.cache_token)


@dataclasses.dataclass
class RepeatToGridMapper(RangeVectorTransformer):
    """The `@` modifier's finisher: the upstream mapper evaluated on a
    single-step grid pinned at the @ timestamp; that one column repeated
    across the query's output grid (Prometheus: the pinned value at every
    step)."""
    start_ms: int
    step_ms: int
    end_ms: int

    def args_str(self):
        return (f"start={self.start_ms}, step={self.step_ms}, "
                f"end={self.end_ms}")

    def apply(self, data: Data, ctx: QueryContext, stats: QueryStats,
              source=None) -> Data:
        wends = make_window_ends(self.start_ms, self.end_ms, self.step_ms)
        if data is None:
            return None
        if not isinstance(data, ResultBlock):
            raise TypeError("@ repeat needs periodic data")
        vals = data.values
        if vals.shape[1] != 1:
            raise ValueError("@ inner grid must be single-step")
        reps = (1, len(wends)) + (1,) * (vals.ndim - 2)
        out = (vals.repeat(*reps) if isinstance(vals, torch.Tensor)
               else np.tile(vals, reps))
        return ResultBlock(data.keys, wends, out, data.bucket_les,
                           cache_token=data.cache_token)


def _arg_value(a, source, per_step: bool = False):
    """A (possibly deferred) scalar argument.  per_step gives a [W] array
    for the elementwise functions; otherwise one float — a scalar that
    varies over time is refused rather than read at its first step."""
    if hasattr(a, "resolve"):                 # deferred scalar subplan
        a = a.resolve(source)
    if isinstance(a, ScalarResult):
        if len(a.values) == 0:
            return np.nan
        if per_step:
            return a.values
        vals = a.values[~np.isnan(a.values)]
        if len(vals) and not np.all(vals == vals[0]):
            raise ValueError("time-varying scalar argument not supported "
                             "for this function")
        return a.values[0] if len(vals) == 0 else vals[0]
    return a


@dataclasses.dataclass
class InstantVectorFunctionMapper(RangeVectorTransformer):
    """abs(), round(), hour(), histogram_quantile(), ... over a block."""
    function: str
    args: Tuple = ()

    def args_str(self):
        return f"function={self.function}"

    def apply(self, data: Data, ctx: QueryContext, stats: QueryStats,
              source=None) -> Data:
        if not isinstance(data, ResultBlock) or data.num_series == 0:
            return data
        if self.function in ("histogram_quantile",
                             "histogram_max_quantile"):
            q = float(_arg_value(self.args[0], source))
            if not data.is_histogram:
                # classic Prometheus histograms: `_bucket` series
                # carrying cumulative counts in `le` labels
                return self._classic_bucket_quantile(q, data, ctx)
            # a host [G, W, B] partial takes the numpy twin, a device
            # block is computed where it lies
            out = hist_ops.histogram_quantile(q, data.values,
                                              np.asarray(data.bucket_les))
            return ResultBlock(data.keys, data.wends, out,
                               cache_token=data.cache_token)
        if self.function == "histogram_bucket":
            le = float(_arg_value(self.args[0], source))
            out = hist_ops.histogram_bucket(
                le, device_values(data.values, ctx), data.bucket_les)
            return ResultBlock(data.keys, data.wends, out,
                               cache_token=data.cache_token)
        fn = INSTANT_FUNCTIONS[self.function]
        vals = device_values(data.values, ctx)
        # per-step scalar arguments broadcast over [S, W], in f64: an
        # epoch-sized scalar does not fit f32 (the result promotes)
        extra = [torch.as_tensor(np.asarray(_arg_value(a, source,
                                                       per_step=True),
                                            np.float64)).to(vals.device)
                 for a in self.args]
        return ResultBlock(data.keys, data.wends, fn(vals, *extra),
                           data.bucket_les, cache_token=data.cache_token)

    @staticmethod
    def _classic_bucket_quantile(q: float, data: ResultBlock,
                                 ctx: QueryContext) -> ResultBlock:
        """histogram_quantile over le-labelled `_bucket` series: group by
        the labels minus `le`, stack each group's cumulative counts in
        ascending le order and take the quantile per ladder of les, one
        [G, W, B] call each.  Groups without a +Inf bucket are dropped,
        as upstream; an absent bucket sample fills down from the bucket
        below (no extra observations) instead of making the group NaN."""
        vals = device_values(data.values, ctx)
        groups: Dict[tuple, list] = {}
        for i, k in enumerate(data.keys):
            le_txt = k.labels_dict.get("le")
            if le_txt is None:
                continue
            try:
                le = float(le_txt)
            except ValueError:
                continue
            gk = k.without(("le", "_metric_", "__name__")).labels
            groups.setdefault(gk, []).append((le, i))
        by_ladder: Dict[tuple, list] = {}
        for gk, entries in sorted(groups.items()):
            entries.sort(key=lambda e: e[0])
            les = tuple(e[0] for e in entries)
            if len(les) < 2 or not math.isinf(les[-1]):
                continue                  # upstream requires an +Inf bucket
            by_ladder.setdefault(les, []).append(
                (gk, [e[1] for e in entries]))
        keys, outs = [], []
        for les, members in by_ladder.items():
            idx = torch.tensor([rows for _, rows in members],
                               dtype=torch.int64, device=vals.device)
            mat = vals[idx]                                  # [G, B, W]
            nan = torch.isnan(mat)
            cols = [torch.where(nan[:, 0], torch.zeros_like(mat[:, 0]),
                                mat[:, 0])]
            for b in range(1, mat.shape[1]):
                cols.append(torch.where(nan[:, b], cols[-1], mat[:, b]))
            stacked = torch.stack(cols, dim=-1)              # [G, W, B]
            outs.append(hist_ops.histogram_quantile(q, stacked, list(les)))
            keys.extend(RangeVectorKey(gk) for gk, _ in members)
        if not keys:
            return ResultBlock([], data.wends,
                               np.zeros((0, len(data.wends))))
        return ResultBlock(keys, data.wends, torch.cat(outs))


@dataclasses.dataclass
class ScalarOperationMapper(RangeVectorTransformer):
    """vector op scalar."""
    operator: str
    scalar: Union[float, ScalarResult]
    scalar_is_lhs: bool = False
    bool_modifier: bool = False

    def args_str(self):
        return f"operator={self.operator}, scalarOnLhs={self.scalar_is_lhs}"

    def apply(self, data: Data, ctx: QueryContext, stats: QueryStats,
              source=None) -> Data:
        if not isinstance(data, ResultBlock) or data.num_series == 0:
            return data
        vals = device_values(data.values, ctx)
        scalar = self.scalar
        if hasattr(scalar, "resolve"):            # deferred scalar subplan
            scalar = scalar.resolve(source)
        if isinstance(scalar, ScalarResult):
            # an empty scalar stream behaves as NaN
            sv = (scalar.values[None, :] if scalar.values.shape[0]
                  == vals.shape[1] else np.full((1, 1), np.nan))
        else:
            sv = np.full((1, 1), float(scalar))
        # the scalar stays f64 (time() does not fit f32); the result
        # promotes
        sv = torch.as_tensor(np.asarray(sv, np.float64)).to(
            vals.device).expand(vals.shape)
        a, b = (sv, vals) if self.scalar_is_lhs else (vals, sv)
        # comparison filtering keeps the VECTOR side's value
        out = apply_binary_op(a, b, op=self.operator,
                              bool_modifier=self.bool_modifier,
                              keep_side="rhs" if self.scalar_is_lhs
                              else "lhs")
        return ResultBlock(data.keys, data.wends, out, data.bucket_les,
                           cache_token=data.cache_token)


def _group_ids(keys: Sequence[RangeVectorKey], by: Tuple[str, ...],
               without: Tuple[str, ...]) -> Tuple[np.ndarray, List[RangeVectorKey]]:
    """Host-side grouping: series key -> group key (by/without semantics)."""
    gmap: Dict[RangeVectorKey, int] = {}
    gids = np.empty(len(keys), dtype=np.int32)
    gkeys: List[RangeVectorKey] = []
    for i, k in enumerate(keys):
        if by:
            gk = k.only(by)
        elif without:
            gk = k.without(tuple(without) + ("_metric_", "__name__"))
        else:
            gk = RangeVectorKey(())
        gid = gmap.get(gk)
        if gid is None:
            gid = len(gkeys)
            gmap[gk] = gid
            gkeys.append(gk)
        gids[i] = gid
    return gids, gkeys


# host group-id cache: (cache_token, by, without) -> (gids, gkeys).  The
# token (shard keys_serial, keys_epoch, pids bytes) identifies the key set
# exactly, so repeat queries do a dict hit instead of the O(S) loop.
_HOST_GROUP_CACHE: Dict[tuple, tuple] = {}
_HOST_GROUP_LOCK = threading.Lock()


def _group_ids_cached(token, keys, by, without):
    if token is None:
        return _group_ids(keys, by, without)
    k = (token, tuple(by), tuple(without))
    with _HOST_GROUP_LOCK:
        ent = _lru_touch(_HOST_GROUP_CACHE, k)
    if ent is not None and len(ent[0]) == len(keys):
        return ent
    gids, gkeys = _group_ids(keys, by, without)
    with _HOST_GROUP_LOCK:
        # entries of strictly older epochs of the same shard are dead: a
        # reclaimed pid may have been recycled for another series.  An
        # in-flight query holding an older token evicts nothing newer and
        # installs nothing.  Only leaf tokens carry the (serial, epoch:
        # int, ...) shape compared here; derived tokens (agg_token) embed
        # the leaf's, and a prune mints new ones, so theirs age out
        # through the LRU cap
        if len(token) > 1 and isinstance(token[1], int):
            def _epoch(o):
                t = o[0]
                return (t[1] if t[0] == token[0] and len(t) > 1
                        and isinstance(t[1], int) else None)
            for old in [o for o in _HOST_GROUP_CACHE
                        if _epoch(o) is not None and _epoch(o) < token[1]]:
                del _HOST_GROUP_CACHE[old]
            if any(_epoch(o) is not None and _epoch(o) > token[1]
                   for o in _HOST_GROUP_CACHE):
                return gids, gkeys
        _HOST_GROUP_CACHE[k] = (gids, gkeys)
        while len(_HOST_GROUP_CACHE) > 8:
            _HOST_GROUP_CACHE.pop(next(iter(_HOST_GROUP_CACHE)))
    return gids, gkeys


_CANDIDATE_OPS = ("topk", "bottomk", "count_values")


@dataclasses.dataclass
class AggregateMapReduce(RangeVectorTransformer):
    """Map phase of 3-phase aggregation (the fused leaf runs it when it
    takes the leaf)."""
    op: str
    params: Tuple = ()
    by: Tuple[str, ...] = ()
    without: Tuple[str, ...] = ()

    def args_str(self):
        return (f"aggrOp={self.op}, aggrParams={list(self.params)}, "
                f"without={list(self.without)}, by={list(self.by)}")

    def apply(self, data: Data, ctx: QueryContext, stats: QueryStats,
              source=None) -> Data:
        if data is None or (isinstance(data, ResultBlock)
                            and data.num_series == 0):
            return None
        if not isinstance(data, ResultBlock):
            raise TypeError("AggregateMapReduce needs periodic data")
        vals = device_values(data.values, ctx)
        gids, gkeys = _group_ids_cached(data.cache_token, data.keys,
                                        self.by, self.without)
        limit = ctx.planner_params.group_by_cardinality_limit
        if limit and len(gkeys) > limit:
            raise GroupCardinalityError(
                f"group-by cardinality limit {limit} exceeded "
                f"({len(gkeys)} groups)")
        G = len(gkeys)
        gids_t = torch.from_numpy(np.asarray(gids, np.int64)).to(vals.device)
        if data.is_histogram and self.op not in ("sum", "count_values"):
            # the reference answers these with an error too (its
            # [S, W, B] values do not broadcast in the map phase)
            raise ValueError(f"{self.op} over histogram blocks: only sum "
                             f"aggregates buckets")
        if data.is_histogram and self.op == "sum":
            return AggPartial(
                "hist_sum", gkeys, data.wends,
                comp=_hist_sum_map(vals, gids, gids_t, G),
                params=self.params, bucket_les=data.bucket_les,
                cache_token=agg_token("hist_sum", self.by, self.without,
                                      data.cache_token))
        if self.op == "quantile":
            # the mergeable sketch, built on the host as the reference
            # builds it (one copy of the values off the device)
            return AggPartial(
                self.op, gkeys, data.wends,
                sketch=sketch_ops.sketch_from_values(
                    host_values(vals), np.asarray(gids), G),
                params=self.params,
                cache_token=agg_token(self.op, self.by, self.without,
                                      data.cache_token))
        if self.op in _CANDIDATE_OPS:
            rows = np.arange(len(data.keys))
            if self.op in ("topk", "bottomk"):
                # a row outside every window's group top/bottom k on this
                # shard cannot make the merged one
                keep = agg_ops.topk_mask(
                    vals, gids_t, G, int(self.params[0]),
                    largest=self.op == "topk").any(dim=1)
                rows = np.flatnonzero(keep.cpu().numpy())
            return AggPartial(
                self.op, gkeys, data.wends,
                cand_keys=[data.keys[int(r)] for r in rows],
                cand_vals=vals.index_select(
                    0, torch.from_numpy(rows).to(vals.device)),
                cand_groups=np.asarray(gids)[rows], params=self.params)
        if self.op not in agg_ops.AGGREGATORS:
            raise ValueError(f"unknown aggregate {self.op}")
        csr = None
        if self.op in ("sum", "avg", "stddev", "stdvar"):
            csr = fused.pad_groups(gids, len(data.keys), G,
                                   device=vals.device).csr
        comp = agg_ops.map_phase(self.op, vals, gids_t, G, csr)
        return AggPartial(self.op, gkeys, data.wends,
                          comp=comp.cpu().numpy(), params=self.params,
                          cache_token=agg_token(self.op, self.by,
                                                self.without,
                                                data.cache_token))


def _hist_sum_map(vals: torch.Tensor, gids, gids_t: torch.Tensor,
                  G: int) -> np.ndarray:
    """sum over histogram blocks [S, W, B] -> [G, W, B+1] f64: each
    bucket summed elementwise over the group's present series in the
    fixed CSR order (f64, no float atomics), then the count of series with
    any bucket present."""
    S, W, B = vals.shape
    present = ~torch.isnan(vals)
    zeroed = torch.where(present, vals.double(),
                         torch.zeros((), dtype=torch.float64,
                                     device=vals.device))
    csr = fused.pad_groups(gids, S, G, device=vals.device).csr
    sums = fused.segment_sum(zeroed.reshape(S, W * B), csr, G)
    cnt = agg_ops.seg_count(present.any(dim=2), gids_t, G)
    return torch.cat([sums.reshape(G, W, B), cnt[..., None]],
                     dim=2).cpu().numpy()


class AggregatePresenter(RangeVectorTransformer):
    """Present phase."""

    def __init__(self, op: str, params: Tuple = ()):
        self.op = op
        self.params = params

    def args_str(self):
        return f"aggrOp={self.op}, aggrParams={list(self.params)}"

    def apply(self, data: Data, ctx: QueryContext, stats: QueryStats,
              source=None) -> Data:
        if data is None:
            return None
        if not isinstance(data, AggPartial):
            raise TypeError(f"AggregatePresenter needs an AggPartial, "
                            f"got {type(data).__name__}")
        return present_partial(data)


@dataclasses.dataclass
class AbsentFunctionMapper(RangeVectorTransformer):
    """absent(): one series of 1.0 at the steps where no input series has
    a sample, labelled with the selector's equality matchers."""
    filters: Tuple[ColumnFilter, ...]
    start_ms: int = 0
    step_ms: int = 0
    end_ms: int = 0

    def args_str(self):
        return "functionId=absent"

    def apply(self, data: Data, ctx: QueryContext, stats: QueryStats,
              source=None) -> Data:
        wends = (data.wends if isinstance(data, ResultBlock)
                 else make_window_ends(self.start_ms, self.end_ms,
                                       max(self.step_ms, 1)))
        if isinstance(data, ResultBlock) and data.num_series:
            present = ~np.isnan(host_values(data.values)).all(axis=0)
            if present.ndim == 2:             # histogram blocks [W, B]
                present = present.any(axis=-1)
        else:
            present = np.zeros(len(wends), dtype=bool)
        out = np.where(present, np.nan, 1.0)[None, :]
        labels = {f.column: f.value for f in self.filters
                  if isinstance(f, Equals)
                  and f.column not in ("__name__", "_metric_")}
        return ResultBlock([RangeVectorKey.make(labels)], wends, out)


@dataclasses.dataclass
class SortFunctionMapper(RangeVectorTransformer):
    """sort()/sort_desc(): series ordered by their mean over the steps
    (f64, NaN steps ignored), a stable sort; a series with no sample
    ranks first either way, as in the reference."""
    descending: bool = False

    def args_str(self):
        return f"function={'sort_desc' if self.descending else 'sort'}"

    def apply(self, data: Data, ctx: QueryContext, stats: QueryStats,
              source=None) -> Data:
        if not isinstance(data, ResultBlock) or data.num_series <= 1:
            return data
        with np.errstate(invalid="ignore"), warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            means = np.nanmean(host_values(data.values).astype(np.float64),
                               axis=1)
        means = np.where(np.isnan(means),
                         np.inf if self.descending else -np.inf, means)
        order = np.argsort(-means if self.descending else means,
                           kind="stable")
        return data.select(order)


@dataclasses.dataclass
class MiscellaneousFunctionMapper(RangeVectorTransformer):
    """label_replace / label_join: new label sets on the host; series
    that land on one label set merge where their samples never share a
    step, else the query fails (_merge_relabeled)."""
    function: str
    string_args: Tuple[str, ...] = ()

    def args_str(self):
        return f"function={self.function}"

    def apply(self, data: Data, ctx: QueryContext, stats: QueryStats,
              source=None) -> Data:
        if not isinstance(data, ResultBlock):
            return data
        if self.function == "label_replace":
            dst, repl, src, regex = self.string_args
            pat = re.compile("^(?:" + regex + ")$")
            keys = []
            for k in data.keys:
                lbls = k.labels_dict
                m = pat.match(lbls.get(src, ""))
                if m:
                    val = m.expand(_dollar_to_backslash(repl))
                    if val:
                        lbls[dst] = val
                    else:
                        lbls.pop(dst, None)
                keys.append(RangeVectorKey.make(lbls))
        elif self.function == "label_join":
            dst, sep, *srcs = self.string_args
            keys = []
            for k in data.keys:
                lbls = k.labels_dict
                val = sep.join(lbls.get(s, "") for s in srcs)
                if val:
                    lbls[dst] = val
                else:
                    lbls.pop(dst, None)
                keys.append(RangeVectorKey.make(lbls))
        else:
            raise ValueError(f"unknown misc function {self.function}")
        keys, vals = _merge_relabeled(keys, data, self.function)
        return ResultBlock(keys, data.wends, vals, data.bucket_les)


def _merge_relabeled(keys, data: ResultBlock, fn_name: str):
    """Relabeling that lands several series on one label set is an error
    only where the duplicates share an evaluation step ("vector cannot
    contain metrics with the same labelset"); series whose samples never
    overlap merge into one.  Presence is NaN-only, as in the reference:
    a ±Inf sample is a sample, so it collides and merges like any other.
    -> (keys, values) with disjoint duplicates merged."""
    groups: dict = {}
    for i, k in enumerate(keys):
        groups.setdefault(k.labels, []).append(i)
    if all(len(rows) == 1 for rows in groups.values()):
        return keys, data.values
    vals = host_values(data.values)
    out_keys, out_rows = [], []
    for rows in groups.values():
        if len(rows) == 1:
            out_keys.append(keys[rows[0]])
            out_rows.append(vals[rows[0]])
            continue
        sub = vals[rows]                      # [d, W] or [d, W, B]
        present = ~np.isnan(sub)
        if sub.ndim == 3:
            present = present.any(axis=-1)
        if (present.sum(axis=0) > 1).any():
            raise ValueError(
                f"{fn_name}: vector cannot contain metrics with the "
                f"same labelset")
        merged = np.full(sub.shape[1:], np.nan, vals.dtype)
        for d in range(sub.shape[0]):
            m = present[d]
            merged[m] = sub[d][m]
        out_keys.append(keys[rows[0]])
        out_rows.append(merged)
    return out_keys, np.stack(out_rows)


def _dollar_to_backslash(repl: str) -> str:
    """PromQL writes $1 where python's re.expand reads \\1."""
    return re.sub(r"\$(\d+)", r"\\\1", repl)


@dataclasses.dataclass
class LimitFunctionMapper(RangeVectorTransformer):
    """limitk: the first `limit` series."""
    limit: int

    def args_str(self):
        return f"limit={self.limit}"

    def apply(self, data: Data, ctx: QueryContext, stats: QueryStats,
              source=None) -> Data:
        if isinstance(data, ResultBlock) and data.num_series > self.limit:
            return data.select(np.arange(self.limit))
        return data


@dataclasses.dataclass
class ScalarFunctionMapper(RangeVectorTransformer):
    """scalar(vector): a single series becomes a scalar stream; anything
    else is NaN at every step."""
    function: str = "scalar"

    def args_str(self):
        return f"function={self.function}"

    def apply(self, data: Data, ctx: QueryContext, stats: QueryStats,
              source=None) -> Data:
        if data is not None and not isinstance(data, ResultBlock):
            raise TypeError(f"scalar() needs periodic data, got "
                            f"{type(data).__name__}")
        if data is None or data.num_series != 1:
            wends = data.wends if data is not None else np.zeros(0, np.int64)
            return ScalarResult(wends, np.full(len(wends), np.nan))
        return ScalarResult(data.wends, host_values(data.values)[0])


@dataclasses.dataclass
class VectorFunctionMapper(RangeVectorTransformer):
    """vector(scalar): the scalar stream as one series without labels."""

    def args_str(self):
        return "function=vector"

    def apply(self, data: Data, ctx: QueryContext, stats: QueryStats,
              source=None) -> Data:
        if isinstance(data, ScalarResult):
            return ResultBlock([RangeVectorKey(())], data.wends,
                               data.values[None, :])
        return data
