"""Non-leaf exec plans (port of filodb_tpu/query/nonleaf.py):
DistConcatExec and LocalPartitionDistConcatExec (the planner's
multi-shard concat root), ReduceAggregateExec with its streamed fold,
RemoteAggregateExec (the node-level pushdown group), BinaryJoinExec,
SetOperatorExec, SubqueryExec and StitchRvsExec (the time stitch of the
composed planners).  Label matching runs on the host, as in the
reference; the values stay on their device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from filodb_tpu_torch.memory.histogram import rebucket
from filodb_tpu_torch.ops.rangefns import evaluate_range_function
from filodb_tpu_torch.ops.select import gather_binop, topk_keep_rows
from filodb_tpu_torch.ops.timewindow import PAD_TS, make_window_ends
from filodb_tpu_torch.query.execbase import (AggPartial, ExecPlan,
                                             GroupCardinalityError,
                                             NonLeafExecPlan, RawBlock,
                                             _block_empty, _union_scheme,
                                             reduce_partials)
from filodb_tpu_torch.query.exprfuse import join_index_maps
from filodb_tpu_torch.query.rangevector import (QueryStats, RangeVectorKey,
                                                ResultBlock, cat_values,
                                                concat_blocks,
                                                device_values,
                                                remove_nan_series)
from filodb_tpu_torch.query.transformers import _group_ids
from filodb_tpu_torch.utils.counters import counters


class DistConcatExec(NonLeafExecPlan):
    """Concatenate child results."""

    # children are same-selector per-shard leaves: a shard listed twice
    # (both owners during a live handoff) must contribute exactly once
    dedup_shard_children = True

    def compose(self, results, stats):
        raws = [r for r in results if isinstance(r, RawBlock)]
        if raws:
            return _concat_raw(raws)
        return concat_blocks([r for r in results
                              if isinstance(r, ResultBlock)])


class LocalPartitionDistConcatExec(DistConcatExec):
    """The concat the planner builds over a selector's per-shard leaves
    (the reference's name, which explain prints)."""


def _concat_raw(raws: List[RawBlock]) -> RawBlock:
    """Raw blocks of one grid and base, concatenated along series; shards
    whose bucket schemes differ are first rebucketed onto the union.
    Blocks that all lie on the device join there; where any is a host
    gather's (numpy), all join on the host, in their own value types, and
    a consumer that needs tensors uploads the result once."""
    on_dev = all(isinstance(r.values, torch.Tensor) for r in raws)
    if not on_dev:
        raws = [r.on_host() for r in raws]
    cat = torch.cat if on_dev else np.concatenate
    les0 = raws[0].bucket_les
    if any((r.bucket_les is None) != (les0 is None)
           or (les0 is not None and not np.array_equal(les0, r.bucket_les))
           for r in raws[1:]):
        union = _union_scheme([r.bucket_les for r in raws])
        if union is None:
            raise ValueError("cannot concat histogram blocks: some shards "
                             "carry no bucket boundaries")
        counters.inc("hist_concat_rebuckets")

        def take(a, axis, idx):
            if on_dev:
                return a.index_select(axis, torch.from_numpy(idx).to(
                    a.device))
            return np.take(a, idx, axis=axis)

        def remap(r):
            # rebucket selects source buckets: an index along the last axis
            idx = rebucket(np.arange(len(r.bucket_les)), r.bucket_les, union)
            return dataclasses.replace(
                r, values=take(r.values, 2, idx),
                vbase=(take(r.vbase, 1, idx)
                       if r.vbase is not None and r.vbase.ndim == 2
                       else r.vbase),
                bucket_les=union)
        raws = [r if np.array_equal(r.bucket_les, union) else remap(r)
                for r in raws]
    keys = []
    for r in raws:
        keys.extend(r.keys)
    T = max(r.ts_off.shape[1] for r in raws)

    def pad(a, fill):
        shape = (a.shape[0], T) + tuple(a.shape[2:])
        out = a.new_full(shape, fill) if on_dev \
            else np.full(shape, fill, a.dtype)
        out[:, :a.shape[1]] = a
        return out

    def zeros(r):
        shape = r.values.shape[:1] + r.values.shape[2:]
        return r.values.new_zeros(shape) if on_dev else np.zeros(shape)
    vbase = None
    if any(r.vbase is not None for r in raws):
        vbase = cat([r.vbase if r.vbase is not None else zeros(r)
                     for r in raws])
    return RawBlock(keys, cat([pad(r.ts_off, int(PAD_TS)) for r in raws]),
                    cat([pad(r.values, float("nan")) for r in raws]),
                    raws[0].base_ms, raws[0].bucket_les,
                    samples=sum(r.samples for r in raws), vbase=vbase,
                    precorrected=all(r.precorrected for r in raws),
                    # pad NaNs sit at PAD_TS slots, so raggedness merges
                    # as AND over the blocks
                    dense=all(r.dense for r in raws))


class _AggStreamFold:
    """Incremental fold for a STREAMED ship-everything child: each
    arriving row-slice mini block runs the map phase immediately and
    merges into ONE running AggPartial — the coordinator holds a frame
    plus a [G, W] partial, never the child's full [S, W] block.  The
    candidate ops stay correct piecewise for the same reason they are
    correct per shard: per-piece top-k is a superset of each group's
    true top-k, and the present phase applies the final mask."""

    def __init__(self, op, params, by, without, ctx):
        from filodb_tpu_torch.query.transformers import AggregateMapReduce
        self._mapper = AggregateMapReduce(op, params, by, without)
        self._ctx = ctx
        self._stats = QueryStats()
        self._partial = None

    def add(self, block) -> None:
        p = self._mapper.apply(block, self._ctx, self._stats)
        if p is None:
            return
        self._partial = p if self._partial is None else \
            reduce_partials([self._partial, p])
        # the per-slice map only sees one slice's worth of groups, so
        # the limit must also be enforced on the MERGED partial — the
        # streamed fold raises exactly where non-streamed compose would
        limit = self._ctx.planner_params.group_by_cardinality_limit
        if limit and len(self._partial.group_keys) > limit:
            raise GroupCardinalityError(
                f"group-by cardinality limit {limit} exceeded "
                f"({len(self._partial.group_keys)} groups in the "
                f"streamed fold)")

    def result(self):
        return self._partial


# ops whose map phase may run per row slice and reduce across slices
# without changing the presented result (quantile's sketch
# re-compression is merge-tree-dependent — it assembles whole)
_FOLDABLE_OPS = frozenset({"sum", "count", "avg", "min", "max", "stddev",
                           "stdvar", "group", "topk", "bottomk",
                           "count_values"})


class ReduceAggregateExec(NonLeafExecPlan):
    """Reduce phase across shards: children reply with AggPartials (the
    map phase rides the leaves), merged in child order.

    With ship_raw_series (the ship-everything baseline of
    query/pushdown.py), remote children ship their full per-series
    ResultBlocks instead and the map phase runs HERE — by/without are
    carried so the coordinator-side map is possible."""

    # a duplicate shard here would double-count its samples into the
    # aggregate — the dedup contract matters most on this plan
    dedup_shard_children = True

    # node-level reduce (RemoteAggregateExec): the composed partial is an
    # INTERMEDIATE that another reduce will merge — quantile sketches must
    # not re-compress here (reduce_partials compress=False) and candidate
    # partials may prune to the node-local top-k before crossing the wire
    node_level = False

    def __init__(self, ctx, children, op: str, params: Tuple = (),
                 by: Tuple[str, ...] = (), without: Tuple[str, ...] = ()):
        super().__init__(ctx, children)
        self.op = op
        self.params = params
        self.by = tuple(by)
        self.without = tuple(without)

    def args_str(self):
        return f"aggrOp={self.op}, aggrParams={list(self.params)}"

    def compose(self, results, stats):
        from filodb_tpu_torch.query.transformers import AggregateMapReduce
        mapper = None
        parts = []
        for r in results:
            if isinstance(r, ResultBlock) and r.num_series:
                # ship-everything child: the map phase runs here over the
                # full shipped series block
                if mapper is None:
                    mapper = AggregateMapReduce(self.op, self.params,
                                                self.by, self.without)
                r = mapper.apply(r, self.ctx, stats)
            if isinstance(r, AggPartial):
                parts.append(r)
        return reduce_partials(parts, compress=not self.node_level)

    def child_stream_fold(self, child):
        if self.op not in _FOLDABLE_OPS:
            return None
        return lambda: _AggStreamFold(self.op, self.params, self.by,
                                      self.without, self.ctx)

    def _do_execute(self, source):
        results, stats = self._gather(source)
        # plan-time pushdown verdict (query/pushdown.py): remote children
        # this aggregation could not push
        npn = getattr(self, "pushdown_not_pushable", 0)
        if npn:
            stats.pushdown_not_pushable += npn
        return self.compose(results, stats), stats


class RemoteAggregateExec(ReduceAggregateExec):
    """Node-level reduce pushdown (query/pushdown.py): children are the
    per-shard map subtrees owned by ONE data node, and the whole plan
    serializes to that node via its PushdownDispatcher — the node runs
    leaf scan + range function + map phase per shard, reduces locally
    (inherited compose = reduce_partials), and replies with a single
    [G, W] AggPartial.  Decoded on the data node the children fall back
    to InProcessPlanDispatcher, so execution there is the ordinary
    scatter-gather one level down.

    Rank and sketch aggregations push exactly: quantile node partials
    concatenate their shards' centroids without re-compressing
    (node_level -> reduce_partials compress=False), so the coordinator's
    single merge sees the flat per-shard centroid layout; topk/bottomk
    node partials prune to the per-window node-local top-k before
    replying (ops/select.topk_keep_rows) — rows outside every window's
    local top-k cannot reach any global top-k."""

    node_level = True

    def compose(self, results, stats):
        part = super().compose(results, stats)
        if part is not None and part.cand_vals is not None \
                and self.op in ("topk", "bottomk") and len(part.cand_vals):
            vals = device_values(part.cand_vals, self.ctx)
            keep = topk_keep_rows(
                vals, torch.from_numpy(np.asarray(part.cand_groups,
                                                  np.int64)).to(vals.device),
                len(part.group_keys), int(self.params[0]),
                largest=self.op == "topk").cpu().numpy()
            if not keep.all():
                rows = np.flatnonzero(keep)
                part = dataclasses.replace(
                    part,
                    cand_keys=[part.cand_keys[int(r)] for r in rows],
                    cand_vals=vals.index_select(
                        0, torch.from_numpy(rows).to(vals.device)),
                    cand_groups=np.asarray(part.cand_groups)[rows])
        return part

    def args_str(self):
        shards = sorted(getattr(c, "shard", -1) for c in self._children)
        return (f"aggrOp={self.op}, aggrParams={list(self.params)}, "
                f"shards={shards}")


class BinaryJoinExec(NonLeafExecPlan):
    """Vector-vector join, one-to-one or group_left/group_right: lhs
    children first, then rhs children, split at n_lhs."""

    def __init__(self, ctx, lhs: Sequence[ExecPlan], rhs: Sequence[ExecPlan],
                 operator: str, cardinality: str = "OneToOne",
                 on: Optional[Tuple[str, ...]] = None,
                 ignoring: Tuple[str, ...] = (),
                 include: Tuple[str, ...] = (),
                 bool_modifier: bool = False):
        super().__init__(ctx, list(lhs) + list(rhs))
        self.n_lhs = len(lhs)
        self.operator = operator
        self.cardinality = cardinality
        self.on = tuple(on) if on is not None else None
        self.ignoring = tuple(ignoring)
        self.include = tuple(include)
        self.bool_modifier = bool_modifier

    def args_str(self):
        return (f"binaryOp={self.operator}, on={self.on}, "
                f"ignoring={list(self.ignoring)}")

    def _match_key(self, k: RangeVectorKey) -> RangeVectorKey:
        if self.on is not None:
            return k.only(self.on)
        return k.without(self.ignoring + ("_metric_", "__name__"))

    def compose(self, results, stats):
        lhs = _side(results[:self.n_lhs])
        rhs = _side(results[self.n_lhs:])
        if lhs is None or rhs is None:
            return None
        many_side, one_side = lhs, rhs
        flip = self.cardinality == "OneToMany"
        if flip:
            many_side, one_side = rhs, lhs
        # label matching resolves on the host into (mi, oi) index maps,
        # memoized on the operand blocks' cache_token (query/exprfuse.py)
        mi, oi, keys = join_index_maps(self, many_side, one_side)
        if not len(mi):
            return None
        mv = device_values(many_side.values, self.ctx)
        ov = device_values(one_side.values, self.ctx)
        mi_t = torch.from_numpy(mi).to(mv.device)
        oi_t = torch.from_numpy(oi).to(ov.device)
        # a = the query's LHS values
        a, b, ai, bi = (ov, mv, oi_t, mi_t) if flip else (mv, ov, mi_t, oi_t)
        out = gather_binop(a, b, ai, bi, op=self.operator,
                           bool_modifier=self.bool_modifier,
                           keep_side="lhs")
        return ResultBlock(keys, many_side.wends, out)

    def _result_labels(self, many_key: RangeVectorKey,
                       one_key: RangeVectorKey) -> RangeVectorKey:
        if self.cardinality in ("ManyToOne", "OneToMany"):
            lbls = many_key.without(("_metric_", "__name__")).labels_dict
            if self.include:
                od = one_key.labels_dict
                for lbl in self.include:
                    if lbl in od:
                        lbls[lbl] = od[lbl]
                    else:
                        lbls.pop(lbl, None)
            return RangeVectorKey.make(lbls)
        if self.on is not None:
            return many_key.only(self.on)
        return many_key.without(self.ignoring + ("_metric_", "__name__"))


def _side(results) -> Optional[ResultBlock]:
    """One side of a join or set operation: its children's result blocks
    concatenated.  A raw range vector is no result block and drops out,
    as in the reference: such a side is empty."""
    return concat_blocks([r for r in results if isinstance(r, ResultBlock)])


class SetOperatorExec(NonLeafExecPlan):
    """and / or / unless, step by step, on the values' device."""

    def __init__(self, ctx, lhs: Sequence[ExecPlan], rhs: Sequence[ExecPlan],
                 operator: str, on: Optional[Tuple[str, ...]] = None,
                 ignoring: Tuple[str, ...] = ()):
        super().__init__(ctx, list(lhs) + list(rhs))
        self.n_lhs = len(lhs)
        self.operator = operator.lower()
        self.on = tuple(on) if on is not None else None
        self.ignoring = tuple(ignoring)

    def args_str(self):
        return (f"binaryOp={self.operator}, on={self.on}, "
                f"ignoring={list(self.ignoring)}")

    def _match_key(self, k: RangeVectorKey) -> RangeVectorKey:
        if self.on is not None:
            return k.only(self.on)
        return k.without(self.ignoring + ("_metric_", "__name__"))

    def _presence_by_key(self, block: ResultBlock, vals: torch.Tensor):
        """({match key: g}, present [G, W] bool on the device): some series
        with match key g has a sample at the step (a histogram's first
        bucket)."""
        if vals.ndim == 3:
            vals = vals[..., 0]
        S = len(block.keys)
        if self.on is not None and not self.on:
            # on(): every series shares the empty match key
            gids = np.zeros(S, dtype=np.int64)
            gkeys = [RangeVectorKey(())]
        elif self.on is not None:
            gids, gkeys = _group_ids(block.keys, tuple(self.on), ())
        else:
            # ignoring=() still strips only _metric_/__name__: pad with a
            # name no label can carry so _group_ids takes `without`
            gids, gkeys = _group_ids(block.keys, (),
                                     tuple(self.ignoring) or ("\x00",))
        cnt = torch.zeros((len(gkeys), vals.shape[1]), dtype=torch.int64,
                          device=vals.device)
        cnt.index_add_(0, torch.from_numpy(np.asarray(gids, np.int64)).to(
            vals.device), (~torch.isnan(vals)).long())
        return {gk: g for g, gk in enumerate(gkeys)}, cnt > 0

    def _masks(self, block: ResultBlock, other: ResultBlock,
               other_vals: torch.Tensor):
        """For each row of `block`: its match key's group in `other` (-1
        when none) and the [rows, W] presence of that group (False where
        none)."""
        gmap, present = self._presence_by_key(other, other_vals)
        g = torch.tensor([gmap.get(self._match_key(k), -1)
                          for k in block.keys], dtype=torch.int64,
                         device=present.device)
        mask = present[g.clamp(min=0)] & (g >= 0)[:, None]
        return g, mask

    def compose(self, results, stats):
        lhs = _side(results[:self.n_lhs])
        rhs = _side(results[self.n_lhs:])
        op = self.operator
        if op == "and":
            if lhs is None or rhs is None:
                return None
            lvals = device_values(lhs.values, self.ctx)
            g, mask = self._masks(lhs, rhs, device_values(rhs.values,
                                                          self.ctx))
            rows = torch.nonzero(g >= 0)[:, 0]
            if not rows.numel():
                return None
            out = torch.where(mask[rows].to(lvals.device), lvals[rows],
                              _nan_like(lvals[rows]))
            return ResultBlock([lhs.keys[i] for i in rows.tolist()],
                               lhs.wends, out)
        if op == "or":
            if lhs is None:
                return rhs
            if rhs is None:
                return lhs
            lvals = device_values(lhs.values, self.ctx)
            rvals = device_values(rhs.values, self.ctx)
            _, mask = self._masks(rhs, lhs, lvals)
            rows = torch.where(mask.to(rvals.device), _nan_like(rvals), rvals)
            return ResultBlock(list(lhs.keys) + list(rhs.keys), lhs.wends,
                               cat_values([lvals, rows]))
        if op == "unless":
            if lhs is None:
                return None
            if rhs is None:
                return lhs
            lvals = device_values(lhs.values, self.ctx)
            _, mask = self._masks(lhs, rhs, device_values(rhs.values,
                                                          self.ctx))
            out = torch.where(mask.to(lvals.device), _nan_like(lvals), lvals)
            return remove_nan_series(ResultBlock(list(lhs.keys), lhs.wends,
                                                 out))
        raise ValueError(op)


def _nan_like(x: torch.Tensor) -> torch.Tensor:
    return torch.full_like(x, float("nan"))


class SubqueryExec(NonLeafExecPlan):
    """An outer range function over an inner periodic series
    (`max_over_time(expr[30m:1m])`): the inner grid's steps are the outer
    window function's raw samples, evaluated on the values' device by
    ops/rangefns.py.  The inner grid is the one the parser planned
    (query/logical.py's SubqueryWithWindowing.inner)."""

    def __init__(self, ctx, children, start_ms, step_ms, end_ms, function,
                 function_args, subquery_window_ms, subquery_step_ms,
                 offset_ms=0):
        super().__init__(ctx, children)
        self.start_ms, self.step_ms, self.end_ms = start_ms, step_ms, end_ms
        self.function = function
        self.function_args = tuple(function_args)
        self.subquery_window_ms = subquery_window_ms
        self.subquery_step_ms = subquery_step_ms
        self.offset_ms = offset_ms

    def args_str(self):
        return (f"function={self.function}, "
                f"window={self.subquery_window_ms}, "
                f"step={self.subquery_step_ms}")

    def compose(self, results, stats):
        block = concat_blocks([r for r in results
                               if isinstance(r, ResultBlock)])
        wends = make_window_ends(self.start_ms, self.end_ms, self.step_ms)
        if block is None:
            return _block_empty(wends)
        inner_ts = np.asarray(block.wends)
        base = int(inner_ts[0]) if len(inner_ts) else 0
        vals = device_values(block.values, self.ctx)
        # every series shares the inner grid: one offset row; a NaN step
        # is an absent sample
        ts_off = torch.from_numpy((inner_ts - base).astype(np.int32)[None, :]
                                  ).to(vals.device)
        eval_wends = torch.from_numpy(
            (wends - self.offset_ms - base).astype(np.int32)).to(vals.device)
        out = evaluate_range_function(
            ts_off, vals, eval_wends, self.subquery_window_ms,
            self.function, self.function_args, base_ms=base,
            shared_grid=True, dense=not bool(torch.isnan(vals).any()))
        return ResultBlock(block.keys, wends, out)


class StitchRvsExec(NonLeafExecPlan):
    """Merge same-key series evaluated over adjacent time ranges into one
    grid: the union of the blocks' step times, one row a key.  One
    searchsorted and one scatter a block into a preallocated [S, W_union]
    (or [S, W_union, B] for histogram blocks) f64 output, on the device
    of the first block whose values are a tensor; a NaN step keeps what
    an earlier block put there, and a later block wins where two
    overlap."""

    def compose(self, results, stats):
        blocks = [r for r in results if isinstance(r, ResultBlock)]
        if not blocks:
            return None
        if len(blocks) == 1:
            return blocks[0]
        wends = np.unique(np.concatenate([np.asarray(b.wends)
                                          for b in blocks]))
        row_of: Dict[RangeVectorKey, int] = {}
        keys: List[RangeVectorKey] = []
        for b in blocks:
            for k in b.keys:
                if k not in row_of:
                    row_of[k] = len(keys)
                    keys.append(k)
        # shape and bucket scheme from the widest block: an empty tier
        # (0 series, 2-d values) may come before one with [S, W, B] data
        ref = max(blocks, key=lambda b: b.values.ndim)
        extra = tuple(ref.values.shape[2:])
        dev = next((b.values.device for b in blocks
                    if isinstance(b.values, torch.Tensor)), self.ctx.device)
        out = torch.full((len(keys), len(wends)) + extra, float("nan"),
                         dtype=torch.float64, device=dev)
        for b in blocks:
            if b.num_series == 0:
                continue
            vals = device_values(b.values, self.ctx).to(dev, torch.float64)
            pos = torch.from_numpy(
                np.searchsorted(wends, np.asarray(b.wends))).to(dev)
            rows = torch.from_numpy(np.fromiter(
                (row_of[k] for k in b.keys), dtype=np.int64,
                count=len(b.keys))).to(dev)
            ri, ci = rows[:, None], pos[None, :]
            out[ri, ci] = torch.where(torch.isnan(vals), out[ri, ci], vals)
        les = next((b.bucket_les for b in blocks
                    if b.bucket_les is not None), None)
        return ResultBlock(keys, wends, out, les)
