"""FederationPlanner — routes whole-expression subtrees to the clusters
that own the matching series, above the rest of the planner stack (port
of filodb_tpu/federation/planner.py).

Sits OUTERMOST (above LongTimeRangePlanner / ShardKeyRegexPlanner /
the shard fan-out): a query that only touches local data falls straight
through to the inner stack unchanged.  When remote clusters may own
matching series (registry ownership: label matchers / time windows),
the coordinator tree gains FederatedLeafExec children dispatched to the
owning clusters' federation doors:

  label-partitioned, exactly-mergeable aggregate (sum/count/avg/min/
  max/stddev/stdvar/group/topk/bottomk/count_values at the root)
      -> each remote reduces ITS series locally and replies one [G, W]
         AggPartial (mode="partial"); the coordinator's
         ReduceAggregateExec merges cluster partials with local shard
         partials exactly — wire cost O(groups), not O(series);
  label-partitioned, anything else
      -> series shipping: remotes evaluate the per-series expression
         (or a join side / the aggregate's input) and ship blocks;
  time-windowed ownership
      -> the MultiPartitionPlanner stance: clamp the WHOLE expression
         onto each cluster's window (step-grid snapped, windows must
         not overlap) and stitch — exact for any shape, since every
         instant is computed entirely inside one cluster;
  binary joins / set operators
      -> each side routes independently (cross-cluster joins ship both
         sides' series and join on the coordinator).

Degradation is inherited, not reimplemented: federated children ride
the ordinary scatter-gather, so a dead cluster trips its
`cluster:<name>` breaker, the engine's replan/partial machinery drops
it, and the flagged warning names the cluster (doc/federation.md).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from filodb_tpu_torch.query import logical as lp
from filodb_tpu_torch.query import planutils as pu
from filodb_tpu_torch.query.nonleaf import (ReduceAggregateExec, StitchRvsExec,
                                            _FOLDABLE_OPS)
from filodb_tpu_torch.query.planner import SET_OPERATORS, QueryPlanner
from filodb_tpu_torch.query.planners import ShardKeyRegexPlanner, _snap_up
from filodb_tpu_torch.query.planutils import TimeRange
from filodb_tpu_torch.query.rangevector import QueryContext
from filodb_tpu_torch.query.transformers import AggregatePresenter

from filodb_tpu_torch.federation.exec import (FederatedDispatcher,
                                              FederatedLeafExec,
                                              flip_to_partial)
from filodb_tpu_torch.federation.registry import ClusterDef, FederationRegistry


class FederationPlanner(QueryPlanner):

    def __init__(self, inner: QueryPlanner, registry: FederationRegistry,
                 dataset: str = "", config=None):
        self.inner = inner
        self.registry = registry
        self.dataset = dataset
        # FederationConfig (push_partials knob); falls back to pushing
        self.config = config
        self._dispatchers = {}

    # ---------------------------------------------------------- plumbing

    def federation_state(self) -> tuple:
        """Result-cache validity contribution (query/frontend.py folds
        this into the dataset's cache token): participating cluster set,
        health transitions and remote data tokens."""
        return self.registry.cache_state()

    def _dispatcher(self, cd: ClusterDef) -> FederatedDispatcher:
        d = self._dispatchers.get(cd.name)
        if d is None or (d.host, d.port) != (cd.host, cd.port):
            d = FederatedDispatcher(cd.name, cd.host, cd.port)
            self._dispatchers[cd.name] = d
        return d

    def _remote_leaf(self, ctx: QueryContext, cd: ClusterDef,
                     plan: lp.LogicalPlan, mode: str) -> FederatedLeafExec:
        from filodb_tpu_torch.utils.metrics import make_traceparent
        try:
            promql = pu.unparse(plan)
        except Exception:  # noqa: BLE001 — display only, never load-bearing
            promql = f"<{type(plan).__name__}>"
        leaf = FederatedLeafExec(
            ctx, dataset=cd.dataset, plan=plan, mode=mode, cluster=cd.name,
            promql=promql,
            traceparent=make_traceparent(getattr(ctx, "query_id", "")))
        leaf.dispatcher = self._dispatcher(cd)
        return leaf

    def _push_enabled(self, ctx: QueryContext) -> bool:
        pp = ctx.planner_params
        if getattr(pp, "ship_raw_series", False):
            return False                    # bench strawman: ship everything
        if getattr(pp, "aggregation_pushdown", None) is False:
            return False                    # per-query A/B override
        if self.config is not None and \
                not getattr(self.config, "push_partials", True):
            return False
        return True

    # -------------------------------------------------------- materialize

    def materialize(self, plan: lp.LogicalPlan, ctx: QueryContext):
        if not isinstance(plan, lp.PeriodicSeriesPlan):
            # metadata plans stay local (doc/federation.md limitation)
            return self.inner.materialize(plan, ctx)
        filter_groups = pu.get_raw_series_filters(plan)
        if not filter_groups:
            # pure scalar expressions read no series — nothing to route
            return self.inner.materialize(plan, ctx)
        tr = pu.get_time_range(plan)
        local, remotes = self.registry.owners_for(filter_groups, tr)
        if not remotes:
            return self.inner.materialize(plan, ctx)
        if lp.contains_at_pin(plan):
            raise ValueError(
                "@-pinned expressions cannot be federated: the pinned "
                "read's owner is ambiguous across clusters — narrow the "
                "selector to one cluster's series")
        windowed = [(cd, eff) for cd, eff in remotes if cd.windowed]
        if windowed or (local and self.registry.local_def is not None
                        and self.registry.local_def.windowed):
            if len(windowed) != len(remotes):
                raise ValueError(
                    "federation.clusters mixes time-windowed and "
                    "label-matched ownership for one selector — a series "
                    "must have exactly one owner per instant")
            return self._materialize_windowed(plan, ctx, local, remotes)
        # label-partitioned, full-range owners
        if isinstance(plan, lp.BinaryJoin):
            return self._materialize_join(plan, ctx)
        if isinstance(plan, lp.Aggregate):
            return self._materialize_aggregate(plan, ctx, local, remotes)
        if not local and len(remotes) == 1:
            # single-owner whole-expression routing is shape-agnostic:
            # the one cluster evaluates everything (the stitch parent
            # supplies the scatter-gather degradation slot)
            cd, _ = remotes[0]
            return StitchRvsExec(ctx,
                                 [self._remote_leaf(ctx, cd, plan,
                                                    "series")])
        if not ShardKeyRegexPlanner._per_series_only(plan):
            raise ValueError(
                f"cannot federate {type(plan).__name__} across "
                f"{len(remotes) + (1 if local else 0)} clusters: only "
                f"per-series expressions, top-level aggregations and "
                f"binary joins split exactly (doc/federation.md) — "
                f"narrow the selector to one cluster or lift the "
                f"aggregation to the top of the expression")
        # per-series pipeline: every cluster evaluates its own series;
        # the union is exact because each series lives in ONE cluster
        children = []
        if local:
            children.append(self.inner.materialize(plan, ctx))
        children += [self._remote_leaf(ctx, cd, plan, "series")
                     for cd, _ in remotes]
        return StitchRvsExec(ctx, children)

    # -------------------------------------------------------- aggregates

    def _materialize_aggregate(self, plan: lp.Aggregate, ctx: QueryContext,
                               local: bool,
                               remotes: List[Tuple[ClusterDef, TimeRange]]):
        op = plan.operator
        if op in _FOLDABLE_OPS and self._push_enabled(ctx):
            local_child = None
            if local:
                try:
                    local_child = flip_to_partial(
                        self.inner.materialize(plan, ctx), op)
                except ValueError:
                    # the local stack produced a non-flippable root
                    # (range straddles tiers, shard-key fan-out reduce):
                    # fall back to shipping for the WHOLE query rather
                    # than mixing incomparable intermediates
                    local_child = None
            if local_child is not None or not local:
                children = ([local_child] if local_child is not None
                            else [])
                children += [self._remote_leaf(ctx, cd, plan, "partial")
                             for cd, _ in remotes]
                reducer = ReduceAggregateExec(
                    ctx, children, op, tuple(plan.params),
                    by=tuple(plan.by), without=tuple(plan.without))
                reducer.add_transformer(
                    AggregatePresenter(op, tuple(plan.params)))
                return reducer
        # shipped mode: remotes (and the local stack) evaluate the
        # aggregate's INPUT per-series; the map phase runs coordinator-
        # side over each shipped block (ReduceAggregateExec.compose),
        # which is correct for any inner plan shape
        children = []
        if local:
            children.append(self.inner.materialize(plan.vectors, ctx))
        children += [self._remote_leaf(ctx, cd, plan.vectors, "series")
                     for cd, _ in remotes]
        reducer = ReduceAggregateExec(ctx, children, op, tuple(plan.params),
                                      by=tuple(plan.by),
                                      without=tuple(plan.without))
        reducer.add_transformer(AggregatePresenter(op, tuple(plan.params)))
        return reducer

    # ------------------------------------------------------------- joins

    def _materialize_join(self, plan: lp.BinaryJoin, ctx: QueryContext):
        from filodb_tpu_torch.query.nonleaf import BinaryJoinExec, SetOperatorExec
        lhs = self.materialize(plan.lhs, ctx)
        rhs = self.materialize(plan.rhs, ctx)
        op = plan.operator[:-5] if plan.operator.endswith("_bool") \
            else plan.operator
        if op.lower() in SET_OPERATORS:
            return SetOperatorExec(ctx, [lhs], [rhs], op.lower(),
                                   on=plan.on, ignoring=plan.ignoring)
        return BinaryJoinExec(ctx, [lhs], [rhs], op, plan.cardinality,
                              on=plan.on, ignoring=plan.ignoring,
                              include=plan.include,
                              bool_modifier=plan.operator.endswith("_bool"))

    # --------------------------------------------------- windowed routing

    def _materialize_windowed(self, plan, ctx: QueryContext, local: bool,
                              remotes: List[Tuple[ClusterDef, TimeRange]]):
        """Time-ownership routing: clamp the WHOLE expression onto each
        cluster's window and stitch (exact for any shape — every instant
        evaluates entirely inside its owning cluster).  Lookback windows
        reaching across a boundary see only the owning cluster's data;
        boundary instants may therefore carry partial lookback (the same
        caveat as the raw/downsample stitch, doc/federation.md)."""
        step = plan.step_ms
        spans: List[Tuple[str, int, int]] = []   # (cluster, start, end)
        for cd, eff in remotes:
            spans.append((cd.name, eff.start_ms, eff.end_ms))
        lr = None
        if local:
            lr = self.registry.local_range(pu.get_time_range(plan))
            spans.append((self.registry.local_name, lr.start_ms, lr.end_ms))
        spans.sort(key=lambda s: s[1])
        for (n1, _, e1), (n2, s2, _) in zip(spans, spans[1:]):
            if s2 <= e1:
                raise ValueError(
                    f"federation.clusters time windows of {n1!r} and "
                    f"{n2!r} overlap — a series must have exactly one "
                    f"owner per instant")
        children = []
        for cd, eff in remotes:
            sub = self._clamp(plan, eff, step)
            if sub is not None:
                children.append(self._remote_leaf(ctx, cd, sub, "series"))
        if local and lr is not None:
            sub = self._clamp(plan, lr, step)
            if sub is not None:
                children.append(self.inner.materialize(sub, ctx))
        if not children:
            return self.inner.materialize(plan, ctx)
        if len(children) == 1:
            # keep a gather parent: degradation needs a scatter slot
            return StitchRvsExec(ctx, children)
        return StitchRvsExec(ctx, children)

    @staticmethod
    def _clamp(plan, window: TimeRange, step: int) -> Optional[lp.LogicalPlan]:
        """The plan restricted to grid instants inside `window`, or None
        when the window covers none of them."""
        s = max(plan.start_ms, _snap_up(window.start_ms, plan.start_ms,
                                        step))
        e = min(plan.end_ms,
                plan.start_ms
                + ((window.end_ms - plan.start_ms) // step) * step)
        if s > e:
            return None
        return pu.copy_with_time_range(plan, TimeRange(s, e))
