"""SingleClusterPlanner — materializes a LogicalPlan into an ExecPlan
(port of filodb_tpu/query/planner.py).

One dataset over N shards: selectors, range functions and aggregates
become one leaf MultiSchemaPartitionsExec per shard with the
transformers pushed down, composed by ReduceAggregateExec (+
AggregatePresenter) or a concat; binary joins, set operators, scalar
operations, instant functions, subqueries, `@`, sort, limitk, absent,
the label functions, scalar(), vector() and the scalar plans they need
compose those; the metadata plans (label names, label values, series
keys) fan out to one metadata leaf per shard under MetadataMergeExec.
Every plan node of the reference's planner is carried, and its
dispatcher hook (`dispatcher_factory`: every leaf keeps the in-process
dispatcher unless the factory names another), and its node-level
aggregation pushdown (query/pushdown.py).  A plan node it does not
carry, the chunk-metadata plan (RawChunkMeta) among them, is refused
as the reference refuses it.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from filodb_tpu_torch.core.index import ColumnFilter, Equals
from filodb_tpu_torch.core.partkey import PartKey, strip_metric_suffix
from filodb_tpu_torch.core.schemas import PartitionSchema
from filodb_tpu_torch.parallel.shardmapper import ShardMapper, SpreadProvider
from filodb_tpu_torch.query import logical as lp
from filodb_tpu_torch.query.execbase import (ExecPlan,
                                             InProcessPlanDispatcher,
                                             PlanDispatcher, ScalarResult)
from filodb_tpu_torch.query.leafexec import (MultiSchemaPartitionsExec,
                                             ScalarBinaryOperationExec,
                                             ScalarFixedDoubleExec,
                                             TimeScalarGeneratorExec)
from filodb_tpu_torch.query.metaexec import (LabelValuesExec,
                                             MetadataMergeExec, PartKeysExec)
from filodb_tpu_torch.query.nonleaf import (BinaryJoinExec,
                                            LocalPartitionDistConcatExec,
                                            ReduceAggregateExec,
                                            SetOperatorExec, SubqueryExec)
from filodb_tpu_torch.query.rangevector import QueryContext
from filodb_tpu_torch.query.transformers import (
    AbsentFunctionMapper, AggregateMapReduce, AggregatePresenter,
    InstantVectorFunctionMapper, LimitFunctionMapper,
    MiscellaneousFunctionMapper, PeriodicSamplesMapper, RepeatToGridMapper,
    ScalarFunctionMapper, ScalarOperationMapper, SortFunctionMapper,
    VectorFunctionMapper)

SET_OPERATORS = ("and", "or", "unless")


class QueryPlanner:
    """A logical plan in, an exec tree out."""

    def materialize(self, plan: lp.LogicalPlan, ctx: QueryContext) -> ExecPlan:
        raise NotImplementedError


class SingleClusterPlanner(QueryPlanner):

    def __init__(self, dataset: str, shard_mapper: ShardMapper,
                 spread_provider: Optional[SpreadProvider] = None,
                 part_schema: Optional[PartitionSchema] = None,
                 stale_lookback_ms: int = 5 * 60 * 1000,
                 dispatcher_factory: Optional[
                     Callable[[int], PlanDispatcher]] = None):
        self.dataset = dataset
        self.shard_mapper = shard_mapper
        self.spread_provider = spread_provider or SpreadProvider()
        self.part_schema = part_schema or PartitionSchema()
        self.stale_lookback_ms = stale_lookback_ms
        self.dispatcher_factory = dispatcher_factory

    def _dispatcher(self, shard: int) -> Optional[PlanDispatcher]:
        if self.dispatcher_factory is not None:
            return self.dispatcher_factory(shard)
        return None

    def _with_dispatcher(self, plans: List[ExecPlan],
                         shards: Sequence[int]) -> List[ExecPlan]:
        """Each shard's plan gets the factory's dispatcher, if any."""
        for e, s in zip(plans, shards):
            d = self._dispatcher(s)
            if d is not None:
                e.dispatcher = d
        return plans

    def shards_from_filters(self, filters: Sequence[ColumnFilter],
                            ctx: QueryContext) -> List[int]:
        """Shard set from the shard-key filters (_ws_/_ns_/_metric_) via
        the shard-key hash and spread; all shards when one is missing."""
        if ctx.planner_params.shard_overrides:
            return list(ctx.planner_params.shard_overrides)
        eq = {f.column: f.value for f in filters if isinstance(f, Equals)}
        opts = self.part_schema.options
        shard_key: Dict[str, str] = {}
        for col in opts.shard_key_columns:
            if col in ("_metric_", "__name__"):
                metric = eq.get("_metric_") or eq.get("__name__")
                if metric is None:
                    return self.shard_mapper.all_shards()
                shard_key[col] = strip_metric_suffix(metric, self.part_schema)
            else:
                v = eq.get(col)
                if v is None:
                    return self.shard_mapper.all_shards()
                shard_key[col] = v
        spread = self.spread_provider.spread_for(shard_key)
        pk = PartKey(shard_key.get("_metric_", ""),
                     tuple(sorted((k, v) for k, v in shard_key.items()
                                  if k not in ("_metric_", "__name__"))))
        h = pk.shard_key_hash(self.part_schema)
        return self.shard_mapper.query_shards(h, spread)

    def materialize(self, plan: lp.LogicalPlan, ctx: QueryContext) -> ExecPlan:
        plan = lp.resolve_lookback_windows(plan, self.stale_lookback_ms)
        out = self._walk(plan, ctx)
        if isinstance(out, list):
            if len(out) == 1:
                return out[0]
            return LocalPartitionDistConcatExec(ctx, out)
        return out

    def _leaves(self, plan, ctx) -> List[ExecPlan]:
        out = self._walk(plan, ctx)
        return out if isinstance(out, list) else [out]

    def _walk(self, plan: lp.LogicalPlan, ctx: QueryContext):
        m = getattr(self, "_m_" + type(plan).__name__, None)
        if m is None:
            raise ValueError(f"cannot materialize {type(plan).__name__}")
        return m(plan, ctx)

    def _m_RawSeries(self, p: lp.RawSeries, ctx: QueryContext) -> List[ExecPlan]:
        candidates = self.shards_from_filters(p.filters, ctx)
        shards = self.shard_mapper.active_shards(candidates) or candidates
        plans = [MultiSchemaPartitionsExec(
            ctx, self.dataset, s, p.filters,
            p.range_selector.from_ms, p.range_selector.to_ms,
            columns=p.columns) for s in shards]
        return self._with_dispatcher(plans, shards)

    def _m_PeriodicSeries(self, p: lp.PeriodicSeries, ctx: QueryContext):
        lookback = p.raw_series.lookback_ms or self.stale_lookback_ms
        offset = p.offset_ms or 0
        raw = lp.RawSeries(
            lp.IntervalSelector(p.start_ms - lookback - offset,
                                p.end_ms - offset),
            p.raw_series.filters, p.raw_series.columns,
            p.raw_series.lookback_ms, p.raw_series.offset_ms)
        leaves = self._m_RawSeries(raw, ctx)
        for leaf in leaves:
            leaf.add_transformer(PeriodicSamplesMapper(
                p.start_ms, p.step_ms, p.end_ms, None, None, (),
                offset_ms=offset, lookback_ms=lookback))
        return leaves

    def _m_PeriodicSeriesWithWindowing(self, p: lp.PeriodicSeriesWithWindowing,
                                       ctx: QueryContext):
        offset = p.offset_ms or 0
        raw = lp.RawSeries(
            lp.IntervalSelector(p.start_ms - p.window_ms - offset,
                                p.end_ms - offset),
            p.series.filters, p.series.columns,
            p.series.lookback_ms, p.series.offset_ms)
        leaves = self._m_RawSeries(raw, ctx)
        for leaf in leaves:
            leaf.add_transformer(PeriodicSamplesMapper(
                p.start_ms, p.step_ms, p.end_ms, p.window_ms, p.function,
                tuple(p.function_args), offset_ms=offset,
                lookback_ms=self.stale_lookback_ms))
        return leaves

    def _m_ApplyAtTimestamp(self, p: lp.ApplyAtTimestamp, ctx: QueryContext):
        out = self._walk(p.inner, ctx)
        if not p.repeat:                 # a pinned matrix (subquery)
            return out
        mapper = RepeatToGridMapper(p.start_ms, p.step_ms, p.end_ms)
        for leaf in out if isinstance(out, list) else [out]:
            leaf.add_transformer(mapper)
        return out

    # subqueries --------------------------------------------------------------

    def _m_TopLevelSubquery(self, p: lp.TopLevelSubquery, ctx: QueryContext):
        return self._walk(p.inner, ctx)

    def _m_SubqueryWithWindowing(self, p: lp.SubqueryWithWindowing,
                                 ctx: QueryContext):
        inner = self.materialize(p.inner, ctx)
        return SubqueryExec(ctx, [inner], p.start_ms, p.step_ms, p.end_ms,
                            p.function, tuple(p.function_args),
                            p.subquery_window_ms, p.subquery_step_ms,
                            p.offset_ms or 0)

    # aggregates --------------------------------------------------------------

    def _m_Aggregate(self, p: lp.Aggregate, ctx: QueryContext) -> ExecPlan:
        from filodb_tpu_torch.query.pushdown import plan_aggregate_pushdown
        children = self._leaves(p.vectors, ctx)
        ship_raw = bool(getattr(ctx.planner_params, "ship_raw_series",
                                False))
        for c in children:
            # every child keeps its leaf-side map phase (per-shard
            # dispatches reply with [G, W] partials).  The one exception
            # is ship_raw_series, the ship-everything baseline, which
            # makes remote leaves reply with FULL per-series blocks so
            # the wire cost of not pushing can be measured; the map then
            # runs on the coordinator (ReduceAggregateExec.compose).
            # Local children always map in place.
            if not ship_raw or isinstance(c.dispatcher,
                                          InProcessPlanDispatcher):
                c.add_transformer(AggregateMapReduce(
                    p.operator, tuple(p.params), tuple(p.by),
                    tuple(p.without)))
        # node-level pushdown (query/pushdown.py): same-node map subtrees
        # collapse into RemoteAggregateExec groups whose reduce runs ON
        # the data node — only a [G, W] partial per NODE crosses the wire
        children, not_pushable = plan_aggregate_pushdown(
            children, p.operator, tuple(p.params), ctx)
        reducer = ReduceAggregateExec(ctx, children, p.operator,
                                      tuple(p.params), by=tuple(p.by),
                                      without=tuple(p.without))
        if not_pushable:
            reducer.pushdown_not_pushable = not_pushable
        reducer.add_transformer(AggregatePresenter(p.operator,
                                                   tuple(p.params)))
        return reducer

    # joins -------------------------------------------------------------------

    def _m_BinaryJoin(self, p: lp.BinaryJoin, ctx: QueryContext) -> ExecPlan:
        lhs = self._leaves(p.lhs, ctx)
        rhs = self._leaves(p.rhs, ctx)
        op = p.operator[:-5] if p.operator.endswith("_bool") else p.operator
        if op.lower() in SET_OPERATORS:
            return SetOperatorExec(ctx, lhs, rhs, op.lower(),
                                   on=p.on, ignoring=p.ignoring)
        return BinaryJoinExec(ctx, lhs, rhs, op, p.cardinality,
                              on=p.on, ignoring=p.ignoring, include=p.include,
                              bool_modifier=p.operator.endswith("_bool"))

    def _m_ScalarVectorBinaryOperation(self, p: lp.ScalarVectorBinaryOperation,
                                       ctx: QueryContext) -> ExecPlan:
        vec = self.materialize(p.vector, ctx)
        op = p.operator[:-5] if p.operator.endswith("_bool") else p.operator
        scalar_exec = self.materialize(p.scalar_arg, ctx)
        # a literal folds to a float; any other scalar runs on its own
        if isinstance(scalar_exec, ScalarFixedDoubleExec):
            scalar: object = scalar_exec.value
        else:
            scalar = _DeferredScalar(scalar_exec)
        vec.add_transformer(ScalarOperationMapper(
            op, scalar, scalar_is_lhs=p.scalar_is_lhs,
            bool_modifier=p.operator.endswith("_bool")))
        return vec

    # functions ---------------------------------------------------------------

    def _m_ApplyInstantFunction(self, p: lp.ApplyInstantFunction,
                                ctx: QueryContext) -> ExecPlan:
        child = self.materialize(p.vectors, ctx)
        args = tuple(self._fold_scalar(a, ctx) for a in p.function_args)
        child.add_transformer(InstantVectorFunctionMapper(p.function, args))
        return child

    def _m_ApplyMiscellaneousFunction(self, p, ctx) -> ExecPlan:
        child = self.materialize(p.vectors, ctx)
        child.add_transformer(MiscellaneousFunctionMapper(
            p.function, tuple(p.string_args)))
        return child

    def _m_ApplySortFunction(self, p, ctx) -> ExecPlan:
        child = self.materialize(p.vectors, ctx)
        child.add_transformer(SortFunctionMapper(p.function == "sort_desc"))
        return child

    def _m_ApplyAbsentFunction(self, p: lp.ApplyAbsentFunction,
                               ctx) -> ExecPlan:
        child = self.materialize(p.vectors, ctx)
        child.add_transformer(AbsentFunctionMapper(
            tuple(p.filters), p.start_ms, p.step_ms, p.end_ms))
        return child

    def _m_ApplyLimitFunction(self, p, ctx) -> ExecPlan:
        child = self.materialize(p.vectors, ctx)
        child.add_transformer(LimitFunctionMapper(p.limit))
        return child

    # scalars -----------------------------------------------------------------

    def _m_ScalarTimeBasedPlan(self, p: lp.ScalarTimeBasedPlan, ctx):
        return TimeScalarGeneratorExec(ctx, p.start_ms, p.step_ms, p.end_ms,
                                       p.function)

    def _m_ScalarFixedDoublePlan(self, p: lp.ScalarFixedDoublePlan, ctx):
        return ScalarFixedDoubleExec(ctx, p.start_ms, p.step_ms, p.end_ms,
                                     p.scalar)

    def _m_ScalarVaryingDoublePlan(self, p: lp.ScalarVaryingDoublePlan, ctx):
        child = self.materialize(p.vectors, ctx)
        child.add_transformer(ScalarFunctionMapper())
        return child

    def _m_ScalarBinaryOperation(self, p: lp.ScalarBinaryOperation, ctx):
        def conv(x):
            if isinstance(x, lp.ScalarBinaryOperation):
                return ScalarBinaryOperationExec(
                    ctx, x.start_ms, x.step_ms, x.end_ms, x.operator,
                    conv(x.lhs), conv(x.rhs))
            return float(x)
        return ScalarBinaryOperationExec(ctx, p.start_ms, p.step_ms, p.end_ms,
                                         p.operator, conv(p.lhs), conv(p.rhs))

    def _m_VectorPlan(self, p: lp.VectorPlan, ctx) -> ExecPlan:
        child = self.materialize(p.scalars, ctx)
        child.add_transformer(VectorFunctionMapper())
        return child

    def _fold_scalar(self, arg, ctx):
        if isinstance(arg, lp.ScalarFixedDoublePlan):
            return arg.scalar
        if isinstance(arg, lp.LogicalPlan):
            return _DeferredScalar(self.materialize(arg, ctx))
        return arg

    # metadata ----------------------------------------------------------------

    def _m_LabelValues(self, p: lp.LabelValues, ctx) -> ExecPlan:
        shards = self.shard_mapper.all_shards()
        return MetadataMergeExec(ctx, self._with_dispatcher([
            LabelValuesExec(ctx, self.dataset, s, p.filters, p.label_names,
                            p.start_ms, p.end_ms) for s in shards], shards))

    def _m_LabelNames(self, p: lp.LabelNames, ctx) -> ExecPlan:
        shards = self.shard_mapper.all_shards()
        return MetadataMergeExec(ctx, self._with_dispatcher([
            LabelValuesExec(ctx, self.dataset, s, p.filters, [], p.start_ms,
                            p.end_ms) for s in shards], shards))

    def _m_SeriesKeysByFilters(self, p: lp.SeriesKeysByFilters,
                               ctx) -> ExecPlan:
        shards = self.shards_from_filters(p.filters, ctx)
        return MetadataMergeExec(ctx, self._with_dispatcher([
            PartKeysExec(ctx, self.dataset, s, p.filters, p.start_ms,
                         p.end_ms) for s in shards], shards))


class _DeferredScalar:
    """A scalar subplan run when a transformer first reads it."""

    def __init__(self, plan: ExecPlan):
        self.plan = plan
        self._result: Optional[ScalarResult] = None

    def resolve(self, source) -> ScalarResult:
        if self._result is None:
            data, _ = self.plan.execute_internal(source)
            if not isinstance(data, ScalarResult):
                raise TypeError(f"scalar argument gave "
                                f"{type(data).__name__}")
            self._result = data
        return self._result
