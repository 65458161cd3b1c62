"""Composed planners above SingleClusterPlanner (port of
filodb_tpu/query/planners.py):

  - LongTimeRangePlanner: raw | persisted | downsample routing by time,
    stitched; the downsample planner is injected (None until a
    downsample cluster exists);
  - PersistedClusterPlanner: SingleClusterPlanner whose leaves read the
    persisted-segment tier (SelectPersistedSegmentsExec);
  - HighAvailabilityPlanner + FailureProvider: a local failure window
    routed to a remote replica over PromQL HTTP;
  - MultiPartitionPlanner + PartitionLocationProvider: a query split by
    time across independent partitions;
  - SinglePartitionPlanner: one of several planners picked by metric;
  - ShardKeyRegexPlanner: regex or multi-valued shard keys fanned out
    into concrete combinations, re-aggregated by
    MultiPartitionReduceAggregateExec.

Every remote hop is a PromQlRemoteExec with an injectable transport (the
default is a urllib GET), so tests run without a network.  Stitching
(StitchRvsExec) and the reduce run wherever their inputs' values lie.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from filodb_tpu_torch.core.index import ColumnFilter, Equals, EqualsRegex, In
from filodb_tpu_torch.query import logical as lp
from filodb_tpu_torch.query import planutils as pu
from filodb_tpu_torch.query.execbase import (ExecPlan, LeafExecPlan,
                                             NonLeafExecPlan)
from filodb_tpu_torch.query.nonleaf import DistConcatExec, StitchRvsExec
from filodb_tpu_torch.query.planner import QueryPlanner, SingleClusterPlanner
from filodb_tpu_torch.query.planutils import TimeRange
from filodb_tpu_torch.query.rangevector import (QueryContext, QueryStats,
                                                RangeVectorKey, ResultBlock,
                                                host_values)

# ------------------------------------------------------------- remote exec


class PromQlRemoteExec(LeafExecPlan):
    """Dispatch a PromQL query to a remote cluster over HTTP
    (ref: exec/PromQlRemoteExec.scala:247).

    `transport(endpoint, params) -> prom-matrix-json` is injectable; the
    default uses urllib at execute time.  Params mirror the reference's
    PromQlQueryParams (query/start/step/end in seconds).
    """

    def __init__(self, ctx: QueryContext, endpoint: str, promql: str,
                 start_ms: int, step_ms: int, end_ms: int,
                 transport: Optional[Callable] = None):
        super().__init__(ctx)
        self.endpoint = endpoint
        self.promql = promql
        self.start_ms, self.step_ms, self.end_ms = start_ms, step_ms, end_ms
        self.transport = transport or _http_transport

    def args_str(self) -> str:
        return (f"endpoint={self.endpoint}, promql={self.promql}, "
                f"start={self.start_ms}, step={self.step_ms}, "
                f"end={self.end_ms}")

    def _do_execute(self, source):
        params = {"query": self.promql, "start": self.start_ms // 1000,
                  "step": max(self.step_ms // 1000, 1),
                  "end": self.end_ms // 1000}
        payload = self.transport(self.endpoint, params)
        return _matrix_json_to_block(payload), QueryStats()


def _http_transport(endpoint: str, params: Dict) -> Dict:
    import json
    import urllib.parse
    import urllib.request
    url = endpoint + "?" + urllib.parse.urlencode(params)
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _matrix_json_to_block(payload: Dict) -> Optional[ResultBlock]:
    """Prometheus matrix JSON → dense ResultBlock (NaN-padded grid union)."""
    result = (payload.get("data") or {}).get("result") or []
    if not result:
        return None
    all_ts = sorted({int(t * 1000) for series in result
                     for t, _ in series.get("values", [])})
    if not all_ts:
        return None
    wends = np.asarray(all_ts, dtype=np.int64)
    keys, rows = [], []
    for series in result:
        keys.append(RangeVectorKey.make(series.get("metric", {})))
        row = np.full(len(wends), np.nan)
        for t, v in series.get("values", []):
            row[np.searchsorted(wends, int(t * 1000))] = float(v)
        rows.append(row)
    return ResultBlock(keys, wends, np.stack(rows))


# --------------------------------------------------------- long time range


class LongTimeRangePlanner(QueryPlanner):
    """Route recent ranges to the raw cluster, old ranges to the downsample
    cluster, split + stitch when a query straddles raw retention
    (ref: queryplanner/LongTimeRangePlanner.scala:27-40).

    With a `persisted_planner` wired, a THIRD tier sits between them: the
    full-resolution persisted-segment tier (the compacted historical
    store).  Instants too old for the in-memory working set but covered by
    segments route there; only instants older than segment coverage fall
    to downsample.  One query over months stitches all three into one
    grid (the real-LTS contract: raw | persisted | downsample)."""

    def __init__(self, raw_planner: QueryPlanner,
                 downsample_planner: Optional[QueryPlanner],
                 earliest_raw_time_fn: Callable[[], int],
                 latest_downsample_time_fn: Callable[[], int],
                 stale_lookback_ms: int = 5 * 60 * 1000,
                 persisted_planner: Optional[QueryPlanner] = None,
                 persisted_range_fn: Optional[Callable] = None):
        self.raw = raw_planner
        self.downsample = downsample_planner
        self.earliest_raw_time_fn = earliest_raw_time_fn
        self.latest_downsample_time_fn = latest_downsample_time_fn
        self.stale_lookback_ms = stale_lookback_ms
        self.persisted = persisted_planner
        # () -> (floor_ms, ceil_ms) of segment coverage, or None when no
        # segments exist yet (PersistedTier.range)
        self.persisted_range_fn = persisted_range_fn

    def _downsample_or_raw(self):
        return self.downsample if self.downsample is not None else self.raw

    def materialize(self, plan: lp.LogicalPlan, ctx: QueryContext) -> ExecPlan:
        if not isinstance(plan, lp.PeriodicSeriesPlan):
            return self.raw.materialize(plan, ctx)   # metadata → raw cluster
        if lp.contains_at_pin(plan):
            # @ (anywhere in the tree) reads data at pinned times, not the
            # outer grid: route the WHOLE query by the true data range —
            # straddle-splitting the outer grid cannot relocate pinned
            # reads.  Fits-raw wins; else persisted when it covers the
            # whole data range; else downsample when it covers the range
            # end; else conservatively raw.
            dr = lp.pinned_data_range(plan, self.stale_lookback_ms)
            if dr is None:
                return self.raw.materialize(plan, ctx)
            if dr[0] >= self.earliest_raw_time_fn():
                return self.raw.materialize(plan, ctx)
            pr = self.persisted_range_fn() \
                if (self.persisted is not None
                    and self.persisted_range_fn is not None) else None
            if pr is not None and dr[0] >= pr[0] and dr[1] <= pr[1]:
                return self.persisted.materialize(plan, ctx)
            if self.downsample is not None \
                    and dr[1] <= self.latest_downsample_time_fn():
                return self.downsample.materialize(plan, ctx)
            return self.raw.materialize(plan, ctx)
        earliest_raw = self.earliest_raw_time_fn()
        lookback = pu.get_lookback_ms(plan, self.stale_lookback_ms)
        offset = pu.get_offset_ms(plan)
        start, step, end = plan.start_ms, plan.step_ms, plan.end_ms
        # instants whose full window [t-lookback-offset, t] is inside raw
        # retention can be answered by the raw cluster alone
        if start - lookback - offset >= earliest_raw:
            return self.raw.materialize(plan, ctx)
        pr = self.persisted_range_fn() \
            if (self.persisted is not None
                and self.persisted_range_fn is not None) else None
        if end - offset < earliest_raw:
            if pr is None:
                return self._downsample_or_raw().materialize(plan, ctx)
            return self._materialize_old(plan, ctx, pr, lookback, offset)
        # first grid instant fully covered by raw data
        need = earliest_raw + lookback + offset
        k = -((start - need) // step)                # ceil((need-start)/step)
        first_raw_instant = start + k * step
        if first_raw_instant > end:
            if pr is None:
                return self._downsample_or_raw().materialize(plan, ctx)
            return self._materialize_old(plan, ctx, pr, lookback, offset)
        old_end = first_raw_instant - step
        raw_plan = pu.copy_with_time_range(plan, TimeRange(first_raw_instant,
                                                           end))
        if old_end < start:
            return self.raw.materialize(plan, ctx)
        old_plan = pu.copy_with_time_range(plan, TimeRange(start, old_end))
        if pr is not None:
            old = self._materialize_old(old_plan, ctx, pr, lookback, offset)
            return StitchRvsExec(ctx, [old,
                                       self.raw.materialize(raw_plan, ctx)])
        latest_ds = self.latest_downsample_time_fn()
        ds_end = min(old_end, latest_ds)
        if ds_end < start:
            return self.raw.materialize(plan, ctx)
        ds_plan = pu.copy_with_time_range(plan, TimeRange(start, ds_end))
        return StitchRvsExec(
            ctx, [self._downsample_or_raw().materialize(ds_plan, ctx),
                  self.raw.materialize(raw_plan, ctx)])

    def _materialize_old(self, plan, ctx, pr, lookback: int,
                         offset: int) -> ExecPlan:
        """Route a fully-before-raw plan across persisted + downsample:
        instants whose window [t-lookback-offset, t-offset] sits inside
        segment coverage go to the persisted tier at full resolution; only
        older instants fall to downsample."""
        start, step, end = plan.start_ms, plan.step_ms, plan.end_ms
        p0, p1 = pr
        # first grid instant whose whole window is inside segment coverage
        # (clamped to the grid start: coverage reaching further back than
        # the query must not mint extra instants before it)
        need = p0 + lookback + offset
        k = max(-((start - need) // step), 0)
        first_p = start + k * step
        # last instant whose data end (t - offset) segments still cover
        last_p = end if p1 >= end - offset else \
            start + ((p1 + offset - start) // step) * step
        if first_p > end or last_p < start or first_p > last_p:
            # segments cover none of the grid
            return self._downsample_or_raw().materialize(plan, ctx)
        children: List[ExecPlan] = []
        if first_p > start:
            # grid head older than segment coverage: downsample when
            # wired, else the raw cluster's chunk-paging path (retention
            # never prunes frames no segment covers, so raw still holds
            # that data — dropping the head would silently truncate)
            if self.downsample is not None:
                ds_end = min(first_p - step,
                             self.latest_downsample_time_fn())
            else:
                ds_end = first_p - step
            if ds_end >= start:
                head = pu.copy_with_time_range(plan,
                                               TimeRange(start, ds_end))
                children.append(
                    self._downsample_or_raw().materialize(head, ctx))
        children.append(self.persisted.materialize(
            pu.copy_with_time_range(plan, TimeRange(first_p, last_p)), ctx))
        if last_p < end:
            # newer than segment coverage but older than raw: the raw
            # cluster's chunk-paging path is the only source
            children.append(self.raw.materialize(
                pu.copy_with_time_range(plan,
                                        TimeRange(last_p + step, end)),
                ctx))
        if len(children) == 1:
            return children[0]
        return StitchRvsExec(ctx, children)


class PersistedClusterPlanner(SingleClusterPlanner):
    """SingleClusterPlanner variant whose leaves read the persisted-segment
    tier (SelectPersistedSegmentsExec) instead of shard memory.  Long
    ranges split on the step grid (`tier.plan_split_ms` slices, stitched)
    so each leaf merges a bounded number of segments and int32 time
    offsets never overflow."""

    def __init__(self, dataset: str, shard_mapper, tier, **kwargs):
        super().__init__(dataset, shard_mapper, **kwargs)
        self.tier = tier

    def materialize(self, plan: lp.LogicalPlan, ctx: QueryContext) -> ExecPlan:
        split = getattr(self.tier, "plan_split_ms", 0)
        if split and isinstance(plan, lp.PeriodicSeriesPlan) \
                and not lp.contains_at_pin(plan) \
                and plan.end_ms - plan.start_ms > split:
            parts = pu.split_plans(plan, split)
            if len(parts) > 1:
                return StitchRvsExec(
                    ctx, [super(PersistedClusterPlanner, self)
                          .materialize(p, ctx) for p in parts])
        return super().materialize(plan, ctx)

    def _m_RawSeries(self, p: lp.RawSeries, ctx: QueryContext):
        from filodb_tpu_torch.query.leafexec import SelectPersistedSegmentsExec
        candidates = self.shards_from_filters(p.filters, ctx)
        shards = self.shard_mapper.active_shards(candidates) or candidates
        plans = [SelectPersistedSegmentsExec(
            ctx, self.dataset, s, p.filters,
            p.range_selector.from_ms, p.range_selector.to_ms, self.tier,
            columns=p.columns) for s in shards]
        # same owner routing as the memstore leaves: a cluster-mode
        # persisted planner dispatches cold leaves to the shard's node
        # (and the PR-15 pushdown can then group them per node)
        return self._with_dispatcher(plans, shards)


# ------------------------------------------------------------ HA routing


@dataclasses.dataclass(frozen=True)
class FailureTimeRange:
    """A known data-gap window in one cluster
    (ref: queryplanner/FailureProvider.scala FailureTimeRange)."""
    cluster: str
    time_range: TimeRange
    is_remote: bool = False


class FailureProvider:
    """ref: FailureProvider.scala:45."""

    def get_failures(self, dataset: str, tr: TimeRange) -> List[FailureTimeRange]:
        return []


@dataclasses.dataclass(frozen=True)
class LocalRoute:
    time_range: Optional[TimeRange] = None          # None = whole query


@dataclasses.dataclass(frozen=True)
class RemoteRoute:
    time_range: TimeRange


def plan_routes(start_ms: int, step_ms: int, end_ms: int,
                local_failures: Sequence[TimeRange],
                lookback_ms: int) -> List:
    """Split the query grid into alternating local/remote routes so no local
    instant's lookback window overlaps a local failure
    (ref: queryplanner/FailureRoutingStrategy.scala QueryRoutingStrategy)."""
    if not local_failures:
        return [LocalRoute()]
    merged: List[TimeRange] = []
    for f in sorted(local_failures, key=lambda t: t.start_ms):
        if merged and f.start_ms <= merged[-1].end_ms:
            merged[-1] = TimeRange(merged[-1].start_ms,
                                   max(merged[-1].end_ms, f.end_ms))
        else:
            merged.append(f)
    routes: List = []
    cur = start_ms
    for f in merged:
        if cur > end_ms:
            break
        # local instants strictly before any instant whose window touches f
        bad_from = f.start_ms                         # t-lookback < f.end …
        last_local = bad_from - 1
        # snap to grid: largest instant <= last_local with window clear of f
        n = (last_local - start_ms) // step_ms
        last_local_instant = start_ms + n * step_ms
        if last_local_instant >= cur and last_local_instant - lookback_ms >= 0:
            routes.append(LocalRoute(TimeRange(cur, last_local_instant)))
            cur = last_local_instant + step_ms
        # remote covers instants while windows overlap the failure
        clear = f.end_ms + lookback_ms
        k = -((start_ms - clear) // step_ms)
        first_clear_instant = start_ms + k * step_ms
        remote_end = min(first_clear_instant - step_ms, end_ms)
        if remote_end >= cur:
            routes.append(RemoteRoute(TimeRange(cur, remote_end)))
            cur = remote_end + step_ms
    if cur <= end_ms:
        routes.append(LocalRoute(TimeRange(cur, end_ms)))
    return routes


class HighAvailabilityPlanner(QueryPlanner):
    """Route failure windows of the local cluster to a remote replica via
    PromQlRemoteExec (ref: queryplanner/HighAvailabilityPlanner.scala:22)."""

    def __init__(self, dataset: str, local_planner: QueryPlanner,
                 failure_provider: FailureProvider, remote_endpoint: str,
                 transport: Optional[Callable] = None,
                 stale_lookback_ms: int = 5 * 60 * 1000):
        self.dataset = dataset
        self.local = local_planner
        self.failure_provider = failure_provider
        self.remote_endpoint = remote_endpoint
        self.transport = transport
        self.stale_lookback_ms = stale_lookback_ms

    def materialize(self, plan: lp.LogicalPlan, ctx: QueryContext) -> ExecPlan:
        if not isinstance(plan, lp.PeriodicSeriesPlan):
            return self.local.materialize(plan, ctx)
        if lp.contains_at_pin(plan):
            # @ reads at pinned times: check failures against the true
            # data range and route the WHOLE query (slicing the outer
            # grid cannot relocate a pinned read)
            dr = lp.pinned_data_range(plan, self.stale_lookback_ms)
            if dr is not None:
                failures = self.failure_provider.get_failures(
                    self.dataset, TimeRange(dr[0], dr[1]))
                if any(not f.is_remote for f in failures):
                    return PromQlRemoteExec(
                        ctx, self.remote_endpoint, pu.unparse(plan),
                        plan.start_ms, plan.step_ms, plan.end_ms,
                        transport=self.transport)
            return self.local.materialize(plan, ctx)
        lookback = pu.get_lookback_ms(plan, self.stale_lookback_ms)
        offset = pu.get_offset_ms(plan)
        tr = TimeRange(plan.start_ms - lookback - offset, plan.end_ms)
        failures = self.failure_provider.get_failures(self.dataset, tr)
        local_fail = [f.time_range for f in failures if not f.is_remote]
        if not local_fail:
            return self.local.materialize(plan, ctx)
        routes = plan_routes(plan.start_ms, plan.step_ms, plan.end_ms,
                             local_fail, lookback + offset)
        children: List[ExecPlan] = []
        for r in routes:
            if isinstance(r, LocalRoute):
                sub = plan if r.time_range is None else \
                    pu.copy_with_time_range(plan, r.time_range)
                children.append(self.local.materialize(sub, ctx))
            else:
                sub = pu.copy_with_time_range(plan, r.time_range)
                children.append(PromQlRemoteExec(
                    ctx, self.remote_endpoint, pu.unparse(sub),
                    sub.start_ms, sub.step_ms, sub.end_ms,
                    transport=self.transport))
        if len(children) == 1:
            return children[0]
        return StitchRvsExec(ctx, children)


# -------------------------------------------------------- multi-partition


@dataclasses.dataclass(frozen=True)
class PartitionAssignment:
    """ref: MultiPartitionPlanner PartitionAssignment."""
    partition_name: str
    endpoint: str
    time_range: TimeRange


class PartitionLocationProvider:
    """ref: MultiPartitionPlanner.scala PartitionLocationProvider."""

    def get_partitions(self, filters: Sequence[ColumnFilter],
                       tr: TimeRange) -> List[PartitionAssignment]:
        raise NotImplementedError

    def get_metadata_partitions(self, filters: Sequence[ColumnFilter],
                                tr: TimeRange) -> List[PartitionAssignment]:
        return self.get_partitions(filters, tr)


class MultiPartitionPlanner(QueryPlanner):
    """Fan a query out across independent FiloDB partitions (clusters) and
    stitch by time (ref: queryplanner/MultiPartitionPlanner.scala:12-52)."""

    def __init__(self, partition_provider: PartitionLocationProvider,
                 local_partition_name: str, local_planner: QueryPlanner,
                 transport: Optional[Callable] = None,
                 stale_lookback_ms: int = 5 * 60 * 1000):
        self.provider = partition_provider
        self.local_name = local_partition_name
        self.local = local_planner
        self.transport = transport
        self.stale_lookback_ms = stale_lookback_ms

    def materialize(self, plan: lp.LogicalPlan, ctx: QueryContext) -> ExecPlan:
        if not isinstance(plan, lp.PeriodicSeriesPlan):
            return self.local.materialize(plan, ctx)
        filter_groups = pu.get_raw_series_filters(plan)
        tr = pu.get_time_range(plan)
        if lp.contains_at_pin(plan):
            return self._materialize_pinned(plan, ctx, filter_groups)
        # a partition may own several disjoint windows (data moved away and
        # back) — dedupe on the full assignment, never just the name
        assignments: List[PartitionAssignment] = []
        seen = set()
        for fg in (filter_groups or [()]):
            for a in self.provider.get_partitions(fg, tr):
                if a not in seen:
                    seen.add(a)
                    assignments.append(a)
        if not assignments or all(a.partition_name == self.local_name
                                  for a in assignments):
            return self.local.materialize(plan, ctx)
        step = plan.step_ms
        children: List[ExecPlan] = []
        for a in sorted(assignments, key=lambda x: x.time_range.start_ms):
            # clamp the plan onto this partition's assignment period
            s = max(plan.start_ms, _snap_up(a.time_range.start_ms,
                                            plan.start_ms, step))
            e = min(plan.end_ms, a.time_range.end_ms)
            if s > e:
                continue
            sub = pu.copy_with_time_range(plan, TimeRange(s, e))
            if a.partition_name == self.local_name:
                children.append(self.local.materialize(sub, ctx))
            else:
                children.append(PromQlRemoteExec(
                    ctx, a.endpoint, pu.unparse(sub), sub.start_ms,
                    sub.step_ms, sub.end_ms, transport=self.transport))
        if len(children) == 1:
            return children[0]
        return StitchRvsExec(ctx, children)

    def _materialize_pinned(self, plan: lp.LogicalPlan, ctx: QueryContext,
                            filter_groups) -> ExecPlan:
        """@ plans read data at the PINNED time, not the outer grid: select
        the partition by the true data range and send the WHOLE plan there
        (slicing the outer grid cannot relocate a pinned read).  A pinned
        data range that SPANS partitions is an error: no single node holds
        the whole range, so local evaluation would silently return partial
        results (every partition is missing part of the window), and the
        outer-grid stitch used for unpinned plans cannot split a pinned
        read either."""
        dr = lp.pinned_data_range(plan, self.stale_lookback_ms)
        if dr is None:
            return self.local.materialize(plan, ctx)
        tr = TimeRange(dr[0], dr[1])
        names = set()
        endpoint = None
        for fg in (filter_groups or [()]):
            for a in self.provider.get_partitions(fg, tr):
                names.add(a.partition_name)
                if a.partition_name != self.local_name:
                    endpoint = a.endpoint
        if len(names) > 1:
            raise ValueError(
                "@-pinned expression reads data spanning partitions "
                f"{sorted(names)}; a pinned read cannot be split — narrow "
                "the @ timestamp or the selector range")
        if len(names) == 1 and endpoint is not None:
            return PromQlRemoteExec(
                ctx, endpoint, pu.unparse(plan), plan.start_ms,
                plan.step_ms, plan.end_ms, transport=self.transport)
        return self.local.materialize(plan, ctx)


def _snap_up(t: int, grid_start: int, step: int) -> int:
    if t <= grid_start:
        return grid_start
    k = -((grid_start - t) // step)
    return grid_start + k * step


# ------------------------------------------------------- single partition


class SinglePartitionPlanner(QueryPlanner):
    """Pick one of several cluster planners by metric name within a single
    partition (ref: queryplanner/SinglePartitionPlanner.scala)."""

    def __init__(self, planners: Dict[str, QueryPlanner],
                 planner_selector: Callable[[str], str],
                 default: Optional[str] = None):
        self.planners = planners
        self.planner_selector = planner_selector
        self.default = default or next(iter(planners))

    def _pick(self, plan: lp.LogicalPlan) -> QueryPlanner:
        for fg in pu.get_raw_series_filters(plan):
            for f in fg:
                if f.column in ("_metric_", "__name__") and isinstance(f, Equals):
                    return self.planners[self.planner_selector(f.value)]
        return self.planners[self.default]

    def materialize(self, plan: lp.LogicalPlan, ctx: QueryContext) -> ExecPlan:
        return self._pick(plan).materialize(plan, ctx)


# ------------------------------------------------------ shard-key regex


ShardKeyMatcher = Callable[[Sequence[ColumnFilter]], List[Sequence[ColumnFilter]]]


def default_shard_key_matcher(index_label_values: Callable[[str], List[str]],
                              shard_key_columns: Sequence[str]) -> ShardKeyMatcher:
    """Expand regex/In shard-key filters against known label values."""
    import re

    def matcher(filters: Sequence[ColumnFilter]) -> List[Sequence[ColumnFilter]]:
        from filodb_tpu_torch.core.index import NotEquals, NotEqualsRegex, NotIn
        combos: List[List[ColumnFilter]] = [[]]
        for f in filters:
            if f.column not in shard_key_columns:
                continue
            if isinstance(f, Equals):
                vals = [f.value]
            elif isinstance(f, In):
                vals = sorted(f.values)
            elif isinstance(f, EqualsRegex):
                rx = re.compile(f.pattern)
                vals = [v for v in index_label_values(f.column)
                        if rx.fullmatch(v)]
            elif isinstance(f, NotEquals):
                vals = [v for v in index_label_values(f.column)
                        if v != f.value]
            elif isinstance(f, NotIn):
                vals = [v for v in index_label_values(f.column)
                        if v not in f.values]
            elif isinstance(f, NotEqualsRegex):
                rx = re.compile(f.pattern)
                vals = [v for v in index_label_values(f.column)
                        if not rx.fullmatch(v)]
            else:
                vals = index_label_values(f.column)
            combos = [c + [Equals(f.column, v)] for c in combos for v in vals]
        return [tuple(c) for c in combos]
    return matcher


class ShardKeyRegexPlanner(QueryPlanner):
    """Fan out regex / multi-valued shard-key filters into N concrete
    shard-key combinations, each materialized by the wrapped planner; combine
    with a reduce (when the top is an Aggregate) or concat
    (ref: queryplanner/ShardKeyRegexPlanner.scala)."""

    NONEXPANDABLE = (Equals,)

    def __init__(self, planner: QueryPlanner, shard_key_matcher: ShardKeyMatcher,
                 shard_key_columns: Sequence[str] = ("_ws_", "_ns_")):
        self.planner = planner
        self.matcher = shard_key_matcher
        self.shard_key_columns = tuple(shard_key_columns)

    def _needs_fanout(self, plan: lp.LogicalPlan) -> bool:
        for fg in pu.get_raw_series_filters(plan):
            for f in fg:
                if f.column in self.shard_key_columns and \
                        not isinstance(f, self.NONEXPANDABLE):
                    return True
        return False

    def materialize(self, plan: lp.LogicalPlan, ctx: QueryContext) -> ExecPlan:
        if not self._needs_fanout(plan):
            return self.planner.materialize(plan, ctx)
        if isinstance(plan, lp.BinaryJoin):
            # each side fans out independently — rewriting one side's combos
            # onto the other would corrupt the join
            # (ref: ShardKeyRegexPlanner materializeBinaryJoin)
            return self._materialize_join(plan, ctx)
        if not self._concat_safe(plan):
            # a cross-series op (avg/topk/sort/...) that cannot be rebuilt
            # from per-combo presented results: let the wrapped planner fan
            # to all shards and apply the regex at the index — correct,
            # just less targeted
            return self.planner.materialize(plan, ctx)
        groups = pu.get_raw_series_filters(plan)
        base = groups[0] if groups else ()
        key_of = lambda fs: frozenset(  # noqa: E731
            f for f in fs if f.column in self.shard_key_columns)
        if any(key_of(g) != key_of(base) for g in groups[1:]):
            # selectors disagree on shard-key filters: fall back to the
            # wrapped planner, which fans to all shards and applies the
            # regex at the index — correct, just less targeted
            return self.planner.materialize(plan, ctx)
        combos = self.matcher([f for f in base
                               if f.column in self.shard_key_columns])
        if not combos:
            return self.planner.materialize(plan, ctx)
        if len(combos) == 1:
            return self.planner.materialize(
                pu.rewrite_filters(plan, combos[0]), ctx)
        children = [self.planner.materialize(pu.rewrite_filters(plan, c), ctx)
                    for c in combos]
        if isinstance(plan, lp.Aggregate) and \
                plan.operator in MultiPartitionReduceAggregateExec.COMBINE:
            return MultiPartitionReduceAggregateExec(ctx, children,
                                                     plan.operator)
        return DistConcatExec(ctx, children)

    def _concat_safe(self, plan: lp.LogicalPlan) -> bool:
        """True when per-combo results compose correctly: either the top is a
        combinable Aggregate, or the plan contains no cross-series operation
        at all (pure per-series pipelines concatenate cleanly)."""
        if isinstance(plan, lp.Aggregate):
            return plan.operator in MultiPartitionReduceAggregateExec.COMBINE \
                and self._per_series_only(plan.vectors)
        return self._per_series_only(plan)

    @staticmethod
    def _per_series_only(plan) -> bool:
        import dataclasses as _dc
        if isinstance(plan, (lp.Aggregate, lp.ApplySortFunction,
                             lp.ApplyLimitFunction)):
            return False
        if _dc.is_dataclass(plan):
            for f in _dc.fields(plan):
                v = getattr(plan, f.name)
                if isinstance(v, lp.LogicalPlan) and \
                        not ShardKeyRegexPlanner._per_series_only(v):
                    return False
        return True

    def _materialize_join(self, plan: lp.BinaryJoin,
                          ctx: QueryContext) -> ExecPlan:
        from filodb_tpu_torch.query.nonleaf import (BinaryJoinExec,
                                                    SetOperatorExec)
        from filodb_tpu_torch.query.planner import SET_OPERATORS
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


class MultiPartitionReduceAggregateExec(NonLeafExecPlan):
    """Re-aggregate already-presented aggregate results coming from multiple
    shard-key fan-out branches, merging rows that share a group key
    (ref: exec/AggrOverRangeVectors.scala MultiPartitionReduceAggregateExec).
    Only ops whose presented form re-combines exactly are allowed."""

    COMBINE = {"sum": np.nansum, "min": np.nanmin, "max": np.nanmax,
               "count": np.nansum, "group": np.nanmax}

    def __init__(self, ctx, children, op: str):
        super().__init__(ctx, children)
        self.op = op

    def args_str(self):
        return f"aggrOp={self.op}"

    def compose(self, results, stats):
        blocks = [r for r in results if isinstance(r, ResultBlock)]
        if not blocks:
            return None
        wends = blocks[0].wends
        rows: Dict[RangeVectorKey, List[np.ndarray]] = {}
        for b in blocks:
            vals = host_values(b.values)
            for i, k in enumerate(b.keys):
                rows.setdefault(k, []).append(vals[i])
        comb = self.COMBINE[self.op]
        keys = list(rows)
        out = np.stack([
            np.where(np.all(np.isnan(np.stack(v)), axis=0), np.nan,
                     comb(np.stack(v), axis=0))
            for v in (rows[k] for k in keys)])
        return ResultBlock(keys, wends, out)
