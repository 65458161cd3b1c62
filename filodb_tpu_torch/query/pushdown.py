"""Node-level aggregation pushdown — ship the reduce, not the series (port
of filodb_tpu/query/pushdown.py).

The 3-phase map/reduce/present aggregation contract (ops/agg.py,
ref: AggrOverRangeVectors.scala) already runs the MAP phase on whatever
node executes the leaf, so per-shard dispatches reply with [G, W]
partials.  What still scaled with the shard count was the coordinator's
side: one round trip per shard, one partial per shard buffered whole,
and the inter-shard reduce running entirely on the coordinator.

This module promotes the chip-level partial-merge architecture one
level up, exactly like FiloDB's queryplanner hierarchy pushes
`sum by (...)` into the data nodes (PAPER.md §1; the Thanos/Cortex
query-frontend map/reduce split): the planner groups an aggregation's
per-shard map subtrees by OWNING NODE and wraps each group in a
`RemoteAggregateExec` (query/nonleaf.py) dispatched to that node as ONE
unit.  The data node scans its shards, runs the local reduce, and
replies with a single [G, W] AggPartial — one round trip and one tiny
partial per NODE, merged coordinator-side by the unchanged
`execbase.reduce_partials`.

Correctness rules:

  - Only EXACTLY-mergeable partial forms push.  PUSHABLE_OPS are the
    component-form aggregators whose reduce is an order-insensitive
    elementwise sum/min/max.  CANDIDATE_PUSHABLE_OPS push via
    the node-level intermediate mode (nonleaf.RemoteAggregateExec
    docstring): `quantile` concatenates centroids without
    re-compressing, `topk`/`bottomk` prune candidates to the node-
    local per-window top-k, `count_values` ships candidate rows.
    Joins and raw selectors keep the per-shard path.
  - A shard listed TWICE (both owners during a live-handoff window)
    never enters a node group: the duplicate leaves stay direct
    children of the coordinator reducer so the gather dedup
    (first owner to answer wins, twin absorbs shard_unavailable)
    keeps working on partials.
  - A node group that cannot be reached falls back to the per-shard
    dispatch path (`PushdownDispatcher`): the wrapped leaves kept
    their own per-shard (replica-failover) dispatchers, so a dead
    primary still fails over — availability never loses to pushdown.

Verdicts (`pushed` / `fallback` / `not_pushable`) land in QueryStats
(`?stats=true`, explain analyze, slowlog) and the `query_pushdown`
counter.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from filodb_tpu_torch.query.execbase import (InProcessPlanDispatcher,
                                             PlanDispatcher, QueryError)

# component/sketch-form ops whose partial merge is associative and
# order-insensitive enough to regroup per node without changing results
# (histogram sum rides op="sum" and merges bucketwise the same way)
PUSHABLE_OPS = frozenset({"sum", "count", "avg", "min", "max",
                          "stddev", "stdvar", "group"})

# rank/candidate/sketch aggregations made exactly-pushable by the node-
# level intermediate mode (query/nonleaf.py RemoteAggregateExec): quantile node
# partials concatenate centroids without re-compressing, topk/bottomk
# prune to the node-local per-window top-k (ops/select.topk_keep_rows),
# count_values ships its candidate rows — in every case the
# coordinator's final merge sees data bit-identical to the flat
# per-shard path
CANDIDATE_PUSHABLE_OPS = frozenset({"topk", "bottomk", "quantile",
                                    "count_values"})


def pushdown_enabled(ctx) -> bool:
    """Per-request PlannerParams override, else the server config."""
    v = getattr(ctx.planner_params, "aggregation_pushdown", None)
    if v is not None:
        return bool(v)
    from filodb_tpu_torch.config import settings
    return settings().query.aggregation_pushdown


def _count_not_pushable(n: int) -> None:
    if n:
        from filodb_tpu_torch.utils.metrics import registry
        registry.counter("query_pushdown",
                         verdict="not_pushable").increment(n)


def _target_of(dispatcher) -> Optional[PlanDispatcher]:
    """The node-address dispatcher a child's dispatcher resolves to, or
    None when the child is local / not addressable as one node."""
    fn = getattr(dispatcher, "pushdown_target", None)
    if fn is None:
        return None
    try:
        return fn()
    except Exception:  # noqa: BLE001 — an empty owner list etc.
        return None


class PushdownDispatcher(PlanDispatcher):
    """Dispatcher for one RemoteAggregateExec node group: the whole
    subtree ships to the owning data node; if that node is unreachable
    (connect refused / breaker open) the group degrades to TODAY'S path
    — the group plan executes in-process on the coordinator, which
    scatter-gathers its leaves through their own per-shard
    replica-failover dispatchers and reduces locally."""

    def __init__(self, target: PlanDispatcher):
        self.target = target

    def dispatch(self, plan, source):
        from filodb_tpu_torch.utils.metrics import registry
        try:
            data, stats = self.target.dispatch(plan, source)
        except QueryError as e:
            if e.code != "shard_unavailable":
                # dispatch_timeout / query_timeout / remote_failure never
                # fall back: the remote may still be executing, and a
                # re-run would spend the survivors' budget twice — the
                # parent's partial/deadline machinery owns these
                raise
            registry.counter("query_pushdown",
                             verdict="fallback").increment()
            data, stats = InProcessPlanDispatcher().dispatch(plan, source)
            stats.pushdown_fallback += 1
            return data, stats
        registry.counter("query_pushdown", verdict="pushed").increment()
        stats.pushdown_pushed += 1
        rec = getattr(plan.ctx, "analyze", None)
        if rec is not None:
            rec.add(plan, {"plan": type(plan).__name__, "self_s": 0.0,
                           "device_s": 0.0, "transfer_s": 0.0,
                           "bytes_transferred": stats.bytes_transferred,
                           "samples_scanned": stats.samples_scanned,
                           "series_scanned": stats.series_scanned,
                           "shards_queried": stats.shards_queried,
                           "pushdown": "pushed"})
        return data, stats


def plan_aggregate_pushdown(children: List, op: str, params: Tuple,
                            ctx) -> Tuple[List, int]:
    """Regroup an aggregation's materialized children for node-level
    pushdown.  Returns (children', not_pushable_count): same-node
    pushable map subtrees collapse into RemoteAggregateExec groups; the
    rest pass through unchanged.  not_pushable_count is the number of
    REMOTE children the aggregation could not push (local children are
    not a verdict — there is no wire to win)."""
    from filodb_tpu_torch.query.leafexec import MultiSchemaPartitionsExec
    from filodb_tpu_torch.query.nonleaf import RemoteAggregateExec
    from filodb_tpu_torch.query.transformers import (AggregateMapReduce,
                                                     PeriodicSamplesMapper,
                                                     RepeatToGridMapper)

    def _remote(c) -> bool:
        return not isinstance(c.dispatcher, InProcessPlanDispatcher)

    n_remote = sum(1 for c in children if _remote(c))
    if n_remote == 0:
        return children, 0
    if not pushdown_enabled(ctx):
        return children, 0
    if op not in PUSHABLE_OPS and op not in CANDIDATE_PUSHABLE_OPS:
        _count_not_pushable(n_remote)
        return children, n_remote
    # duplicate shards (both owners materialized during a live handoff)
    # stay direct children so the gather dedup contract keeps holding
    shard_seen: Dict[object, int] = {}
    for c in children:
        s = getattr(c, "shard", None)
        if s is not None:
            shard_seen[s] = shard_seen.get(s, 0) + 1

    groups: Dict[Tuple, List] = {}
    group_targets: Dict[Tuple, PlanDispatcher] = {}
    order: List[Tuple[str, object]] = []       # rebuild in original order
    not_pushable = 0
    for c in children:
        tgt = _target_of(c.dispatcher) if _remote(c) else None
        pushable = (
            tgt is not None
            and isinstance(c, MultiSchemaPartitionsExec)
            and shard_seen.get(getattr(c, "shard", None), 0) == 1
            and c.transformers
            and isinstance(c.transformers[-1], AggregateMapReduce)
            and all(isinstance(t, (PeriodicSamplesMapper,
                                   AggregateMapReduce, RepeatToGridMapper))
                    for t in c.transformers))
        if not pushable:
            if _remote(c):
                not_pushable += 1
            order.append(("child", c))
            continue
        key = (getattr(tgt, "host", None), getattr(tgt, "port", None))
        if key not in groups:
            groups[key] = []
            group_targets[key] = tgt
            order.append(("group", key))
        groups[key].append(c)
    out: List = []
    for kind, item in order:
        if kind == "child":
            out.append(item)
            continue
        node = RemoteAggregateExec(ctx, groups[item], op, params)
        node.dispatcher = PushdownDispatcher(group_targets[item])
        out.append(node)
    _count_not_pushable(not_pushable)
    return out, not_pushable
