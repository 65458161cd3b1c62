"""Federated exec: the leaf that carries a whole logical subtree to a
remote cluster, and the dispatcher that names the hop after the cluster
(port of filodb_tpu/federation/exec.py).

A FederatedLeafExec is a LEAF on the coordinator (the remote cluster is
one opaque child) and a whole QUERY on the remote: decoded at the
remote's federation door it re-plans the shipped logical subtree through
that cluster's own planner stack and executes it against the cluster's
store.  Two modes:

  series  — the remote evaluates the (per-series or whole) expression
            and ships the presented ResultBlock;
  partial — the remote's root reduce is flipped to reply with its
            cluster-level [G, W] AggPartial (the node-level
            pushdown promoted to clusters): only one partial per
            cluster crosses the wire, and the coordinator's
            ReduceAggregateExec merges it exactly.

The dispatcher subclasses the node transport, so streaming frames,
typed errors, deadline budgets, kill fan-out and span stitching are the
SAME machinery queries already use between nodes — federation adds the
`cluster:<name>` identity (breaker rows, degradation warnings) and the
federation_* metric families on top.
"""
from __future__ import annotations

from typing import Optional

from filodb_tpu_torch.parallel import serialize
from filodb_tpu_torch.parallel.transport import RemoteNodeDispatcher
from filodb_tpu_torch.query.execbase import LeafExecPlan, QueryError
from filodb_tpu_torch.query.nonleaf import ReduceAggregateExec
from filodb_tpu_torch.query.transformers import AggregatePresenter


def flip_to_partial(ep, operator: str):
    """Presented root reduce -> intermediate cluster partial: strip the
    AggregatePresenter and mark the reduce node-level, so it replies an
    AggPartial another (coordinator-side) reduce merges.  Raises
    ValueError when the materialized root is not EXACTLY a
    ReduceAggregateExec for the expected operator — a stitched root
    (range straddling tiers) or a shard-key fan-out reduce re-combines
    PRESENTED results, and flipping those would merge incomparable
    intermediates.  Callers fall back to series shipping (coordinator
    side) or surface a typed error (remote side)."""
    if type(ep) is not ReduceAggregateExec:
        raise ValueError(
            f"cannot flip {type(ep).__name__} to a cluster partial "
            f"(only a plain root ReduceAggregateExec merges exactly)")
    if ep.op != operator:
        raise ValueError(
            f"root reduce op {ep.op!r} does not match the federated "
            f"aggregate {operator!r}")
    ep.transformers = [t for t in ep.transformers
                       if not isinstance(t, AggregatePresenter)]
    # instance-level: this partial is an intermediate another reduce
    # merges (sketches must not re-compress here)
    ep.node_level = True
    return ep


class FederatedLeafExec(LeafExecPlan):
    """One remote cluster's share of a federated query.

    Ships the EXACT logical subtree (`plan`) — not PromQL text — so
    sub-second step grids, clamped ranges and offsets survive the hop
    byte-for-byte (TimeStepParams re-parsing is integer-seconds).  The
    `promql` string rides only for the remote ActiveQueryRegistry /
    trace display; `traceparent` carries the coordinator's W3C trace
    context so the remote's spans stitch under the ONE trace id."""

    def __init__(self, ctx, dataset: str = "", plan=None,
                 mode: str = "series", cluster: str = "",
                 promql: str = "", traceparent: str = ""):
        super().__init__(ctx)
        self.dataset = dataset
        self.plan = plan
        self.mode = mode
        self.cluster = cluster
        self.promql = promql
        self.traceparent = traceparent

    def args_str(self) -> str:
        return (f"cluster={self.cluster}, dataset={self.dataset or '(same)'}"
                f", mode={self.mode}, promql={self.promql}")

    def _do_execute(self, source):
        from filodb_tpu_torch.federation.door import FederationSource
        if isinstance(source, FederationSource):
            return self._execute_remote(source)
        # coordinator side, and this leaf is the tree ROOT (single-owner
        # whole-expression routing): no parent _gather dispatched it, so
        # dispatch ourselves.  The planner always assigns a
        # FederatedDispatcher; a default in-process dispatcher here
        # would re-enter _do_execute forever.
        from filodb_tpu_torch.query.execbase import InProcessPlanDispatcher
        if isinstance(self.dispatcher, InProcessPlanDispatcher):
            raise QueryError(
                "remote_failure",
                f"federated leaf for cluster {self.cluster} has no remote "
                f"dispatcher on this side of the wire")
        return self.dispatcher.dispatch(self, source)

    def _execute_remote(self, fsrc):
        """Remote-cluster side: re-plan the shipped logical subtree
        through THIS cluster's planner stack and run it on the local
        store.  self.ctx already carries the coordinator's query id,
        deadline and (door-attached) registry entry + kill token, so the
        whole inner tree participates in the one trace / one kill."""
        planner, store = fsrc.resolve(self.dataset)
        if self.plan is None:
            raise QueryError("remote_failure",
                             "federated leaf arrived without a plan")
        ep = planner.materialize(self.plan, self.ctx)
        if self.mode == "partial":
            try:
                ep = flip_to_partial(ep, getattr(self.plan, "operator", ""))
            except ValueError as e:
                # typed, never silent: the coordinator requested an
                # exactly-mergeable cluster partial and this cluster's
                # plan shape cannot provide one (e.g. the range straddles
                # its storage tiers).  doc/federation.md names the
                # workaround (series mode / narrower range).
                raise QueryError(
                    "remote_failure",
                    f"cluster {fsrc.cluster_name or '?'} cannot push a "
                    f"partial aggregation: {e}") from e
        return ep.execute_internal(store)


class FederatedDispatcher(RemoteNodeDispatcher):
    """Node transport aimed at a remote CLUSTER's federation door.

    Everything rides the inherited dispatch (streamed frames, typed
    errors, deadline share, kill fan-out via note_remote, span
    stitching); this subclass adds:

      - `cluster:<name>` peer identity → the breaker registry keys and
        every degradation warning name the cluster, not a host:port;
      - federation_* metric families (dispatches, errors, wire bytes);
      - shed mapping: a remote door replying tenant_overloaded /
        tenant_limit_exceeded becomes THIS cluster's shard_unavailable,
        so the partial-results gate drops it as a flagged per-cluster
        partial instead of failing the whole federated query with a
        throttle the caller cannot act on.  (The breaker is untouched —
        a reply arrived, the cluster is alive.)
      - pushdown accounting: a partial-mode hop counts as pushed, a
        series-mode hop as fallback, so ?stats=true shows the
        federation hop next to the node-level pushdown columns.
    """

    def __init__(self, cluster: str, host: str, port: int,
                 timeout_s: Optional[float] = None):
        super().__init__(host, port, timeout_s=timeout_s,
                         peer=f"cluster:{cluster}")
        self.cluster = cluster

    def pushdown_target(self):
        # a cluster door is NOT a shard-owner node: node-level
        # aggregation pushdown must not group ordinary shard leaves
        # behind it
        return None

    def dispatch(self, plan, source):
        from filodb_tpu_torch.utils.metrics import registry
        mode = getattr(plan, "mode", "series")
        registry.counter("federation_dispatches", cluster=self.cluster,
                         mode=mode).increment()
        try:
            data, stats = super().dispatch(plan, source)
        except QueryError as e:
            registry.counter("federation_errors", cluster=self.cluster,
                             code=e.code).increment()
            if e.code in ("tenant_overloaded", "tenant_limit_exceeded"):
                raise QueryError(
                    "shard_unavailable",
                    f"cluster {self.cluster} shed the query: {e}") from e
            raise
        registry.counter("federation_wire_bytes",
                         cluster=self.cluster).increment(stats.wire_bytes)
        if mode == "partial":
            stats.pushdown_pushed += 1
        else:
            stats.pushdown_fallback += 1
        return data, stats


# the federated leaf revives at the remote door via the node wire's
# closed leaf registry (ctor attrs after ctx, like every entry there)
serialize.register_leaf_plan(
    FederatedLeafExec,
    ["dataset", "plan", "mode", "cluster", "promql", "traceparent"])
