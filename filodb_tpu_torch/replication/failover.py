"""Query-time replica failover — full results through a SIGKILL (port of
filodb_tpu/replication/failover.py).

`ReplicaFailoverDispatcher` wraps one dispatcher per owner of a shard,
in assignment-list order: the primary is preferred; `shard_unavailable`
(connection refused/reset, or the peer's circuit breaker failing fast)
falls through to the next owner BEFORE the partial-results path
ever engages.  Only when EVERY owner of the shard is unreachable does
the typed error propagate — and then the existing retry-then-degrade
machinery (engine re-plan, partial_now) takes over, so partials happen
exactly when all copies of a shard are dead.

`dispatch_timeout` / `query_timeout` / `remote_failure` do NOT fail
over: a timeout means the remote may still be executing (re-sending
elsewhere wastes the survivors' budget), and a remote_failure would
fail identically on the replica (same plan, same data).
"""
from __future__ import annotations

import logging
from typing import Callable, List, Optional, Sequence, Tuple

from filodb_tpu_torch.query.execbase import PlanDispatcher, QueryError

_log = logging.getLogger("filodb.replication")


class ReplicaFailoverDispatcher(PlanDispatcher):
    """Ordered owner list -> first owner that answers.  `targets` is
    [(node_name, dispatcher)] in assignment order (primary first).

    Shuffle sharding (query.shuffle_shard_factor > 0): when the plan's
    context carries a tenant workspace, the walk order is re-ranked so
    owners inside the tenant's deterministic k-of-N node subset
    (qos.shuffle_shard_nodes over `all_nodes`, the cluster's node
    universe) are tried FIRST — each tenant's scatter-gather load lands
    on a bounded, tenant-stable blast radius, and a hot tenant browns
    out its own subset before anyone else's.  Failover semantics are
    unchanged: non-preferred owners remain fallbacks, so availability
    never loses to affinity."""

    def __init__(self, targets: Sequence[Tuple[str, PlanDispatcher]],
                 shard: Optional[int] = None,
                 all_nodes: Optional[Sequence[str]] = None,
                 shuffle_k: Optional[int] = None,
                 rotate: bool = False):
        import itertools
        self.targets = list(targets)
        self.shard = shard
        self.all_nodes = list(all_nodes) if all_nodes else \
            [n for n, _ in self.targets]
        self.shuffle_k = shuffle_k
        # cold-leaf load spreading (persist/objectstore.py query-only
        # nodes): every target can serve the leaf from the shared tier,
        # so successive dispatches rotate the start of the walk —
        # elastic read capacity actually takes load instead of idling as
        # a fallback.  Failover semantics unchanged: the rest of the
        # rotated list still walks on shard_unavailable.
        self.rotate = rotate
        self._rr = itertools.count()

    def pushdown_target(self):
        """Node address for aggregation pushdown (query/pushdown.py):
        the PRIMARY owner's remote dispatcher.  A pushdown group that
        cannot reach it falls back to per-shard dispatch, where this
        dispatcher's owner walk provides the replica failover — so
        grouping by primary never costs availability."""
        if not self.targets:
            return None
        fn = getattr(self.targets[0][1], "pushdown_target", None)
        return fn() if fn is not None else None

    def _walk_order(self, plan) -> Sequence[Tuple[str, PlanDispatcher]]:
        base = self.targets
        if self.rotate and len(base) > 1:
            k0 = next(self._rr) % len(base)
            base = base[k0:] + base[:k0]
        ws = getattr(getattr(plan, "ctx", None), "tenant_ws", "")
        k = self.shuffle_k
        if k is None:
            from filodb_tpu_torch.config import settings
            k = settings().query.shuffle_shard_factor
        if not ws or k <= 0 or len(base) < 2:
            return base
        from filodb_tpu_torch.query.qos import shuffle_shard_nodes
        preferred = set(shuffle_shard_nodes(ws, self.all_nodes, k))
        ordered = ([t for t in base if t[0] in preferred]
                   + [t for t in base if t[0] not in preferred])
        if ordered[0][0] != self.targets[0][0]:
            from filodb_tpu_torch.utils.metrics import registry
            registry.counter("query_shuffle_shard_routed",
                             ws=ws).increment()
        return ordered

    def dispatch(self, plan, source):
        from filodb_tpu_torch.utils.metrics import registry
        last: Optional[QueryError] = None
        targets = self._walk_order(plan)
        for i, (node, disp) in enumerate(targets):
            try:
                out = disp.dispatch(plan, source)
                if i > 0:
                    # served by a replica: a FULL answer, not a partial
                    # — counted so chaos runs can prove failover (not
                    # luck) kept availability at 1.0
                    registry.counter("query_replica_failovers",
                                     peer=node).increment()
                return out
            except QueryError as e:
                if e.code != "shard_unavailable":
                    raise
                last = e
                if i + 1 < len(targets):
                    _log.debug("shard %s owner %s unavailable (%s) — "
                               "failing over to %s", self.shard, node,
                               e, targets[i + 1][0])
        if last is None:
            raise QueryError(
                "shard_unavailable",
                f"shard {self.shard} has no owners to dispatch to")
        raise QueryError(
            "shard_unavailable",
            f"all {len(self.targets)} owner(s) of shard {self.shard} "
            f"unavailable (last: {last})")


def failover_dispatcher_factory(
        mapper, dispatcher_for: Callable[[str], PlanDispatcher],
        local_node: Optional[str] = None,
        local_dispatcher: Optional[PlanDispatcher] = None,
        shuffle_k: Optional[int] = None
        ) -> Callable[[int], Optional[PlanDispatcher]]:
    """Build a planner `dispatcher_factory(shard)` from a replica-aware
    ShardMapper: each shard's dispatcher walks its CURRENT owner list
    (read per materialization, so a promotion or handoff cutover is
    picked up by the very next query).  `dispatcher_for(node)` dials a
    remote owner; `local_node`'s copy (when this process IS an owner)
    executes through `local_dispatcher` (defaults to in-process).
    `shuffle_k` pins the shuffle-shard subset size (None = the
    query.shuffle_shard_factor setting at dispatch time)."""
    from filodb_tpu_torch.query.execbase import InProcessPlanDispatcher

    def factory(shard: int) -> Optional[PlanDispatcher]:
        # primary always dispatches; replicas only once query-ready
        # (ACTIVE/RECOVERY) — an ASSIGNED copy still catching up would
        # serve a silently-short "full" result on failover
        primary = mapper.node_for_shard(shard)
        owners = ([primary] if primary is not None else []) + [
            n for n in mapper.replicas[shard]
            if mapper.owner_status(shard, n).query_ready]
        if not owners:
            return None
        targets: List[Tuple[str, PlanDispatcher]] = []
        for node in owners:
            if local_node is not None and node == local_node:
                targets.append((node, local_dispatcher
                                or InProcessPlanDispatcher()))
            else:
                targets.append((node, dispatcher_for(node)))
        if len(targets) == 1:
            return targets[0][1]
        # the node universe for the tenant's k-of-N subset: every node
        # holding any copy of any shard (snapshot per materialization,
        # like the owner list)
        all_nodes = sorted(
            {n for n in mapper.nodes if n is not None}
            | {n for repls in mapper.replicas for n in repls})
        return ReplicaFailoverDispatcher(targets, shard=shard,
                                         all_nodes=all_nodes,
                                         shuffle_k=shuffle_k)

    return factory


def cold_dispatcher_factory(
        mapper, dispatcher_for: Callable[[str], PlanDispatcher],
        local_node: Optional[str] = None,
        local_dispatcher: Optional[PlanDispatcher] = None,
        shuffle_k: Optional[int] = None
        ) -> Callable[[int], Optional[PlanDispatcher]]:
    """`dispatcher_factory(shard)` for the PERSISTED (cold) planner: the
    shared object tier means ANY query-capable node can serve a cold
    leaf, so targets are the shard's query-ready owners PLUS every
    registered query-only node (`mapper.query_nodes`), walked
    round-robin — adding stateless query nodes actually spreads cold
    read load instead of idling as fallbacks.  Failover semantics are
    the ordinary owner walk: `shard_unavailable` tries the next target,
    and only when EVERY target is dead does the partial-results
    machinery engage."""
    from filodb_tpu_torch.query.execbase import InProcessPlanDispatcher

    def factory(shard: int) -> Optional[PlanDispatcher]:
        primary = mapper.node_for_shard(shard)
        owners = ([primary] if primary is not None else []) + [
            n for n in mapper.replicas[shard]
            if mapper.owner_status(shard, n).query_ready]
        extras = [n for n in getattr(mapper, "query_nodes", [])
                  if n not in owners]
        nodes = owners + extras
        if not nodes:
            return None
        targets: List[Tuple[str, PlanDispatcher]] = []
        for node in nodes:
            if local_node is not None and node == local_node:
                targets.append((node, local_dispatcher
                                or InProcessPlanDispatcher()))
            else:
                targets.append((node, dispatcher_for(node)))
        if len(targets) == 1:
            return targets[0][1]
        all_nodes = sorted(
            {n for n in mapper.nodes if n is not None}
            | {n for repls in mapper.replicas for n in repls}
            | set(extras))
        return ReplicaFailoverDispatcher(targets, shard=shard,
                                         all_nodes=all_nodes,
                                         shuffle_k=shuffle_k,
                                         rotate=True)

    return factory
