"""Whole-expression device compilation (port of
filodb_tpu/query/exprfuse.py).

Only the leaves a tree runs in this process are eligible: those whose
dispatcher is the InProcessPlanDispatcher, as in the reference (the
port has no other dispatcher yet).  A
leaf's fused work that fails raises instead of degrading, as the port's
leaf does everywhere; "degraded" counts the eligible leaves whose shape
the fused path does not take (the general path answers them).

The fused-leaf machinery (query/leafexec.py + query/fusedbatch.py)
compiles a single leaf's scan + range function + map phase into one
kernel dispatch.  This module lifts that one level: given a WHOLE
physical plan tree (or a dashboard batch of trees), it

  * walks the tree and runs the fused preflight on every in-process
    ``MultiSchemaPartitionsExec`` leaf (``prepare_fused``), so all the
    leaves' kernel work lands in one ``finish_fused_calls`` merged
    dispatch instead of one dispatch per leaf — a multi-shard
    ``sum(rate(...))`` or an ``a / b`` join over two selectors costs
    the same device round-trips as a single leaf;
  * resolves vector-matching binary-join label matching host-side ONCE
    into ``(mi, oi)`` index maps cached on the operand blocks'
    ``cache_token`` (``keys_serial``/``keys_epoch``-keyed) so a
    dashboard re-poll skips the per-series dict matching entirely — the
    join itself runs as one gather+binop (ops/select.py);
  * filters killed queries out of the merged dispatch (the kill-token
    contract: a cancelled query must be checked BEFORE
    fused kernel dispatch — its leaf keeps the parked FusedCall and
    ``_finish_or_degrade`` surfaces ``query_canceled``).

Any leaf whose shape the fused path can't take degrades node-by-node
to the general engine with bit-identical results — counted under
``query_exprfuse{verdict="degraded"}`` and surfaced per query in
``?stats=true`` (``stats.exprfuse``) — never an error.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

__all__ = ["compile_tree", "finish_prepared", "join_index_maps",
           "TreeCompilation"]


@dataclass
class TreeCompilation:
    """One tree's prepared-leaf bookkeeping (engine-side handle)."""
    calls: List[Tuple[object, object]] = field(default_factory=list)
    fused: int = 0          # leaves whose preflight produced fused work
    degraded: int = 0       # eligible leaves that fell to the general path


def _eligible_leaves(ep):
    from filodb_tpu_torch.query.engine import _walk_plan
    from filodb_tpu_torch.query.execbase import InProcessPlanDispatcher
    from filodb_tpu_torch.query.leafexec import MultiSchemaPartitionsExec
    return [leaf for leaf in _walk_plan(ep)
            if isinstance(leaf, MultiSchemaPartitionsExec)
            and isinstance(leaf.dispatcher, InProcessPlanDispatcher)]


def compile_tree(ep, source, *, min_leaves: int = 1
                 ) -> Optional[TreeCompilation]:
    """Run the fused preflight over a tree's in-process leaves.

    Returns the prepared calls + per-tree verdict counts, or ``None``
    when the tree holds fewer than ``min_leaves`` eligible leaves (the
    single-query path passes ``min_leaves=2`` — one leaf gains nothing
    from cross-leaf merging and keeps its exact standalone behavior).
    Leaves whose preflight raises are reset to re-execute standalone;
    preparation failures never surface as query errors.
    """
    from filodb_tpu_torch.utils.metrics import registry
    leaves = _eligible_leaves(ep)
    if len(leaves) < min_leaves:
        return None
    comp = TreeCompilation()
    for leaf in leaves:
        try:
            fc = leaf.prepare_fused(source)
        except Exception:  # noqa: BLE001 — leaf will re-execute
            leaf._prefused = None
            fc = None
        if fc is not None:
            comp.calls.append((leaf, fc))
        parked = getattr(leaf, "_prefused", None)
        if parked is not None and parked[2] is not None:
            comp.fused += 1
            registry.counter("query_exprfuse",
                             verdict="fused").increment()
        else:
            comp.degraded += 1
            registry.counter("query_exprfuse",
                             verdict="degraded").increment()
    return comp


def finish_prepared(calls) -> None:
    """Phase-2: merge the prepared FusedCalls into batched dispatches.

    Killed queries are filtered out BEFORE any device dispatch — their
    leaves keep the parked FusedCall, and phase-3's
    ``_finish_or_degrade`` cancel check surfaces ``query_canceled``
    without the kernel ever running.  A batch-level dispatch failure
    likewise leaves every FusedCall parked for standalone finishing.
    """
    from filodb_tpu_torch.query.fusedbatch import finish_fused_calls
    if not calls:
        return
    live = []
    for leaf, fc in calls:
        tok = getattr(leaf.ctx, "cancel", None)
        if tok is not None and tok.cancelled:
            continue
        live.append((leaf, fc))
    if not live:
        return
    try:
        partials = finish_fused_calls([fc for _, fc in live])
    except Exception:  # noqa: BLE001 — leaves finish standalone
        return
    for (leaf, fc), partial in zip(live, partials):
        if partial is not None:
            leaf.inject_fused(partial)


# --------------------------------------------------- join index-map cache
#
# BinaryJoinExec resolves PromQL vector matching by building per-series
# match keys and pairing the sides through a dict — pure host work that
# is identical on every dashboard re-poll as long as neither side's
# series set changed.  Both operand blocks carry a ``cache_token``
# derived from (keys_serial, keys_epoch, row ids); the resolved
# (mi, oi, result keys) triple is memoized on those tokens.  An
# ingest-side epoch bump changes the token, so stale entries simply
# never match again and age out of the LRU.  Error shapes (many-to-many
# duplicates, one-to-one violations) are never cached.

_JOIN_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_JOIN_LOCK = threading.Lock()


def _join_cache_cap() -> int:
    from filodb_tpu_torch.config import settings
    return settings().query.exprfuse_join_cache_entries


def join_index_maps(join, many_side, one_side):
    """Resolved match maps for ``BinaryJoinExec.compose``.

    Returns ``(mi, oi, keys)``: many-side / one-side row indices (numpy
    int arrays, one entry per output pair) and the per-pair result
    label keys.  Raises the exact errors the uncached path raises
    (many-to-many duplicate, one-to-one violation, join cardinality
    limit).  Caching engages only when both blocks carry a non-None
    ``cache_token``.
    """
    import numpy as np

    from filodb_tpu_torch.utils.metrics import registry
    card_limit = join.ctx.planner_params.join_cardinality_limit
    key = None
    if many_side.cache_token is not None \
            and one_side.cache_token is not None:
        key = (many_side.cache_token, one_side.cache_token,
               join.cardinality, join.on, join.ignoring, join.include)
        with _JOIN_LOCK:
            hit = _JOIN_CACHE.get(key)
            if hit is not None:
                _JOIN_CACHE.move_to_end(key)
        if hit is not None:
            registry.counter("exprfuse_join_cache",
                             verdict="hit").increment()
            mi, oi, keys = hit
            if len(mi) > card_limit:
                raise ValueError(
                    f"join cardinality limit {card_limit} exceeded")
            return mi, oi, keys
        registry.counter("exprfuse_join_cache",
                         verdict="miss").increment()
    one_index = {}
    for i, k in enumerate(one_side.keys):
        mk = join._match_key(k)
        if mk in one_index:
            raise ValueError(
                "many-to-many matching not allowed: duplicate series on "
                f"'one' side for key {mk}")
        one_index[mk] = i
    pairs: List[Tuple[int, int]] = []
    for i, k in enumerate(many_side.keys):
        j = one_index.get(join._match_key(k))
        if j is not None:
            pairs.append((i, j))
            if len(pairs) > card_limit:
                raise ValueError(
                    f"join cardinality limit {card_limit} exceeded")
    if join.cardinality == "OneToOne":
        seen = {}
        for i, j in pairs:
            if j in seen:
                raise ValueError(
                    "one-to-one join has many-to-one matches; "
                    "use group_left/group_right")
            seen[j] = i
    mi = np.asarray([p[0] for p in pairs], dtype=np.int64)
    oi = np.asarray([p[1] for p in pairs], dtype=np.int64)
    keys = [join._result_labels(many_side.keys[i], one_side.keys[j])
            for i, j in pairs]
    if key is not None:
        with _JOIN_LOCK:
            _JOIN_CACHE[key] = (mi, oi, keys)
            _JOIN_CACHE.move_to_end(key)
            cap = max(_join_cache_cap(), 1)
            while len(_JOIN_CACHE) > cap:
                _JOIN_CACHE.popitem(last=False)
    return mi, oi, keys
