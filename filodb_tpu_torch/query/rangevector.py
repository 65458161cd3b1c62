"""Result types: range-vector keys, dense result blocks, query context.

The reference materializes per-series SerializedRangeVectors (ref:
core/.../query/RangeVector.scala:121, ResultTypes.scala).  The TPU-native
design keeps results BATCH-DENSE: one ResultBlock = many series sharing the
same step grid, values in a single [S, W] (or [S, W, B] histogram) matrix.
Transformers and reducers operate on whole blocks on device; per-series
objects only exist at the JSON/serialization edge.

In this package a block's values are a numpy array or, on the general
path, a torch tensor on the engine's device; the root of the exec tree
reads them back to the host for the result (ExecPlan.execute).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class RangeVectorKey:
    """Series identity in results (ref: RangeVector.scala:27
    CustomRangeVectorKey)."""
    labels: Tuple[Tuple[str, str], ...]             # sorted

    @staticmethod
    def make(labels: Dict[str, str]) -> "RangeVectorKey":
        return RangeVectorKey(tuple(sorted(labels.items())))

    @property
    def labels_dict(self) -> Dict[str, str]:
        return dict(self.labels)

    def without(self, names: Sequence[str]) -> "RangeVectorKey":
        ns = set(names)
        return RangeVectorKey(tuple((k, v) for k, v in self.labels
                                    if k not in ns))

    def only(self, names: Sequence[str]) -> "RangeVectorKey":
        ns = set(names)
        return RangeVectorKey(tuple((k, v) for k, v in self.labels
                                    if k in ns))

    def __str__(self) -> str:
        return "{" + ",".join(f'{k}="{v}"' for k, v in self.labels) + "}"


@dataclasses.dataclass
class ResultBlock:
    """A batch of series on a common step grid.

    values: [S, W] float (NaN = absent at that step), or [S, W, B] for
    histogram-valued vectors (bucket_les gives upper bounds).
    """
    keys: List[RangeVectorKey]
    wends: np.ndarray                               # int64 [W] step timestamps ms
    values: np.ndarray
    bucket_les: Optional[np.ndarray] = None
    # working-set identity for the host group-id cache; ONLY propagate
    # through transformers that keep `keys` unchanged 1:1 (a stale token
    # on a re-keyed block would serve another key set's group ids)
    cache_token: Optional[tuple] = None

    @property
    def num_series(self) -> int:
        return len(self.keys)

    @property
    def is_histogram(self) -> bool:
        return self.values.ndim == 3

    def select(self, rows: np.ndarray) -> "ResultBlock":
        rows = np.asarray(rows, np.int64)
        if isinstance(self.values, torch.Tensor):
            vals = self.values.index_select(
                0, torch.from_numpy(rows).to(self.values.device))
        else:
            vals = np.asarray(self.values)[rows]
        return ResultBlock([self.keys[int(r)] for r in rows], self.wends,
                           vals, self.bucket_les)


def host_values(values) -> np.ndarray:
    """A block's values as a host numpy array."""
    if isinstance(values, torch.Tensor):
        return values.cpu().numpy()
    return np.asarray(values)


def cat_values(parts: Sequence) -> object:
    """Concatenate value matrices along series: numpy when every part is,
    else a tensor on the first tensor part's device."""
    tensors = [p for p in parts if isinstance(p, torch.Tensor)]
    if not tensors:
        return np.concatenate([np.asarray(p) for p in parts])
    dev = tensors[0].device
    return torch.cat([p if isinstance(p, torch.Tensor)
                      else torch.from_numpy(np.asarray(p)).to(dev)
                      for p in parts])


def concat_blocks(blocks: Sequence[ResultBlock]) -> Optional[ResultBlock]:
    """Concatenate blocks sharing a step grid (DistConcatExec analogue)."""
    blocks = [b for b in blocks if b is not None and b.num_series > 0]
    if not blocks:
        return None
    if len(blocks) == 1:
        return blocks[0]
    keys: List[RangeVectorKey] = []
    for b in blocks:
        keys.extend(b.keys)
    # the concatenation's identity is the ordered tuple of part tokens —
    # valid (keys are the parts' keys, in order) iff every part carries
    # one; used by the PR 17 join index-map cache
    token = None
    if all(b.cache_token is not None for b in blocks):
        token = ("cat",) + tuple(b.cache_token for b in blocks)
    return ResultBlock(keys, blocks[0].wends,
                       cat_values([b.values for b in blocks]),
                       blocks[0].bucket_les, cache_token=token)


@dataclasses.dataclass
class QueryStats:
    """Per-query resource attribution, merged bottom-up through the exec
    tree and carried over the wire with dispatch replies (ref: the
    reference's QueryStats threaded through every ExecPlan +
    TimeSeriesShardStats query-side counters; Prometheus `stats=all`).

    Phase seconds are EXCLUSIVE per node and therefore additive: the
    root's cpu_seconds is the sum of every node's own work (remote nodes
    included — their stats merge in from the reply), never a
    double-count of nested wall time.  See utils.metrics._ExecTally."""
    samples_scanned: int = 0
    series_scanned: int = 0
    result_samples: int = 0
    shards_queried: int = 0
    # set when allow_partial_results dropped an unreachable child —
    # propagates bottom-up through merge() to the root QueryResult
    partial: bool = False
    # human-readable degradation notes (one per dropped child / wedged
    # leader fallback), merged bottom-up and over the wire; surfaced as
    # the Prometheus envelope's `warnings` list, in `?stats=true`, and
    # in slowlog records — degradation is NEVER silent
    warnings: List[str] = dataclasses.field(default_factory=list)
    # --- phase attribution (seconds) ---
    queue_wait_s: float = 0.0       # frontend scheduler semaphore wait
    parse_s: float = 0.0            # PromQL → logical plan
    plan_s: float = 0.0             # logical plan → exec tree
    cpu_seconds: float = 0.0        # host work inside exec nodes (exclusive)
    device_seconds: float = 0.0     # device gather + kernel dispatch wall
    transfer_s: float = 0.0         # host→device uploads + wire round-trips
    # --- bytes ---
    bytes_transferred: int = 0      # host→device upload + wire reply bytes
    result_bytes: int = 0           # final result-matrix bytes at the root
    # --- distributed execution (PR 15) ---
    # bytes that actually crossed node-to-node sockets (request + reply
    # frames) — bytes_transferred conflates these with host→device
    # uploads, so wire attribution gets its own counter
    wire_bytes: int = 0
    # reply frames received on streamed (multi-frame) dispatches
    streamed_frames: int = 0
    # per-node aggregation-pushdown verdicts: node groups whose reduce
    # ran ON the data node (pushed), groups that fell back to per-shard
    # dispatch because the node was unreachable (fallback), and remote
    # children an aggregation could not push (not_pushable)
    pushdown_pushed: int = 0
    pushdown_fallback: int = 0
    pushdown_not_pushable: int = 0
    # --- cache attribution ---
    # result-cache verdict for this poll: "" (bypass) | "hit" | "partial"
    # | "miss" — set by the serving frontend, not merged bottom-up
    result_cache: str = ""
    # device-mirror uploads THIS query paid for on its critical path
    mirror_full_rebuilds: int = 0
    mirror_incremental: int = 0
    # --- historical-tier attribution ---
    # samples materialized from persistence on THIS query's critical path
    # (chunk-frame ODP page-ins + cold-segment builds); counted into
    # samples_scanned too, so tenant scan limits see paged work
    samples_paged: int = 0
    bytes_paged: int = 0            # decoded segment bytes uploaded/built
    # tier verdict (result_cache-style): "" (no cold-capable leaf) |
    # "hot" (all in memory) | "cold_hit" (served from the resident cold
    # region) | "cold_paged" (paid a page-in).  merge keeps the WORST.
    cold_tier: str = ""
    # --- whole-expression compilation (PR 17, query/exprfuse.py) ---
    # per-leaf verdicts when the expression compiler engaged: leaves
    # whose work joined a fused/batched dispatch vs leaves that
    # degraded to the general path (both zero = compiler not engaged)
    exprfuse_fused: int = 0
    exprfuse_degraded: int = 0
    # --- per-device kernel breakdown (PR 18, utils/devicetelem.py) ---
    # "device|kernel" -> [seconds, dispatches]: the split of
    # device_seconds by chip and kernel, folded from the exec tally by
    # execbase and merged additively (locally and over the wire) — the
    # sum of seconds over entries equals device_seconds
    device_calls: Dict[str, List[float]] = dataclasses.field(
        default_factory=dict)

    _COLD_ORDER = ("", "hot", "cold_hit", "cold_paged")

    def merge(self, other: "QueryStats") -> None:
        self.samples_scanned += other.samples_scanned
        self.series_scanned += other.series_scanned
        self.result_samples += other.result_samples
        self.shards_queried += other.shards_queried
        self.partial = self.partial or other.partial
        if other.warnings:
            self.warnings.extend(other.warnings)
        self.queue_wait_s += other.queue_wait_s
        self.parse_s += other.parse_s
        self.plan_s += other.plan_s
        self.cpu_seconds += other.cpu_seconds
        self.device_seconds += other.device_seconds
        self.transfer_s += other.transfer_s
        self.bytes_transferred += other.bytes_transferred
        self.result_bytes += other.result_bytes
        self.wire_bytes += other.wire_bytes
        self.streamed_frames += other.streamed_frames
        self.pushdown_pushed += other.pushdown_pushed
        self.pushdown_fallback += other.pushdown_fallback
        self.pushdown_not_pushable += other.pushdown_not_pushable
        self.result_cache = self.result_cache or other.result_cache
        self.mirror_full_rebuilds += other.mirror_full_rebuilds
        self.mirror_incremental += other.mirror_incremental
        self.samples_paged += other.samples_paged
        self.bytes_paged += other.bytes_paged
        if self._COLD_ORDER.index(other.cold_tier) > \
                self._COLD_ORDER.index(self.cold_tier):
            self.cold_tier = other.cold_tier
        self.exprfuse_fused += other.exprfuse_fused
        self.exprfuse_degraded += other.exprfuse_degraded
        for key, cell in other.device_calls.items():
            mine = self.device_calls.get(key)
            if mine is None:
                self.device_calls[key] = [cell[0], cell[1]]
            else:
                mine[0] += cell[0]
                mine[1] += cell[1]

    def to_dict(self) -> Dict[str, object]:
        """The `?stats=true` wire shape (http/routes attaches it to the
        query_range payload; doc/observability.md documents the fields)."""
        return {
            "samplesScanned": self.samples_scanned,
            "seriesScanned": self.series_scanned,
            "resultSamples": self.result_samples,
            "resultBytes": self.result_bytes,
            "shardsQueried": self.shards_queried,
            "bytesTransferred": self.bytes_transferred,
            "partial": self.partial,
            "warnings": list(self.warnings),
            "phases": {
                "queue_s": round(self.queue_wait_s, 6),
                "parse_s": round(self.parse_s, 6),
                "plan_s": round(self.plan_s, 6),
                "exec_s": round(self.cpu_seconds, 6),
                "device_s": round(self.device_seconds, 6),
                "transfer_s": round(self.transfer_s, 6),
            },
            "samplesPaged": self.samples_paged,
            "bytesPaged": self.bytes_paged,
            "wireBytes": self.wire_bytes,
            "streamedFrames": self.streamed_frames,
            "pushdown": {
                "pushed": self.pushdown_pushed,
                "fallback": self.pushdown_fallback,
                "notPushable": self.pushdown_not_pushable,
            },
            "exprfuse": {
                "fused": self.exprfuse_fused,
                "degraded": self.exprfuse_degraded,
            },
            "cache": {
                "result": self.result_cache,
                "mirrorFullRebuilds": self.mirror_full_rebuilds,
                "mirrorIncremental": self.mirror_incremental,
                "coldTier": self.cold_tier,
            },
            # device -> kernel -> {seconds, dispatches}: the per-chip
            # split of phases.device_s (empty when no kernel ran)
            "devices": self._devices_dict(),
        }

    def _devices_dict(self) -> Dict[str, object]:
        out: Dict[str, Dict[str, object]] = {}
        for key, (secs, count) in sorted(self.device_calls.items()):
            dev, _, kern = key.partition("|")
            out.setdefault(dev, {})[kern] = {
                "seconds": round(secs, 6), "dispatches": int(count)}
        return out


@dataclasses.dataclass
class QueryResult:
    """ref: filodb.query QueryResult / QueryError."""
    blocks: List[ResultBlock]
    stats: QueryStats = dataclasses.field(default_factory=QueryStats)
    error: Optional[str] = None
    # metadata-query payloads (label values etc.) ride in `data`
    data: Optional[object] = None
    # the query's trace id (= ctx.query_id): fetch the stitched cross-node
    # span tree from utils.metrics.collector / GET /admin/traces/<id>
    trace_id: str = ""
    # True when allow_partial_results dropped unreachable shards from a
    # scatter-gather (ref: QueryContext.scala PlannerParams
    # allowPartialResults / QueryResult mayBePartial): NEVER silently —
    # to_prom_matrix surfaces it as a warning + "partial": true
    partial: bool = False

    @property
    def num_series(self) -> int:
        return sum(b.num_series for b in self.blocks)

    def series(self):
        """Iterate (key, wends, values_row) across blocks — serialization edge."""
        for b in self.blocks:
            vals = host_values(b.values)
            for i, k in enumerate(b.keys):
                yield k, b.wends, vals[i]


@dataclasses.dataclass
class PlannerParams:
    """ref: core/.../query/QueryContext.scala:98 PlannerParams."""
    spread: int = 1
    sample_limit: int = 1_000_000        # RESULT samples (post-transform)
    # samples a leaf may SCAN (gather/page) per shard for one query — the
    # fail-fast guard against pathological selectors (ref:
    # OnDemandPagingShard.scala:55 capDataScannedPerShardCheck).  Distinct
    # from sample_limit: aggregations scan much more than they return.
    scan_limit: int = 50_000_000
    group_by_cardinality_limit: int = 100_000
    join_cardinality_limit: int = 100_000
    enforced_limits: bool = True
    shard_overrides: Optional[List[int]] = None
    process_multi_partition: bool = False
    # scatter-gather children whose shard owner is unreachable are
    # DROPPED (result flagged partial) instead of failing the query
    # (ref: PlannerParams.allowPartialResults).  This is the GATE: a
    # shard_unavailable still gets the engine's re-plan retries first;
    # only when those are exhausted does the engine engage the drop via
    # `partial_now` (peers blowing their deadline share — dispatch
    # timeouts — drop under the gate alone, since retrying them cannot
    # help within the budget)
    allow_partial_results: bool = False
    # --- deadline/degradation fields, repr=False: the serving keys
    # (singleflight, coalescer, result cache) are repr(planner_params),
    # and neither per-request budgets, absolute deadlines, nor engine-
    # engaged degradation state may split byte-identical requests into
    # distinct keys (two clients polling one panel with different
    # timeouts share one execution; each follower's own deadline still
    # bounds its wait in the frontend) ---
    # per-request time budget in seconds; 0 = query.default_timeout_s.
    # The server config CAPS it (a client cannot extend past the cap).
    timeout_s: float = dataclasses.field(default=0.0, repr=False)
    # absolute unix deadline stamped at admission (frontend) so queue
    # wait counts against the budget; 0 = engine stamps at exec start
    deadline_unix_s: float = dataclasses.field(default=0.0, repr=False)
    # set by the ENGINE after re-plan retries are exhausted: scatter-
    # gathers may now drop unreachable children (see gate note above)
    partial_now: bool = dataclasses.field(default=False, repr=False)
    # per-request override of query.aggregation_pushdown (None = server
    # config).  repr=False: pushdown on/off is bit-identical by contract
    # (exactly-mergeable partials only), so the serving keys must not
    # split identical requests by routing stance.
    aggregation_pushdown: Optional[bool] = dataclasses.field(
        default=None, repr=False)
    # benchmark-only strawman: suppress the leaf-side map phase so
    # remote children ship FULL per-series blocks (the "ship everything"
    # baseline bench.py distexec measures wire bytes against).  Off
    # (False) is the only supported production value — pushdown=False
    # already restores the per-shard dispatch where every shard still
    # replies with its [G, W] map partial.
    ship_raw_series: bool = dataclasses.field(default=False, repr=False)


@dataclasses.dataclass
class QueryContext:
    """Per-query context threaded through planning + execution
    (ref: QueryContext.scala)."""
    query_id: str = ""
    submit_time_ms: int = 0
    origin: str = ""
    planner_params: PlannerParams = dataclasses.field(default_factory=PlannerParams)
    lookback_ms: int = 5 * 60 * 1000                # staleness window
    # end-to-end deadline (unix seconds; 0 = none): checked at every
    # exec-node boundary (execbase.execute_internal) and shrinking each
    # remote hop's socket timeout to the remaining budget — it rides the
    # wire with dispatched subtrees, so remote nodes enforce it too
    # (nodes share one clock here; document skew bounds for real WANs)
    deadline_unix_s: float = 0.0
    # the engine's device: where the general path puts host values (a
    # presented aggregate, a scalar) it computes on
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cpu"))
    # a mirror whose cells were rearranged (eviction, paging) is rebuilt
    # in full on a background thread while the leaf serves from the host
    # gather; False rebuilds it inline, on the query's path
    mirror_background_rebuild: bool = True


def device_values(values, ctx: "QueryContext") -> torch.Tensor:
    """A block's values as a tensor on the query's device (host arrays
    move there; tensors stay where they are)."""
    if isinstance(values, torch.Tensor):
        return values
    return torch.from_numpy(np.asarray(values)).to(ctx.device)


def compute_deadline(pp: PlannerParams, default_timeout_s: float) -> float:
    """Absolute unix deadline for a request: an already-stamped deadline
    wins; otherwise the request's timeout_s CAPPED by the server default
    (a client can shrink its budget, never extend it); 0 = no deadline.
    The single home of the cap rule — the frontend (admission stamp) and
    the bare engine (execution-start stamp) must never drift."""
    if pp.deadline_unix_s:
        return pp.deadline_unix_s
    budget = pp.timeout_s or default_timeout_s
    if pp.timeout_s > 0 and default_timeout_s > 0:
        budget = min(pp.timeout_s, default_timeout_s)
    if budget <= 0:
        return 0.0
    import time as _t
    return _t.time() + budget


def remaining_budget(pp: Optional[PlannerParams], bound: float) -> float:
    """`bound` shrunk to the time left on pp's stamped deadline (floored
    at 0); `bound` unchanged when no deadline rides the params.  The
    single home of the wait-bound rule shared by the singleflight dedup
    wait, the scheduler queue wait, and the coalescer follower wait —
    every place a query BLOCKS must spend from the same budget the exec
    tree enforces (getattr: params serialized by an older peer may lack
    the field)."""
    dl = getattr(pp, "deadline_unix_s", 0.0) if pp is not None else 0.0
    if not dl:
        return bound
    import time as _t
    return min(bound, max(dl - _t.time(), 0.0))


def remove_nan_series(block: Optional[ResultBlock]) -> Optional[ResultBlock]:
    """Drop series that are NaN at every step (the reference filters
    all-NaN SerializedRangeVectors before responding)."""
    if block is None:
        return None
    vals = block.values
    if isinstance(vals, torch.Tensor):
        flat = torch.isnan(vals).reshape(vals.shape[0], -1)
        keep = (~flat.all(dim=1)).cpu().numpy()
    else:
        vals = np.asarray(vals)
        keep = ~np.isnan(vals).all(axis=tuple(range(1, vals.ndim)))
    if keep.all():
        return block
    rows = np.flatnonzero(keep)
    if len(rows) == 0:
        return None
    return block.select(rows)
