"""Exec-tree foundations (port of filodb_tpu/query/execbase.py): data
shapes, the fused-leaf caches and the byte budget of the padded-values
cache, the 3-phase aggregation finishers (the component form, the
quantile sketch and the candidate form of topk, bottomk and
count_values), and the
ExecPlan base classes: the deadline and cancellation checks at every
node boundary, the resource tally (each node's exclusive host time, the
device time the kernel ledger books to it, its transfers), the
live-query tally, the plan printer behind explain (`print_tree`,
`args_str`) and the recorder behind explain-analyze (`AnalyzeRecorder`);
the in-process plan dispatcher (remote ones: parallel/transport), the
scatter-gather with partial results, and EmptyResultExec.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from filodb_tpu_torch.memory.histogram import rebucket, union_les
from filodb_tpu_torch.ops import agg as agg_ops
from filodb_tpu_torch.ops import sketch as sketch_ops
from filodb_tpu_torch.query.rangevector import (QueryContext, QueryResult,
                                                QueryStats, RangeVectorKey,
                                                ResultBlock, cat_values,
                                                host_values,
                                                remove_nan_series)
from filodb_tpu_torch.utils.metrics import exec_tally, note_transfer

# --------------------------------------------------------------- data shapes


class LazyKeys:
    """Sequence facade over `shard.keys_for(pids)` deferring the O(S)
    per-series key materialization until something reads a key.  Warm
    fused queries never do: group ids come from the group cache.
    len()/bool are O(1); iteration and indexing materialize once."""
    __slots__ = ("_shard", "_pids", "_keys")

    def __init__(self, shard, pids):
        self._shard = shard
        self._pids = pids
        self._keys = None

    def _mat(self):
        if self._keys is None:
            self._keys = self._shard.keys_for(self._pids)
        return self._keys

    def __len__(self):
        return int(self._pids.size)

    def __bool__(self):
        return self._pids.size > 0

    def __iter__(self):
        return iter(self._mat())

    def __getitem__(self, i):
        return self._mat()[i]


@dataclasses.dataclass
class RawBlock:
    """Raw gathered samples for one schema on one shard: pre-step-grid.

    values are REBASED per series (absolute value - vbase[s]) so counter
    deltas survive the f32 downcast; vbase is the per-series base.  A
    block from the device mirror holds tensors on its device; one from
    the leaf's windowed host gather holds numpy arrays (f32 values, f64
    for the numpy host route and a raw range vector), which on_device()
    uploads once for the consumers that need tensors."""
    keys: Sequence[RangeVectorKey]
    ts_off: torch.Tensor                # int32 [S, T] offsets from base_ms
    values: torch.Tensor                # f32 [S, T] or [S, T, B] (numpy
                                        # from the host gather)
    base_ms: int
    bucket_les: Optional[np.ndarray] = None     # [B] histogram bounds
    samples: int = 0                    # total valid samples (stats)
    vbase: Optional[torch.Tensor] = None  # [S] or [S, B]
    precorrected: bool = False          # counter reset-correction done
    # shared scrape grid: row-0 ts offsets when ALL rows share one grid,
    # else None.  `dense`: no NaN holes anywhere in the counted region.
    shared_ts_row: Optional[np.ndarray] = None
    dense: bool = True
    # working-set identity (shard keys_serial, keys_epoch, pids bytes)
    cache_token: Optional[Tuple] = None
    # the leaf's router sent this block to the host: ts_off, values and
    # vbase are numpy arrays from the windowed host gather
    route_host: bool = False
    _device_copy: Optional["RawBlock"] = dataclasses.field(
        default=None, repr=False, compare=False)

    def on_device(self, device, stats=None) -> "RawBlock":
        """This block with its host arrays moved onto `device` in the
        mirror's types (int32 offsets, f32 rebased values, f64 bases),
        uploaded once: later calls return the same copy.  A block whose
        values already lie on a device is returned as it is.  With
        `stats` given, the upload is synchronized and booked through the
        exec tally (note_transfer), which the running node folds into
        its stats (transfer_s, bytes_transferred)."""
        if isinstance(self.values, torch.Tensor):
            return self
        if self._device_copy is None:
            t0 = time.perf_counter()
            ts = torch.from_numpy(np.ascontiguousarray(
                self.ts_off, np.int32)).to(device)
            vals = torch.from_numpy(np.ascontiguousarray(
                self.values, np.float32)).to(device)
            vbase = None if self.vbase is None else torch.from_numpy(
                np.ascontiguousarray(self.vbase, np.float64)).to(device)
            if stats is not None:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                note_transfer(
                    ts.numel() * 4 + vals.numel() * 4
                    + (0 if vbase is None else vbase.numel() * 8),
                    time.perf_counter() - t0)
            self._device_copy = dataclasses.replace(
                self, ts_off=ts, values=vals, vbase=vbase)
        return self._device_copy

    def on_host(self) -> "RawBlock":
        """This block with device tensors read back into numpy arrays."""
        if not isinstance(self.values, torch.Tensor):
            return self
        return dataclasses.replace(
            self, ts_off=host_values(self.ts_off),
            values=host_values(self.values),
            vbase=None if self.vbase is None else host_values(self.vbase))


# Fused-leaf caches (MultiSchemaPartitionsExec._try_fused): keyed by
# (mirror serial, snapshot gen, ...) so any re-upload naturally misses.
# The VALUES cache holds the padded device copies, bounded in bytes; the
# GROUP cache holds the small per-grouping gid + CSR arrays.
_FUSED_PLAN_CACHE: Dict[Tuple, object] = {}
_FUSED_VALS_CACHE: Dict[Tuple, object] = {}
_FUSED_GROUP_CACHE: Dict[Tuple, Tuple] = {}
# NaN-padded device copies for the min/max path's end=now shape, keyed
# (working set, t_needed); a small cap: each entry pins a full copy
_FUSED_MINMAX_PAD_CACHE: Dict[Tuple, object] = {}
_FUSED_VALS_CACHE_BYTES: Optional[int] = None    # resolved lazily
_MIRROR_LIMIT_SEEN: Optional[int] = None         # largest live mirror budget
_MIRROR_DEVICE: Optional[torch.device] = None    # where that mirror lives


def _note_mirror_limit(limit_bytes: int, device=None) -> None:
    """Record the largest DeviceMirror budget actually constructed (and
    its device), so the values cache's budget subtracts the real mirror
    share, not only the default."""
    global _MIRROR_LIMIT_SEEN, _MIRROR_DEVICE, _FUSED_VALS_CACHE_BYTES
    if _MIRROR_LIMIT_SEEN is None or limit_bytes > _MIRROR_LIMIT_SEEN:
        _MIRROR_LIMIT_SEEN = limit_bytes
        _MIRROR_DEVICE = device
        _FUSED_VALS_CACHE_BYTES = None   # re-derive on next insert


def _fused_vals_budget() -> int:
    """Byte budget for the padded-values cache, derived as the reference
    derives it: FILODB_TPU_FUSED_CACHE_BYTES when set; else 4 GiB, and
    at most the device's memory (`torch.cuda.mem_get_info`) minus the
    largest mirror budget minus 2 GiB headroom (floored at 1 GiB).  A
    CPU mirror reports no device memory and keeps the 4 GiB.  Resolved
    once, at the first insert after a new mirror budget."""
    global _FUSED_VALS_CACHE_BYTES
    if _FUSED_VALS_CACHE_BYTES is not None:
        return _FUSED_VALS_CACHE_BYTES
    env = os.environ.get("FILODB_TPU_FUSED_CACHE_BYTES")
    if env:
        _FUSED_VALS_CACHE_BYTES = int(env)
        return _FUSED_VALS_CACHE_BYTES
    from filodb_tpu_torch.core.devicecache import DEFAULT_HBM_LIMIT_BYTES
    budget = 4 << 30
    dev = _MIRROR_DEVICE
    if dev is not None and dev.type == "cuda":
        limit = int(torch.cuda.mem_get_info(dev)[1])
        mirror_limit = _MIRROR_LIMIT_SEEN or DEFAULT_HBM_LIMIT_BYTES
        budget = min(budget, max(1 << 30, limit - mirror_limit - (2 << 30)))
    _FUSED_VALS_CACHE_BYTES = budget
    return budget


_FUSED_CACHE_LOCK = threading.Lock()


def release_mirror_caches(serial: int) -> None:
    """Drop every fused-cache entry of one mirror (their keys start with
    its serial): a dropped shard's padded values, min/max pads, plans
    and groups leave the device with it, not at the next eviction."""
    with _FUSED_CACHE_LOCK:
        for cache in (_FUSED_PLAN_CACHE, _FUSED_VALS_CACHE,
                      _FUSED_GROUP_CACHE, _FUSED_MINMAX_PAD_CACHE):
            for k in [k for k in cache if k[0] == serial]:
                del cache[k]


class GroupCardinalityError(ValueError):
    """group-by cardinality limit exceeded — a real query error."""


class QueryError(Exception):
    """Typed query-path failure with a stable machine-readable code.  The
    string form is "<code>: <detail>".  Codes raised in the port:

      query_timeout — the query's end-to-end deadline
          (query.default_timeout_s / the `timeout=` request param)
          expired: at an exec-node boundary or while queued in the
          frontend scheduler.  Never retried, never cached.
      query_canceled — the query's CancellationToken was tripped (admin
          kill via POST /admin/queries/<id>/kill, or a client
          disconnect): checked at every exec-node boundary and before
          fused kernel launches.  Never retried, never cached.
      paged_limit_exceeded — demand paging would bring back more than
          the scan limit."""

    def __init__(self, code: str, detail: str):
        self.code = code
        super().__init__(detail)

    def __str__(self):
        return f"{self.code}: {super().__str__()}"


def _lru_touch(cache: Dict, key) -> object:
    """Get + move-to-back (dicts iterate in insertion order, so eviction
    pops the front = least-recently-used)."""
    val = cache.get(key)
    if val is not None:
        cache[key] = cache.pop(key)
    return val


def _vals_nbytes(v) -> int:
    return int(v.vals_p.numel() * 4 + v.vbase_p.numel() * 4)


def _group_cache_lookup(key, by, without):
    """Cached (PaddedGroups, gkeys) for this working set + grouping, or
    (None, None)."""
    if key is None:
        return None, None
    with _FUSED_CACHE_LOCK:
        ent = _lru_touch(_FUSED_GROUP_CACHE, key + (by, without))
    return ent if ent is not None else (None, None)


def _group_cache_insert(key, by, without, groups, gkeys) -> None:
    """Insert a (PaddedGroups, gkeys) entry, evicting entries from older
    snapshot generations of the same mirror and capping the cache."""
    if key is None:
        return
    with _FUSED_CACHE_LOCK:
        for k in [k for k in _FUSED_GROUP_CACHE
                  if k[0] == key[0] and k[1] != key[1]]:
            del _FUSED_GROUP_CACHE[k]
        _FUSED_GROUP_CACHE[key + (by, without)] = (groups, gkeys)
        while len(_FUSED_GROUP_CACHE) > 16:
            _FUSED_GROUP_CACHE.pop(next(iter(_FUSED_GROUP_CACHE)))


def _vals_cache_insert(key, v) -> None:
    """Caller holds _FUSED_CACHE_LOCK.  Evictions are counted
    (`fused_vals_cache_evictions`)."""
    from filodb_tpu_torch.utils.metrics import registry
    _FUSED_VALS_CACHE[key] = v
    budget = _fused_vals_budget()
    while len(_FUSED_VALS_CACHE) > 1 and (
            len(_FUSED_VALS_CACHE) > 4
            or sum(_vals_nbytes(e) for e in _FUSED_VALS_CACHE.values())
            > budget):
        _FUSED_VALS_CACHE.pop(next(iter(_FUSED_VALS_CACHE)))
        registry.counter("fused_vals_cache_evictions").increment()


@dataclasses.dataclass
class ScalarResult:
    """One value per step (scalar plans)."""
    wends: np.ndarray                   # int64 [W]
    values: np.ndarray                  # float [W]


@dataclasses.dataclass
class AggPartial:
    """Partial aggregate: the [G, W, C] component form, the quantile
    sketch, or the candidate rows (topk, bottomk, count_values)."""
    op: str
    group_keys: List[RangeVectorKey]
    wends: np.ndarray
    comp: Optional[np.ndarray] = None   # [G, W, C] float64
    cand_keys: Optional[List[RangeVectorKey]] = None
    cand_vals: Optional[torch.Tensor] = None    # [N, W]
    cand_groups: Optional[np.ndarray] = None    # int [N] -> group_keys index
    params: Tuple = ()
    bucket_les: Optional[np.ndarray] = None     # hist_sum partials
    # quantile(): the mergeable centroid sketch [G, W, K, 2] f64
    # (ops/sketch.py), O(groups) on the wire
    sketch: Optional[np.ndarray] = None
    # working-set identity of the aggregated keys ("agg", op, by,
    # without, source token); value-level identity is not implied
    cache_token: Optional[Tuple] = None


def agg_token(op: str, by, without,
              data_token: Optional[Tuple]) -> Optional[Tuple]:
    """Token for an AggPartial built from a block carrying data_token."""
    if data_token is None:
        return None
    return ("agg", op, tuple(by), tuple(without), data_token)


Data = Union[RawBlock, ResultBlock, ScalarResult, AggPartial, None]


def _block_empty(wends: np.ndarray) -> ResultBlock:
    return ResultBlock([], wends, np.zeros((0, len(wends))))


def present_partial(p: AggPartial) -> Optional[ResultBlock]:
    """Finish an AggPartial into a ResultBlock."""
    if p.sketch is not None:
        out = sketch_ops.sketch_quantile(p.sketch, float(p.params[0]))
        return ResultBlock(p.group_keys, p.wends, out,
                           cache_token=p.cache_token)
    if p.comp is not None and p.op == "hist_sum":
        # [G, W, B+1]: the bucket sums, then the present-series count
        out = np.where(p.comp[..., -1:] > 0, p.comp[..., :-1], np.nan)
        return ResultBlock(p.group_keys, p.wends, out, p.bucket_les,
                           cache_token=p.cache_token)
    if p.comp is not None:
        out = agg_ops.present(p.op, torch.from_numpy(
            np.asarray(p.comp, np.float64))).numpy()
        return ResultBlock(p.group_keys, p.wends, out,
                           cache_token=p.cache_token)
    vals = p.cand_vals
    gids = torch.from_numpy(np.asarray(p.cand_groups, np.int64)).to(
        vals.device)
    if p.op in ("topk", "bottomk"):
        mask = agg_ops.topk_mask(vals, gids, len(p.group_keys),
                                 int(p.params[0]), largest=p.op == "topk")
        out = torch.where(mask, vals, torch.full_like(vals, float("nan")))
        return remove_nan_series(ResultBlock(p.cand_keys, p.wends, out))
    if p.op == "quantile":
        out = agg_ops.quantile_agg(vals, gids, len(p.group_keys),
                                   float(p.params[0]))
        return ResultBlock(p.group_keys, p.wends, out)
    if p.op == "count_values":
        return _count_values(p, host_values(vals))
    raise ValueError(p.op)


def _count_values(p: AggPartial, vals: np.ndarray) -> Optional[ResultBlock]:
    """count_values(label, expr): one series per (group, distinct value)
    counting the series with that value at each step (host math, as the
    reference)."""
    label = str(p.params[0])
    out_keys: List[RangeVectorKey] = []
    out_rows: List[np.ndarray] = []
    for g in range(len(p.group_keys)):
        rows = vals[p.cand_groups == g]
        for v in np.unique(rows[~np.isnan(rows)]):
            cnt = np.nansum(rows == v, axis=0).astype(float)
            cnt[cnt == 0] = np.nan
            lbls = dict(p.group_keys[g].labels)
            lbls[label] = f"{v:g}"
            out_keys.append(RangeVectorKey.make(lbls))
            out_rows.append(cnt)
    if not out_keys:
        return None
    return ResultBlock(out_keys, p.wends, np.stack(out_rows))


def _union_scheme(les_list: List[Optional[np.ndarray]]
                  ) -> Optional[np.ndarray]:
    """The union bucket scheme across shards, or None when a shard carries
    no boundaries."""
    if any(les is None for les in les_list):
        return None
    out = les_list[0]
    for les in les_list[1:]:
        out = union_les(out, les)
    return out


def _align_hist_schemes(parts: List[AggPartial]) -> List[AggPartial]:
    """Rebucket hist_sum partials onto the union scheme, so shards whose
    series changed bucket scheme still merge."""
    les_list = [p.bucket_les for p in parts]
    if any(les is None for les in les_list):
        # boundary-less partials merge only by width, and only when every
        # known scheme is the same one
        widths = {p.comp.shape[-1] for p in parts}
        known = [les for les in les_list if les is not None]
        if len(widths) > 1 or any(not np.array_equal(les, known[0])
                                  for les in known[1:]):
            raise ValueError(
                "cannot merge histogram partials of different schemes when "
                "some shards carry no bucket boundaries to re-map by")
        return parts
    if all(np.array_equal(les, les_list[0]) for les in les_list):
        return parts
    union = _union_scheme(les_list)

    def rebucket_comp(p):
        # [G, W, B+1]: B bucket slots, then the present-series count
        B = len(p.bucket_les)
        buckets = rebucket(p.comp[..., :B], p.bucket_les, union)
        return np.concatenate([buckets, p.comp[..., B:]], axis=-1)

    return [dataclasses.replace(p, comp=rebucket_comp(p), bucket_les=union)
            if not np.array_equal(p.bucket_les, union) else p
            for p in parts]


def _reduced_token(parts: List[AggPartial]) -> Optional[Tuple]:
    """Composite identity of a merged partial: the children's tokens in
    merge order."""
    toks = tuple(p.cache_token for p in parts)
    return ("red",) + toks if all(t is not None for t in toks) else None


def reduce_partials(parts: List[AggPartial],
                    compress: bool = True) -> Optional[AggPartial]:
    """Inter-shard reduce (ReduceAggregateExec): merge partials by group
    key, children in order, so the sum order is fixed.

    ``compress=False`` is the node-level pushdown mode for quantile
    sketches: the centroid axes are concatenated (zero-weight padded)
    but not re-compressed, so the coordinator's single merge_sketches
    over the node partials sees the same centroid multiset as a flat
    per-shard merge would, and pushdown answers the same bits."""
    parts = [p for p in parts if p is not None]
    if not parts:
        return None
    op = parts[0].op
    if op == "hist_sum":
        parts = _align_hist_schemes(parts)
    gmap: Dict[RangeVectorKey, int] = {}
    gkeys: List[RangeVectorKey] = []
    for p in parts:
        for k in p.group_keys:
            if k not in gmap:
                gmap[k] = len(gkeys)
                gkeys.append(k)
    if parts[0].sketch is not None:
        # quantile sketches: concatenate the centroid axis per group
        # (zero-weight padding where a partial lacks a group), then
        # re-compress to K
        W = parts[0].sketch.shape[1]
        M = sum(p.sketch.shape[2] for p in parts)
        cat = np.zeros((len(gkeys), W, M, 2))
        cat[..., 0] = np.nan
        off = 0
        for p in parts:
            idx = np.asarray([gmap[k] for k in p.group_keys], np.int64)
            m = p.sketch.shape[2]
            cat[idx, :, off:off + m] = p.sketch
            off += m
        return AggPartial(op, gkeys, parts[0].wends,
                          sketch=(sketch_ops.merge_sketches(cat)
                                  if compress else cat),
                          params=parts[0].params,
                          cache_token=_reduced_token(parts))
    if parts[0].comp is None:
        # candidate form: concatenate the rows, group ids remapped
        ck: List[RangeVectorKey] = []
        cg: List[np.ndarray] = []
        for p in parts:
            idx = np.asarray([gmap[k] for k in p.group_keys], np.int64)
            ck.extend(p.cand_keys)
            cg.append(idx[p.cand_groups])
        return AggPartial(op, gkeys, parts[0].wends, cand_keys=ck,
                          cand_vals=cat_values([p.cand_vals for p in parts]),
                          cand_groups=np.concatenate(cg),
                          params=parts[0].params)
    W, C = parts[0].comp.shape[1:]
    # a hist_sum partial's B bucket sums and count all merge by addition
    comb_op = "sum" if op == "hist_sum" else op
    # each component starts from its combiner's identity (+inf for min,
    # -inf for max): starting a max from 0 would beat negative values
    out = agg_ops.identity_partial(comb_op, len(gkeys), W, C)
    for p in parts:
        idx = torch.tensor([gmap[k] for k in p.group_keys], dtype=torch.long)
        # group keys are unique within one partial: a plain indexed
        # combine, no duplicate-index accumulation
        out[idx] = agg_ops.reduce_phase(comb_op, out[idx],
                                        torch.from_numpy(p.comp))
    return AggPartial(op, gkeys, parts[0].wends, comp=out.numpy(),
                      bucket_les=parts[0].bucket_les,
                      cache_token=_reduced_token(parts))


# ---------------------------------------------------------------- exec plans


class AnalyzeRecorder:
    """Per-node resource records for `/api/v1/explain?analyze=true` (the
    EXPLAIN ANALYZE of the exec tree): every executed node appends its
    EXCLUSIVE wall/device/transfer attribution plus the cumulative scan
    counters its subtree produced.  Attach by setting
    `ctx.analyze = AnalyzeRecorder()` on the QueryContext BEFORE
    execution (a plain attribute, not a dataclass field)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.by_node: Dict[int, dict] = {}      # id(node) -> record
        self.order: List[dict] = []

    def add(self, node, rec: dict) -> None:
        with self._lock:
            self.by_node[id(node)] = rec
            self.order.append(rec)

    def annotation(self, node) -> str:
        """Tree-line suffix for print_tree(annot=...)."""
        r = self.by_node.get(id(node))
        if r is None:
            return "  [not executed locally]"
        return ("  [self=%.3fms device=%.3fms transfer=%.3fms "
                "bytes=%d samples=%d series=%d]"
                % (r["self_s"] * 1e3, r["device_s"] * 1e3,
                   r["transfer_s"] * 1e3, r["bytes_transferred"],
                   r["samples_scanned"], r["series_scanned"]))


class PlanDispatcher:
    """Where a subtree runs: a parent hands each child to its
    dispatcher."""

    def dispatch(self, plan: "ExecPlan", source):
        raise NotImplementedError


class InProcessPlanDispatcher(PlanDispatcher):
    """Run the subtree in this process (remote nodes:
    parallel/transport.RemoteNodeDispatcher)."""

    def dispatch(self, plan: "ExecPlan", source):
        return plan.execute_internal(source)


class ExecPlan:
    """Base execution node.  `execute_internal` returns raw Data + stats;
    `execute` materializes a QueryResult with limits enforced."""

    def __init__(self, ctx: Optional[QueryContext] = None):
        self.ctx = ctx or QueryContext()
        self.transformers: list = []
        self.dispatcher: PlanDispatcher = InProcessPlanDispatcher()

    def add_transformer(self, t) -> "ExecPlan":
        self.transformers.append(t)
        return self

    @property
    def children(self) -> List["ExecPlan"]:
        return []

    def _do_execute(self, source):
        raise NotImplementedError

    def _execute_impl(self, source):
        data, stats = self._do_execute(source)
        for t in self.transformers:
            self._check_live(type(t).__name__)
            data = t.apply(data, self.ctx, stats, source)
        return data, stats

    def _check_live(self, where: str) -> None:
        """The deadline and the cancellation token, checked at a stage
        boundary: a query past its budget raises query_timeout, a killed
        one query_canceled, instead of starting more work."""
        dl = getattr(self.ctx, "deadline_unix_s", 0.0)
        if dl and time.time() >= dl:
            raise QueryError(
                "query_timeout",
                f"deadline exceeded at {where} "
                f"(budget expired {time.time() - dl:.3f}s ago)")
        tok = getattr(self.ctx, "cancel", None)
        if tok is not None and tok.cancelled:
            tok.raise_if_cancelled(f"at {where}")

    def execute_internal(self, source):
        """_execute_impl behind the node-boundary checks (deadline, then
        cancellation) and inside the resource tally: each node's
        EXCLUSIVE wall time (total minus nested nodes', minus the device
        and transfer seconds it booked) goes into stats.cpu_seconds, and
        whatever device/transfer work the thread accumulated while this
        node ran (utils/metrics.exec_tally, fed by the kernel ledger and
        the uploads) lands in ITS QueryStats — children's contributions
        arrive via stats.merge, so the root totals are exact sums over
        nodes.  An attached AnalyzeRecorder gets the node's record; the
        live registry entry riding the context sees this node's counters
        in place."""
        self._check_live(type(self).__name__)
        snap = exec_tally.snapshot()
        t0 = time.perf_counter()
        try:
            data, stats = self._execute_impl(source)
        except BaseException:
            # the parent sees the whole failed subtree as child time
            exec_tally.restore(snap, time.perf_counter() - t0)
            raise
        total = time.perf_counter() - t0
        self_wall = max(total - exec_tally.child_wall
                        - exec_tally.device_s - exec_tally.transfer_s, 0.0)
        fold_tally(stats, self_wall)
        rec = getattr(self.ctx, "analyze", None)
        if rec is not None:
            rec.add(self, {
                "plan": type(self).__name__,
                "self_s": self_wall,
                "device_s": exec_tally.device_s,
                "transfer_s": exec_tally.transfer_s,
                "bytes_transferred": exec_tally.transfer_bytes,
                # cumulative over this node's subtree (leaves: own scan)
                "samples_scanned": stats.samples_scanned,
                "series_scanned": stats.series_scanned,
                "shards_queried": stats.shards_queried,
            })
        ent = getattr(self.ctx, "active", None)
        if ent is not None:
            ent.tally(self, stats, exec_tally)
        exec_tally.restore(snap, total)
        return data, stats

    def execute(self, source) -> QueryResult:
        """Run the tree under the query's trace id (ctx.query_id), so the
        kernel ledger's entries and the spans carry it.  Query errors
        come back in the result, as in the reference."""
        from filodb_tpu_torch.utils.metrics import span, trace_context
        try:
            with trace_context(self.ctx.query_id), \
                    span("execplan", plan=type(self).__name__):
                data, stats = self.execute_internal(source)
        except QueryError as e:
            return QueryResult([], QueryStats(), error=str(e))
        except Exception as e:  # noqa: BLE001 — query errors surface in result
            return QueryResult([], QueryStats(),
                               error=f"{type(e).__name__}: {e}")
        if isinstance(data, RawBlock):
            # a raw range vector at the root (a RawSeries plan): the
            # reference hands the gathered block itself back, rebased
            # values and int32 offsets from base_ms; here on the host
            data = data.on_host()
        elif isinstance(data, AggPartial):
            data = present_partial(data)
        if isinstance(data, ScalarResult):
            data = ResultBlock([RangeVectorKey(())], data.wends,
                               data.values[None, :])
        if isinstance(data, ResultBlock):
            data = remove_nan_series(data)
        if data is not None and isinstance(data.values, torch.Tensor):
            # the result leaves the device here, for the Prometheus JSON
            data = dataclasses.replace(data, values=host_values(data.values))
        blocks = [data] if data is not None else []
        limit = self.ctx.planner_params.sample_limit
        result_samples = sum(int(np.asarray(b.values).size) for b in blocks)
        if limit and result_samples > limit:
            return QueryResult([], stats,
                               error=f"sample limit {limit} exceeded "
                                     f"({result_samples} samples)")
        stats.result_samples = result_samples
        stats.result_bytes = sum(int(np.asarray(b.values).nbytes)
                                 for b in blocks)
        if stats.partial:
            from filodb_tpu_torch.utils.metrics import registry
            registry.counter("query_partial_results").increment()
        return QueryResult(blocks, stats, partial=stats.partial)

    # -- plan printing (the reference's ExecPlan.printTree)

    def args_str(self) -> str:
        return ""

    def print_tree(self, level: int = 0, annot=None) -> str:
        """annot: optional node -> suffix-string callable (the explain
        analyze mode passes AnalyzeRecorder.annotation)."""
        transf = [f"{'-' * (level + i + 1)}T~{type(t).__name__}({t.args_str()})"
                  for i, t in enumerate(reversed(self.transformers))]
        me = (f"{'-' * (level + len(self.transformers) + 1)}"
              f"E~{type(self).__name__}({self.args_str()})"
              + (annot(self) if annot is not None else ""))
        kids = [c.print_tree(level + len(self.transformers) + 1, annot)
                for c in self.children]
        return "\n".join(transf + [me] + kids)

    def __str__(self):
        return self.print_tree()


def fold_tally(stats: QueryStats, self_wall: float = 0.0) -> None:
    """Fold the thread's exec tally (what the running scope accumulated:
    device seconds by device and kernel, transfers, mirror refreshes)
    into `stats`, plus `self_wall` of exclusive host time.  The caller
    owns the snapshot/restore around the scope."""
    stats.cpu_seconds += self_wall
    stats.device_seconds += exec_tally.device_s
    stats.transfer_s += exec_tally.transfer_s
    stats.bytes_transferred += exec_tally.transfer_bytes
    stats.mirror_full_rebuilds += exec_tally.mirror_full
    stats.mirror_incremental += exec_tally.mirror_incremental
    # the per-(device, kernel) split of device_seconds, under a flat
    # "dev|kernel" key
    for (dev, kern), cell in exec_tally.device_calls.items():
        key = f"{dev}|{kern}"
        mine = stats.device_calls.get(key)
        if mine is None:
            stats.device_calls[key] = [cell[0], cell[1]]
        else:
            mine[0] += cell[0]
            mine[1] += cell[1]


class LeafExecPlan(ExecPlan):
    pass


class EmptyResultExec(LeafExecPlan):
    """A leaf that answers nothing."""

    def _do_execute(self, source):
        return None, QueryStats()


class NonLeafExecPlan(ExecPlan):
    """Gather over children, in order, each through its dispatcher."""

    # concat/reduce plans whose children are SAME-SELECTOR per-shard
    # leaves set this True (nonleaf.py, metaexec.py): when two children
    # name the same shard — both owners listed during a live handoff
    # window — only the first to answer contributes, so an aggregation
    # can never double-count a shard's samples (replication/handoff.py
    # dedup contract).  Positional plans (BinaryJoin/SetOperator: lhs
    # and rhs legitimately repeat shard numbers) keep it False.
    dedup_shard_children = False

    def __init__(self, ctx: QueryContext, children: Sequence[ExecPlan]):
        super().__init__(ctx)
        self._children = list(children)

    @property
    def children(self) -> List[ExecPlan]:
        return self._children

    def _dedup_groups(self) -> Dict[int, Tuple]:
        """child index -> leaf-identity key, ONLY for children that
        appear more than once (a live-handoff window lists both owners
        of a shard).  Within a group the first child to answer is the
        shard's result; the rest are hot standbys.

        The key is the leaf's FULL identity — plan type, dataset,
        shard, args_str (filters/time range/columns), and the
        transformer chain — never just the shard number: a
        ShardKeyRegexPlanner fan-out legitimately puts two same-shard
        leaves with DIFFERENT selectors under one concat, and deduping
        those would silently drop a shard-key combo's data."""
        if not self.dedup_shard_children:
            return {}
        by_key: Dict[Tuple, List[int]] = {}
        for i, c in enumerate(self._children):
            shard = getattr(c, "shard", None)
            if shard is None:
                continue
            key = (type(c).__name__, getattr(c, "dataset", None), shard,
                   c.args_str(),
                   tuple((type(t).__name__, t.args_str())
                         for t in c.transformers))
            by_key.setdefault(key, []).append(i)
        return {i: key for key, idxs in by_key.items()
                if len(idxs) > 1 for i in idxs}

    def child_stream_fold(self, child) -> Optional[Callable]:
        """Factory for an incremental fold of a STREAMED child reply
        (parallel/streams.StreamFold): when non-None, the transport
        hands each row-slice frame to `factory().add(mini_block)` as it
        arrives and returns `.result()` — the child's full block never
        materializes on the coordinator.  Default: None (whole-block
        assembly).  ReduceAggregateExec overrides with its map+reduce
        fold."""
        return None

    def _gather(self, source):
        stats = QueryStats()
        results = []
        pp = self.ctx.planner_params
        # shard_unavailable drops only once the ENGINE has engaged
        # degradation (partial_now: re-plan retries exhausted) — so a
        # transient owner death still gets routed around before any data
        # is given up.  A peer blowing its deadline share
        # (dispatch_timeout) drops under the gate alone: retrying cannot
        # help inside the budget.  query_timeout NEVER drops — the
        # budget is global, so the root propagates the structured error.
        droppable = set()
        if pp.allow_partial_results:
            droppable.add("dispatch_timeout")
            if getattr(pp, "partial_now", False):
                droppable.add("shard_unavailable")
        # handoff-window dedup: when the planner materialized BOTH
        # owners of a shard, the duplicates are hot standbys — only the
        # first to answer contributes (aggregations never double-count a
        # shard), and a standby absorbs its twin's shard_unavailable
        # BEFORE the partial machinery is consulted
        dedup_groups = self._dedup_groups()
        answered: set = set()       # keys already answered
        for i, c in enumerate(self._children):
            key = dedup_groups.get(i)
            if key is not None and key in answered:
                from filodb_tpu_torch.utils.metrics import registry
                registry.counter("query_shard_dedup").increment()
                results.append(None)         # twin already answered
                continue
            has_later_twin = key is not None and any(
                j > i for j, k in dedup_groups.items() if k == key)
            ff = self.child_stream_fold(c)
            if ff is not None:
                # plain attribute, never serialized: the remote side
                # streams row slices and THIS side folds them in place
                c._stream_fold = ff
            try:
                data, st = c.dispatcher.dispatch(c, source)
                if key is not None:
                    answered.add(key)
            except QueryError as e:
                if e.code == "shard_unavailable" and has_later_twin:
                    # this owner is dead but its twin is still listed:
                    # the twin becomes the shard's answer — no partial,
                    # no error, exactly the handoff-window contract
                    results.append(None)
                    continue
                # a dead shard owner mid-query: fail the whole query with
                # the typed error — or, when partial results are engaged,
                # drop the child and FLAG the result (never silent
                # partials)
                if e.code not in droppable:
                    raise
                from filodb_tpu_torch.utils.metrics import registry
                registry.counter("query_partial_children",
                                 plan=type(self).__name__,
                                 code=e.code).increment()
                stats.partial = True
                stats.warnings.append(f"shard dropped ({e})")
                # placeholder, not skip: BinaryJoin/SetOperator split
                # `results` positionally at n_lhs, so a dropped child
                # keeps its slot (every compose filters by type, so None
                # contributes nothing)
                results.append(None)
                continue
            stats.merge(st)
            results.append(data)
            # a child's return is a boundary too: a kill or deadline
            # that landed while it ran stops the tree here
            self._check_live(f"{type(self).__name__} gather")
        return results, stats

    def compose(self, results: List[Data], stats: QueryStats) -> Data:
        raise NotImplementedError

    def _do_execute(self, source):
        results, stats = self._gather(source)
        return self.compose(results, stats), stats
