"""DownsampledTimeSeriesStore — query-only store over downsampled datasets
(port of filodb_tpu/downsample/store.py).

ref: core/.../downsample/DownsampledTimeSeriesStore.scala /
DownsampledTimeSeriesShard.scala:49 — a store holding one dataset per
downsample resolution in the downsample keyspace, index refreshed
periodically from persisted part keys, chunks paged on demand at query time.

Resolution choice happens at PLAN time here (the planner knows step/window;
the reference chooses inside the shard read path) and is encoded in the leaf
dataset name `<raw>::ds::<res>`, so the stock MultiSchemaPartitionsExec and
TimeSeriesShard machinery serve downsampled queries unchanged.  The
store takes ``device=`` as TimeSeriesMemStore does (default ``"cuda"``,
raising without a card unless given ``device="cpu"``): its shards' device
mirrors hold the downsampled columns there, and the fused kernels answer
over them.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Sequence

from filodb_tpu_torch.config import FilodbSettings
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.core.records import RecordBatch
from filodb_tpu_torch.core.schemas import Schemas, DEFAULT_SCHEMAS
from filodb_tpu_torch.core.shard import TimeSeriesShard
from filodb_tpu_torch.core.store import ColumnStore, MetaStore
from filodb_tpu_torch.downsample.shard_downsampler import DEFAULT_RESOLUTIONS
from filodb_tpu_torch.query.planner import SingleClusterPlanner


def ds_dataset_name(raw_dataset: str, resolution_ms: int) -> str:
    return f"{raw_dataset}::ds::{resolution_ms}"


class DownsampledTimeSeriesStore(TimeSeriesMemStore):
    """One TimeSeriesShard per (resolution, shard), all backed by the
    downsample column store.  Exposes the same `get_shard(dataset, shard)`
    surface as TimeSeriesMemStore so the query exec path is unchanged."""

    def __init__(self, raw_dataset: str,
                 column_store: Optional[ColumnStore] = None,
                 meta_store: Optional[MetaStore] = None,
                 schemas: Schemas = DEFAULT_SCHEMAS,
                 resolutions: Sequence[int] = DEFAULT_RESOLUTIONS,
                 config: Optional[FilodbSettings] = None, device="cuda"):
        super().__init__(schemas, column_store, meta_store, device, config)
        self.raw_dataset = raw_dataset
        self.resolutions = tuple(sorted(resolutions))

    def setup_shard(self, shard_num: int) -> List[TimeSeriesShard]:
        """Create the per-resolution shards (ref:
        DownsampledTimeSeriesStore.setup)."""
        return [self.setup(ds_dataset_name(self.raw_dataset, r), shard_num)
                for r in self.resolutions]

    def refresh_index(self, shard_num: int) -> int:
        """Periodic index refresh from persisted part keys (ref:
        DownsampledTimeSeriesShard index refresh task)."""
        n = 0
        for r in self.resolutions:
            shard = self.get_shard(ds_dataset_name(self.raw_dataset, r),
                                   shard_num)
            if shard is not None:
                n += shard.recover_index()
        return n

    def ingest_downsample_batches(
            self, shard_num: int,
            batches_by_res: Dict[int, List[RecordBatch]]) -> int:
        """Streaming path: consume a ShardDownsampler drain
        (ref: downsample publisher → downsample cluster ingestion)."""
        n = 0
        for res, batches in batches_by_res.items():
            ds = ds_dataset_name(self.raw_dataset, res)
            shard = self.get_shard(ds, shard_num) or self.setup(ds, shard_num)
            for b in batches:
                n += shard.ingest(b)
        return n

    def pick_resolution(self, step_ms: int, window_ms: Optional[int]) -> int:
        """Largest resolution that at least two periods fit the window (or
        step, for plain selectors) — coarser data, fewer samples, same
        answer shape (ref: DownsampledTimeSeriesShard.chooseDownsampleResolution)."""
        budget = window_ms if window_ms else step_ms
        best = self.resolutions[0]
        for r in self.resolutions:
            if 2 * r <= max(budget, 1):
                best = r
        return best


class DownsampleClusterPlanner(SingleClusterPlanner):
    """SingleClusterPlanner variant whose leaves target the downsample
    dataset chosen for each query's step/window (ref: the downsample-cluster
    planner half of LongTimeRangePlanner; resolution choice ref:
    DownsampledTimeSeriesShard.scala:49 area)."""

    def __init__(self, store: DownsampledTimeSeriesStore, shard_mapper,
                 **kwargs):
        super().__init__(store.raw_dataset, shard_mapper, **kwargs)
        self.store = store
        # per-thread: one planner instance serves concurrent HTTP requests
        self._tls = threading.local()

    def materialize(self, plan, ctx):
        from filodb_tpu_torch.query import logical as lp
        res = None
        if isinstance(plan, lp.PeriodicSeriesPlan):
            win = _first_window(plan)
            res = self.store.pick_resolution(plan.step_ms, win)
        if res is None:
            res = self.store.resolutions[0]
        stack = getattr(self._tls, "res_stack", None)
        if stack is None:
            stack = self._tls.res_stack = []
        stack.append(res)
        try:
            return super().materialize(plan, ctx)
        finally:
            stack.pop()

    def _m_RawSeries(self, p, ctx):
        plans = super()._m_RawSeries(p, ctx)
        stack = getattr(self._tls, "res_stack", None)
        res = stack[-1] if stack else self.store.resolutions[0]
        for leaf in plans:
            leaf.dataset = ds_dataset_name(self.store.raw_dataset, res)
        return plans


def _first_window(plan) -> Optional[int]:
    import dataclasses
    from filodb_tpu_torch.query import logical as lp
    if isinstance(plan, lp.PeriodicSeriesWithWindowing):
        return plan.window_ms
    if dataclasses.is_dataclass(plan):
        for f in dataclasses.fields(plan):
            v = getattr(plan, f.name)
            if isinstance(v, lp.LogicalPlan):
                w = _first_window(v)
                if w is not None:
                    return w
    return None
