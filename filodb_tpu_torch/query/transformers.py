"""Range-vector transformers for the query slice (port of
filodb_tpu/query/transformers.py).

PeriodicSamplesMapper and AggregateMapReduce carry the query's window
grid, function and grouping down to the leaf, whose fused path consumes
both (query/leafexec.py).  Their general-path apply() over non-empty
data — evaluating a range function series by series, then aggregating —
is not ported: it raises not_ported, naming what the fused path did not
take.  Empty inputs keep their reference behaviour.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from filodb_tpu_torch.ops.timewindow import make_window_ends
from filodb_tpu_torch.query.execbase import (Data, RawBlock, _block_empty,
                                             _lru_touch, not_ported,
                                             present_partial, AggPartial)
from filodb_tpu_torch.query.rangevector import (QueryContext, QueryStats,
                                                RangeVectorKey, ResultBlock)


class RangeVectorTransformer:

    def apply(self, data: Data, ctx: QueryContext, stats: QueryStats,
              source=None) -> Data:
        raise NotImplementedError


@dataclasses.dataclass
class PeriodicSamplesMapper(RangeVectorTransformer):
    """Raw samples -> regular step grid, optional range function."""
    start_ms: int
    step_ms: int
    end_ms: int
    window_ms: Optional[int] = None     # None => plain lookback sampling
    function: Optional[str] = None
    function_args: Tuple[float, ...] = ()
    offset_ms: int = 0
    lookback_ms: int = 5 * 60 * 1000

    def apply(self, data: Data, ctx: QueryContext, stats: QueryStats,
              source=None) -> Data:
        wends = make_window_ends(self.start_ms, self.end_ms, self.step_ms)
        if data is None or (isinstance(data, RawBlock) and not data.keys):
            return _block_empty(wends)
        raise not_ported(
            f"general range-function path for "
            f"{self.function or 'an instant selector'} (ops/rangefns.py): "
            f"only a fused leaf (rate family, last/sum/avg/count/min/"
            f"max_over_time or an instant selector, under sum/avg/count/"
            f"min/max) on one shared scrape grid is ported")


def _group_ids(keys: Sequence[RangeVectorKey], by: Tuple[str, ...],
               without: Tuple[str, ...]) -> Tuple[np.ndarray, List[RangeVectorKey]]:
    """Host-side grouping: series key -> group key (by/without semantics)."""
    gmap: Dict[RangeVectorKey, int] = {}
    gids = np.empty(len(keys), dtype=np.int32)
    gkeys: List[RangeVectorKey] = []
    for i, k in enumerate(keys):
        if by:
            gk = k.only(by)
        elif without:
            gk = k.without(tuple(without) + ("_metric_", "__name__"))
        else:
            gk = RangeVectorKey(())
        gid = gmap.get(gk)
        if gid is None:
            gid = len(gkeys)
            gmap[gk] = gid
            gkeys.append(gk)
        gids[i] = gid
    return gids, gkeys


# host group-id cache: (cache_token, by, without) -> (gids, gkeys).  The
# token (shard keys_serial, keys_epoch, pids bytes) identifies the key set
# exactly, so repeat queries do a dict hit instead of the O(S) loop.
_HOST_GROUP_CACHE: Dict[tuple, tuple] = {}
_HOST_GROUP_LOCK = threading.Lock()


def _group_ids_cached(token, keys, by, without):
    if token is None:
        return _group_ids(keys, by, without)
    k = (token, tuple(by), tuple(without))
    with _HOST_GROUP_LOCK:
        ent = _lru_touch(_HOST_GROUP_CACHE, k)
    if ent is not None and len(ent[0]) == len(keys):
        return ent
    gids, gkeys = _group_ids(keys, by, without)
    with _HOST_GROUP_LOCK:
        _HOST_GROUP_CACHE[k] = (gids, gkeys)
        while len(_HOST_GROUP_CACHE) > 8:
            _HOST_GROUP_CACHE.pop(next(iter(_HOST_GROUP_CACHE)))
    return gids, gkeys


@dataclasses.dataclass
class AggregateMapReduce(RangeVectorTransformer):
    """Map phase of 3-phase aggregation (the fused leaf runs it)."""
    op: str
    params: Tuple = ()
    by: Tuple[str, ...] = ()
    without: Tuple[str, ...] = ()

    def apply(self, data: Data, ctx: QueryContext, stats: QueryStats,
              source=None) -> Data:
        if data is None or (isinstance(data, ResultBlock)
                            and data.num_series == 0):
            return None
        raise not_ported(f"general-path map phase of {self.op} "
                         f"(ops/agg.map_phase)")


class AggregatePresenter(RangeVectorTransformer):
    """Present phase."""

    def __init__(self, op: str):
        self.op = op

    def apply(self, data: Data, ctx: QueryContext, stats: QueryStats,
              source=None) -> Data:
        if data is None:
            return None
        if not isinstance(data, AggPartial):
            raise TypeError(f"AggregatePresenter needs an AggPartial, "
                            f"got {type(data).__name__}")
        return present_partial(data)
