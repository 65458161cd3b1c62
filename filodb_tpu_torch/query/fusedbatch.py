"""Batched fused-leaf dispatch: merge compatible panels into single
kernel launches (port of filodb_tpu/query/fusedbatch.py).  Calls of one
working set, window grid and function share a launch: sum/avg/count
panels one group-mode launch, min/max panels one per-series launch
(ops/fused.fused_leaf_agg_batch).  A histogram call's groups are
(group, bucket) slots; its finisher reshapes them to [G, W, B] and adds
the present-series count (a "hist_sum" AggPartial).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from filodb_tpu_torch.ops.hist import from_bucket_rows
from filodb_tpu_torch.query.execbase import AggPartial
from filodb_tpu_torch.utils.metrics import registry


@dataclasses.dataclass
class FusedCall:
    """A fused leaf evaluation with everything resolved except the kernel
    launch — the unit of merging.  Compatible calls (same plan, device
    values and function flavor) become panels of ONE
    ops/fused.fused_leaf_agg_batch launch."""
    plan: object                  # fused.FusedPlan
    values: object                # fused.PaddedValues (device-resident)
    groups: object                # fused.PaddedGroups
    gkeys: List
    wends: np.ndarray
    fn: str
    op: str
    precorrected: bool
    ragged: bool
    num_series: Optional[int] = None   # real rows (per-series launches)
    # semantic identity (mirror serial + snapshot gen + column + row
    # subset + window params): lets equal-but-distinct plan/values
    # objects merge when the caches declined to share them
    cache_key: Optional[tuple] = None
    # histogram leaf: groups carry (group, bucket) slots, gid * B + b
    bucket_les: Optional[np.ndarray] = None
    num_buckets: int = 1
    cache_token: Optional[tuple] = None

    def compat_key(self):
        base = (self.fn, self.precorrected, self.ragged)
        if self.cache_key is not None:
            return ("k",) + base + (self.cache_key,)
        return ("id",) + base + (id(self.plan), id(self.values.vals_p))


def finish_fused_calls(calls: List[FusedCall]) -> List[AggPartial]:
    """Launch every FusedCall, merging compatible ones into single kernel
    launches (identical panels dedup to one).  Phase A issues every
    merged set's launch without reading back; phase B synchronizes."""
    from filodb_tpu_torch.ops import fused
    out: List[Optional[AggPartial]] = [None] * len(calls)
    prim: Dict[tuple, int] = {}
    alias: Dict[int, int] = {}
    for i, fc in enumerate(calls):
        k = fc.compat_key() + (id(fc.groups.gids_p), fc.op, fc.num_buckets)
        if k in prim:
            alias[i] = prim[k]
        else:
            prim[k] = i
    if alias:
        registry.counter("fused_batch_deduped").increment(len(alias))
    by_key: Dict[tuple, List[int]] = {}
    for i, fc in enumerate(calls):
        if i not in alias:
            by_key.setdefault(fc.compat_key(), []).append(i)
    pending = []
    for take in by_key.values():
        fc0 = calls[take[0]]
        panels = [(calls[i].groups,
                   len(calls[i].gkeys) * calls[i].num_buckets, calls[i].op)
                  for i in take]
        if len(take) > 1:
            # the batching win: the launches this merged set costs
            # (group mode, per-series mode) and the panels sharing them
            group_mode = any(
                calls[i].op in ("sum", "avg")
                or (calls[i].op == "count" and fc0.ragged) for i in take)
            per_series = any(calls[i].op in ("min", "max") for i in take)
            registry.counter("fused_batch_dispatches").increment(
                group_mode + per_series)
            registry.counter("fused_batch_merged_panels").increment(
                len(take))
        finisher = fused.fused_leaf_agg_batch(
            fc0.plan, fc0.values, panels, fc0.fn,
            precorrected=fc0.precorrected, ragged=fc0.ragged,
            num_series=fc0.num_series, lazy=True)
        pending.append((take, finisher))
    for take, finisher in pending:
        for i, comp in zip(take, finisher()):
            out[i] = _present(calls[i], comp)
    for i, j in alias.items():
        out[i] = dataclasses.replace(out[j])
    return out


def _present(fc: FusedCall, comp) -> AggPartial:
    if fc.bucket_les is None:
        return AggPartial(fc.op, fc.gkeys, fc.wends, comp=comp,
                          cache_token=fc.cache_token)
    # histogram: comp[..., 0] sums each (group, bucket) slot -> [G, W, B]
    G, B = len(fc.gkeys), fc.num_buckets
    buckets = from_bucket_rows(np.asarray(comp[..., 0], np.float64), B)
    if fc.ragged:
        # scrape holes take whole scrapes, so every bucket of a series
        # shares one presence pattern: bucket 0's count is the series
        # count (the kernel's presence output)
        cnt = from_bucket_rows(np.asarray(comp[..., 1], np.float64),
                               B)[..., 0]
    else:
        gsize = fc.groups.gsize.reshape(G, B)[:, 0]
        cnt = gsize[:, None] * fc.plan.wvalid[None, :].astype(np.float64)
    hist_comp = np.concatenate([buckets, cnt[..., None]], axis=2)
    return AggPartial("hist_sum", fc.gkeys, fc.wends, comp=hist_comp,
                      bucket_les=fc.bucket_les, cache_token=fc.cache_token)
