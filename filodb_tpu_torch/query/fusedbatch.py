"""Batched fused-leaf dispatch: merge compatible panels into single
kernel launches (port of filodb_tpu/query/fusedbatch.py, scalar series
only).  Calls of one working set, window grid and function share a
launch: sum/avg/count panels one group-mode launch, min/max panels one
per-series launch (ops/fused.fused_leaf_agg_batch).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from filodb_tpu_torch.query.execbase import AggPartial


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
        k = fc.compat_key() + (id(fc.groups.gids_p), fc.op)
        if k in prim:
            alias[i] = prim[k]
        else:
            prim[k] = i
    by_key: Dict[tuple, List[int]] = {}
    for i, fc in enumerate(calls):
        if i not in alias:
            by_key.setdefault(fc.compat_key(), []).append(i)
    pending = []
    for take in by_key.values():
        fc0 = calls[take[0]]
        panels = [(calls[i].groups, len(calls[i].gkeys), calls[i].op)
                  for i in take]
        finisher = fused.fused_leaf_agg_batch(
            fc0.plan, fc0.values, panels, fc0.fn,
            precorrected=fc0.precorrected, ragged=fc0.ragged,
            num_series=fc0.num_series, lazy=True)
        pending.append((take, finisher))
    for take, finisher in pending:
        for i, comp in zip(take, finisher()):
            fc = calls[i]
            out[i] = AggPartial(fc.op, fc.gkeys, fc.wends, comp=comp,
                                cache_token=fc.cache_token)
    for i, j in alias.items():
        out[i] = dataclasses.replace(out[j])
    return out
