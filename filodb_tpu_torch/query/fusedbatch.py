"""Batched fused-leaf dispatch: merge compatible panels into single
kernel launches (port of filodb_tpu/query/fusedbatch.py).  Calls of one
working set, window grid and function share a launch: sum/avg/count
panels one group-mode launch, min/max panels one per-series launch
(ops/fused.fused_leaf_agg_batch).  A histogram call's groups are
(group, bucket) slots; its finisher reshapes them to [G, W, B] and adds
the present-series count (a "hist_sum" AggPartial).

Each merged set is one entry of the kernel ledger (`fused_{fn}`,
utils/devicetelem), timed from its launch through the synchronizing
readback.  A standalone leaf's entry feeds the running node's exec
tally; a batch's (a call carrying its leaf's `stats`) is booked to the
stats of the set's first call and to that query's trace, so the sum of
device seconds over a batch's panels is the sum of its ledger entries
(the reference's exec tally drops a batch's merged launch).
"""
from __future__ import annotations

import dataclasses
import time
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
    # a batch-prepared call's owner: its leaf's QueryStats and query id,
    # which the merged launch's device seconds are booked to (None: the
    # running node's exec tally)
    stats: Optional[object] = None
    origin: str = ""

    def compat_key(self):
        base = (self.fn, self.precorrected, self.ragged)
        if self.cache_key is not None:
            return ("k",) + base + (self.cache_key,)
        return ("id",) + base + (id(self.plan), id(self.values.vals_p))


def finish_fused_calls(calls: List[FusedCall]) -> List[AggPartial]:
    """Launch every FusedCall, merging compatible ones into single kernel
    launches (identical panels dedup to one).  Phase A issues every
    merged set's launch without reading back; phase B synchronizes.
    Every merged set is recorded in the kernel ledger (see the module
    docstring)."""
    from filodb_tpu_torch.ops import fused
    from filodb_tpu_torch.utils.devicetelem import telem
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
        t0 = time.perf_counter()
        finisher = fused.fused_leaf_agg_batch(
            fc0.plan, fc0.values, panels, fc0.fn,
            precorrected=fc0.precorrected, ragged=fc0.ragged,
            num_series=fc0.num_series, lazy=True)
        pending.append((take, finisher, time.perf_counter() - t0))
    for take, finisher, disp_s in pending:
        t0 = time.perf_counter()
        comps = finisher()
        for i, comp in zip(take, comps):
            out[i] = _present(calls[i], comp)
        # launch + readback (_present's numpy conversion synchronizes)
        fc0 = calls[take[0]]
        seconds = disp_s + (time.perf_counter() - t0)
        vals_p = fc0.values.vals_p
        dev = str(vals_p.device)
        kernel = f"fused_{fc0.fn}"
        telem.record_dispatch(
            kernel, device=dev,
            shape=(f"S{fc0.num_series}xW{len(fc0.wends)}x{len(take)}p"
                   + (":ragged" if fc0.ragged else "")),
            seconds=seconds, bytes_in=int(vals_p.numel()) * 4,
            bytes_out=sum(int(getattr(c, "nbytes", 0)) for c in comps),
            origin=fc0.origin if fc0.stats is not None else None,
            note=fc0.stats is None)
        if fc0.stats is not None:
            _book_device(fc0.stats, dev, kernel, seconds)
    for i, j in alias.items():
        out[i] = dataclasses.replace(out[j])
    return out


def _book_device(stats, dev: str, kernel: str, seconds: float) -> None:
    """One kernel call booked straight into a QueryStats, as the exec
    tally would have folded it."""
    stats.device_seconds += seconds
    cell = stats.device_calls.setdefault(f"{dev}|{kernel}", [0.0, 0])
    cell[0] += seconds
    cell[1] += 1


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
