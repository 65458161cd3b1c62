"""Cross-series aggregation, the 3-phase map/reduce/present contract
(port of filodb_tpu/ops/agg.py).

Partial aggregates keep the reference's [G, W, C] component layout
(AGGREGATORS) so partials from shards merge the same way; topk, bottomk
and quantile keep their candidate rows instead (topk_mask,
quantile_agg).  Everything here gives the same bits on every run:
min/max/group are order-independent scatter reductions, presence flags
and counts are small integers (exact in f64 in any order), value sums
(sum, avg, stddev, stdvar) run in a fixed CSR row order
(ops/fused.segment_sum), never through float atomics, and the rank
aggregates sort stably.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch


class AggSpec(NamedTuple):
    num_components: int
    # one op for every component, or a per-component tuple
    # ('sum' | 'min' | 'max')
    combiner: object


AGGREGATORS: Dict[str, AggSpec] = {
    "sum":    AggSpec(2, "sum"),     # (sum, count) — count masks empty steps
    "count":  AggSpec(1, "sum"),
    "avg":    AggSpec(2, "sum"),     # (sum, count)
    # min/max carry an explicit presence flag (combined with max = OR):
    # the +/-inf identity alone cannot mark absence because +/-Inf are
    # legal sample values the result must preserve
    "min":    AggSpec(2, ("min", "max")),   # (min-or-+inf, present)
    "max":    AggSpec(2, ("max", "max")),   # (max-or--inf, present)
    "stddev": AggSpec(3, "sum"),     # (sum, sumsq, count)
    "stdvar": AggSpec(3, "sum"),
    "group":  AggSpec(1, "max"),     # group() = 1 for any present series
}

IDENTITY = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}
"""The start value of each combiner (a merge starts from it, not from 0)."""


def combiners_for(op: str, ncomp: int):
    """Normalized per-component combiner tuple for an op's partials."""
    comb = AGGREGATORS.get(op, AggSpec(1, "sum")).combiner
    return comb if isinstance(comb, tuple) else (comb,) * ncomp


def _seg_extreme(x: torch.Tensor, gids: torch.Tensor, num_groups: int,
                 comb: str) -> torch.Tensor:
    """[S, W] -> [G, W] segment min/max from the combiner's identity (an
    empty group keeps it, as jax.ops.segment_min/max do).  gids lie in
    [0, G): one group is a plain column reduction, which spares the card
    S-way atomic contention on W cells."""
    out = torch.full((num_groups, x.shape[1]), IDENTITY[comb],
                     dtype=x.dtype, device=x.device)
    if num_groups == 1 and x.shape[0]:
        red = x.amin(0, keepdim=True) if comb == "min" \
            else x.amax(0, keepdim=True)
        return torch.minimum(out, red) if comb == "min" \
            else torch.maximum(out, red)
    idx = gids.long()[:, None].expand(-1, x.shape[1])
    return out.scatter_reduce_(0, idx, x, "amin" if comb == "min" else "amax",
                               include_self=True)


def seg_count(present: torch.Tensor, gids: torch.Tensor,
               num_groups: int) -> torch.Tensor:
    """[S, W] bool -> [G, W] f64 counts, summed as integers (no float
    atomics; exact in any order)."""
    if num_groups == 1:
        return present.sum(0, keepdim=True, dtype=torch.int64).double()
    out = torch.zeros((num_groups, present.shape[1]), dtype=torch.int64,
                      device=present.device)
    return out.index_add_(0, gids.long(), present.long()).double()


def map_phase(op: str, vals: torch.Tensor, gids: torch.Tensor,
              num_groups: int, csr=None) -> torch.Tensor:
    """vals [S, W] (NaN absent) -> partial components [G, W, C] f64.

    gids [S] on vals' device.  The value sums (sum, avg, stddev, stdvar)
    need `csr` (the grouping's ops/fused.GroupCSR, rows by group in
    ascending order) for their fixed summation order; the others do not."""
    present = ~torch.isnan(vals)
    if op in ("min", "max"):
        ident = torch.full((), IDENTITY[op], dtype=vals.dtype,
                           device=vals.device)
        ext = _seg_extreme(torch.where(present, vals, ident), gids,
                           num_groups, op)
        flag = _seg_extreme(present.to(vals.dtype), gids, num_groups, "max")
        return torch.stack([ext.double(), flag.double()], dim=-1)
    if op == "group":
        one = torch.where(present, 1.0, float("-inf")).double()
        return _seg_extreme(one, gids, num_groups, "max")[..., None]
    if op not in ("sum", "avg", "count", "stddev", "stdvar"):
        raise ValueError(f"unsupported aggregate {op}")
    cnt = seg_count(present, gids, num_groups)
    if op == "count":
        return cnt[..., None]
    if csr is None:
        raise ValueError(f"map_phase {op} needs the grouping's CSR order")
    from filodb_tpu_torch.ops.fused import segment_sum
    zeroed = torch.where(present, vals.double(),
                         torch.zeros((), dtype=torch.float64,
                                     device=vals.device))
    planes = [segment_sum(zeroed, csr, num_groups)]
    if op in ("stddev", "stdvar"):
        planes.append(segment_sum(zeroed * zeroed, csr, num_groups))
    return torch.stack(planes + [cnt], dim=-1)


def reduce_phase(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Combine two partials [G, W, C] (inter-shard reduce)."""
    if op not in AGGREGATORS:
        raise ValueError(f"unsupported aggregate {op}")
    combs = combiners_for(op, a.shape[-1])

    def one(comb, x, y):
        if comb == "sum":
            return x + y
        return torch.minimum(x, y) if comb == "min" else torch.maximum(x, y)
    if len(set(combs)) == 1:
        return one(combs[0], a, b)
    return torch.stack([one(c, a[..., i], b[..., i])
                        for i, c in enumerate(combs)], dim=-1)


def identity_partial(op: str, G: int, W: int, C: int) -> torch.Tensor:
    """[G, W, C] f64 filled with each component's combiner identity: the
    start of an inter-shard merge."""
    out = torch.empty((G, W, C), dtype=torch.float64)
    for i, comb in enumerate(combiners_for(op, C)):
        out[..., i] = IDENTITY[comb]
    return out


def present(op: str, partial: torch.Tensor) -> torch.Tensor:
    """Partial components [G, W, C] -> final [G, W] (NaN where no series)."""
    nan = torch.full_like(partial[..., 0], float("nan"))
    if op in ("sum", "min", "max"):
        v, c = partial[..., 0], partial[..., 1]
        return torch.where(c > 0, v, nan)
    if op == "count":
        c = partial[..., 0]
        return torch.where(c > 0, c, nan)
    if op == "avg":
        s, c = partial[..., 0], partial[..., 1]
        return torch.where(c > 0, s / torch.clamp(c, min=1.0), nan)
    if op in ("stddev", "stdvar"):
        s, s2, c = partial[..., 0], partial[..., 1], partial[..., 2]
        cs = torch.clamp(c, min=1.0)
        var = torch.clamp(s2 / cs - (s / cs) ** 2, min=0.0)
        out = torch.sqrt(var) if op == "stddev" else var
        return torch.where(c > 0, out, nan)
    if op == "group":
        v = partial[..., 0]
        return torch.where(torch.isinf(v), nan, v)
    raise ValueError(f"unsupported aggregate {op}")


def aggregate(op: str, vals: torch.Tensor, gids: torch.Tensor,
              num_groups: int, csr=None) -> torch.Tensor:
    """Single-shard shortcut: map + present -> [G, W] f64."""
    return present(op, map_phase(op, vals, gids, num_groups, csr))


# ----------------------------------------------------------- rank aggregates

def _group_sorted(key: torch.Tensor, gids: torch.Tensor):
    """Per column, the rows ordered by (group ascending, key ascending),
    ties in row order (a stable lexsort) -> order [S, W] int64."""
    by_key = torch.sort(key, dim=0, stable=True).indices
    by_group = torch.sort(gids.long()[by_key], dim=0, stable=True).indices
    return by_key.gather(0, by_group)


def _group_starts(gids: torch.Tensor, num_groups: int) -> torch.Tensor:
    """[G] first position of each group in a group-sorted column."""
    size = torch.bincount(gids.long(), minlength=num_groups)[:num_groups]
    return torch.cumsum(size, 0) - size


def topk_mask(vals: torch.Tensor, gids: torch.Tensor, num_groups: int,
              k: int, largest: bool = True) -> torch.Tensor:
    """Per-(group, step) top/bottom-k selection mask [S, W]: each value's
    rank within its group per step by a stable sort on (group, value
    descending for topk), as the reference's lexsort."""
    S, W = vals.shape
    if S == 0:
        return torch.zeros((0, W), dtype=torch.bool, device=vals.device)
    fill = float("-inf") if largest else float("inf")
    key = torch.where(torch.isnan(vals), torch.full((), fill,
                                                    dtype=vals.dtype,
                                                    device=vals.device),
                      vals)
    order = _group_sorted(-key if largest else key, gids)
    g_sorted = gids.long()[order]
    pos = torch.arange(S, device=vals.device)[:, None]
    rank_sorted = pos - _group_starts(gids, num_groups)[g_sorted]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    return (rank < k) & ~torch.isnan(vals)


def quantile_agg(vals: torch.Tensor, gids: torch.Tensor, num_groups: int,
                 q: float) -> torch.Tensor:
    """quantile(q, expr) by group -> [G, W], exact (sort-based): within
    each group's sorted present values, linear interpolation between
    ranks floor and ceil of q * (count - 1).  As the reference, `count`
    leaves out ±Inf samples while the sort keeps them, so a group holding
    one differs from Prometheus (ROADMAP Queue 3)."""
    S, W = vals.shape
    dev = vals.device
    inf = torch.full((), float("inf"), dtype=vals.dtype, device=dev)
    present = ~torch.isnan(vals)
    key = torch.where(present, vals, inf)
    order = _group_sorted(key, gids)
    srt = key.gather(0, order)
    n_present = torch.zeros((num_groups, W), dtype=torch.int64, device=dev)
    n_present.index_add_(0, gids.long(), present.long())
    cnt = torch.zeros((num_groups, W), dtype=torch.int64, device=dev)
    cnt.index_add_(0, gids.long(), (~torch.isinf(key)).long())
    rank = q * (cnt.to(vals.dtype) - 1.0)
    lo = torch.clamp(torch.floor(rank).long(), 0, S - 1)
    hi = torch.clamp(torch.ceil(rank).long(), 0, S - 1)
    frac = rank - lo.to(vals.dtype)
    start = _group_starts(gids, num_groups)[:, None]

    def at(i):
        # past the group's present values the reference reads its +inf
        # padding, as in its per-group [S, W] sort
        v = srt.gather(0, torch.clamp(start + i, max=max(S - 1, 0)))
        return torch.where(i < n_present, v, inf)
    vlo, vhi = at(lo), at(hi)
    out = vlo + (vhi - vlo) * frac
    return torch.where(cnt > 0, out, torch.full_like(out, float("nan")))
