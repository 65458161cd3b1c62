"""Cross-series aggregation, the 3-phase map/reduce/present contract
(port of filodb_tpu/ops/agg.py for the slice's aggregates).

Partial aggregates keep the reference's [G, W, C] component layout
(AGGREGATORS) so partials from shards merge the same way.  The port
carries sum, avg, count, min and max.  Everything here gives the same
bits on every run: min/max are order-independent scatter reductions,
presence flags and counts are small integers (exact in f64 in any
order), and value sums run in a fixed CSR row order
(ops/fused.segment_sum), never through float atomics.
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


def _seg_count(present: torch.Tensor, gids: torch.Tensor,
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

    gids [S] on vals' device.  sum/avg value sums need `csr` (the
    grouping's ops/fused.GroupCSR, rows by group in ascending order) for
    their fixed summation order; min/max and count do not."""
    present = ~torch.isnan(vals)
    if op in ("min", "max"):
        ident = torch.full((), IDENTITY[op], dtype=vals.dtype,
                           device=vals.device)
        ext = _seg_extreme(torch.where(present, vals, ident), gids,
                           num_groups, op)
        flag = _seg_extreme(present.to(vals.dtype), gids, num_groups, "max")
        return torch.stack([ext.double(), flag.double()], dim=-1)
    if op not in ("sum", "avg", "count"):
        raise ValueError(f"unsupported aggregate {op}")
    cnt = _seg_count(present, gids, num_groups)
    if op == "count":
        return cnt[..., None]
    if csr is None:
        raise ValueError(f"map_phase {op} needs the grouping's CSR order")
    from filodb_tpu_torch.ops.fused import segment_sum
    zeroed = torch.where(present, vals.double(),
                         torch.zeros((), dtype=torch.float64,
                                     device=vals.device))
    return torch.stack([segment_sum(zeroed, csr, num_groups), cnt], dim=-1)


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
    raise ValueError(f"unsupported aggregate {op}")
