"""Row selection for the non-leaf nodes (port of filodb_tpu/ops/select.py).

gather_binop applies a vector-matching binary operator to the rows the
host resolved label matching into (the (mi, oi) index maps), on the
values' own device; topk_keep_rows keeps the rows of a candidate partial
that make some window's top/bottom k.
"""
from __future__ import annotations

import torch

from filodb_tpu_torch.ops.agg import topk_mask
from filodb_tpu_torch.ops.instant import apply_binary_op


def gather_binop(lhs_vals: torch.Tensor, rhs_vals: torch.Tensor,
                 mi: torch.Tensor, oi: torch.Tensor, *, op: str,
                 bool_modifier: bool = False,
                 keep_side: str = "lhs") -> torch.Tensor:
    """lhs_vals[mi] <op> rhs_vals[oi] -> [P, W] with PromQL absent/NaN
    semantics (ops/instant.apply_binary_op)."""
    a = lhs_vals.index_select(0, mi.to(lhs_vals.device).long())
    b = rhs_vals.index_select(0, oi.to(rhs_vals.device).long())
    return apply_binary_op(a, b, op=op, bool_modifier=bool_modifier,
                           keep_side=keep_side)


def topk_keep_rows(vals: torch.Tensor, group_ids: torch.Tensor,
                   num_groups: int, k: int,
                   largest: bool = True) -> torch.Tensor:
    """[N] bool: the row makes its group's top/bottom k in at least one
    window, so no global top/bottom k over a union can need the others."""
    return topk_mask(vals, group_ids, num_groups, k, largest=largest).any(dim=1)
