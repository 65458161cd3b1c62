"""min/max_over_time + cross-series aggregation over one shared scrape
grid (port of filodb_tpu/ops/pallas_fused.py uniform_window_geometry and
fused_minmax_agg).

The reference runs these through XLA's lax.reduce_window, not a Pallas
kernel (a windowed order statistic is not a matmul).  The counterpart
here is torch ops on the values' device: Tensor.unfold gives each
(series, window) its strided span of the grid as a view (no copy), amin
/ amax reduce it, and ops/agg.map_phase groups the [S, W] result.  Min
and max are exact and independent of order, so the result has the same
bits on every run.

The per-series base is added after the reduction: rounding is monotone,
so min(fl(v + b)) == fl(min(v) + b) for every window, and the [S, T]
absolute copy the reference makes is never built.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def uniform_window_geometry(ts_row: np.ndarray, wends: np.ndarray,
                            range_ms: int
                            ) -> Optional[Tuple[int, int, int, int]]:
    """(first0, stride_samples, width_samples, t_needed) when every window
    covers a constant-width, constant-stride span of the (conceptually
    extended) uniform grid, else None.  Closed-form from the grid spacing,
    so windows hanging past the data's right edge (the `end=now` dashboard
    shape) stay uniform: t_needed > len(ts_row) tells the caller to
    NaN-pad that tail and run the ragged variant.  Irregular grids or
    steps and left-clipped windows give None."""
    ts_row = np.asarray(ts_row, dtype=np.int64)
    wend = np.asarray(wends, dtype=np.int64)
    T = ts_row.size
    if wend.size == 0 or T < 2:
        return None
    d = int(ts_row[1] - ts_row[0])
    if d <= 0 or (np.diff(ts_row) != d).any():
        return None
    t0 = int(ts_row[0])
    if wend.size > 1:
        s = int(wend[1] - wend[0])
        if s <= 0 or (np.diff(wend) != s).any() or s % d:
            return None
        stride = s // d
    else:
        stride = 1
    f0 = -(-(int(wend[0]) - int(range_ms) + 1 - t0) // d)      # ceil div
    l0 = (int(wend[0]) - t0) // d
    width = l0 - f0 + 1
    if f0 < 0 or width < 1:
        return None
    t_needed = l0 + stride * (wend.size - 1) + 1
    return f0, stride, width, t_needed


def window_minmax(vals: torch.Tensor, vbase: Optional[torch.Tensor],
                  f0: int, stride: int, width: int, W: int, fn_name: str,
                  ragged: bool) -> torch.Tensor:
    """vals [S, T] f32 (rebased; absolute = vals + vbase) -> [S, W] f32
    per-series min/max_over_time, NaN where a window holds no valid
    sample.  Absence comes from a valid count, never from the +/-inf
    start value: +/-Inf are legal samples."""
    if fn_name not in ("min_over_time", "max_over_time"):
        raise ValueError(f"not a windowed min/max function: {fn_name}")
    is_min = fn_name == "min_over_time"
    seg = vals[:, f0:f0 + stride * (W - 1) + width]
    init = float("inf") if is_min else float("-inf")
    if ragged:
        valid = seg == seg
        seg = torch.where(valid, seg, torch.full((), init, dtype=seg.dtype,
                                                 device=seg.device))
    spans = seg.unfold(1, width, stride)               # [S, W, width] view
    red = spans.amin(dim=-1) if is_min else spans.amax(dim=-1)
    if vbase is not None:
        red = red + vbase.to(red.dtype)[:, None]
    if ragged:
        present = valid.unfold(1, width, stride).any(dim=-1)
        red = torch.where(present, red, torch.full((), float("nan"),
                                                   dtype=red.dtype,
                                                   device=red.device))
    return red


def fused_minmax_agg(vals: torch.Tensor, vbase: Optional[torch.Tensor],
                     gids: torch.Tensor, f0: int, stride: int, width: int,
                     W: int, fn_name: str, agg_op: str, num_groups: int,
                     ragged: bool, csr=None) -> torch.Tensor:
    """min/max_over_time + group aggregation -> partial components
    [G, W, C] f64 (ops/agg.AGGREGATORS layout).  gids [S] on vals' device;
    `csr` (the grouping's ops/fused.GroupCSR) fixes the summation order of
    the sum/avg aggregates."""
    from filodb_tpu_torch.ops import agg as agg_ops
    red = window_minmax(vals, vbase, f0, stride, width, W, fn_name, ragged)
    return agg_ops.map_phase(agg_op, red, gids, num_groups, csr=csr)
