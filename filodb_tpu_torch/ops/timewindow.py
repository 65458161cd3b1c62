"""Window-grid host helpers (port of filodb_tpu/ops/timewindow.py).

Timestamps become int32 millisecond offsets from a per-upload int64 base,
and values are rebased per series before the f32 downcast.  The numpy
host halves build the grid; window_bounds, gather_at and
windowed_cumsum_delta are the device halves the general path's range
functions (ops/rangefns.py) run on the tensors' own device.
"""
from __future__ import annotations

import numpy as np
import torch

# Padding sentinel for ts offsets beyond each row's sample count.  Chosen well
# below int32 max so `pad + range_ms` cannot overflow.
PAD_TS = np.int32(1 << 30)


def make_window_ends(start_ms: int, end_ms: int, step_ms: int) -> np.ndarray:
    """Absolute output step timestamps: start, start+step, ..., <= end
    (PromQL range-query grid)."""
    return np.arange(start_ms, end_ms + 1, step_ms, dtype=np.int64)


def to_offsets(ts: np.ndarray, counts: np.ndarray, base_ms: int) -> np.ndarray:
    """Host-side: int64 absolute ms -> padded int32 offsets from base."""
    pos = np.arange(ts.shape[1])[None, :]
    off = np.clip(ts - base_ms, -(1 << 30), 1 << 30).astype(np.int32)
    return np.where(pos < counts[:, None], off, PAD_TS)


def series_value_base(vals: np.ndarray) -> np.ndarray:
    """Host-side per-series value base for f64->f32 rebasing: the first
    finite value along time.  [S, T] -> [S]; [S, T, B] -> [S, B].

    Subtracting this in f64 BEFORE the device downcast keeps counter deltas
    exact in f32 even for counters >= 2^24, where absolute f32 storage loses
    every per-sample increment."""
    finite = np.isfinite(vals)
    first = finite.argmax(axis=1)
    if vals.ndim == 3:
        base = np.take_along_axis(vals, first[:, None, :], axis=1)[:, 0, :]
    else:
        base = vals[np.arange(vals.shape[0]), first]
    return np.where(finite.any(axis=1), base, 0.0)


def series_value_base_t(vals: torch.Tensor) -> torch.Tensor:
    """series_value_base on a [S, T] tensor, on the tensor's device."""
    finite = torch.isfinite(vals)
    first = finite.to(torch.uint8).argmax(dim=1)
    base = vals.gather(1, first[:, None])[:, 0]
    return torch.where(finite.any(dim=1), base, torch.zeros_like(base))


def window_bounds(ts_off: torch.Tensor, wstart: torch.Tensor,
                  wend: torch.Tensor):
    """Per (series, window) first/last sample indices and counts.

    ts_off: int32 [S, T], ascending per row, PAD_TS beyond each row's
    count (S = 1 for a shared grid).  wstart/wend: int32 [W] inclusive
    window bounds.  Returns int32 (first [S, W], last [S, W], n [S, W]);
    n == 0 means an empty window."""
    S = ts_off.shape[0]
    ts = ts_off.contiguous()
    lo = wstart.to(ts.dtype)[None, :].expand(S, -1).contiguous()
    hi = wend.to(ts.dtype)[None, :].expand(S, -1).contiguous()
    first = torch.searchsorted(ts, lo, side="left", out_int32=True)
    last = torch.searchsorted(ts, hi, side="right", out_int32=True) - 1
    n = torch.clamp(last - first + 1, min=0)
    return first, last, n


def gather_at(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[s, idx[s, w]] -> [S, W], idx clipped (the caller masks).  A
    [1, W] idx (shared grid) is one column selection; a [1, T] arr at
    per-series indices reads the one row."""
    safe = torch.clamp(idx, 0, arr.shape[1] - 1).long()
    if safe.shape[0] == 1 and arr.shape[0] != 1:
        return arr.index_select(1, safe[0])
    if arr.shape[0] == 1 and safe.shape[0] != 1:
        return arr[0][safe]
    return torch.gather(arr, 1, safe)


def windowed_cumsum_delta(csum: torch.Tensor, first: torch.Tensor,
                          last: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Window sums from an inclusive cumulative sum along time:
    csum[last] - csum[first - 1], 0 where the window is empty -> [S, W]."""
    hi = gather_at(csum, last)
    zero = torch.zeros((), dtype=csum.dtype, device=csum.device)
    lo = torch.where(first > 0, gather_at(csum, first - 1), zero)
    return torch.where(n > 0, hi - lo, zero)
