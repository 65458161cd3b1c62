"""Counter reset (drop) correction (port of filodb_tpu/ops/counter.py).

The numpy host functions are kept as they are in the reference.  The
torch functions do the same f64 correction and rebase on a tensor's own
device: the DeviceMirror runs them on the card in row chunks, because the
host version takes minutes at a million series x 720 samples.  drops,
counter_correct and total_correction_and_last are the general path's
query-time correction (ops/rangefns.py), in the values' own dtype.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from filodb_tpu_torch.ops.timewindow import series_value_base, series_value_base_t


def host_counter_correct(vals: np.ndarray) -> np.ndarray:
    """Reset-correction in f64 on HOST, before the f32 device downcast.

    Counter columns are corrected (made monotone) in f64 so that after
    per-series rebasing every delta the device computes is exact in f32 —
    including across resets, where the drop magnitude itself can exceed f32
    resolution at large counter values.  Accepts [S, T] or [S, T, B];
    NaNs pass through.
    """
    v = np.asarray(vals, dtype=np.float64)
    orig_shape = v.shape
    if v.ndim == 3:
        v = np.moveaxis(v, 2, 1).reshape(-1, orig_shape[1])
    S, T = v.shape
    valid = np.isfinite(v)
    idx = np.where(valid, np.arange(T)[None, :], -1)
    last_valid = np.maximum.accumulate(idx, axis=1)
    prev_idx = np.concatenate(
        [np.full((S, 1), -1, dtype=last_valid.dtype), last_valid[:, :-1]],
        axis=1)
    prev = np.where(prev_idx >= 0,
                    np.take_along_axis(v, np.maximum(prev_idx, 0), axis=1),
                    np.nan)
    # a reset adds the FULL previous value (the counter restarted from 0;
    # everything up to `prev` already happened); NaN samples are skipped
    # and `prev` tracks the last finite value
    drops = np.where(valid & np.isfinite(prev) & (prev > v), prev, 0.0)
    out = v + np.cumsum(drops, axis=1)
    if len(orig_shape) == 3:
        out = np.moveaxis(out.reshape(orig_shape[0], orig_shape[2],
                                      orig_shape[1]), 1, 2)
    return out


def host_counter_correct_after(prefix: np.ndarray,
                               vals: np.ndarray) -> np.ndarray:
    """host_counter_correct of `vals` as the tail of rows whose earlier
    columns are `prefix` ([S, P] or [S, P, B]): the correction the whole
    rows would get, carried into `vals` from the prefix's total correction
    and last finite value.  -> f64, the shape of `vals`."""
    if prefix.shape[1] == 0:
        return host_counter_correct(vals)
    pre = np.asarray(prefix, dtype=np.float64)
    fin = np.isfinite(pre)
    last = np.expand_dims(pre.shape[1] - 1 - fin[:, ::-1].argmax(axis=1), 1)
    has = fin.any(axis=1)
    raw_last = np.take_along_axis(pre, last, axis=1)[:, 0]
    cor_last = np.take_along_axis(host_counter_correct(pre), last,
                                  axis=1)[:, 0]
    carry = np.where(has, raw_last, np.nan)
    out = host_counter_correct(np.concatenate(
        [np.expand_dims(carry, 1), np.asarray(vals, np.float64)],
        axis=1))[:, 1:]
    return out + np.expand_dims(np.where(has, cor_last - raw_last, 0.0), 1)


def rebase_values(vals: np.ndarray, correct_counter: bool,
                  return_corrected: bool = False,
                  _block_rows: int = 65_536):
    """Host prep for device value columns: optional f64 reset correction,
    then per-series rebasing.  Returns (rebased f64, vbase [S] or [S, B]),
    plus the corrected f64 matrix when return_corrected.  Rows are
    processed in blocks; blocking changes no output bit."""
    v_in = np.asarray(vals)
    S = v_in.shape[0]
    if S <= _block_rows and v_in.dtype == np.float64:
        v64 = v_in
        if correct_counter:
            v64 = host_counter_correct(v64)
        vbase = series_value_base(v64)
        rebased = v64 - (vbase[:, None, :] if v64.ndim == 3
                         else vbase[:, None])
        return (rebased, vbase, v64) if return_corrected \
            else (rebased, vbase)
    rebased = np.empty(v_in.shape, np.float64)
    corrected = np.empty(v_in.shape, np.float64) if return_corrected \
        else None
    vbase_parts = []
    for i in range(0, S, _block_rows):
        j = min(i + _block_rows, S)
        blk = v_in[i:j].astype(np.float64)
        if correct_counter:
            blk = host_counter_correct(blk)
        vb = series_value_base(blk)
        vbase_parts.append(vb)
        rebased[i:j] = blk - (vb[:, None, :] if blk.ndim == 3
                              else vb[:, None])
        if corrected is not None:
            corrected[i:j] = blk
    if vbase_parts:
        vbase = (np.concatenate(vbase_parts) if len(vbase_parts) > 1
                 else vbase_parts[0])
    else:
        vbase = series_value_base(rebased)
    if return_corrected:
        return rebased, vbase, corrected
    return rebased, vbase


def counter_correct_t(v: torch.Tensor) -> torch.Tensor:
    """host_counter_correct for a [S, T] f64 tensor, on its own device."""
    S, T = v.shape
    valid = torch.isfinite(v)
    pos = torch.arange(T, device=v.device).expand(S, T)
    idx = torch.where(valid, pos, torch.full_like(pos, -1))
    last_valid = torch.cummax(idx, dim=1).values
    prev_idx = torch.cat([torch.full_like(last_valid[:, :1], -1),
                          last_valid[:, :-1]], dim=1)
    prev = v.gather(1, prev_idx.clamp(min=0))
    prev = torch.where(prev_idx >= 0, prev, torch.full_like(prev, float("nan")))
    drops = torch.where(valid & torch.isfinite(prev) & (prev > v), prev,
                        torch.zeros_like(v))
    return v + torch.cumsum(drops, dim=1)


def rebase_rows_t(v: torch.Tensor, correct_counter: bool):
    """rebase_values(..., return_corrected=True) for one [S, T] f64 row
    chunk already on its device -> (rebased, vbase, corrected), all f64."""
    corrected = counter_correct_t(v) if correct_counter else v
    vbase = series_value_base_t(corrected)
    return corrected - vbase[:, None], vbase, corrected


def _prev_valid(vals: torch.Tensor) -> torch.Tensor:
    """prev[s, t] = the most recent non-NaN value at an index < t (NaN if
    none): NaN gaps inside a row do not hide a reset across the gap."""
    S, T = vals.shape
    valid = ~torch.isnan(vals)
    pos = torch.arange(T, device=vals.device).expand(S, T)
    last = torch.cummax(torch.where(valid, pos, torch.full_like(pos, -1)),
                        dim=1).values
    prev_idx = torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]],
                         dim=1)
    prev = vals.gather(1, prev_idx.clamp(min=0))
    return torch.where(prev_idx >= 0, prev,
                       torch.full_like(prev, float("nan")))


def drops(vals: torch.Tensor, vbase=None) -> torch.Tensor:
    """Per-sample reset correction: the FULL previous valid value where the
    counter dropped, 0 at NaN samples.  vbase [S]: on rebased values the
    true previous raw value is prev + vbase."""
    valid = ~torch.isnan(vals)
    prev = _prev_valid(vals)
    amount = prev if vbase is None else prev + vbase[:, None]
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    return torch.where(valid & ~torch.isnan(prev) & (prev > vals), amount,
                       zero)


def counter_correct(vals: torch.Tensor, vbase=None) -> torch.Tensor:
    """Reset-corrected values: vals + cumulative drop sum; monotone per row."""
    correction = torch.cumsum(drops(vals, vbase), dim=1)
    return torch.where(torch.isnan(vals), vals, vals + correction)


def total_correction_and_last(vals: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-series (total correction, last raw value) for a carry across
    blocks."""
    S, T = vals.shape
    valid = ~torch.isnan(vals)
    total = torch.sum(drops(vals), dim=1)
    pos = torch.arange(T, device=vals.device).expand(S, T)
    last_idx = torch.where(valid, pos, torch.full_like(pos, -1)).amax(dim=1)
    last = vals.gather(1, last_idx.clamp(min=0)[:, None])[:, 0]
    return total, torch.where(last_idx >= 0, last,
                              torch.full_like(last, float("nan")))
