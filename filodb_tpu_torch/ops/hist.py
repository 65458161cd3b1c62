"""Histogram kernels over dense bucket matrices: histogram_quantile (with
its numpy twin), histogram_bucket and hist_sum_rv (port of
filodb_tpu/ops/hist.py), and the bucket-row layout.

Buckets are cumulative counts with ascending `le` upper bounds, the last
one +Inf, laid out [S, W, B] with `les` [B].  The quantile is
Prometheus's algorithm: the first bucket whose cumulative count reaches
q * total, then linear interpolation inside it.  A numpy array takes the
numpy twin, as the reference does for host arrays; a tensor is computed
on its own device.
"""
from __future__ import annotations

import numpy as np
import torch


# The bucket-row layout: a histogram column [S, T, B] runs through the
# per-series machinery (counter correction, range functions, the fused
# kernels) as S*B rows, bucket-major within a series (row s * B + b); the
# fused leaf's (group, bucket) slots follow it (slot g * B + b).  Numpy
# arrays and tensors alike.

def bucket_rows(x):
    """[S, T, B] -> [S*B, T], row s * B + b = bucket b of series s."""
    S, T, B = x.shape
    return x.swapaxes(1, 2).reshape(S * B, T)


def from_bucket_rows(x, B: int):
    """[S*B, W] rows (or slots) -> [S, W, B]: bucket_rows' inverse."""
    return x.reshape(-1, B, x.shape[1]).swapaxes(1, 2)


def bucket_slots(gids, B: int) -> np.ndarray:
    """Per-series group ids [S] -> the slot of each bucket row [S*B]."""
    return (np.asarray(gids, np.int64)[:, None] * B
            + np.arange(B)[None, :]).reshape(-1)


def histogram_quantile(q, buckets, les):
    """q scalar, buckets [S, W, B] cumulative counts, les [B] -> [S, W].

    Prometheus semantics: rank = q * total; the first bucket with
    cumulative >= rank; linear interpolation within [lower le, upper le].
    The +Inf bucket gives the highest finite le; the first bucket
    interpolates from 0 (from its le when that le <= 0).  q < 0 -> -Inf,
    q > 1 -> +Inf, an empty histogram -> NaN."""
    if isinstance(buckets, np.ndarray):
        return _histogram_quantile_np(float(q), buckets, np.asarray(les))
    return _histogram_quantile_t(float(q), buckets, les)


def _histogram_quantile_t(q: float, buckets: torch.Tensor,
                          les) -> torch.Tensor:
    B = buckets.shape[-1]
    dt, dev = buckets.dtype, buckets.device
    les = torch.as_tensor(les, dtype=dt, device=dev)
    # monotone non-decreasing cumulative counts (Prometheus'
    # ensureMonotonic fixup for float jitter)
    cum = torch.cummax(buckets, dim=-1).values
    total = cum[..., -1]
    rank = q * total
    ge = cum >= rank[..., None]
    idx = torch.argmax(ge.to(torch.uint8), dim=-1)     # first True
    idx = torch.where(ge.any(dim=-1), idx, torch.full_like(idx, B - 1))
    les_b = les.expand(buckets.shape)
    zero = torch.zeros((), dtype=dt, device=dev)

    def take(a, i):
        return a.gather(-1, i[..., None])[..., 0]
    count_at = take(cum, idx)
    le_at = take(les_b, idx)
    prev_idx = torch.clamp(idx - 1, min=0)
    count_prev = torch.where(idx > 0, take(cum, prev_idx), zero)
    le_prev = torch.where(idx > 0, take(les_b, prev_idx), zero)
    # a first bucket with a negative upper bound: its lower bound is its le
    le_prev = torch.where((idx == 0) & (le_at <= 0), le_at, le_prev)
    bucket_count = count_at - count_prev
    frac = torch.where(bucket_count > 0, (rank - count_prev) / bucket_count,
                       zero)
    interp = le_prev + (le_at - le_prev) * frac
    finite_les = torch.where(torch.isinf(les),
                             torch.full((), float("-inf"), dtype=dt,
                                        device=dev), les)
    out = torch.where(torch.isinf(le_at), finite_les.max(), interp)
    nan = torch.full((), float("nan"), dtype=dt, device=dev)
    out = torch.where(total > 0, out, nan)
    out = torch.where(torch.isnan(rank), nan, out)
    if q < 0:
        out = torch.full_like(out, float("-inf"))
    elif q > 1:
        out = torch.full_like(out, float("inf"))
    return out


def _histogram_quantile_np(q: float, buckets: np.ndarray,
                           les: np.ndarray) -> np.ndarray:
    """Numpy twin of histogram_quantile: the same semantics on the host."""
    B = buckets.shape[-1]
    cum = np.maximum.accumulate(buckets, axis=-1)
    total = cum[..., -1]
    rank = q * total
    ge = cum >= rank[..., None]
    idx = np.argmax(ge, axis=-1)
    idx = np.where(~np.any(ge, axis=-1), B - 1, idx)
    les_b = np.broadcast_to(les, buckets.shape)

    def take(a, i):
        return np.take_along_axis(a, i[..., None], axis=-1)[..., 0]
    count_at = take(cum, idx)
    le_at = take(les_b, idx)
    prev_idx = np.maximum(idx - 1, 0)
    count_prev = np.where(idx > 0, take(cum, prev_idx), 0.0)
    le_prev = np.where(idx > 0, take(les_b, prev_idx), 0.0)
    le_prev = np.where((idx == 0) & (le_at <= 0), le_at, le_prev)
    bucket_count = count_at - count_prev
    with np.errstate(invalid="ignore", divide="ignore"):
        frac = np.where(bucket_count > 0,
                        (rank - count_prev) / bucket_count, 0.0)
    interp = le_prev + (le_at - le_prev) * frac
    finite_les = np.where(np.isinf(les), -np.inf, les)
    out = np.where(np.isinf(le_at), np.max(finite_les), interp)
    out = np.where(total > 0, out, np.nan)
    out = np.where(np.isnan(rank), np.nan, out)
    if q < 0:
        out = np.full_like(out, -np.inf)
    elif q > 1:
        out = np.full_like(out, np.inf)
    return out


def histogram_bucket(le: float, buckets: torch.Tensor,
                     les) -> torch.Tensor:
    """One bucket's series [S, W] by its upper bound; NaN when no bucket
    has that bound."""
    les = torch.as_tensor(les, dtype=buckets.dtype, device=buckets.device)
    le_t = torch.tensor(float(le), dtype=buckets.dtype,
                        device=buckets.device)
    matches = torch.isclose(les, le_t) | (torch.isinf(les)
                                          & torch.isinf(le_t))
    if not bool(matches.any()):
        return torch.full(buckets.shape[:-1], float("nan"),
                          dtype=buckets.dtype, device=buckets.device)
    return buckets[..., int(torch.argmax(matches.to(torch.uint8)))]


def hist_sum_rv(buckets: torch.Tensor) -> torch.Tensor:
    """Sum across series of bucket matrices, NaN-aware: [S, W, B] ->
    [W, B], NaN where no series is present."""
    present = ~torch.isnan(buckets)
    s = torch.where(present, buckets, torch.zeros_like(buckets)).sum(dim=0)
    return torch.where(present.any(dim=0), s, torch.full_like(s,
                                                              float("nan")))
