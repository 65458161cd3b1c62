"""Mergeable quantile sketch for distributed aggregation (port of
filodb_tpu/ops/sketch.py, a numpy copy).

The reference aggregates `quantile()` across shards with t-digest partials
(ref: query/.../exec/aggregator/QuantileRowAggregator.scala:87 — serialized
TDigest per group/window) so the wire cost is O(groups), not O(series).
This is the numpy equivalent: per (group, window) an equal-depth centroid
summary [K, 2] of (mean, weight), built vectorized over the window axis.

Properties:
- exact when a cell holds <= K samples (centroids are singletons, and the
  quantile interpolation below reduces to Prometheus' linear interpolation
  over sorted values);
- mergeable: concatenate centroid lists, re-compress to K by cumulative
  weight (same shape regardless of how many shards contributed);
- bounded size: K*(2 float64) per (group, window) on the wire.
"""
from __future__ import annotations

import numpy as np

K_DEFAULT = 64


def sketch_from_values(vals: np.ndarray, gids: np.ndarray, num_groups: int,
                       k: int = K_DEFAULT) -> np.ndarray:
    """Build [G, W, K, 2] sketches from per-series values [N, W] with group
    assignment gids [N].  NaN samples are absent.  Slot 0 = mean, 1 = weight
    (weight 0 = unused centroid, mean NaN)."""
    N, W = vals.shape
    out = np.zeros((num_groups, W, k, 2))
    out[..., 0] = np.nan
    # one stable sort, then contiguous slices per group — O(N log N) total
    # instead of a full boolean mask per group (O(G*N))
    order = np.argsort(gids, kind="stable")
    sorted_gids = gids[order]
    g_ids = np.arange(num_groups)
    starts = np.searchsorted(sorted_gids, g_ids, side="left")
    ends = np.searchsorted(sorted_gids, g_ids, side="right")
    for g in range(num_groups):
        rows = vals[order[starts[g]:ends[g]]]         # [n_g, W]
        n_g = rows.shape[0]
        if n_g == 0:
            continue
        srt = np.sort(rows, axis=0)                   # NaN sorts last
        cnt = (~np.isnan(rows)).sum(axis=0)           # [W]
        if n_g <= k:
            # singleton centroids: exact
            out[g, :, :n_g, 0] = srt.T
            pos = np.arange(n_g)[None, :]
            out[g, :, :n_g, 1] = (pos < cnt[:, None]).astype(float)
            out[g, :, :n_g, 0] = np.where(out[g, :, :n_g, 1] > 0,
                                          out[g, :, :n_g, 0], np.nan)
            continue
        # equal-depth bins per window: bin i covers sorted ranks
        # [floor(i*c/k), floor((i+1)*c/k))
        cs = np.nancumsum(srt, axis=0)                # [n_g, W]
        cs = np.vstack([np.zeros((1, W)), cs])        # prefix sums, 1-indexed
        edges = (np.arange(k + 1)[:, None] * cnt[None, :]) // k   # [k+1, W]
        lo, hi = edges[:-1], edges[1:]                # [k, W]
        w = (hi - lo).astype(float)
        sums = np.take_along_axis(cs, hi, axis=0) - \
            np.take_along_axis(cs, lo, axis=0)
        mean = np.divide(sums, w, out=np.full_like(sums, np.nan),
                         where=w > 0)
        out[g, :, :, 0] = mean.T
        out[g, :, :, 1] = w.T
    return out


def _centroid_order(means: np.ndarray, wts: np.ndarray) -> np.ndarray:
    """Content-based total order over the centroid axis: live before
    dead, then by (mean, weight).  A pure function of the centroid
    MULTISET — centroids tied on both mean and weight are identical and
    interchangeable — so every consumer below is insensitive to the
    order shards/nodes concatenated in (a mean-only sort left equal-
    mean ties at the mercy of concat order, which broke bit-identity
    once node-level pushdown regrouped the shard merge tree)."""
    key_mean = np.where(wts > 0, means, np.inf)
    key_wt = np.where(wts > 0, wts, np.inf)
    return np.lexsort((key_wt, key_mean), axis=-1)


def merge_sketches(sk: np.ndarray, k: int = K_DEFAULT) -> np.ndarray:
    """Compress [G, W, M, 2] (concatenated centroids) back to [G, W, K, 2].
    Whole centroids are assigned to equal-weight bins by their cumulative
    weight midpoint; bin mean is the weighted mean of its centroids."""
    G, W, M, _ = sk.shape
    if M <= k:
        out = np.zeros((G, W, k, 2))
        out[..., 0] = np.nan
        out[:, :, :M] = sk
        return out
    means, wts = sk[..., 0], sk[..., 1]
    order = _centroid_order(means, wts)
    means = np.take_along_axis(means, order, axis=-1)
    wts = np.take_along_axis(wts, order, axis=-1)
    cum = np.cumsum(wts, axis=-1)
    total = cum[..., -1:]                             # [G, W, 1]
    mid = cum - wts / 2.0
    with np.errstate(invalid="ignore", divide="ignore"):
        bin_idx = np.where(total > 0,
                           (mid / total * k).astype(np.int64), 0)
    bin_idx = np.clip(bin_idx, 0, k - 1)
    # segment-sum weights and weight*mean into bins
    gw = np.repeat(np.arange(G * W), M)
    flat_bin = bin_idx.reshape(-1)
    idx = gw * k + flat_bin
    wsum = np.zeros(G * W * k)
    msum = np.zeros(G * W * k)
    fw = wts.reshape(-1)
    fm = np.where(np.isnan(means), 0.0, means).reshape(-1)
    np.add.at(wsum, idx, fw)
    np.add.at(msum, idx, fm * fw)
    wsum = wsum.reshape(G, W, k)
    msum = msum.reshape(G, W, k)
    out = np.zeros((G, W, k, 2))
    out[..., 1] = wsum
    with np.errstate(invalid="ignore"):
        out[..., 0] = np.where(wsum > 0, msum / np.maximum(wsum, 1e-300),
                               np.nan)
    return out


def sketch_quantile(sk: np.ndarray, q: float) -> np.ndarray:
    """Estimate the q-quantile per (group, window) cell -> [G, W].

    Centroid i of weight w_i occupies sample ranks
    [cum_{i-1}, cum_{i-1}+w_i); its representative rank is the midpoint
    cum_{i-1} + (w_i - 1)/2.  Linear interpolation between representative
    ranks reproduces Prometheus' `quantile()` exactly for singleton
    centroids and is the standard t-digest estimator otherwise."""
    means, wts = sk[..., 0], sk[..., 1]
    order = _centroid_order(means, wts)
    means = np.take_along_axis(means, order, axis=-1)
    wts = np.take_along_axis(wts, order, axis=-1)
    cum = np.cumsum(wts, axis=-1)
    total = cum[..., -1]                              # [G, W]
    rank = np.where(wts > 0, cum - wts + (wts - 1) / 2.0, np.inf)
    target = q * (total - 1.0)                        # [G, W]
    if q < 0:
        return np.where(total > 0, -np.inf, np.nan)
    if q > 1:
        return np.where(total > 0, np.inf, np.nan)
    # hi = first LIVE centroid whose rank >= target; lo = hi - 1.  Dead
    # (weight-0) centroids must not win — their rank is +inf and their mean
    # NaN, which would turn high quantiles into NaN whenever live and dead
    # slots coexist (e.g. after a merge with a sparse shard)
    ge = (rank >= target[..., None]) & (wts > 0)
    hi = np.argmax(ge, axis=-1)
    any_ge = ge.any(axis=-1)
    last_live = np.maximum((wts > 0).sum(axis=-1) - 1, 0)
    hi = np.where(any_ge, hi, last_live)
    lo = np.maximum(hi - 1, 0)
    take = lambda a, i: np.take_along_axis(a, i[..., None], axis=-1)[..., 0]  # noqa: E731
    r_lo, r_hi = take(rank, lo), take(rank, hi)
    m_lo, m_hi = take(means, lo), take(means, hi)
    first_rank = take(rank, np.zeros_like(hi))
    span = np.where(r_hi > r_lo, r_hi - r_lo, 1.0)
    frac = np.clip((target - r_lo) / span, 0.0, 1.0)
    est = m_lo + (m_hi - m_lo) * frac
    est = np.where(target <= first_rank, take(means, np.zeros_like(hi)), est)
    return np.where(total > 0, est, np.nan)
