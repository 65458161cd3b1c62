"""Host numpy evaluation of small fused-leaf working sets, and the batch
gather memo (port of filodb_tpu/ops/hostleaf.py).

The host side of the leaf's cost-based router: the same (fusable fn x
aggregate) set as ops/fused.py, dense shared-grid working sets only,
computed with vectorized numpy straight from the FusedPlan's indices.
Ragged and histogram sets stay on the device paths.  The formulas are
the kernels' (same boundary indices, same extrapolation) in f64.

The routing decision lives in query/leafexec.py (threshold
`query.host_route_max_samples`) and is observable through the
`leaf_host_routed` counter.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np

from filodb_tpu_torch.utils.counters import counters

# ----------------------------------------------------- batch gather memo
#
# Under engine.query_range_batch, N panels over one working set would
# each run the same windowed host gather and its post-processing
# (offsets, reset correction, rebasing) during their fused preflight.
# The engine opens this scope around the batch's prepare phase; the
# leaf's host gather and its host-routed partials consult it, so the
# working set is scanned and processed once and the arrays are shared
# (every consumer reads them and never writes them).  The scope is
# thread-local: concurrent batches on other threads never see each
# other's entries, and outside a scope the memo is inert.

_MEMO = threading.local()


@contextlib.contextmanager
def batch_gather_memo():
    """Scope the gather memo over one batch's prepare phase."""
    prev = getattr(_MEMO, "entries", None)
    _MEMO.entries = {}
    try:
        yield
    finally:
        _MEMO.entries = prev


def memo_active() -> bool:
    """A memo scope is open on this thread."""
    return getattr(_MEMO, "entries", None) is not None


def memo_get(key):
    entries = getattr(_MEMO, "entries", None)
    if entries is None:
        return None
    hit = entries.get(key)
    if hit is not None:
        counters.inc("leaf_gather_memo_hits")
    return hit


def memo_put(key, value) -> None:
    entries = getattr(_MEMO, "entries", None)
    if entries is not None:
        entries[key] = value


def host_leaf_agg(plan, vals: np.ndarray, vbase, gids: np.ndarray,
                  num_groups: int, fn_name: str, agg_op: str) -> np.ndarray:
    """-> partial components [G, W, C] (float64, ops/agg.AGGREGATORS
    layout) for a dense shared-grid working set.  `plan` is an
    ops/fused.FusedPlan; vals [S, T] rebased; vbase [S] or None."""
    S = vals.shape[0]
    W = plan.W
    v = np.asarray(vals, np.float64)
    vb = (np.zeros(S) if vbase is None
          else np.asarray(vbase, np.float64))
    idx1 = plan.idx1[:W].astype(np.int64)
    idx2 = plan.idx2[:W].astype(np.int64)
    n1 = plan.n1[:W].astype(np.float64)

    over_time = fn_name in ("sum_over_time", "avg_over_time",
                            "count_over_time", "last_over_time")
    if fn_name == "last_over_time":
        per = v[:, idx2] + vb[:, None]
        per = np.where(plan.wvalid1[None, :], per, np.nan)
    elif over_time:
        cs = np.cumsum(np.concatenate(
            [np.zeros((S, 1)), v], axis=1), axis=1)       # exclusive
        s = cs[:, idx2 + 1] - cs[:, idx1]
        if fn_name == "sum_over_time":
            per = s + vb[:, None] * n1[None, :]
        elif fn_name == "avg_over_time":
            per = s / np.maximum(n1[None, :], 1.0) + vb[:, None]
        else:                                             # count_over_time
            per = np.broadcast_to(n1[None, :], (S, W)).copy()
        per = np.where(plan.wvalid1[None, :], per, np.nan)
    elif fn_name in ("min_over_time", "max_over_time"):
        red = np.minimum if fn_name == "min_over_time" else np.maximum
        per = np.empty((S, W))
        av = v + vb[:, None]
        for w in range(W):                                # W is small
            per[:, w] = red.reduce(av[:, idx1[w]:idx2[w] + 1], axis=1) \
                if idx2[w] >= idx1[w] else np.nan
        per = np.where(plan.wvalid1[None, :], per, np.nan)
    else:
        # rate family (precorrected dense): the kernel's formula, f64
        t1 = plan.t1[:W].astype(np.float64)
        t2 = plan.t2[:W].astype(np.float64)
        n = plan.n[:W].astype(np.float64)
        ws = plan.wstart_x[:W].astype(np.float64)
        we = plan.wend_x[:W].astype(np.float64)
        v1 = v[:, idx1]
        v2 = v[:, idx2]
        dur_start = (t1 - ws) / 1000.0
        dur_end = (we - t2) / 1000.0
        sampled = np.maximum((t2 - t1) / 1000.0, 1e-9)
        avg_between = sampled / (n - 1.0)
        delta = v2 - v1
        if fn_name in ("rate", "increase"):
            va = v1 + vb[:, None]
            with np.errstate(invalid="ignore", divide="ignore"):
                dur_zero = sampled * (va / np.where(delta == 0.0, np.inf,
                                                    delta))
            take = (delta > 0) & (va >= 0) & (dur_zero < dur_start)
            dur_start = np.where(take, dur_zero, dur_start)
        threshold = avg_between * 1.1
        extrap = sampled \
            + np.where(dur_start < threshold, dur_start, avg_between / 2) \
            + np.where(dur_end < threshold, dur_end, avg_between / 2)
        per = delta * (extrap / sampled)
        if fn_name == "rate":
            per = per / np.maximum(we - ws, 1.0) * 1000.0
        per = np.where(plan.wvalid[None, :], per, np.nan)

    # the 3-phase map in numpy, in ops/agg.AGGREGATORS' component layout
    # and combiner semantics
    present = ~np.isnan(per)
    zeroed = np.where(present, per, 0.0)
    cnt = present.astype(np.float64)
    G = num_groups

    def seg_sum(x):
        out = np.zeros((G,) + x.shape[1:])
        np.add.at(out, gids, x)             # S x W small by routing gate
        return out

    def seg_ext(x, red, init):
        out = np.full((G,) + x.shape[1:], init)
        red.at(out, gids, x)
        return out

    if agg_op in ("sum", "avg"):
        comp = np.stack([seg_sum(zeroed), seg_sum(cnt)], axis=-1)
    elif agg_op == "count":
        comp = seg_sum(cnt)[..., None]
    elif agg_op == "min":
        comp = np.stack([seg_ext(np.where(present, per, np.inf),
                                 np.minimum, np.inf),
                         seg_ext(cnt, np.maximum, -np.inf)], axis=-1)
    elif agg_op == "max":
        comp = np.stack([seg_ext(np.where(present, per, -np.inf),
                                 np.maximum, -np.inf),
                         seg_ext(cnt, np.maximum, -np.inf)], axis=-1)
    else:
        raise ValueError(f"host route: unsupported agg {agg_op}")
    return comp
