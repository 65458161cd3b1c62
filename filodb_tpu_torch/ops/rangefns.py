"""PromQL range functions over dense [S, T] tensors (port of
filodb_tpu/ops/rangefns.py).

Each function evaluates every (series, window) cell at once on the
tensors' own device, in the values' dtype (f32 on the card, f32 or f64 in
the tests).  A window for output step `wend` holds the samples with
timestamp in [wend - range + 1, wend]; the extrapolation boundary of the
rate family is wend - range.

Strategies, as in the reference:
  - O(1)-per-window functions (sum/count/avg/stddev/rate/...) take
    cumulative sums along time and gather at the window bounds;
  - order statistics (min/max/quantile/mad) and holt_winters reduce a
    masked broadcast over window tiles of bounded size;
  - counter functions reset-correct first unless the mirror already did
    (ops/counter.py).
Absent results are NaN.

The reference runs these functions compiled, and XLA turns each division
by a constant into a multiply by the constant's reciprocal in the value
dtype; so a division by a constant here is written as that multiply
(`* MS_TO_S` for `/ 1000.0`), and the two agree to the bit on ties such
as a gap of exactly 1.1 average spacings.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from filodb_tpu_torch.ops import counter as counter_ops
from filodb_tpu_torch.ops.timewindow import (PAD_TS, gather_at, window_bounds,
                                             windowed_cumsum_delta)

MS_TO_S = 0.001
"""The reciprocal of 1000 the compiled reference multiplies by, rounded to
the value dtype by the multiply."""

TILE_ELEMS = 1 << 26
"""Cells of one masked tile in _window_tile_reduce (the reference's
tile_elems)."""


class WindowCtx(NamedTuple):
    """Per-query window state shared by all range functions."""
    ts_off: torch.Tensor   # i32 [S, T] (or [1, T] on a shared grid)
    vals: torch.Tensor     # f [S, T] (rebased: absolute value - vbase[s])
    valid: torch.Tensor    # bool [S, T]
    wstart: torch.Tensor   # i32 [W] inclusive
    wend: torch.Tensor     # i32 [W] inclusive
    first: torch.Tensor    # i32 [S, W] ([1, W] on a shared grid)
    last: torch.Tensor     # i32 [S, W]
    n: torch.Tensor        # i32 [S, W] samples in window
    base_ms: torch.Tensor  # f scalar: absolute ms of offset 0
    vbase: torch.Tensor    # f [S] per-series value base (0 when not rebased)
    # the mirror reset-corrected the counter values in f64 already
    precorrected: bool = False
    # False when values may hold NaN holes: the rate family then works
    # from each series' VALID boundaries instead of slot boundaries
    dense: bool = True


def make_ctx(ts_off: torch.Tensor, vals: torch.Tensor, wends: torch.Tensor,
             range_ms, base_ms=0.0, shared_grid: bool = False, vbase=None,
             precorrected: bool = False, dense: bool = True) -> WindowCtx:
    """shared_grid: every row of ts_off is the same scrape grid; the
    bounds are then computed once from row 0 and stay [1, W]."""
    wend = wends.to(torch.int32)
    wstart = (wend - int(range_ms) + 1).to(torch.int32)
    if shared_grid:
        ts_off = ts_off[:1]
    valid = (~torch.isnan(vals)) & (ts_off < int(PAD_TS))
    first, last, n = window_bounds(ts_off, wstart, wend)
    if vbase is None:
        vbase = torch.zeros(vals.shape[:1], dtype=vals.dtype,
                            device=vals.device)
    return WindowCtx(ts_off, vals, valid, wstart, wend, first, last, n,
                     torch.tensor(float(base_ms), dtype=vals.dtype,
                                  device=vals.device),
                     vbase.to(vals.dtype), precorrected, dense)


def _absolute(ctx: WindowCtx) -> WindowCtx:
    """Ctx with absolute values restored, for functions whose output is in
    absolute value space."""
    return ctx._replace(vals=ctx.vals + ctx.vbase[:, None],
                        vbase=torch.zeros_like(ctx.vbase))


def _counter_values(ctx: WindowCtx) -> torch.Tensor:
    """Reset-corrected values (free when the mirror corrected them); the
    base rides along, as the correction adds the full previous RAW value."""
    return ctx.vals if ctx.precorrected \
        else counter_ops.counter_correct(ctx.vals, ctx.vbase)


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=1)


def _masked(ctx: WindowCtx, arr: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    a = ctx.vals if arr is None else arr
    return torch.where(ctx.valid, a, _zero(a))


def _nan_where(cond: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(cond, x, torch.full((), float("nan"), dtype=x.dtype,
                                           device=x.device))


def _f(ctx: WindowCtx, x: torch.Tensor) -> torch.Tensor:
    """An integer tensor in the value dtype."""
    return x.to(ctx.vals.dtype)


def _sum_window(ctx: WindowCtx, x: torch.Tensor) -> torch.Tensor:
    return windowed_cumsum_delta(_cumsum(x), ctx.first, ctx.last, ctx.n)


# --------------------------------------------------------------- extrapolation

def extrapolated_rate(window_start, window_end, n, t1, v1, t2, v2,
                      is_counter: bool, is_rate: bool,
                      v1_abs=None) -> torch.Tensor:
    """Prometheus extrapolation (ref: RateFunctions.scala:37-76
    extrapolatedRate); all [S, W] but the window bounds ([1, W]).  v1_abs
    is the ABSOLUTE first value for the counter-started-at-zero rule when
    v1/v2 are rebased."""
    dur_start = (t1 - window_start) * MS_TO_S
    dur_end = (window_end - t2) * MS_TO_S
    sampled = (t2 - t1) * MS_TO_S
    avg_between = sampled / (n - 1.0)
    delta = v2 - v1
    if is_counter:
        va = v1 if v1_abs is None else v1_abs
        inf = torch.full((), float("inf"), dtype=delta.dtype,
                         device=delta.device)
        dur_zero = sampled * (va / torch.where(delta == 0, inf, delta))
        take_zero = (delta > 0) & (va >= 0) & (dur_zero < dur_start)
        dur_start = torch.where(take_zero, dur_zero, dur_start)
    threshold = avg_between * 1.1
    half = avg_between / 2
    extrap = sampled + torch.where(dur_start < threshold, dur_start, half)
    extrap = extrap + torch.where(dur_end < threshold, dur_end, half)
    scaled = delta * (extrap / sampled)
    if is_rate:
        return scaled / (window_end - window_start) * 1000.0
    return scaled


def _valid_bounds(ctx: WindowCtx):
    """Per-series first/last VALID sample index in each window and the
    valid count, for the rate family on ragged data -> (firstv, lastv,
    nv, lastrun [S, T])."""
    S, T = ctx.vals.shape
    iota = torch.arange(T, dtype=torch.int32, device=ctx.vals.device)
    iota = iota[None, :].expand(S, T)
    lastrun = torch.cummax(torch.where(ctx.valid, iota,
                                       torch.full_like(iota, -1)),
                           dim=1).values
    firstrun = torch.flip(torch.cummin(torch.flip(
        torch.where(ctx.valid, iota, torch.full_like(iota, T)), [1]),
        dim=1).values, [1])
    lastv = gather_at(lastrun, ctx.last)
    firstv = gather_at(firstrun, ctx.first)
    nv = _sum_window(ctx, _f(ctx, ctx.valid)).to(torch.int32)
    return firstv, lastv, nv, lastrun


def _rate_family(ctx: WindowCtx, is_counter: bool, is_rate: bool
                 ) -> torch.Tensor:
    vals = _counter_values(ctx) if is_counter else ctx.vals
    if ctx.dense:
        first, last, n = ctx.first, ctx.last, ctx.n
    else:
        first, last, n, _ = _valid_bounds(ctx)
    t1 = _f(ctx, gather_at(ctx.ts_off, first))
    t2 = _f(ctx, gather_at(ctx.ts_off, last))
    v1 = gather_at(vals, first)
    v2 = gather_at(vals, last)
    # the boundary per ChunkedRateFunctionBase: windowStart - 1
    wstart_x = _f(ctx, ctx.wstart - 1)[None, :]
    wend_x = _f(ctx, ctx.wend)[None, :]
    v1_abs = v1 + ctx.vbase[:, None] if is_counter else None
    out = extrapolated_rate(wstart_x, wend_x, _f(ctx, n), t1, v1, t2, v2,
                            is_counter, is_rate, v1_abs=v1_abs)
    return _nan_where(n >= 2, out)


def rate(ctx: WindowCtx) -> torch.Tensor:
    return _rate_family(ctx, True, True)


def increase(ctx: WindowCtx) -> torch.Tensor:
    return _rate_family(ctx, True, False)


def delta_fn(ctx: WindowCtx) -> torch.Tensor:
    return _rate_family(ctx, False, False)


def _instant_pair(ctx: WindowCtx):
    """(last, prev, ok): the newest two sample indices of each window for
    irate/idelta, by slot when dense, the last two VALID ones otherwise."""
    if ctx.dense:
        return (ctx.last, ctx.last - 1,
                (ctx.n >= 2) & (ctx.last - 1 >= ctx.first))
    _, lastv, nv, lastrun = _valid_bounds(ctx)
    prev = gather_at(lastrun, torch.clamp(lastv - 1, min=0))
    return lastv, prev, nv >= 2


def irate(ctx: WindowCtx) -> torch.Tensor:
    vals = _counter_values(ctx)
    last, prev, ok = _instant_pair(ctx)
    t2 = _f(ctx, gather_at(ctx.ts_off, last))
    t1 = _f(ctx, gather_at(ctx.ts_off, prev))
    out = (gather_at(vals, last) - gather_at(vals, prev)) \
        / ((t2 - t1) * MS_TO_S)
    return _nan_where(ok, out)


def idelta(ctx: WindowCtx) -> torch.Tensor:
    last, prev, ok = _instant_pair(ctx)
    return _nan_where(ok, gather_at(ctx.vals, last)
                      - gather_at(ctx.vals, prev))


# ------------------------------------------------------------- over_time / sums

def _valid_count(ctx: WindowCtx) -> torch.Tensor:
    """Per-window count of VALID samples: a window whose slots are all NaN
    is absent for the value-summing functions."""
    return _sum_window(ctx, _f(ctx, ctx.valid))


def sum_over_time(ctx: WindowCtx) -> torch.Tensor:
    return _nan_where(_valid_count(ctx) > 0, _sum_window(ctx, _masked(ctx)))


def count_over_time(ctx: WindowCtx) -> torch.Tensor:
    return _nan_where(ctx.n > 0, _valid_count(ctx))


def avg_over_time(ctx: WindowCtx) -> torch.Tensor:
    s = _sum_window(ctx, _masked(ctx))
    c = _valid_count(ctx)
    return _nan_where(c > 0, s / torch.clamp(c, min=1.0))


def _var_over_time(ctx: WindowCtx):
    s = _sum_window(ctx, _masked(ctx))
    s2 = _sum_window(ctx, _masked(ctx, ctx.vals * ctx.vals))
    c = _valid_count(ctx)
    cs = torch.clamp(c, min=1.0)
    mean = s / cs
    var = torch.clamp(s2 / cs - mean * mean, min=0.0)
    return var, c


def stdvar_over_time(ctx: WindowCtx) -> torch.Tensor:
    var, c = _var_over_time(ctx)
    return _nan_where((ctx.n > 0) & (c > 0.5), var)


def stddev_over_time(ctx: WindowCtx) -> torch.Tensor:
    var, c = _var_over_time(ctx)
    return _nan_where((ctx.n > 0) & (c > 0.5), torch.sqrt(var))


def last_over_time(ctx: WindowCtx) -> torch.Tensor:
    return _nan_where(ctx.n > 0, gather_at(ctx.vals, ctx.last))


def _n_full(ctx: WindowCtx) -> torch.Tensor:
    """ctx.n broadcast to [S, W] (it stays [1, W] on a shared grid)."""
    return ctx.n.expand(ctx.vals.shape[0], ctx.n.shape[-1])


def timestamp_fn(ctx: WindowCtx) -> torch.Tensor:
    """Seconds of each series' last VALID sample in the window: a running
    max of valid-sample times gathered at the window's last slot."""
    tsb = _f(ctx, ctx.ts_off).expand(ctx.vals.shape)
    vt = torch.where(ctx.valid, tsb, torch.full((), float("-inf"),
                                                dtype=tsb.dtype,
                                                device=tsb.device))
    t = gather_at(torch.cummax(vt, dim=1).values, ctx.last)
    in_window = (t >= _f(ctx, ctx.wstart)[None, :]) & torch.isfinite(t) \
        & (_n_full(ctx) > 0)
    return _nan_where(in_window, (t + ctx.base_ms) * MS_TO_S)


def absent_over_time(ctx: WindowCtx) -> torch.Tensor:
    one = torch.ones((), dtype=ctx.vals.dtype, device=ctx.vals.device)
    return _nan_where(_n_full(ctx) == 0, one.expand(_n_full(ctx).shape))


def present_over_time(ctx: WindowCtx) -> torch.Tensor:
    one = torch.ones((), dtype=ctx.vals.dtype, device=ctx.vals.device)
    return _nan_where(_n_full(ctx) > 0, one.expand(_n_full(ctx).shape))


# ------------------------------------------------ pairwise-indicator functions

def _pair_indicator_window(ctx: WindowCtx, indicator: torch.Tensor
                           ) -> torch.Tensor:
    """Sum indicator[t] (for the pair (previous valid, t)) over pairs whose
    BOTH members are valid samples inside the window:
    cum[last] - cum[first valid in window]."""
    cum = _cumsum(indicator)
    cv = torch.cumsum(ctx.valid.to(torch.int32), dim=1)
    rank_before = torch.where(ctx.first > 0, gather_at(cv, ctx.first - 1),
                              torch.zeros((), dtype=cv.dtype,
                                          device=cv.device))
    rank_before = rank_before.expand(cv.shape[0], -1).contiguous()
    first_valid = torch.searchsorted(cv.contiguous(), rank_before + 1,
                                     side="left", out_int32=True)
    nvalid = gather_at(cv, ctx.last) - rank_before
    hi = gather_at(cum, ctx.last)
    lo = gather_at(cum, first_valid)
    return torch.where(nvalid >= 2, hi - lo, _zero(hi))


def resets(ctx: WindowCtx) -> torch.Tensor:
    # on the VALUE ordering: the correction amount can be <= 0 on rebased
    # rows at a genuine reset
    prev = counter_ops._prev_valid(ctx.vals)
    ind = _f(ctx, ctx.valid & ~torch.isnan(prev) & (ctx.vals < prev))
    return _nan_where(ctx.n > 0, _pair_indicator_window(ctx, ind))


def changes(ctx: WindowCtx) -> torch.Tensor:
    prev = counter_ops._prev_valid(ctx.vals)
    ind = _f(ctx, ctx.valid & ~torch.isnan(prev) & (ctx.vals != prev))
    return _nan_where(ctx.n > 0, _pair_indicator_window(ctx, ind))


# ------------------------------------------------------- regression functions

def _linreg(ctx: WindowCtx) -> Tuple[torch.Tensor, torch.Tensor]:
    """Least-squares slope and intercept over (t seconds, value), as
    Prometheus deriv/predict_linear."""
    t_sec = torch.where(ctx.valid, _f(ctx, ctx.ts_off) * MS_TO_S,
                        _zero(ctx.vals))
    v = _masked(ctx)
    n = torch.clamp(_valid_count(ctx), min=1.0)
    st = _sum_window(ctx, t_sec)
    sv = _sum_window(ctx, v)
    stt = _sum_window(ctx, t_sec * t_sec)
    stv = _sum_window(ctx, t_sec * v)
    denom = n * stt - st * st
    nan = torch.full((), float("nan"), dtype=denom.dtype, device=denom.device)
    slope = (n * stv - st * sv) / torch.where(denom == 0, nan, denom)
    intercept = (sv - slope * st) / n
    return slope, intercept


def deriv(ctx: WindowCtx) -> torch.Tensor:
    slope, _ = _linreg(ctx)
    return _nan_where(ctx.n >= 2, slope)


def predict_linear(ctx: WindowCtx, t_ahead_s: float) -> torch.Tensor:
    slope, intercept = _linreg(ctx)
    at = _f(ctx, ctx.wend)[None, :] * MS_TO_S + t_ahead_s
    return _nan_where(ctx.n >= 2, slope * at + intercept)


def z_score(ctx: WindowCtx) -> torch.Tensor:
    var, c = _var_over_time(ctx)
    mean = _sum_window(ctx, _masked(ctx)) / c
    std = torch.sqrt(var)
    lastv = gather_at(ctx.vals, ctx.last)
    return _nan_where((ctx.n > 0) & (std > 0), (lastv - mean) / std)


# ----------------------------------------------- masked-broadcast reductions

def _window_tile_reduce(ctx: WindowCtx,
                        reducer: Callable[[torch.Tensor, torch.Tensor],
                                          torch.Tensor],
                        tile_elems: int = TILE_ELEMS) -> torch.Tensor:
    """reducer(vals [R, wt, T] broadcastable, mask [R, wt, T]) -> [R, wt]
    over tiles of wt windows, the reference's tile size; where one tile's
    [S, wt, T] mask would pass tile_elems the series are taken in row
    blocks that keep to it (rows are independent, so the cells are the
    same)."""
    S, T = ctx.vals.shape
    W = ctx.wend.shape[0]
    wt = max(1, min(W, tile_elems // max(S * T, 1)))
    rows = max(1, tile_elems // max(wt * T, 1))
    out = torch.empty((S, W), dtype=ctx.vals.dtype, device=ctx.vals.device)
    shared = ctx.ts_off.shape[0] == 1
    for w0 in range(0, W, wt):
        ws = ctx.wstart[w0:w0 + wt][None, :, None]
        we = ctx.wend[w0:w0 + wt][None, :, None]
        for r0 in range(0, S, rows):
            r1 = min(S, r0 + rows)
            ts = ctx.ts_off if shared else ctx.ts_off[r0:r1]
            in_win = (ts[:, None, :] >= ws) & (ts[:, None, :] <= we) \
                & ctx.valid[r0:r1, None, :]
            out[r0:r1, w0:w0 + wt] = reducer(ctx.vals[r0:r1, None, :],
                                             in_win)
    return out


def _extreme_over_time(ctx: WindowCtx, largest: bool) -> torch.Tensor:
    fill = float("-inf") if largest else float("inf")

    def red(v, m):
        x = torch.where(m, v, torch.full((), fill, dtype=v.dtype,
                                         device=v.device))
        return x.amax(dim=-1) if largest else x.amin(dim=-1)
    # absent = no VALID sample, counted apart, so windows whose samples
    # are +/-Inf still give their inf
    return _nan_where(_valid_count(ctx) > 0, _window_tile_reduce(ctx, red))


def min_over_time(ctx: WindowCtx) -> torch.Tensor:
    return _extreme_over_time(ctx, largest=False)


def max_over_time(ctx: WindowCtx) -> torch.Tensor:
    return _extreme_over_time(ctx, largest=True)


def _masked_quantile(vals: torch.Tensor, mask: torch.Tensor,
                     q: float) -> torch.Tensor:
    """Linear-interpolated quantile of the masked values along the last
    axis; masked-out cells sort to +inf past the valid prefix."""
    big = torch.where(mask, vals, torch.full((), float("inf"),
                                             dtype=vals.dtype,
                                             device=vals.device))
    srt = torch.sort(big, dim=-1).values
    cnt = mask.sum(dim=-1).to(srt.dtype)
    rank = q * (cnt - 1.0)
    lo = torch.floor(rank).to(torch.int64)
    hi = torch.ceil(rank).to(torch.int64)
    frac = rank - lo.to(srt.dtype)
    top = srt.shape[-1] - 1
    vlo = srt.gather(-1, lo.clamp(0, top)[..., None])[..., 0]
    vhi = srt.gather(-1, hi.clamp(0, top)[..., None])[..., 0]
    return vlo + (vhi - vlo) * frac


def quantile_over_time(ctx: WindowCtx, q: float) -> torch.Tensor:
    r = _window_tile_reduce(
        ctx, lambda v, m: _masked_quantile(v.expand(m.shape), m, q))
    if not 0.0 <= q <= 1.0:
        fill = torch.full((), float("inf") if q > 1 else float("-inf"),
                          dtype=ctx.vals.dtype, device=ctx.vals.device)
        return _nan_where(_n_full(ctx) > 0, fill.expand(r.shape))
    return _nan_where(ctx.n > 0, r)


def mad_over_time(ctx: WindowCtx) -> torch.Tensor:
    """Median absolute deviation median(|x - median(x)|) over the window;
    shift-invariant, so it runs on the rebased values."""
    def reducer(v, m):
        vb = v.expand(m.shape)
        med = _masked_quantile(vb, m, 0.5)
        return _masked_quantile(torch.abs(vb - med[..., None]), m, 0.5)
    return _nan_where(ctx.n > 0, _window_tile_reduce(ctx, reducer))


def holt_winters(ctx: WindowCtx, sf: float, tf: float) -> torch.Tensor:
    """Double exponential smoothing, the Prometheus recurrence, as a loop
    over the time axis inside each window tile."""
    if not 0 < sf < 1:
        raise ValueError(
            f"invalid smoothing factor {sf}: expected 0 < sf < 1")
    if not 0 < tf <= 1:
        raise ValueError(
            f"invalid trend factor {tf}: expected 0 < tf <= 1")

    def reducer(v, m):
        # s1 := x0; b := x1 - x0; then for i >= 1 the trend first, from
        # the previous two smoothed values, then the level
        vb = v.expand(m.shape)
        z = torch.zeros(m.shape[:-1], dtype=v.dtype, device=v.device)
        s_prev2, s_prev, b_prev = z, z, z
        cnt = torch.zeros(m.shape[:-1], dtype=torch.int32, device=v.device)
        for t in range(m.shape[-1]):
            x, valid = vb[..., t], m[..., t]
            b_eff = torch.where(cnt == 1, x - s_prev,
                                tf * (s_prev - s_prev2) + (1 - tf) * b_prev)
            s_new = sf * x + (1 - sf) * (s_prev + b_eff)
            s_upd = torch.where(cnt == 0, x, s_new)
            b_upd = torch.where(cnt == 0, torch.zeros_like(x), b_eff)
            s_prev2 = torch.where(valid, s_prev, s_prev2)
            s_prev = torch.where(valid, s_upd, s_prev)
            b_prev = torch.where(valid, b_upd, b_prev)
            cnt = cnt + valid.to(torch.int32)
        return _nan_where(cnt >= 2, s_prev)
    return _nan_where(ctx.n >= 2, _window_tile_reduce(ctx, reducer))


# ------------------------------------------------------------------ dispatch

class RangeFnSpec(NamedTuple):
    fn: Callable
    needs_params: int = 0       # scalar parameters consumed
    is_counter: bool = False
    # output in absolute value space: the per-series base is added back
    absolute: bool = False


RANGE_FUNCTIONS: Dict[str, RangeFnSpec] = {
    "rate": RangeFnSpec(rate, is_counter=True),
    "increase": RangeFnSpec(increase, is_counter=True),
    "delta": RangeFnSpec(delta_fn),
    "irate": RangeFnSpec(irate, is_counter=True),
    "idelta": RangeFnSpec(idelta),
    "resets": RangeFnSpec(resets),
    "changes": RangeFnSpec(changes),
    "deriv": RangeFnSpec(deriv),
    "predict_linear": RangeFnSpec(predict_linear, needs_params=1,
                                  absolute=True),
    "sum_over_time": RangeFnSpec(sum_over_time, absolute=True),
    "count_over_time": RangeFnSpec(count_over_time),
    "avg_over_time": RangeFnSpec(avg_over_time, absolute=True),
    "min_over_time": RangeFnSpec(min_over_time, absolute=True),
    "max_over_time": RangeFnSpec(max_over_time, absolute=True),
    "stddev_over_time": RangeFnSpec(stddev_over_time),
    "stdvar_over_time": RangeFnSpec(stdvar_over_time),
    "last_over_time": RangeFnSpec(last_over_time, absolute=True),
    "quantile_over_time": RangeFnSpec(quantile_over_time, needs_params=1,
                                      absolute=True),
    "holt_winters": RangeFnSpec(holt_winters, needs_params=2, absolute=True),
    "z_score": RangeFnSpec(z_score),
    "mad_over_time": RangeFnSpec(mad_over_time),
    "timestamp": RangeFnSpec(timestamp_fn),
    "absent_over_time": RangeFnSpec(absent_over_time),
    "present_over_time": RangeFnSpec(present_over_time),
}


def evaluate_range_function(ts_off: torch.Tensor, vals: torch.Tensor,
                            wends: torch.Tensor, range_ms,
                            fn_name: Optional[str],
                            params: Tuple[float, ...] = (),
                            base_ms=0, shared_grid: bool = False,
                            vbase=None, precorrected: bool = False,
                            dense: bool = True) -> torch.Tensor:
    """Window bounds + one range function -> [S, W] in vals' dtype on
    vals' device.  fn_name None is plain lookback sampling
    (last_over_time over range_ms).  shared_grid: all ts_off rows are the
    same grid."""
    ctx = make_ctx(ts_off, vals, wends, range_ms, base_ms, shared_grid,
                   vbase, precorrected, dense)
    spec = RANGE_FUNCTIONS[fn_name or "last_over_time"]
    if spec.absolute:
        ctx = _absolute(ctx)
    if spec.needs_params:
        return spec.fn(ctx, *params[: spec.needs_params])
    return spec.fn(ctx)
