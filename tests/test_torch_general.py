"""The port's general query path against the JAX package's, on the same
seeded numpy inputs: every range function (ops/rangefns.py), the
counter and window helpers, every instant function and binary operator
(ops/instant.py), each aggregate (ops/agg.py), histogram_quantile
(ops/hist.py) and the join's row selection (ops/select.py); then the
engine end to end against the JAX engine on one and two shards for the
query shapes G1-G6 of chip_smoke.py at a small size.

f64 inputs are held to tests/test_rangefns.py's tolerances (rtol 1e-9,
1e-6 for the regression functions); f32 range functions, on
tests/test_tpu_conformance.py's data, to its tolerances against the f64
reference (rtol 2e-5 / atol 1e-4 for the counter functions, rtol 3e-6 /
atol 1e-3 for the absolute-valued ones, rtol 2e-2 for stdvar_over_time,
rtol 5e-4 / atol 5e-3 for the others).  NaN placement must agree.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from filodb_tpu.utils.jaxcompat import enable_x64

from filodb_tpu.ops import agg as jagg
from filodb_tpu.ops import counter as jcounter
from filodb_tpu.ops import hist as jhist
from filodb_tpu.ops import instant as jinst
from filodb_tpu.ops import rangefns as jrf
from filodb_tpu.ops import select as jsel
from filodb_tpu.ops import timewindow as jtw
from filodb_tpu_torch.ops import agg as tagg
from filodb_tpu_torch.ops import counter as tcounter
from filodb_tpu_torch.ops import fused
from filodb_tpu_torch.ops import hist as thist
from filodb_tpu_torch.ops import instant as tinst
from filodb_tpu_torch.ops import rangefns as trf
from filodb_tpu_torch.ops import select as tsel
from filodb_tpu_torch.ops import timewindow as ttw

STEP = 10_000
RANGE_MS = 60_000
PARAMS = {"predict_linear": (60.0,), "quantile_over_time": (0.9,),
          "holt_winters": (0.5, 0.3)}
COUNTER_FNS = ("rate", "increase", "irate")
REGRESSION_FNS = ("deriv", "z_score", "predict_linear")


def _windows(S=9, T=64, layout="dense", seed=3):
    """(ts_off [S, T] int32, vals [S, T] f64 rebased, vbase [S], wends
    [W] int32, shared).  Counters with two resets a row, NaN runs and
    +-Inf samples on the ragged layout (per-series jittered grids of
    different lengths, PAD_TS beyond each row's count); dense is one
    shared grid with no NaN."""
    rng = np.random.default_rng(seed)
    raw = np.cumsum(rng.exponential(10.0, (S, T)), axis=1)
    for s in range(S):
        for r in rng.choice(np.arange(4, T), size=2, replace=False):
            raw[s, r:] -= raw[s, r - 1] * rng.uniform(0.3, 1.0)
    shared = layout == "dense"
    if shared:
        ts = np.broadcast_to(np.arange(T, dtype=np.int64) * STEP, (S, T))
        counts = np.full(S, T)
    else:
        ts = np.cumsum(rng.integers(7_000, 13_000, (S, T)), axis=1)
        counts = rng.integers(T // 2, T + 1, S)
        counts[0] = T
        for s in range(S):
            a = rng.integers(0, T - 8)
            raw[s, a:a + rng.integers(1, 8)] = np.nan
        raw[rng.random((S, T)) < 0.08] = np.nan
        raw[1, :] = np.nan
        raw[2, 5] = np.inf
        raw[3, 30] = -np.inf
        raw[np.arange(T)[None, :] >= counts[:, None]] = np.nan
    ts_off = jtw.to_offsets(np.asarray(ts), counts, 0)
    vbase = jtw.series_value_base(raw)
    wends = np.arange(-20_000, int(T * STEP * 1.2), 15_000).astype(np.int32)
    return ts_off, raw - vbase[:, None], vbase, wends, shared


def _jax_range(args, fn, dtype, precorrected=False, range_ms=RANGE_MS):
    ts_off, vals, vbase, wends, shared = args

    def run():
        return np.asarray(jrf.evaluate_range_function(
            jnp.asarray(ts_off), jnp.asarray(vals.astype(dtype)),
            jnp.asarray(wends), range_ms, fn, PARAMS.get(fn, ()),
            base_ms=1000.0, shared_grid=shared,
            vbase=jnp.asarray(vbase.astype(dtype)),
            precorrected=precorrected, dense=shared))
    if dtype == np.float32:
        with enable_x64(False):
            return run()
    return run()


def _port_range(args, fn, dtype, precorrected=False, range_ms=RANGE_MS):
    ts_off, vals, vbase, wends, shared = args
    return trf.evaluate_range_function(
        torch.from_numpy(ts_off), torch.from_numpy(vals.astype(dtype)),
        torch.from_numpy(wends), range_ms, fn, PARAMS.get(fn, ()),
        base_ms=1000.0, shared_grid=shared,
        vbase=torch.from_numpy(vbase.astype(dtype)),
        precorrected=precorrected, dense=shared).numpy()


def _conformance_windows(layout, restarts, seed=11, S=6, T=240):
    """tests/test_tpu_conformance.py's data: counters at base 1e9, with
    one restart a row for the counter functions (5% scrape gaps when
    ragged), and its 5 m windows each minute."""
    rng = np.random.default_rng(seed)
    inc = rng.exponential(10.0, (S, T))
    raw = 1e9 + np.cumsum(inc, axis=1)
    for s in range(S):
        r = int(rng.integers(T // 3, 2 * T // 3))
        if restarts:
            raw[s, r:] = np.cumsum(inc[s, r:])
    if layout == "ragged":
        raw[rng.random((S, T)) < 0.05] = np.nan
    ts_off = jtw.to_offsets(np.broadcast_to(
        np.arange(T, dtype=np.int64) * STEP, (S, T)), np.full(S, T), 0)
    wends = np.arange(400_000, (T - 1) * STEP + 1, 60_000).astype(np.int32)
    return ts_off, raw, wends


# f32 against the f64 reference, test_tpu_conformance.py's tolerances
F32_TOL = {"rate": (2e-5, 1e-4), "increase": (2e-5, 1e-4),
           "irate": (2e-5, 1e-4), "stdvar_over_time": (2e-2, 5e-3)}
F32_ABSOLUTE_TOL = (3e-6, 1e-3)
F32_OTHER_TOL = (5e-4, 5e-3)


def _same(got, want, rtol, atol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert (np.isnan(got) == np.isnan(want)).all(), f"{what}: NaN pattern"
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               equal_nan=True, err_msg=what)


def _valid_counts(args):
    """Valid samples per (series, window) [S, W]."""
    ts_off, vals, _, wends, _ = args
    ok = ~np.isnan(vals) & (ts_off < int(jtw.PAD_TS))
    inw = (ts_off[:, None, :] > wends[None, :, None] - RANGE_MS) \
        & (ts_off[:, None, :] <= wends[None, :, None])
    return (inw & ok[:, None, :]).sum(axis=-1)


# --------------------------------------------------------- range functions

@pytest.mark.parametrize("layout", ["dense", "ragged"])
@pytest.mark.parametrize("fn", sorted(trf.RANGE_FUNCTIONS))
def test_range_function_matches_jax_f64(fn, layout):
    """f64, tests/test_rangefns.py's tolerances.  Where the answer is
    rounding noise in both (the window sums are differences of running
    sums, added in another order by XLA than by torch), that noise is
    the tolerance, as there: the variance family's floor is the running
    sums' rounding, and deriv/predict_linear over one valid sample and
    z_score over a zero spread are compared for presence only."""
    args = _windows(layout=layout)
    want = _jax_range(args, fn, np.float64)
    got = _port_range(args, fn, np.float64)
    assert got.dtype == np.float64 and (~np.isnan(want)).any()
    rtol = 1e-6 if fn in REGRESSION_FNS else 1e-9
    atol = 1e-9
    vals = args[1]
    sumsq = np.nansum(np.where(np.isinf(vals), 0.0, vals) ** 2, axis=1).max()
    eps = np.finfo(np.float64).eps
    if fn == "stdvar_over_time":
        atol = 4 * sumsq * eps
    elif fn == "stddev_over_time":
        atol = (4 * sumsq * eps) ** 0.5
    ill = np.zeros(want.shape, bool)
    if fn in ("deriv", "predict_linear"):
        ill = _valid_counts(args) < 2
    elif fn == "z_score":
        std = _jax_range(args, "stddev_over_time", np.float64)
        ill = ~(std > (4 * sumsq * eps) ** 0.5)
    assert (np.isnan(got[~ill]) == np.isnan(want[~ill])).all()
    _same(np.where(ill, np.nan, got), np.where(ill, np.nan, want), rtol,
          atol, what=f"{fn} {layout}")


@pytest.mark.parametrize("layout", ["dense", "ragged"])
@pytest.mark.parametrize("fn", sorted(trf.RANGE_FUNCTIONS))
def test_range_function_f32_matches_the_f64_reference(fn, layout):
    """f32 as the mirror feeds it (counter functions over reset-corrected
    values), against the JAX function in f64, with
    tests/test_tpu_conformance.py's tolerances on its data (restarts only
    under the counter functions: a gauge dropping from 1e9 to 0 is beyond
    f32 for anyone)."""
    spec = trf.RANGE_FUNCTIONS[fn]
    ts_off, raw, wends = _conformance_windows(layout, spec.is_counter)
    v64 = jcounter.host_counter_correct(raw) if spec.is_counter else raw
    vbase = jtw.series_value_base(v64)
    args = (ts_off, v64 - vbase[:, None], vbase, wends, layout == "dense")
    kw = dict(precorrected=spec.is_counter, range_ms=300_000)
    want = _jax_range(args, fn, np.float64, **kw)
    got = _port_range(args, fn, np.float32, **kw)
    assert got.dtype == np.float32
    tol = F32_TOL.get(fn, F32_ABSOLUTE_TOL if spec.absolute
                      and fn not in ("predict_linear", "holt_winters")
                      else F32_OTHER_TOL)
    _same(got, want, *tol, what=f"{fn} {layout}")
    # and against the reference's own f32 answer, the same way
    _same(got, _jax_range(args, fn, np.float32, **kw), *tol,
          what=f"{fn} {layout} vs f32")


def test_range_function_tables_agree():
    assert set(trf.RANGE_FUNCTIONS) == set(jrf.RANGE_FUNCTIONS)
    for name, spec in jrf.RANGE_FUNCTIONS.items():
        mine = trf.RANGE_FUNCTIONS[name]
        assert (mine.needs_params, mine.is_counter, mine.absolute) == \
            (spec.needs_params, spec.is_counter, spec.absolute), name


@pytest.mark.parametrize("fn", COUNTER_FNS)
def test_precorrected_counters_match_jax(fn):
    """The mirror's reset-corrected counters skip the device correction."""
    ts_off, vals, vbase, wends, shared = _windows(layout="dense")
    corr = jcounter.host_counter_correct(vals + vbase[:, None])
    vb = jtw.series_value_base(corr)
    args = (ts_off, corr - vb[:, None], vb, wends, shared)
    _same(_port_range(args, fn, np.float32, True),
          _jax_range(args, fn, np.float32, True), *F32_TOL[fn])


@pytest.mark.parametrize("bad", [(0.0, 0.5), (1.0, 0.5), (0.5, 0.0),
                                 (0.5, 1.5)])
def test_holt_winters_rejects_out_of_range_factors(bad):
    args = _windows(layout="dense")
    with pytest.raises(ValueError):
        trf.evaluate_range_function(
            torch.from_numpy(args[0]), torch.from_numpy(args[1]),
            torch.from_numpy(args[3]), RANGE_MS, "holt_winters", bad)


def test_tile_reduce_row_blocks_keep_the_cells():
    """_window_tile_reduce's row blocks (a tile over tile_elems) give the
    same cells as one block."""
    ts_off, vals, vbase, wends, _ = _windows(layout="ragged")
    ctx = trf.make_ctx(torch.from_numpy(ts_off), torch.from_numpy(vals),
                       torch.from_numpy(wends), RANGE_MS)

    def red(v, m):
        return trf._masked_quantile(v.expand(m.shape), m, 0.3)
    whole = trf._window_tile_reduce(ctx, red, tile_elems=1 << 30)
    blocks = trf._window_tile_reduce(ctx, red, tile_elems=64 * 3)
    assert torch.equal(torch.isnan(whole), torch.isnan(blocks))
    assert torch.equal(torch.nan_to_num(whole), torch.nan_to_num(blocks))


@pytest.mark.parametrize("layout", ["dense", "ragged"])
def test_window_helpers_match_jax(layout):
    ts_off, vals, _, wends, shared = _windows(layout=layout)
    ts_in = ts_off[:1] if shared else ts_off
    ws, we = wends - RANGE_MS + 1, wends
    jb = jtw.window_bounds(jnp.asarray(ts_in), jnp.asarray(ws),
                           jnp.asarray(we))
    tb = ttw.window_bounds(torch.from_numpy(ts_in), torch.from_numpy(ws),
                           torch.from_numpy(we))
    for j, t in zip(jb, tb):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    cs = np.nancumsum(vals, axis=1)
    got = ttw.windowed_cumsum_delta(torch.from_numpy(cs), *tb).numpy()
    want = np.asarray(jtw.windowed_cumsum_delta(jnp.asarray(cs), *jb))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


def test_counter_helpers_match_jax():
    _, vals, vbase, _, _ = _windows(layout="ragged")
    vals = np.where(np.isinf(vals), np.nan, vals)
    v, vb = torch.from_numpy(vals), torch.from_numpy(vbase)
    _same(tcounter.drops(v, vb).numpy(),
          np.asarray(jcounter.drops(jnp.asarray(vals), jnp.asarray(vbase))),
          1e-12, 0)
    _same(tcounter.counter_correct(v, vb).numpy(),
          np.asarray(jcounter.counter_correct(jnp.asarray(vals),
                                              jnp.asarray(vbase))), 1e-12, 0)
    for got, want in zip(tcounter.total_correction_and_last(v),
                         jcounter.total_correction_and_last(
                             jnp.asarray(vals))):
        _same(got.numpy(), np.asarray(want), 1e-12, 0)


# ------------------------------------------- instant functions, operators

def _instant_inputs(name, dtype):
    rng = np.random.default_rng(5)
    if name in ("minute", "hour", "day_of_week", "day_of_month", "month",
                "year", "days_in_month", "day_of_year"):
        v = rng.uniform(-3e9, 4e9, (7, 40))
        v[0, :8] = [0, 951782400, 951868800, 1709164800, 1709251199,
                    -86400, 4102444800, 86399]     # leap days, edges
    elif name in ("asin", "acos", "atanh"):
        v = rng.uniform(-1.2, 1.2, (7, 40))
    else:
        v = rng.normal(0, 50, (7, 40))
    v[1, :3] = [np.nan, np.inf, -np.inf]
    return v.astype(dtype)


INSTANT_ARGS = {"round": (5.0,), "clamp_min": (10.0,), "clamp_max": (-3.0,),
                "clamp": (-5.0, 5.0)}


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", sorted(tinst.INSTANT_FUNCTIONS))
def test_instant_function_matches_jax(name, dtype):
    v = _instant_inputs(name, dtype)
    extra = INSTANT_ARGS.get(name, ())
    with enable_x64(dtype == np.float64):
        want = np.asarray(jinst.INSTANT_FUNCTIONS[name](
            jnp.asarray(v), *[jnp.asarray(np.asarray(x, dtype))
                              for x in extra]))
    got = tinst.INSTANT_FUNCTIONS[name](
        torch.from_numpy(v), *[torch.tensor(x, dtype=torch.from_numpy(
            v).dtype) for x in extra]).numpy()
    assert got.dtype == dtype
    finite = np.isfinite(want)
    assert (np.isnan(got) == np.isnan(want)).all()
    assert (got[~finite & ~np.isnan(want)] == want[~finite
                                                   & ~np.isnan(want)]).all()
    rtol = 1e-12 if dtype == np.float64 else 2e-6
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol,
                               atol=rtol)


def test_instant_table_agrees():
    assert set(tinst.INSTANT_FUNCTIONS) == set(jinst.INSTANT_FUNCTIONS)


@pytest.mark.parametrize("bool_modifier", [False, True])
@pytest.mark.parametrize("keep_side", ["lhs", "rhs"])
@pytest.mark.parametrize("op", sorted(tinst.ARITH_OPERATORS)
                         + sorted(tinst.COMPARISON_OPERATORS))
def test_binary_operator_matches_jax(op, keep_side, bool_modifier):
    rng = np.random.default_rng(6)
    a = np.round(rng.normal(0, 4, (6, 30)))
    b = np.round(rng.normal(0, 4, (6, 30)))
    a[0, :4] = [np.nan, np.inf, -np.inf, 0.0]
    b[0, 4:8] = [np.nan, 0.0, np.inf, -0.0]
    want = np.asarray(jinst.apply_binary_op(
        jnp.asarray(a), jnp.asarray(b), op=op, bool_modifier=bool_modifier,
        keep_side=keep_side))
    got = tinst.apply_binary_op(torch.from_numpy(a), torch.from_numpy(b),
                                op=op, bool_modifier=bool_modifier,
                                keep_side=keep_side).numpy()
    _same(got, want, 1e-12, 0, op)


# ------------------------------------------------------------- aggregates

def _agg_inputs(dtype=np.float64, S=40, W=12, G=5, seed=8):
    rng = np.random.default_rng(seed)
    v = rng.normal(0, 10, (S, W)).astype(dtype)
    v[rng.random((S, W)) < 0.2] = np.nan
    v[3, 2], v[4, 3] = np.inf, -np.inf
    v[:, 0] = np.nan                          # an empty step
    gids = rng.integers(0, G, S).astype(np.int32)
    gids[gids == G - 1] = 0                   # an empty group
    return v, gids, G


@pytest.mark.parametrize("op", sorted(tagg.AGGREGATORS))
def test_aggregate_matches_jax(op):
    v, gids, G = _agg_inputs()
    want = np.asarray(jagg.aggregate(op, jnp.asarray(v), jnp.asarray(gids),
                                     G))
    csr = fused.pad_groups(gids, len(gids), G, device="cpu").csr
    got = tagg.aggregate(op, torch.from_numpy(v),
                         torch.from_numpy(gids).long(), G, csr).numpy()
    rtol = 1e-9 if op in ("stddev", "stdvar") else 1e-12
    _same(got, want, rtol, 1e-12, op)
    # the merge of two partials equals the partial of the whole
    half = len(gids) // 2
    parts = [tagg.map_phase(op, torch.from_numpy(v[sl]),
                            torch.from_numpy(gids[sl]).long(), G,
                            fused.pad_groups(gids[sl], len(gids[sl]),
                                             G, device="cpu").csr)
             for sl in (slice(0, half), slice(half, None))]
    merged = tagg.present(op, tagg.reduce_phase(op, *parts)).numpy()
    _same(merged, want, rtol, 1e-9, op + " merged")


@pytest.mark.parametrize("k", [1, 2, 7])
@pytest.mark.parametrize("largest", [True, False])
def test_topk_mask_matches_jax(largest, k):
    v, gids, G = _agg_inputs()
    v[5:9, 4] = 1.5                           # ties keep row order
    want = np.asarray(jagg.topk_mask(jnp.asarray(v), jnp.asarray(gids), G,
                                     k, largest=largest))
    got = tagg.topk_mask(torch.from_numpy(v), torch.from_numpy(gids), G, k,
                         largest=largest).numpy()
    np.testing.assert_array_equal(got, want)
    keep = tsel.topk_keep_rows(torch.from_numpy(v), torch.from_numpy(gids),
                               G, k, largest=largest).numpy()
    np.testing.assert_array_equal(keep, np.asarray(jsel.topk_keep_rows(
        jnp.asarray(v), jnp.asarray(gids), G, k, largest=largest)))


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.9, 1.0, -0.5, 1.5])
def test_quantile_agg_matches_jax(q):
    v, gids, G = _agg_inputs()
    want = np.asarray(jagg.quantile_agg(jnp.asarray(v), jnp.asarray(gids),
                                        G, q))
    got = tagg.quantile_agg(torch.from_numpy(v), torch.from_numpy(gids), G,
                            q).numpy()
    _same(got, want, 1e-12, 1e-12, f"q={q}")


@pytest.mark.parametrize("vals, q, ref, prom", [
    ([-np.inf, 1.0, 2.0], 0.5, np.nan, 1.0),
    ([1.0, 2.0, 3.0, np.inf], 0.5, 2.0, 2.5),
])
def test_quantile_agg_with_inf_sample_follows_reference_not_prometheus(
        vals, q, ref, prom):
    """The reference's quantile_agg ranks over the group's finite samples
    but reads the sort that holds its ±Inf ones; the port does the same,
    and both differ from Prometheus' quantile over all present samples
    (ROADMAP Queue 3)."""
    v = np.asarray(vals, np.float64)[:, None]
    gids = np.zeros(len(vals), np.int32)
    want = np.asarray(jagg.quantile_agg(jnp.asarray(v), jnp.asarray(gids),
                                        1, q))[0, 0]
    got = tagg.quantile_agg(torch.from_numpy(v), torch.from_numpy(gids), 1,
                            q).numpy()[0, 0]
    np.testing.assert_array_equal([got, want], [ref, ref])
    # Prometheus (promql/quantile.go): rank over all present samples
    rank = q * (len(vals) - 1)
    lo = int(np.floor(rank))
    w = rank - lo
    srt = np.sort(v[:, 0])
    assert srt[lo] * (1 - w) + srt[min(lo + 1, len(vals) - 1)] * w == prom
    assert not np.array_equal(got, prom)


def test_quantile_agg_answers_the_reference_sketch():
    """quantile() aggregates through the reference's 64-centroid sketch
    (ops/sketch.py) in both packages: the port's map, reduce and present
    phases answer the reference's bits at 64 series a group, where the
    sketch is exact, and at 500, where it is not (ROADMAP Queue 3)."""
    from filodb_tpu.query import exec as jexec
    from filodb_tpu.query import rangevector as jrv

    from filodb_tpu_torch.query import execbase as texec
    from filodb_tpu_torch.query import rangevector as trv
    from filodb_tpu_torch.query.transformers import AggregateMapReduce
    rng = np.random.default_rng(12)
    wends = np.arange(3, dtype=np.int64) * 60_000
    for n, exact in ((64, True), (500, False)):
        v = rng.lognormal(0, 2, (n, 3))
        labels = [(("_ns_", f"a{i % 2}"), ("i", str(i))) for i in range(n)]
        want_p = jexec.AggregateMapReduce("quantile", (0.9,), ("_ns_",)).apply(
            jrv.ResultBlock([jrv.RangeVectorKey(k) for k in labels], wends, v),
            jrv.QueryContext(), jrv.QueryStats())
        got_p = AggregateMapReduce("quantile", (0.9,), ("_ns_",)).apply(
            trv.ResultBlock([trv.RangeVectorKey(k) for k in labels], wends,
                            torch.from_numpy(v)),
            trv.QueryContext(), trv.QueryStats())
        np.testing.assert_array_equal(got_p.sketch, want_p.sketch)
        # two shards' partials merge as in the reference
        want = jexec.present_partial(jexec.reduce_partials([want_p, want_p]))
        got = texec.present_partial(texec.reduce_partials([got_p, got_p]))
        np.testing.assert_array_equal(np.asarray(got.values),
                                      np.asarray(want.values))
        # the merged groups hold each series twice
        exact_q = np.stack([np.quantile(np.concatenate([v[i::2]] * 2), 0.9,
                                        axis=0) for i in range(2)])
        assert np.allclose(np.asarray(got.values), exact_q,
                           rtol=1e-9) == exact


# ------------------------------------------------------------- histograms

def _buckets(seed=4, S=6, W=9, B=7):
    rng = np.random.default_rng(seed)
    b = np.cumsum(rng.poisson(3.0, (S, W, B)).astype(np.float64), axis=-1)
    b[0, 0] = 0.0                             # empty histogram
    b[1, 1, 3] -= 2.0                         # non-monotone jitter
    b[2, 2] = np.nan
    les = np.array([-1.0, 0.5, 1.0, 2.5, 5.0, 10.0, np.inf])
    return b, les


@pytest.mark.parametrize("q", [-0.5, 0.0, 0.25, 0.5, 0.9, 1.0, 1.5])
def test_histogram_quantile_matches_jax(q):
    b, les = _buckets()
    want = np.asarray(jhist._histogram_quantile_jax(q, jnp.asarray(b),
                                                    jnp.asarray(les)))
    np_twin = thist.histogram_quantile(q, b, les)
    on_tensor = thist.histogram_quantile(q, torch.from_numpy(b), les).numpy()
    for got in (np_twin, on_tensor):
        _same(got, want, 1e-12, 1e-12, f"q={q}")
    _same(np_twin, jhist._histogram_quantile_np(q, b, les), 0, 0)


def test_histogram_bucket_and_sum_match_jax():
    b, les = _buckets()
    for le in (2.5, np.inf, 3.0):
        want = np.asarray(jhist.histogram_bucket(le, jnp.asarray(b),
                                                 jnp.asarray(les)))
        got = thist.histogram_bucket(le, torch.from_numpy(b), les).numpy()
        _same(got, want, 0, 0, str(le))
    _same(thist.hist_sum_rv(torch.from_numpy(b)).numpy(),
          np.asarray(jhist.hist_sum_rv(jnp.asarray(b))), 1e-12, 0)


@pytest.mark.parametrize("op", ["+", "/", ">", "=="])
def test_gather_binop_matches_jax(op):
    rng = np.random.default_rng(2)
    a, b = rng.normal(0, 3, (5, 8)), rng.normal(0, 3, (4, 8))
    a[0, 0] = np.nan
    mi, oi = np.array([0, 2, 4, 4]), np.array([1, 1, 3, 0])
    want = np.asarray(jsel.gather_binop(jnp.asarray(a), jnp.asarray(b),
                                        jnp.asarray(mi), jnp.asarray(oi),
                                        op=op))
    got = tsel.gather_binop(torch.from_numpy(a), torch.from_numpy(b),
                            torch.from_numpy(mi), torch.from_numpy(oi),
                            op=op).numpy()
    _same(got, want, 1e-12, 0, op)
