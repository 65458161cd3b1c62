"""The port's gauge and min/max kinds (filodb_tpu_torch.ops.fused K4, K5
and the per-series mode K6; ops/minmax) vs the JAX package.

The same numpy inputs, made from a seed, go through
filodb_tpu.ops.pallas_fused.fused_leaf_agg_batch(..., interpret=True) and
the port's fused_leaf_agg_batch on the CPU (the plain torch versions of
the kernels), and through pf.fused_minmax_agg and ops/minmax.  Tolerances
are the reference's: dense rtol 2e-4 / atol 1e-3, ragged rtol 5e-4 /
atol 1e-4 (tests/test_pallas_fused.py:478).  The windowed min/max path
computes the same f32 values in both packages and must match exactly.
"""
import numpy as np
import pytest
import torch

from filodb_tpu.ops import pallas_fused as pf
from filodb_tpu.ops.counter import rebase_values
from filodb_tpu.ops.timewindow import make_window_ends
from filodb_tpu_torch.ops import agg as tagg
from filodb_tpu_torch.ops import fused as tf
from filodb_tpu_torch.ops import minmax as tmm
from filodb_tpu_torch.query import execbase
from test_torch_ingest import _clear_compile_journal  # noqa: F401

STEP = 10_000


def _gauges(S, T, hole_frac, seed, base=100.0):
    rng = np.random.default_rng(seed)
    t = np.arange(T)[None, :]
    raw = base + 50.0 * np.sin(t / 20.0 + rng.uniform(0, 6.3, (S, 1))) \
        + rng.normal(0, 2.0, (S, T))
    if hole_frac:
        raw[rng.random((S, T)) < hole_frac] = np.nan
        raw[3, :] = np.nan                   # one fully-absent series
        raw[5, 40:90] = np.nan               # a long gap
    return raw


def _counters(S, T, hole_frac, seed):
    rng = np.random.default_rng(seed)
    raw = np.cumsum(rng.exponential(10.0, size=(S, T)), axis=1)
    if hole_frac:
        raw[rng.random((S, T)) < hole_frac] = np.nan
    return raw


def _run_both(fn, ops, ragged, S=72, T=120, G=5, seed=0, range_ms=None,
              wends=None, base=100.0):
    """-> (jax comps, port comps, groupings) for panels `ops` (one
    grouping each, the first % G, the others a different hash)."""
    is_rate = fn in ("rate", "increase", "delta")
    hole = 0.1 if ragged else 0.0
    raw = (_counters(S, T, hole, seed) if is_rate
           else _gauges(S, T, hole, seed, base))
    precor = fn in ("rate", "increase")
    reb, vbase = rebase_values(raw, precor)
    v32, vb32 = reb.astype(np.float32), vbase.astype(np.float32)
    ts_row = np.arange(T, dtype=np.int64) * STEP
    if wends is None:
        wends = make_window_ends(40 * STEP, 110 * STEP, 6 * STEP)
    range_ms = range_ms or 30 * STEP
    groupings = []
    for p in range(len(ops)):
        g = G + p
        groupings.append((((np.arange(S) // (p + 1) + p) % g)
                          .astype(np.int32), g))

    plan = pf.build_plan(ts_row, wends, range_ms)
    values = pf.pad_values(v32, vb32, plan)
    jp = [(pf.pad_groups(g, S, n), n, o) for (g, n), o in zip(groupings, ops)]
    want = pf.fused_leaf_agg_batch(plan, values, jp, fn, precorrected=precor,
                                   interpret=True, ragged=ragged,
                                   num_series=S)
    tplan = tf.build_plan(ts_row, wends, range_ms)
    tvals = tf.pad_values(torch.from_numpy(v32), torch.from_numpy(vb32),
                          tplan)
    tp = [(tf.pad_groups(g, S, n, device="cpu"), n, o)
          for (g, n), o in zip(groupings, ops)]
    got = tf.fused_leaf_agg_batch(tplan, tvals, tp, fn, precorrected=precor,
                                  ragged=ragged, num_series=S)
    return want, got


CASES = [
    # (fn, panel aggregates, ragged)
    ("last_over_time", ("sum",), False),
    ("last_over_time", ("max", "count"), True),
    ("last_over_time", ("avg",), True),
    ("sum_over_time", ("sum",), False),
    ("sum_over_time", ("min", "sum"), True),
    ("avg_over_time", ("avg", "max"), False),
    ("avg_over_time", ("avg",), True),
    ("avg_over_time", ("min",), True),
    ("count_over_time", ("sum", "count"), True),
    ("count_over_time", ("max",), False),
    ("rate", ("max",), False),
    ("rate", ("min", "sum"), True),
    ("delta", ("max",), False),
]


@pytest.mark.parametrize("fn,ops,ragged", CASES)
def test_fused_leaf_agg_batch_matches_jax(fn, ops, ragged):
    want, got = _run_both(fn, list(ops), ragged)
    rtol, atol = (5e-4, 1e-4) if ragged else (2e-4, 1e-3)
    assert len(got) == len(want) == len(ops)
    for w, g, op in zip(want, got, ops):
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape and g.shape[-1] == \
            tagg.AGGREGATORS[op].num_components
        gp = tagg.present(op, torch.from_numpy(g)).numpy()
        wp = np.where(w[..., -1] > 0, 0.0, np.nan)     # presence pattern
        assert (np.isnan(gp) == np.isnan(wp)).all(), op
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   equal_nan=True, err_msg=op)


def _minmax_inputs(ragged, inf, S=40, T=100, seed=4):
    raw = _gauges(S, T, 0.2 if ragged else 0.0, seed).astype(np.float32)
    if inf:
        raw[0] = np.inf                       # an all-+Inf series
        raw[1, ::3] = -np.inf
        raw[2, ::2] = np.nan
        raw[2, 1::2] = np.inf                 # +Inf among holes
    vbase = np.random.default_rng(seed).normal(0, 1e3, S).astype(np.float32)
    return raw, vbase


MINMAX_CASES = [
    # (fn, agg, ragged, inf samples, windows past the right edge)
    ("min_over_time", "min", False, False, False),
    ("max_over_time", "max", False, False, False),
    ("min_over_time", "sum", False, False, False),
    ("max_over_time", "avg", True, False, False),
    ("min_over_time", "count", True, False, False),
    ("min_over_time", "max", True, True, False),
    ("max_over_time", "min", True, True, False),
    ("max_over_time", "max", False, False, True),
]


@pytest.mark.parametrize("fn,agg,ragged,inf,past_edge", MINMAX_CASES)
def test_fused_minmax_agg_matches_jax(fn, agg, ragged, inf, past_edge):
    import jax.numpy as jnp
    raw, vbase = _minmax_inputs(ragged, inf)
    S, T, G = raw.shape[0], raw.shape[1], 5
    ts_row = np.arange(T, dtype=np.int64) * STEP
    end = 108 if past_edge else 95
    wends = make_window_ends(40 * STEP, end * STEP, 6 * STEP)
    geom = pf.uniform_window_geometry(ts_row, wends, 30 * STEP)
    assert tmm.uniform_window_geometry(ts_row, wends, 30 * STEP) == geom
    f0, stride, width, t_needed = geom
    assert (t_needed > T) == past_edge
    if past_edge:
        raw = np.pad(raw, ((0, 0), (0, t_needed - T)),
                     constant_values=np.nan)
        ragged = True
    gids = ((np.arange(S) * 3) % G).astype(np.int32)
    want = np.asarray(pf.fused_minmax_agg(
        jnp.asarray(raw), jnp.asarray(vbase), jnp.asarray(gids), f0, stride,
        width, len(wends), fn, agg, G, ragged), np.float64)
    groups = tf.pad_groups(gids, S, G, device="cpu")
    got = tmm.fused_minmax_agg(
        torch.from_numpy(raw), torch.from_numpy(vbase),
        groups.gids_p[:S], f0, stride, width, len(wends), fn, agg, G,
        ragged, csr=groups.csr).numpy()
    assert got.shape == want.shape
    if agg in ("min", "max", "count"):
        # the same f32 values reduced by an exact operation: equal bits
        np.testing.assert_array_equal(got, want)
    else:
        rtol, atol = (5e-4, 1e-4) if ragged else (2e-4, 1e-3)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   equal_nan=True)
    if inf:
        # +Inf is a value, not absence: the all-+Inf series and the one
        # with +Inf between its holes give +Inf in every window
        per = tmm.window_minmax(torch.from_numpy(raw), None, f0, stride,
                                width, len(wends), fn, ragged).numpy()
        assert np.isposinf(per[0]).all() and np.isposinf(per[2]).all()


@pytest.mark.parametrize("wend_args,range_steps", [
    ((30, 90, 6), 30), ((10, 90, 6), 30), ((30, 90, 1.5), 30),
    ((30, 120, 6), 30), ((30, 30, 1), 10)])
def test_uniform_window_geometry_matches_jax(wend_args, range_steps):
    ts_row = np.arange(100, dtype=np.int64) * STEP
    a, b, s = wend_args
    wends = make_window_ends(int(a * STEP), int(b * STEP), int(s * STEP))
    assert tmm.uniform_window_geometry(ts_row, wends, range_steps * STEP) \
        == pf.uniform_window_geometry(ts_row, wends, range_steps * STEP)


@pytest.mark.parametrize("fn", ["sum_over_time", "avg_over_time"])
def test_single_sample_windows_keep_their_sample(fn):
    """Trap 1: the over_time kinds count windows with ONE sample as
    present (wvalid1), like the reference; with the rate family's n >= 2
    rule their values vanish."""
    wends = make_window_ends(5_000, 380_000, 10_000)
    want, got = _run_both(fn, ["sum", "avg"], False, S=8, T=40, G=2,
                          range_ms=15_000, wends=wends)
    plan = tf.build_plan(np.arange(40, dtype=np.int64) * STEP, wends,
                         15_000)
    single = plan.n1 == 1
    assert single.any()
    for w, g in zip(want, got):
        assert (g[:, single, -1] > 0).all()
        np.testing.assert_allclose(g, np.asarray(w), rtol=2e-4, atol=1e-3)


def test_reduce_partials_starts_min_max_from_identity():
    """Trap 3: a 2-shard max over negative values merges from -inf (and a
    min over positive ones from +inf), never from 0."""
    from filodb_tpu_torch.query.rangevector import RangeVectorKey
    k = [RangeVectorKey((("g", "a"),)), RangeVectorKey((("g", "b"),))]
    wends = np.array([1, 2])
    for op, sign in (("max", -1.0), ("min", 1.0)):
        a = execbase.AggPartial(op, [k[0]], wends, comp=np.array(
            [[[sign * 5.0, 1.0], [sign * 7.0, 1.0]]]))
        b = execbase.AggPartial(op, [k[1], k[0]], wends, comp=np.array(
            [[[sign * 3.0, 1.0], [np.nan, 0.0]],
             [[sign * 6.0, 1.0], [sign * 9.0, 1.0]]]))
        out = execbase.present_partial(execbase.reduce_partials([a, b]))
        pick = max if op == "max" else min
        np.testing.assert_array_equal(out.values, np.array(
            [[pick(sign * 5.0, sign * 6.0), pick(sign * 7.0, sign * 9.0)],
             [sign * 3.0, np.nan]]))


@pytest.mark.parametrize("kind,ragged", [
    ("last_over_time", False), ("last_over_time", True),
    ("sum_over_time", True), ("avg_over_time", False),
    ("count_over_time", True)])
def test_plain_group_mode_is_deterministic(kind, ragged):
    """The plain versions of K4/K5 sum in the kernels' fixed order, here
    with 5-row chunks so groups span several: two runs give the same
    bits, pad groups stay zero, and the per-series mode summed per group
    in the same order gives the group mode's bits."""
    S, T, G = 64, 90, 4
    raw = _gauges(S, T, 0.1 if ragged else 0.0, 2, base=1e6)
    reb, vbase = rebase_values(raw, False)
    ts_row = np.arange(T, dtype=np.int64) * STEP
    plan = tf.build_plan(ts_row, make_window_ends(30 * STEP, 85 * STEP,
                                                  5 * STEP), 30 * STEP)
    vals = tf.pad_values(torch.from_numpy(reb.astype(np.float32)),
                         torch.from_numpy(vbase.astype(np.float32)), plan)
    g = tf.pad_groups((np.arange(S) % G).astype(np.int32), S, G,
                      device="cpu")
    Gp = tf.pad_group_count(G)
    ch = tf.chunk_plan(g.csr.offsets, Gp, "cpu", chunk_rows=5)
    rows = plan.device_rows("cpu")
    args = (vals.vals_p, vals.vbase_p, g.csr, ch, rows, Gp)
    a = tf.group_launch(kind, ragged, *args)
    b = tf.group_launch(kind, ragged, *args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
        assert not x[G:].any()
    per, pres = tf.fused_per_series(vals.vals_p, vals.vbase_p, rows, S,
                                    kind, ragged)
    planes = [per] if pres is None else [per, pres]
    order = g.csr.order.long()
    again = tf._chunked_group_sum([p[order] for p in planes], ch, Gp)
    for x, y in zip(a, again):
        assert torch.equal(x, y)


@pytest.mark.parametrize("op", ["min", "max", "count"])
def test_map_phase_one_group_matches_scatter(op):
    """One group takes a column reduction instead of the scatter; both
    give the same bits (an extra empty group keeps the scatter path)."""
    x = torch.from_numpy(_gauges(50, 30, 0.3, 6).astype(np.float32))
    x[4] = float("inf")
    gids = torch.zeros(50, dtype=torch.int32)
    one = tagg.map_phase(op, x, gids, 1)
    two = tagg.map_phase(op, x, gids, 2)
    assert torch.equal(one, two[:1])
