"""The port's fused rate/group-sum leaf (filodb_tpu_torch.ops.fused) vs the
JAX package's Pallas kernel in interpret mode and vs the f64 oracle.

The same numpy inputs, made from a seed, go through
filodb_tpu.ops.pallas_fused.fused_leaf_agg_batch(..., interpret=True) and
the port's fused_leaf_agg_batch on the CPU (its plain torch versions of
kernels K1 and K3), for rate/increase/delta x sum/avg/count x one and two
panels, on the shapes of tests/test_pallas_fused.py.  Tolerances are the
reference's own: dense rtol 2e-5 / atol 1e-4 (test_pallas_fused.py:63),
ragged rtol 5e-4 / atol 1e-4 (:478), and the oracle comparison uses the
ragged ones (f32 kernel vs f64 scalar model).
"""
import numpy as np
import pytest
import torch

from filodb_tpu.ops import pallas_fused as pf
from filodb_tpu.ops.counter import rebase_values
from filodb_tpu.ops.timewindow import make_window_ends
from filodb_tpu_torch.ops import agg as tagg
from filodb_tpu_torch.ops import fused as tf
from test_torch_ingest import _clear_compile_journal  # noqa: F401

STEP = 10_000


def _counters(rng, S, T, resets):
    raw = np.cumsum(rng.exponential(10.0, size=(S, T)), axis=1)
    if resets:
        raw[::7, T // 2:] *= 0.1          # counter resets mid-series
    return raw


def _ragged_counters(rng, S, T, hole_frac=0.15, resets_per_series=2):
    raw = np.cumsum(rng.exponential(10.0, size=(S, T)), axis=1)
    for s in range(S):
        for r in rng.choice(np.arange(6, T), size=resets_per_series,
                            replace=False):
            raw[s, r:] = raw[s, r:] - raw[s, r - 1] + rng.exponential(5.0)
    raw[rng.random((S, T)) < hole_frac] = np.nan
    return raw


def _shape(name):
    """(raw [S, T] f64, ts_row, wends, range_ms, G, ragged) per case —
    the inputs of the test_pallas_fused.py test of the same name."""
    if name == "matches_xla_path":
        rng = np.random.default_rng(0)
        raw = _counters(rng, 120, 160, resets=True)
        return (raw, np.arange(160, dtype=np.int64) * STEP,
                make_window_ends(40 * STEP, 150 * STEP, 6 * STEP),
                30 * STEP, 5, False)
    if name == "sparse_windows_and_edges":
        rng = np.random.default_rng(0)
        raw = _counters(rng, 40, 50, resets=False)
        return (raw, np.arange(50, dtype=np.int64) * STEP,
                make_window_ends(-5 * STEP, 70 * STEP, STEP),
                2 * STEP, 3, False)
    if name == "large_counter_rebase_precision":
        rng = np.random.default_rng(1)
        raw = 2.0**30 + np.cumsum(rng.integers(1, 100, size=(16, 100)),
                                  axis=1).astype(np.float64)
        return (raw, np.arange(100, dtype=np.int64) * STEP,
                make_window_ends(40 * STEP, 90 * STEP, 5 * STEP),
                30 * STEP, 2, False)
    if name == "ragged_rate_family":
        rng = np.random.default_rng(11)
        raw = _ragged_counters(rng, 64, 120)
        return (raw, np.arange(120, dtype=np.int64) * STEP,
                make_window_ends(40 * STEP, 110 * STEP, 6 * STEP),
                30 * STEP, 4, True)
    raise KeyError(name)


SHAPES = ("matches_xla_path", "sparse_windows_and_edges",
          "large_counter_rebase_precision", "ragged_rate_family")


def _both(name, fn, op, panels):
    """Run the JAX interpret-mode kernel and the port on one input; return
    (jax comps, port comps, raw, ts_row, wends, range_ms, groupings)."""
    raw, ts_row, wends, range_ms, G, ragged = _shape(name)
    S = raw.shape[0]
    precor = fn != "delta"
    reb, vbase = rebase_values(raw, precor)
    v32, vb32 = reb.astype(np.float32), vbase.astype(np.float32)
    groupings = [((np.arange(S) % G).astype(np.int32), G)]
    if panels == 2:
        g2 = max(G - 1, 2)
        groupings.append((((np.arange(S) * 7 + 3) % g2).astype(np.int32), g2))
    ops = [op] + ["sum"] * (panels - 1)

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
                                  ragged=ragged)
    return want, got, raw, ts_row, wends, range_ms, groupings, ops, ragged


def _oracle_agg(raw, ts_row, wends, range_ms, fn, gids, G, op):
    from oracle import eval_series
    per = np.stack([eval_series(ts_row, raw[s], wends, range_ms, fn)
                    for s in range(raw.shape[0])])
    sums = np.zeros((G, len(wends)))
    counts = np.zeros((G, len(wends)))
    for s in range(raw.shape[0]):
        m = ~np.isnan(per[s])
        sums[gids[s], m] += per[s, m]
        counts[gids[s]] += m
    if op == "count":
        out = counts
    elif op == "avg":
        out = sums / np.maximum(counts, 1)
    else:
        out = sums
    return np.where(counts > 0, out, np.nan)


@pytest.mark.parametrize("panels", [1, 2])
@pytest.mark.parametrize("op", ["sum", "avg", "count"])
@pytest.mark.parametrize("fn", ["rate", "increase", "delta"])
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_leaf_agg_batch_matches_jax_and_oracle(shape, fn, op, panels):
    want, got, raw, ts_row, wends, range_ms, groupings, ops, ragged = \
        _both(shape, fn, op, panels)
    rtol, atol = (5e-4, 1e-4) if ragged else (2e-5, 1e-4)
    assert len(got) == len(want) == panels
    for w, g, o in zip(want, got, ops):
        assert g.shape == w.shape
        assert (np.isnan(g) == np.isnan(w)).all()
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, equal_nan=True)
        assert g.shape[-1] == tagg.AGGREGATORS[o].num_components
    for comp, (gids, G), o in zip(got, groupings, ops):
        res = tagg.present(o, torch.from_numpy(comp)).numpy()
        ref = _oracle_agg(raw, ts_row, wends, range_ms, fn, gids, G, o)
        assert (np.isnan(res) == np.isnan(ref)).all()
        np.testing.assert_allclose(res, ref, rtol=5e-4, atol=1e-4,
                                   equal_nan=True)


def test_kernel_plain_versions_are_deterministic():
    """The plain versions sum in the kernels' fixed order, here with
    5-row chunks so groups span several: two runs give the same bits, and
    padding groups stay zero."""
    raw, ts_row, wends, range_ms, G, _ = _shape("ragged_rate_family")
    reb, vbase = rebase_values(raw, True)
    plan = tf.build_plan(ts_row, wends, range_ms)
    vals = tf.pad_values(torch.from_numpy(reb.astype(np.float32)),
                         torch.from_numpy(vbase.astype(np.float32)), plan)
    g = tf.pad_groups((np.arange(raw.shape[0]) % G).astype(np.int32),
                      raw.shape[0], G, device="cpu")
    Gp = tf.pad_group_count(G)
    ch = tf.chunk_plan(g.csr.offsets, Gp, "cpu", chunk_rows=5)
    rows = plan.device_rows("cpu")
    a = tf.fused_rate_ragged(vals.vals_p, vals.vbase_p, g.csr, ch, rows, Gp,
                             True, True)
    b = tf.fused_rate_ragged(vals.vals_p, vals.vbase_p, g.csr, ch, rows, Gp,
                             True, True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # pad groups own no chunks and stay zero
    assert not a[0][G:].any() and not a[1][G:].any()


@pytest.mark.parametrize("chunk_rows", [1, 3, 256])
def test_chunk_plan_covers_every_row_once(chunk_rows):
    rng = np.random.default_rng(5)
    gids = rng.integers(0, 9, size=200).astype(np.int32)
    gids[gids == 4] = 5                    # an empty group
    g = tf.pad_groups(gids, 200, 9, device="cpu")
    ch = tf.chunk_plan(g.csr.offsets, tf.pad_group_count(9), "cpu",
                       chunk_rows=chunk_rows)
    lo, hi, gco = ch.lo.numpy(), ch.hi.numpy(), ch.gco.numpy()
    assert (hi - lo <= chunk_rows).all() and (hi > lo).all()
    covered = np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)])
    np.testing.assert_array_equal(covered, np.arange(200))
    order = g.csr.order.numpy()
    for grp in range(9):
        rows = np.concatenate([order[lo[c]:hi[c]]
                               for c in range(gco[grp], gco[grp + 1])]
                              or [np.zeros(0, np.int64)])
        np.testing.assert_array_equal(rows, np.flatnonzero(gids == grp))
    assert gco[9] == gco[-1] == lo.size


# ---------------- adversarial ragged layouts (K3's plain version vs JAX)

def _adversarial_ragged(seed=21, S=70, T=301, inf=True, jitter=True):
    """Counters with NaN runs across 32-slot tiles, lane runs and window
    edges, an all-NaN row, rows with one and two valid samples and (inf)
    ±Inf samples; windows one slot apart from before the grid to past its
    end (W = 371 > 256, empty and one-sample windows at both ends, span =
    T, not a multiple of 4).  The scrapes are jittered by up to 1 s off
    the 10 s grid, as real scrapes are; on an exact grid (jitter=False) a
    window's trailing gap can sit on the extrapolation's threshold, 1.1 x
    the average spacing
    (test_exact_grid_threshold_tie_agrees_with_reference_and_oracle)."""
    rng = np.random.default_rng(seed)
    raw = np.cumsum(rng.exponential(10.0, size=(S, T)), axis=1)
    for s in range(S):
        for r in rng.choice(np.arange(6, T), size=2, replace=False):
            raw[s, r:] = raw[s, r:] - raw[s, r - 1] + rng.exponential(5.0)
    starts = rng.random((S, T)) < 0.0146
    ends = np.where(starts, np.arange(T)[None, :]
                    + rng.integers(1, 48, size=(S, T)) - 1, -1)
    raw[np.maximum.accumulate(ends, axis=1) >= np.arange(T)[None, :]] = \
        np.nan
    raw[0] = np.nan
    raw[1] = np.nan
    raw[1, 150] = 7.0
    raw[2] = np.nan
    raw[2, [149, 152]] = [3.0, 9.0]
    if inf:
        raw[3, 77] = np.inf
        raw[4, 200] = -np.inf
    raw[5, 28:70] = np.nan
    raw[6, 31:33] = np.nan
    raw[7, 9:40] = np.nan
    ts_row = np.arange(T, dtype=np.int64) * STEP + rng.integers(0, 997, T) \
        * jitter
    wends = np.arange(-50, T + 20, dtype=np.int64) * STEP
    return raw, ts_row, wends, 30 * STEP


@pytest.mark.parametrize("fn", ["rate", "increase", "delta"])
@pytest.mark.parametrize("op", ["sum", "count", "max"])
def test_ragged_plain_matches_jax_on_adversarial_rows(fn, op):
    """±Inf samples ride the count and max panels only: the reference sums
    groups by a one-hot matmul, in which a row's NaN rate (Inf - Inf)
    times the zeros of the other groups turns every group NaN — the
    recorded matmul difference (ROADMAP Queue 3); the port sums each group
    on its own."""
    raw, ts_row, wends, range_ms = _adversarial_ragged(inf=op != "sum")
    S, G = raw.shape[0], 5
    gids = np.concatenate([[0], 1 + np.arange(S - 1) % (G - 1)]).astype(
        np.int32)                            # group 0: a one-row chunk
    precor = fn != "delta"
    reb, vbase = rebase_values(raw, precor)
    v32, vb32 = reb.astype(np.float32), vbase.astype(np.float32)
    plan = pf.build_plan(ts_row, wends, range_ms)
    assert plan.W > 256 and int(plan.idx2.max() + 1) % 4
    want = pf.fused_leaf_agg_batch(
        plan, pf.pad_values(v32, vb32, plan),
        [(pf.pad_groups(gids, S, G), G, op)], fn, precorrected=precor,
        interpret=True, ragged=True, num_series=S)[0]
    tplan = tf.build_plan(ts_row, wends, range_ms)
    got = tf.fused_leaf_agg_batch(
        tplan, tf.pad_values(torch.from_numpy(v32), torch.from_numpy(vb32),
                             tplan),
        [(tf.pad_groups(gids, S, G, device="cpu"), G, op)], fn,
        precorrected=precor,
        ragged=True)[0]
    w = np.asarray(tagg.present(op, torch.from_numpy(np.asarray(want))))
    g = tagg.present(op, torch.from_numpy(got)).numpy()
    assert (np.isnan(g) == np.isnan(w)).all()
    np.testing.assert_allclose(g, w, rtol=5e-4, atol=1e-4, equal_nan=True)
    if op == "sum":
        ref = _oracle_agg(raw, ts_row, wends, range_ms, fn, gids, G, op)
        assert (np.isnan(g) == np.isnan(ref)).all()
        np.testing.assert_allclose(g, ref, rtol=5e-4, atol=1e-4,
                                   equal_nan=True)


def test_exact_grid_threshold_tie_agrees_with_reference_and_oracle():
    """On the exact 10 s grid, row 9 of seed 21 has 12 valid samples 200 s
    apart and a 20 s trailing gap in windows 342 and 348: the gap sits on
    the extrapolation threshold 1.1 x 200 / 11.  The reference compiles
    its `/ 1000.0` to a multiply by the f32 reciprocal, which puts the
    threshold a hair above 20 s, on the f64 oracle's side; the port's
    plain rate (and K1/K2/K3 with it) multiplies the same way, so the
    port, the reference (interpret mode) and tests/oracle.py agree in
    every window, the tie included."""
    from oracle import eval_series
    raw, ts_row, wends, range_ms = _adversarial_ragged(inf=False,
                                                       jitter=False)
    raw = raw[9:10]
    reb, vbase = rebase_values(raw, True)
    v32, vb32 = reb.astype(np.float32), vbase.astype(np.float32)
    gids = np.zeros(1, np.int32)
    plan = pf.build_plan(ts_row, wends, range_ms)
    want = pf.fused_leaf_agg_batch(
        plan, pf.pad_values(v32, vb32, plan),
        [(pf.pad_groups(gids, 1, 1), 1, "sum")], "rate", precorrected=True,
        interpret=True, ragged=True, num_series=1)[0]
    tplan = tf.build_plan(ts_row, wends, range_ms)
    got = tf.fused_leaf_agg_batch(
        tplan, tf.pad_values(torch.from_numpy(v32), torch.from_numpy(vb32),
                             tplan),
        [(tf.pad_groups(gids, 1, 1, device="cpu"), 1, "sum")], "rate",
        precorrected=True, ragged=True)[0]
    jax_rate = np.asarray(tagg.present("sum", torch.from_numpy(
        np.asarray(want))))[0]
    port = tagg.present("sum", torch.from_numpy(got)).numpy()[0]
    ref = eval_series(ts_row, raw[0], wends, range_ms, "rate")
    tie = [342, 348]
    assert not np.isnan(ref[tie]).any()
    for other in (jax_rate, ref):
        assert (np.isnan(port) == np.isnan(other)).all()
        np.testing.assert_allclose(port, other, rtol=5e-4, atol=1e-4,
                                   equal_nan=True)
        np.testing.assert_allclose(port[tie], other[tie], rtol=5e-4)
    # the tie is real: divided, the f32 threshold is exactly 20 s and the
    # trailing gap would take half a spacing instead of its own 20 s
    ms_to_s = np.float32(0.001)
    sampled = np.float32(200_000) * ms_to_s
    threshold = sampled / np.float32(11.0) * np.float32(1.1)
    assert np.float32(20_000) * ms_to_s < threshold
    assert not np.float32(20_000) / np.float32(1000.0) \
        < np.float32(200_000) / np.float32(1000.0) / np.float32(11.0) \
        * np.float32(1.1)


# ------------- the O(1) ragged window of csrc/rate_stage.cuh, modelled

def _tile_tables(valid):
    """Per 32-slot tile: (mask, valid slots before, last valid slot before
    or -1, first valid slot after or None) — what build_tables stores."""
    n = valid.size
    nt = -(-n // 32)
    out, cnt, last = [], 0, -1
    for t in range(nt):
        bits = valid[32 * t:32 * t + 32]
        mask = sum(1 << int(b) for b in np.flatnonzero(bits))
        out.append([mask, cnt, last, None])
        cnt += int(bits.sum())
        if bits.any():
            last = 32 * t + int(np.flatnonzero(bits)[-1])
    nxt = None
    for t in range(nt - 1, -1, -1):
        out[t][3] = nxt
        bits = valid[32 * t:32 * t + 32]
        if bits.any():
            nxt = 32 * t + int(np.flatnonzero(bits)[0])
    return out


def _window(tab, i1, i2):
    """ragged_window: (valid count in [i1, i2], first valid >= i1, last
    valid <= i2) from two tile entries."""
    a, b = tab[i1 >> 5], tab[i2 >> 5]
    before1 = (1 << (i1 & 31)) - 1
    upto2 = b[0] & ((2 << (i2 & 31)) - 1)
    from1 = a[0] & ~before1
    j1 = (i1 & ~31) + (from1 & -from1).bit_length() - 1 if from1 else a[3]
    j2 = (i2 & ~31) + upto2.bit_length() - 1 if upto2 else b[2]
    nv = b[1] + bin(upto2).count("1") - a[1] - bin(a[0] & before1).count("1")
    return nv, j1, j2


@pytest.mark.parametrize("seed", range(4))
def test_tile_tables_select_what_the_scan_selects(seed):
    """Two table lookups give the valid count and the first and last valid
    slot of any window — the operands the plain version's prefix scans
    (ops/fused._ragged_rates) and the old slot-by-slot scan select."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(33, 700))
    v = rng.random(n)
    v[rng.random(n) < [0.0, 0.3, 0.9, 1.0][seed]] = np.nan
    v[int(rng.integers(0, n)):][:int(rng.integers(1, 80))] = np.nan
    tab = _tile_tables(~np.isnan(v))
    for _ in range(400):
        i1 = int(rng.integers(0, n - 1))
        i2 = int(rng.integers(i1 + 1, n))
        nv, j1, j2 = _window(tab, i1, i2)
        ok = np.flatnonzero(~np.isnan(v[i1:i2 + 1])) + i1
        assert nv == ok.size
        if ok.size:
            assert (j1, j2) == (ok[0], ok[-1])
