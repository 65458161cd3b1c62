"""The port's kernel-level API of the fused kernel (filodb_tpu_torch.ops.
fused: fused_rate_groupsum, fused_leaf_agg, run_kernel, pad_inputs) over
raw counters — K2, the in-kernel reset correction, and K7, the matmul
selections — against the JAX package's Pallas kernel in interpret mode,
the scalar f64 oracle (tests/oracle.py) and a line-by-line model of the
CUDA kernel's warp.

The same numpy inputs, made from a seed, go through
filodb_tpu.ops.pallas_fused (interpret=True) and the port on the CPU (its
plain torch versions).  Tolerances are the reference's own: dense rtol
2e-5 / atol 1e-4 (tests/test_pallas_fused.py:63), ragged and oracle rtol
5e-4 / atol 1e-4 (:478), leaf aggregates rtol 5e-4 / atol 1e-3 (:224).
The port sums the drops in another association than the reference's
Hillis-Steele doubling, so it matches JAX to tolerance, not to the bit.
"""
import re
import types

import numpy as np
import pytest
import torch

from filodb_tpu.ops import agg as jagg
from filodb_tpu.ops import pallas_fused as pf
from filodb_tpu.ops.counter import rebase_values
from filodb_tpu.ops.timewindow import make_window_ends
from filodb_tpu_torch.ops import agg as tagg
from filodb_tpu_torch.ops import fused as tf
from filodb_tpu_torch.ops import kernels
from test_torch_ingest import _clear_compile_journal  # noqa: F401

STEP = 10_000
DENSE_TOL = dict(rtol=2e-5, atol=1e-4)
RAGGED_TOL = dict(rtol=5e-4, atol=1e-4)
LEAF_TOL = dict(rtol=5e-4, atol=1e-3)


def _counters(S, T, seed, resets_per_series, hole_frac=0.0):
    """Counters with exponential increments, `resets_per_series` restarts
    at random slots of each series, and optional NaN scrape gaps."""
    rng = np.random.default_rng(seed)
    raw = np.cumsum(rng.exponential(10.0, size=(S, T)), axis=1)
    for s in range(S):
        for r in rng.choice(np.arange(6, T), size=resets_per_series,
                            replace=False):
            raw[s, r:] = raw[s, r:] - raw[s, r - 1] + rng.exponential(5.0)
    if hole_frac:
        raw[rng.random((S, T)) < hole_frac] = np.nan
    return raw


def _case(name):
    """(raw [S, T] f64, ts_row, wends, range_ms, G, ragged) per case."""
    if name == "mk":          # tests/test_pallas_fused.py:24, one reset
        rng = np.random.default_rng(0)
        raw = np.cumsum(rng.exponential(10.0, size=(120, 160)), axis=1)
        raw[::7, 80:] *= 0.1
        return (raw, np.arange(160, dtype=np.int64) * STEP,
                make_window_ends(40 * STEP, 150 * STEP, 6 * STEP),
                30 * STEP, 5, False)
    if name == "multi_reset_to_end":  # several resets, last window at T-1
        raw = _counters(96, 130, 3, resets_per_series=6)
        return (raw, np.arange(130, dtype=np.int64) * STEP,
                make_window_ends(39 * STEP, 129 * STEP, 6 * STEP),
                30 * STEP, 7, False)
    if name == "ragged":      # tests/test_pallas_fused.py:429
        raw = _counters(64, 120, 11, resets_per_series=2, hole_frac=0.15)
        return (raw, np.arange(120, dtype=np.int64) * STEP,
                make_window_ends(40 * STEP, 110 * STEP, 6 * STEP),
                30 * STEP, 4, True)
    if name == "ragged_multi_reset_to_end":
        raw = _counters(80, 140, 5, resets_per_series=5, hole_frac=0.15)
        raw[3, 20:100] = np.nan          # a NaN run across many lanes
        raw[4, :] = np.nan               # a fully absent series
        return (raw, np.arange(140, dtype=np.int64) * STEP,
                make_window_ends(43 * STEP, 139 * STEP, 6 * STEP),
                30 * STEP, 6, True)
    raise KeyError(name)


DENSE_CASES = ("mk", "multi_reset_to_end")
RAGGED_CASES = ("ragged", "ragged_multi_reset_to_end")


def _inputs(name, precor=False, fn="rate"):
    raw, ts_row, wends, range_ms, G, ragged = _case(name)
    reb, vbase = rebase_values(raw, precor and fn != "delta")
    gids = (np.arange(raw.shape[0]) % G).astype(np.int32)
    return (raw, reb.astype(np.float32), vbase.astype(np.float32), gids,
            ts_row, wends, range_ms, G, ragged)


def _oracle_group_sum(raw, ts_row, wends, range_ms, fn, gids, G):
    from oracle import eval_series
    per = np.stack([eval_series(ts_row, raw[s], wends, range_ms, fn)
                    for s in range(raw.shape[0])])
    sums = np.zeros((G, len(wends)))
    counts = np.zeros((G, len(wends)))
    for s in range(raw.shape[0]):
        m = ~np.isnan(per[s])
        sums[gids[s], m] += per[s, m]
        counts[gids[s]] += m
    return np.where(counts > 0, sums, np.nan), per


def _groupsum_both(name, fn, precor=False, gather=None, jax_gather=None):
    raw, v32, vb32, gids, ts_row, wends, range_ms, G, ragged = \
        _inputs(name, precor, fn)
    jplan = pf.build_plan(ts_row, wends, range_ms)
    js, jc = pf.fused_rate_groupsum(v32, vb32, gids, jplan, G, fn_name=fn,
                                    precorrected=precor, interpret=True,
                                    ragged=ragged, gather=jax_gather)
    want = pf.present_sum(js, jc)
    tplan = tf.build_plan(ts_row, wends, range_ms)
    ts_, tc = tf.fused_rate_groupsum(v32, vb32, gids, tplan, G, fn_name=fn,
                                     precorrected=precor, ragged=ragged,
                                     gather=gather, device="cpu")
    assert ts_.shape == (G, len(wends)) and tc.shape == (G, len(wends))
    got = tf.present_sum(ts_, tc)
    return got, want, raw, gids, ts_row, wends, range_ms, G, ragged


def _assert_match(got, want, **tol):
    assert (np.isnan(got) == np.isnan(want)).all()
    np.testing.assert_allclose(got, want, equal_nan=True, **tol)


# ------------------------------------------- (a) dense, raw counters (K2)

@pytest.mark.parametrize("fn", ["rate", "increase", "delta"])
@pytest.mark.parametrize("case", DENSE_CASES)
def test_groupsum_raw_counters_dense_matches_jax_and_oracle(case, fn):
    got, want, raw, gids, ts_row, wends, range_ms, G, _ = \
        _groupsum_both(case, fn)
    _assert_match(got, want, **DENSE_TOL)
    ref, _ = _oracle_group_sum(raw, ts_row, wends, range_ms, fn, gids, G)
    _assert_match(got, ref, **RAGGED_TOL)


# ------------------------------------------ (b) ragged, raw counters (K2)

@pytest.mark.parametrize("fn", ["rate", "increase", "delta"])
@pytest.mark.parametrize("case", RAGGED_CASES)
def test_groupsum_raw_counters_ragged_matches_jax_and_oracle(case, fn):
    got, want, raw, gids, ts_row, wends, range_ms, G, _ = \
        _groupsum_both(case, fn)
    _assert_match(got, want, **RAGGED_TOL)
    ref, _ = _oracle_group_sum(raw, ts_row, wends, range_ms, fn, gids, G)
    _assert_match(got, ref, **RAGGED_TOL)


# ----------------------------- (c) fused_leaf_agg over raw counters (K2,
# and K6 over K2 for min/max)

@pytest.mark.parametrize("agg", ["sum", "avg", "count", "min", "max"])
@pytest.mark.parametrize("fn", ["rate", "increase"])
@pytest.mark.parametrize("case", ["mk", "ragged_multi_reset_to_end"])
def test_leaf_agg_raw_counters_matches_jax(case, fn, agg):
    raw, v32, vb32, gids, ts_row, wends, range_ms, G, ragged = _inputs(case)
    jplan = pf.build_plan(ts_row, wends, range_ms)
    jprep = pf.pad_inputs(v32, vb32, gids, jplan, G)
    jcomp = pf.fused_leaf_agg(jplan, jprep, gids, G, fn, agg,
                              precorrected=False, interpret=True,
                              ragged=ragged)
    tplan = tf.build_plan(ts_row, wends, range_ms)
    tprep = tf.pad_inputs(v32, vb32, gids, tplan, G, device="cpu")
    tcomp = tf.fused_leaf_agg(tplan, tprep, gids, G, fn, agg,
                              precorrected=False, ragged=ragged)
    assert tcomp.shape == np.asarray(jcomp).shape
    assert tcomp.shape[-1] == tagg.AGGREGATORS[agg].num_components
    import jax.numpy as jnp
    want = np.asarray(jagg.present(agg, jnp.asarray(jcomp)))
    got = tagg.present(agg, torch.from_numpy(tcomp)).numpy()
    _assert_match(got, want, **LEAF_TOL)


@pytest.mark.parametrize("case", ["multi_reset_to_end", "ragged"])
def test_leaf_agg_batch_raw_counters_panels_match_jax(case):
    """sum + avg merge into one K2 group launch, max rides one K2
    per-series launch; a second grouping of the sum panel too."""
    raw, v32, vb32, gids, ts_row, wends, range_ms, G, ragged = _inputs(case)
    S = raw.shape[0]
    g2 = ((np.arange(S) * 7 + 3) % 3).astype(np.int32)
    spec = [(gids, G, "sum"), (gids, G, "avg"), (gids, G, "max"),
            (g2, 3, "sum")]
    jplan = pf.build_plan(ts_row, wends, range_ms)
    jvals = pf.pad_values(v32, vb32, jplan)
    want = pf.fused_leaf_agg_batch(
        jplan, jvals, [(pf.pad_groups(g, S, n), n, o) for g, n, o in spec],
        "rate", precorrected=False, interpret=True, ragged=ragged,
        num_series=S)
    tplan = tf.build_plan(ts_row, wends, range_ms)
    tvals = tf.pad_values(torch.from_numpy(v32), torch.from_numpy(vb32),
                          tplan)
    got = tf.fused_leaf_agg_batch(
        tplan, tvals,
        [(tf.pad_groups(g, S, n, device="cpu"), n, o) for g, n, o in spec],
        "rate", precorrected=False, ragged=ragged)
    for w, g in zip(want, got):
        assert g.shape == np.asarray(w).shape
        _assert_match(g, np.asarray(w), **LEAF_TOL)


# ------------------------------------------------ (d) K7: gather=False

@pytest.mark.parametrize("fn,precor", [("rate", False), ("rate", True),
                                       ("increase", False), ("delta", False),
                                       ("last_over_time", False)])
@pytest.mark.parametrize("case", ["multi_reset_to_end", "ragged"])
def test_gather_false_matches_jax_matmul_form(case, fn, precor):
    """The reference's one-hot/step matmul selections (K7) against the
    port, whose gather=False launches the same kernels as gather=True."""
    got, want, *_, ragged = _groupsum_both(case, fn, precor, gather=False,
                                           jax_gather=False)
    _assert_match(got, want, **(RAGGED_TOL if ragged else DENSE_TOL))
    same, *_ = _groupsum_both(case, fn, precor, gather=True,
                              jax_gather=False)
    np.testing.assert_array_equal(got, same)


@pytest.mark.parametrize("fn", ["last_over_time", "delta"])
def test_inf_sample_matmul_form_differs_port_follows_gather(fn):
    """±Inf is a legal sample.  The reference's matmul form multiplies it
    by the zeros of every one-hot column (Inf x 0 = NaN), so the row turns
    NaN in EVERY window; the gather form, and the port, only where a
    window selects the Inf slot."""
    S, T, G = 8, 60, 2
    ts_row = np.arange(T, dtype=np.int64) * STEP
    v = (100.0 + np.random.default_rng(0).random((S, T))).astype(np.float32)
    v[3, 10] = np.inf
    gids = (np.arange(S) % G).astype(np.int32)
    wends = make_window_ends(30 * STEP, 59 * STEP, 6 * STEP)
    vb = np.zeros(S, np.float32)
    jplan = pf.build_plan(ts_row, wends, 30 * STEP)
    res = {g: np.asarray(pf.fused_rate_groupsum(
        v, vb, gids, jplan, G, fn_name=fn, interpret=True, gather=g)[0])
        for g in (True, False)}
    assert np.isnan(res[False][1]).all()
    assert np.isfinite(res[True][1]).all()
    tplan = tf.build_plan(ts_row, wends, 30 * STEP)
    for gather in (True, False):
        got = tf.fused_rate_groupsum(v, vb, gids, tplan, G, fn_name=fn,
                                     gather=gather, device="cpu")[0]
        np.testing.assert_allclose(got.numpy(), res[True], **DENSE_TOL)


# ------------------------------------------------ (e) prepared= reuse

@pytest.mark.parametrize("ragged_case", [False, True])
def test_prepared_inputs_reuse(ragged_case):
    raw, v32, vb32, gids, ts_row, wends, range_ms, G, ragged = _inputs(
        "ragged" if ragged_case else "mk")
    plan = tf.build_plan(ts_row, wends, range_ms)
    prep = tf.pad_inputs(v32, vb32, gids, plan, G, device="cpu")
    assert prep.values.vals_p is prep.vals_p
    assert prep.groups.csr is prep.csr
    a, ca = tf.fused_rate_groupsum(v32, vb32, gids, plan, G, ragged=ragged,
                                   device="cpu")
    b, cb = tf.fused_rate_groupsum(None, None, None, plan, G, ragged=ragged,
                                   prepared=prep)
    assert torch.equal(a, b)
    np.testing.assert_array_equal(ca, cb)
    c, _ = tf.fused_rate_groupsum(None, None, None, plan, G, ragged=ragged,
                                  prepared=prep, device="cpu")
    assert torch.equal(a, c)


def test_numpy_inputs_follow_the_device_rule(monkeypatch):
    """No device and numpy inputs mean the card: without one, raise."""
    from filodb_tpu_torch.utils.device import NoCudaDevice
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw, v32, vb32, gids, ts_row, wends, range_ms, G, _ = _inputs("mk")
    plan = tf.build_plan(ts_row, wends, range_ms)
    with pytest.raises(NoCudaDevice):
        tf.fused_rate_groupsum(v32, vb32, gids, plan, G)
    with pytest.raises(NoCudaDevice):
        tf.pad_inputs(v32, vb32, gids, plan, G)
    # a CPU tensor carries its device
    s, _ = tf.fused_rate_groupsum(torch.from_numpy(v32),
                                  torch.from_numpy(vb32), gids, plan, G)
    assert s.device.type == "cpu"


def test_warmup_compile_on_the_host():
    secs = tf.warmup_compile(700, 90, 12, 9, device="cpu")
    assert secs > 0


def test_gather_default_fixed_at_the_reference_default():
    assert tf.gather_default("rate_family") is True
    assert tf.gather_default("last_over_time") is True
    for kind in ("sum_over_time", "avg_over_time", "count_over_time"):
        assert tf.gather_default(kind) is False


# ------------------------------------ (f) the K2 plain version itself

def test_span_is_the_last_selected_slot_plus_one():
    raw, ts_row, wends, range_ms, _, _ = _case("multi_reset_to_end")
    plan = tf.build_plan(ts_row, wends, range_ms)
    assert plan.span == raw.shape[1] == int(plan.idx2.max()) + 1
    assert plan.device_rows("cpu").span == plan.span
    assert plan.Tp > plan.span           # the padded tail is never read


@pytest.mark.parametrize("case", ["multi_reset_to_end",
                                  "ragged_multi_reset_to_end"])
def test_drop_corrected_matches_f64_correction(case):
    """The corrected rows against the f64 host correction (rebased), and
    the per-series rates against the scalar oracle — rows with several
    resets, where the drops' summation order matters, and a last window
    ending at T-1 (the padded column T, which drops to 0, is never read)."""
    from oracle import eval_series
    raw, ts_row, wends, range_ms, _, ragged = _case(case)
    assert wends[-1] == ts_row[-1]
    reb, vbase = rebase_values(raw, False)
    plan = tf.build_plan(ts_row, wends, range_ms)
    vals = tf.pad_values(torch.from_numpy(reb.astype(np.float32)),
                         torch.from_numpy(vbase.astype(np.float32)), plan)
    c = tf._drop_corrected(vals.vals_p, vals.vbase_p, plan.span,
                           ragged).numpy()
    want, wb = rebase_values(raw, True)
    want = want + wb[:, None] - vbase[:, None]
    S = raw.shape[0]
    assert (np.isnan(c[:S]) == np.isnan(want)).all()
    np.testing.assert_allclose(c[:S], want, rtol=1e-6, atol=2e-3,
                               equal_nan=True)
    per, pres = tf.fused_per_series_plain(
        vals.vals_p, vals.vbase_p, plan.device_rows("cpu"), S,
        "rate_family", ragged, True, True, with_drops=True)
    ref = np.stack([eval_series(ts_row, raw[s], wends, range_ms, "rate")
                    for s in range(S)])
    got = per.numpy()
    if ragged:
        got = np.where(pres.numpy() > 0, got, np.nan)
    else:
        got = np.where(plan.wvalid[None, :], got, np.nan)
    _assert_match(got, ref, **RAGGED_TOL)


def _warp_model(row, vb, span, ragged):
    """The CUDA kernel's stage_corrected (csrc/fused_drops.cu), one lane
    at a time in float32 scalars: what the plain version must equal to
    the bit."""
    f = np.float32
    s = [f(x) for x in row[:span]]
    L = (span + 31) // 32
    lo = [min(lane * L, span) for lane in range(32)]
    hi = [min(a + L, span) for a in lo]

    def drop(x, prev, has):
        d = f(prev + f(vb)) if (has and x < prev) else f(0.0)
        if not ragged or x == x:
            prev, has = x, True
        return d, prev, has

    carry, has0, last = [], [], []
    for lane in range(32):
        lv, found = f(0.0), False
        for j in range(lo[lane], hi[lane]):
            if s[j] == s[j]:
                lv, found = s[j], True
        last.append((lv, found))
    for lane in range(32):
        if ragged:
            c, h = f(0.0), False
            for k in range(lane):
                if last[k][1]:
                    c, h = last[k][0], True
        else:
            c, h = (s[lo[lane] - 1], True) if lo[lane] > 0 else (f(0.0),
                                                                   False)
        carry.append(c)
        has0.append(h)
    totals = []
    for lane in range(32):
        t, prev, has = f(0.0), carry[lane], has0[lane]
        for j in range(lo[lane], hi[lane]):
            d, prev, has = drop(s[j], prev, has)
            t = f(t + d)
        totals.append(t)
    out = list(s)
    for lane in range(32):
        run = f(0.0)
        for k in range(lane):
            run = f(run + totals[k])
        prev, has = carry[lane], has0[lane]
        for j in range(lo[lane], hi[lane]):
            d, prev, has = drop(s[j], prev, has)
            run = f(run + d)
            out[j] = f(s[j] + run)
    return np.array(out, np.float32)


@pytest.mark.parametrize("span", [1, 5, 31, 32, 33, 100, 130])
@pytest.mark.parametrize("ragged", [False, True])
def test_drop_corrected_is_bit_identical_to_the_warp_model(span, ragged):
    """Large drops at many resets make every association round
    differently; the plain version must repeat the kernel's."""
    rng = np.random.default_rng(span + 7 * ragged)
    R = 6
    v = np.cumsum(rng.exponential(1e4, size=(R, 130)), axis=1)
    for r in range(R):
        for j in rng.choice(np.arange(1, 130), size=12, replace=False):
            v[r, j:] -= v[r, j] - rng.random()
    if ragged:
        v[rng.random(v.shape) < 0.3] = np.nan
        v[1, 10:120] = np.nan
    v = v.astype(np.float32)
    vb = (rng.random(R) * 3e6).astype(np.float32)
    got = tf._drop_corrected(torch.from_numpy(v), torch.from_numpy(vb),
                             span, ragged).numpy()
    for r in range(R):
        want = _warp_model(v[r], vb[r], span, ragged)
        np.testing.assert_array_equal(got[r].view(np.int32),
                                      want.view(np.int32))


def test_drops_only_apply_to_the_rate_family():
    raw, v32, vb32, gids, ts_row, wends, range_ms, G, _ = _inputs("mk")
    plan = tf.build_plan(ts_row, wends, range_ms)
    prep = tf.pad_inputs(v32, vb32, gids, plan, G, device="cpu")
    with pytest.raises(ValueError, match="rate family"):
        tf.run_kernel(prep.vals_p, prep.vbase_p, prep.groups,
                      plan.device_rows("cpu"), num_groups=8,
                      kind="sum_over_time", with_drops=True)


@pytest.mark.parametrize("ragged_case", [False, True])
def test_run_kernel_dispatches_every_rate_variant(ragged_case):
    """run_kernel by flags = the wrappers it dispatches to, in group and
    per-series mode, with and without drops."""
    raw, v32, vb32, gids, ts_row, wends, range_ms, G, ragged = _inputs(
        "ragged" if ragged_case else "mk")
    plan = tf.build_plan(ts_row, wends, range_ms)
    prep = tf.pad_inputs(v32, vb32, gids, plan, G, device="cpu")
    rows = plan.device_rows("cpu")
    Gp = tf.pad_group_count(G)
    chunks = tf.chunk_plan(prep.csr.offsets, Gp, "cpu")
    S = raw.shape[0]
    for drops in (False, True):
        g = tf.run_kernel(prep.vals_p, prep.vbase_p, prep.groups, rows,
                          num_groups=Gp, is_counter=True, is_rate=True,
                          with_drops=drops, ragged=ragged)
        want = tf.group_plain("rate_family", ragged, prep.vals_p,
                              prep.vbase_p, prep.csr, chunks, rows, Gp,
                              True, True, with_drops=drops)
        for a, b in zip(g if ragged else (g,), want if ragged else (want,)):
            assert a.shape == (Gp, plan.W) and torch.equal(a, b)
        p = tf.run_kernel(prep.vals_p, prep.vbase_p, None, rows,
                          num_groups=Gp, is_counter=True, is_rate=True,
                          with_drops=drops, ragged=ragged, per_series=True,
                          num_rows=S)
        pw = tf.fused_per_series_plain(prep.vals_p, prep.vbase_p, rows, S,
                                       "rate_family", ragged, True, True,
                                       with_drops=drops)
        for a, b in zip(p if ragged else (p,), pw):
            assert a.shape == (S, plan.W) and torch.equal(a, b)


def test_launch_names_of_the_drops_kernels():
    for ragged in (False, True):
        name = kernels._kernel_name("rate_family", ragged, with_drops=True)
        assert name in kernels.LAUNCHES
        assert name + "_series" in kernels.LAUNCHES
    assert "fused_drops" in kernels.SOURCES


def _c_params(src: str):
    """{entry point: [parameter declarations]} of a source's extern "C"
    functions."""
    body = src[src.index('extern "C" {'):]
    out = {}
    for m in re.finditer(r"int (\w+_launch)\((.*?)\)\s*\{", body, re.S):
        out[m.group(1)] = [p.strip() for p in m.group(2).split(",")]
    return out


def test_ctypes_bindings_match_the_c_entry_points():
    """Each bound entry point exists in its source with as many parameters
    as argtypes, each of the bound ctypes width (pointers c_void_p, long
    long c_longlong, int c_int) — the CPU's check of what only the card's
    loader would otherwise find."""
    import ctypes

    class Lib:
        def __init__(self):
            self.fns = {}

        def __getattr__(self, name):
            return self.fns.setdefault(name, types.SimpleNamespace())

    for name, path in kernels.SOURCES.items():
        lib = Lib()
        kernels._BINDERS[name](lib)
        params = _c_params(path.read_text())
        assert set(lib.fns) == set(params), name
        for fn, ns in lib.fns.items():
            decls = params[fn]
            assert len(ns.argtypes) == len(decls), fn
            for decl, ct in zip(decls, ns.argtypes):
                want = (ctypes.c_void_p if "*" in decl else
                        ctypes.c_longlong if "long long" in decl else
                        ctypes.c_int)
                assert ct is want, (fn, decl, ct)
            assert ns.restype is ctypes.c_int


# ---------------- adversarial ragged layouts (K2's plain version vs JAX)

@pytest.mark.parametrize("fn", ["rate", "increase"])
def test_groupsum_raw_counters_adversarial_ragged_matches_jax(fn):
    """NaN runs across tiles, lane runs and window edges, an all-NaN row,
    rows with one and two valid samples, W > 256, a span that is not a
    multiple of 4 and a one-row group, raw counters with resets: the plain
    K2 against the reference's ragged Pallas kernel (no ±Inf here: the
    reference's one-hot group sum spreads a NaN rate to every group; see
    test_ragged_plain_matches_jax_on_adversarial_rows)."""
    from test_torch_fused import _adversarial_ragged
    raw, ts_row, wends, range_ms = _adversarial_ragged(seed=22, inf=False)
    S, G = raw.shape[0], 4
    gids = np.concatenate([[0], 1 + np.arange(S - 1) % (G - 1)]).astype(
        np.int32)
    reb, vbase = rebase_values(raw, False)
    v32, vb32 = reb.astype(np.float32), vbase.astype(np.float32)
    jplan = pf.build_plan(ts_row, wends, range_ms)
    js, jc = pf.fused_rate_groupsum(v32, vb32, gids, jplan, G, fn_name=fn,
                                    precorrected=False, interpret=True,
                                    ragged=True)
    tplan = tf.build_plan(ts_row, wends, range_ms)
    assert tplan.W > 256 and tplan.span % 4
    ts_, tc = tf.fused_rate_groupsum(v32, vb32, gids, tplan, G, fn_name=fn,
                                     precorrected=False, ragged=True,
                                     device="cpu")
    np.testing.assert_array_equal(tc, np.asarray(jc))
    _assert_match(tf.present_sum(ts_, tc), pf.present_sum(js, jc),
                  **RAGGED_TOL)


def test_ptxas_report_reads_the_build_log(tmp_path, monkeypatch):
    """The build keeps nvcc's -Xptxas -v output beside each library;
    ptxas_report turns it into one row per kernel (what chip_smoke.py
    prints), and [] when there is no log."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    assert kernels.ptxas_report("fused_drops") == []
    kernels.library_path("fused_drops").with_suffix(".log").write_text(
        "ptxas info    : Compiling entry function '_Z4kernPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z4kernPf\n"
        "    24 bytes stack frame, 12 bytes spill stores, 20 bytes spill "
        "loads\n"
        "ptxas info    : Used 80 registers, 16 bytes smem, 400 bytes "
        "cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'\n"
        "ptxas info    : Used 32 registers, 400 bytes cmem[0]\n")
    assert kernels.ptxas_report("fused_drops") == [
        dict(kernel="_Z4kernPf", registers=80, smem=16, spill_stores=12,
             spill_loads=20),
        dict(kernel="_Z5otherv", registers=32, smem=0, spill_stores=0,
             spill_loads=0)]


def test_no_fit_code_raises_value_error():
    """csrc/rate_stage.cuh alone decides whether a staged launch fits in
    shared memory: its launchers return kNoFit, which the wrappers turn
    into a ValueError (any other non-zero code is a CUDA error)."""
    src = (kernels.CSRC / "rate_stage.cuh").read_text()
    m = re.search(r"constexpr int kNoFit = (-?\d+);", src)
    assert m and int(m.group(1)) == kernels.NO_FIT
    with pytest.raises(ValueError, match="shared memory"):
        kernels._raise_on(kernels.NO_FIT, "fused_rate_drops_ragged")
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        kernels._raise_on(700, "fused_rate_ragged")
    kernels._raise_on(0, "fused_rate_ragged")
