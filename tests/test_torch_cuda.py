"""filodb_tpu_torch's CUDA kernels (K1 dense and K3 ragged rate, K2 rate
over raw counters, K4 last_over_time, K5 sum/avg/count_over_time, each
also in its per-series mode K6) against their plain torch versions, on
the card; the native histogram leaf, the host route and a plan node on
the card against the same queries on the CPU; an RF-2 cluster's failover
and a handoff's tombstone on the card; a cold-read cluster with
query-only nodes and a dead object store under a query tier on the
card.  Marked `cuda`: without a card they skip.  This file imports
neither jax nor filodb_tpu, so it also runs on a machine with only the
port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from filodb_tpu_torch.ops import fused, kernels

pytestmark = pytest.mark.cuda

SMEM = 232_448          # bytes of shared memory one block may use on sm_90


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


def _inputs(device, S, T, groups, hole_frac, seed, resets=0):
    rng = np.random.default_rng(seed)
    ts = np.arange(T, dtype=np.int64) * 10_000
    plan = fused.build_plan(ts, np.arange(300_000, int(ts[-1]) + 1, 60_000),
                            300_000)
    raw = np.cumsum(rng.exponential(10.0, size=(S, T)), axis=1)
    for _ in range(resets):                 # raw counter restarts
        at = rng.integers(1, T, size=S)
        after = np.arange(T)[None, :] >= at[:, None]
        raw = np.where(after, raw - raw[np.arange(S), at - 1][:, None]
                       + rng.exponential(5.0, size=(S, 1)), raw)
    raw[rng.random((S, T)) < hole_frac] = np.nan
    vals = fused.pad_values(torch.from_numpy(raw.astype(np.float32)),
                            torch.from_numpy(rng.random(S) * 1e3), plan,
                            device=device)
    pg = [fused.pad_groups(rng.integers(0, g, size=S), S, g, device=device)
          for g in groups]
    csr, _, total = fused.merge_groups(pg, groups)
    Gp = fused.pad_group_count(total)
    return (vals.vals_p, vals.vbase_p, csr,
            fused.chunk_plan(csr.offsets, Gp, device),
            plan.device_rows(device), Gp)


@pytest.mark.parametrize("fn", ["rate", "increase", "delta"])
@pytest.mark.parametrize("ragged", [False, True])
def test_kernel_matches_plain_and_repeats_bit_identically(card, ragged, fn):
    args = _inputs(card, 3001, 257, (11, 4), 0.05 if ragged else 0.0, 1)
    flags = (fn != "delta", fn == "rate")
    wrap = fused.fused_rate_ragged if ragged else fused.fused_rate_dense
    plain = (fused.fused_rate_ragged_plain if ragged
             else fused.fused_rate_dense_plain)
    name = "fused_rate_ragged" if ragged else "fused_rate_dense"
    n0 = kernels.LAUNCHES[name]
    a, b = wrap(*args, *flags), wrap(*args, *flags)
    p = plain(*args, *flags)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == n0 + 2
    a, b, p = [x if isinstance(x, tuple) else (x,) for x in (a, b, p)]
    for x, y, z in zip(a, b, p):
        assert torch.equal(x, y)
        torch.testing.assert_close(x, z, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("kind", ["last_over_time", "sum_over_time",
                                  "avg_over_time", "count_over_time"])
@pytest.mark.parametrize("ragged", [False, True])
def test_slot_kernels_match_plain_and_repeat(card, ragged, kind):
    vals_p, vbase_p, csr, chunks, rows, Gp = _inputs(
        card, 3001, 257, (11, 4), 0.05 if ragged else 0.0, 3)
    args = (vals_p, vbase_p, csr, chunks, rows, Gp)
    name = kernels._kernel_name(kind, ragged)
    n0 = kernels.LAUNCHES[name]
    a = fused.fused_over_time(*args, kind, ragged)
    b = fused.fused_over_time(*args, kind, ragged)
    p = fused.fused_over_time_plain(*args, kind, ragged)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == n0 + 2
    a, b, p = [x if isinstance(x, tuple) else (x,) for x in (a, b, p)]
    for x, y, z in zip(a, b, p):
        assert torch.equal(x, y)
        torch.testing.assert_close(x, z, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("kind", ["rate_family", "last_over_time",
                                  "sum_over_time", "avg_over_time",
                                  "count_over_time"])
@pytest.mark.parametrize("ragged", [False, True])
def test_per_series_kernels_match_plain(card, ragged, kind):
    vals_p, vbase_p, _, _, rows, _ = _inputs(
        card, 2049, 300, (5,), 0.05 if ragged else 0.0, 4)
    name = kernels._kernel_name(kind, ragged) + "_series"
    n0 = kernels.LAUNCHES[name]
    a = fused.fused_per_series(vals_p, vbase_p, rows, 2001, kind, ragged,
                               True, True)
    b = fused.fused_per_series(vals_p, vbase_p, rows, 2001, kind, ragged,
                               True, True)
    p = fused.fused_per_series_plain(vals_p, vbase_p, rows, 2001, kind,
                                     ragged, True, True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == n0 + 2
    assert (a[1] is None) == (not ragged) == (p[1] is None)
    for x, y, z in zip(a, b, p):
        if x is None:
            continue
        assert x.shape == (2001, rows.idx1.numel())
        assert torch.equal(x, y)
        torch.testing.assert_close(x, z, rtol=1e-6, atol=1e-5)


def test_kernel_rejects_bad_inputs(card):
    vals_p, vbase_p, csr, chunks, rows, Gp = _inputs(card, 64, 100, (3,),
                                                      0.0, 2)
    with pytest.raises(ValueError, match="dtype"):
        kernels.fused_rate_dense_cuda(vals_p.double(), vbase_p, csr.order,
                                      chunks, rows, Gp, True, True)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.fused_rate_dense_cuda(vals_p.t().contiguous().t(), vbase_p,
                                      csr.order, chunks, rows, Gp, True, True)
    with pytest.raises(ValueError, match="num_rows"):
        kernels.fused_per_series_cuda(vals_p, vbase_p, rows,
                                      vals_p.shape[0] + 1, "sum_over_time",
                                      False)


@pytest.mark.parametrize("fn", ["rate", "increase"])
@pytest.mark.parametrize("ragged", [False, True])
def test_drops_kernel_matches_plain_and_repeats(card, ragged, fn):
    """K2 in group mode over raw counters with several resets: the same
    bits as its plain version, twice; gather=False launches it too."""
    args = _inputs(card, 3001, 257, (11, 4), 0.05 if ragged else 0.0, 5,
                   resets=4)
    flags = (True, fn == "rate")
    name = kernels._kernel_name("rate_family", ragged, with_drops=True)
    n0 = kernels.LAUNCHES[name]
    a = fused.fused_rate_drops(*args, *flags, ragged)
    b = fused.fused_rate_drops(*args, *flags, ragged)
    p = fused.fused_rate_drops_plain(*args, *flags, ragged)
    vals_p, vbase_p, csr, _, rows, Gp = args
    c = fused.run_kernel(vals_p, vbase_p, csr, rows, num_groups=Gp,
                         is_counter=True, is_rate=flags[1], with_drops=True,
                         ragged=ragged, gather=False)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == n0 + 3
    a, b, p, c = [x if isinstance(x, tuple) else (x,) for x in (a, b, p, c)]
    for x, y, z, g in zip(a, b, p, c):
        assert torch.equal(x, y) and torch.equal(x, g)
        assert torch.equal(x, z)


@pytest.mark.parametrize("ragged", [False, True])
def test_drops_per_series_kernel_matches_plain(card, ragged):
    vals_p, vbase_p, _, _, rows, _ = _inputs(
        card, 2049, 300, (5,), 0.05 if ragged else 0.0, 6, resets=3)
    name = kernels._kernel_name("rate_family", ragged, True) + "_series"
    n0 = kernels.LAUNCHES[name]
    a = fused.fused_per_series(vals_p, vbase_p, rows, 2001, "rate_family",
                               ragged, True, True, with_drops=True)
    b = fused.fused_per_series(vals_p, vbase_p, rows, 2001, "rate_family",
                               ragged, True, True, with_drops=True)
    p = fused.fused_per_series_plain(vals_p, vbase_p, rows, 2001,
                                     "rate_family", ragged, True, True,
                                     with_drops=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == n0 + 2
    for x, y, z in zip(a, b, p):
        if x is None:
            continue
        assert x.shape == (2001, rows.idx1.numel())
        assert torch.equal(x, y) and torch.equal(x, z)


def test_drops_kernel_long_rows_stage_fewer_per_block(card):
    """Rows too long for two stages of four in shared memory stage fewer
    per block (12,000 slots: 48 KB each), still bit-identical."""
    args = _inputs(card, 300, 12_000, (3,), 0.0, 7, resets=5)
    assert args[4].span * 4 * 8 > SMEM
    a = fused.fused_rate_drops(*args, True, True, False)
    p = fused.fused_rate_drops_plain(*args, True, True, False)
    torch.cuda.synchronize()
    assert torch.equal(a, p)


def test_drops_api_on_the_card(card):
    """fused_rate_groupsum(precorrected=False) from numpy inputs runs K2
    on the card and agrees with the host run of its plain version."""
    rng = np.random.default_rng(8)
    S, T, G = 1500, 200, 13
    ts = np.arange(T, dtype=np.int64) * 10_000
    plan = fused.build_plan(ts, np.arange(300_000, int(ts[-1]) + 1, 60_000),
                            300_000)
    raw = np.cumsum(rng.exponential(10.0, size=(S, T)), axis=1)
    raw[::5, T // 2:] *= 0.1
    v32 = (raw - raw[:, :1]).astype(np.float32)
    vb32 = raw[:, 0].astype(np.float32)
    gids = rng.integers(0, G, size=S)
    n0 = kernels.LAUNCHES["fused_rate_drops_dense"]
    s, c = fused.fused_rate_groupsum(v32, vb32, gids, plan, G)
    h, hc = fused.fused_rate_groupsum(v32, vb32, gids, plan, G, device="cpu")
    assert kernels.LAUNCHES["fused_rate_drops_dense"] == n0 + 1
    assert s.device.type == "cuda"
    torch.testing.assert_close(s.cpu(), h, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(c, hc)


# ------------------------------------------- K2 ragged and K3 redesigned:
# staged rows, per-tile index tables, O(1) windows

def _adversarial(device, S=600, T=301, wset="edges", seed=9):
    """Raw counters with resets and NaN runs (~30%) plus rows built to
    trip the index tables: an all-NaN row, rows with one and two valid
    samples, ±Inf samples, NaN runs across 32-slot tiles, lane runs and
    window edges.  wset "edges": windows from before the grid to past
    its end, one slot apart (W = 351 > 256; empty and one-sample windows
    at both ends; span = T, not a multiple of 4); "late": windows over
    the last third only (the staged range starts past slot 0).  Groups:
    group 0 holds one row, group 1 holds 257 (a one-row second chunk)."""
    rng = np.random.default_rng(seed)
    ts = np.arange(T, dtype=np.int64) * 10_000
    if wset == "edges":
        wends = np.arange(-50, T + 20, dtype=np.int64) * 10_000
        rng_ms = 300_000
    else:
        wends = np.arange(2 * T // 3, T, 2, dtype=np.int64) * 10_000
        rng_ms = 50_000
    plan = fused.build_plan(ts, wends, rng_ms)
    raw = np.cumsum(rng.exponential(10.0, size=(S, T)), axis=1)
    for _ in range(3):
        at = rng.integers(1, T, size=S)
        after = np.arange(T)[None, :] >= at[:, None]
        raw = np.where(after, raw - raw[np.arange(S), at - 1][:, None]
                       + rng.exponential(5.0, size=(S, 1)), raw)
    starts = rng.random((S, T)) < 0.0146
    ends = np.where(starts, np.arange(T)[None, :]
                    + rng.integers(1, 48, size=(S, T)) - 1, -1)
    raw[np.maximum.accumulate(ends, axis=1) >= np.arange(T)[None, :]] = \
        np.nan
    raw[0] = np.nan                          # all-NaN row
    raw[1] = np.nan
    raw[1, 150] = 7.0                        # one valid sample
    raw[2] = np.nan
    raw[2, [149, 152]] = [3.0, 9.0]          # two valid samples
    raw[3, 77] = np.inf
    raw[4, 200] = -np.inf
    raw[5, 28:70] = np.nan                   # across tiles 0-2
    raw[6, 31:33] = np.nan                   # one tile edge
    raw[7, 9:40] = np.nan                    # a lane run (L = 10)
    raw[8, :] = np.where(np.arange(T) % 31 == 0, raw[8], np.nan)
    vals = fused.pad_values(torch.from_numpy(raw.astype(np.float32)),
                            torch.from_numpy(rng.random(S) * 1e3), plan,
                            device=device)
    gids = np.concatenate([[0], np.ones(257, np.int64),
                           rng.integers(2, 9, size=S - 258)])
    pg = fused.pad_groups(gids, S, 9, device=device)
    Gp = fused.pad_group_count(9)
    return (vals.vals_p, vals.vbase_p, pg.csr,
            fused.chunk_plan(pg.csr.offsets, Gp, device),
            plan.device_rows(device), Gp)


def _same_bits(x, y):
    """Equal to the bit, every NaN where the other has one."""
    nx, ny = torch.isnan(x), torch.isnan(y)
    return bool(torch.equal(nx, ny)) and bool(torch.equal(
        x.masked_fill(nx, 0).view(torch.int32),
        y.masked_fill(ny, 0).view(torch.int32)))


@pytest.mark.parametrize("wset", ["edges", "late"])
@pytest.mark.parametrize("series", [False, True])
@pytest.mark.parametrize("drops", [False, True])
def test_ragged_staged_kernels_match_plain_on_adversarial_rows(card, drops,
                                                               series, wset):
    vals_p, vbase_p, csr, chunks, rows, Gp = _adversarial(card, wset=wset)
    name = kernels._kernel_name("rate_family", True, drops) + \
        ("_series" if series else "")
    n0 = kernels.LAUNCHES[name]
    if series:
        S = vals_p.shape[0] - 7
        args = (vals_p, vbase_p, rows, S, "rate_family", True, True, True,
                drops)
        a = fused.fused_per_series(*args)
        b = fused.fused_per_series(*args)
        p = fused.fused_per_series_plain(*args)
    else:
        args = (vals_p, vbase_p, csr, chunks, rows, Gp)
        a = fused.group_launch("rate_family", True, *args, True, True, drops)
        b = fused.group_launch("rate_family", True, *args, True, True, drops)
        p = fused.group_plain("rate_family", True, *args, True, True, drops)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == n0 + 2
    assert len(a) == len(p) == 2
    assert rows.idx1.numel() > 256 or wset == "late"
    for x, y, z in zip(a, b, p):
        assert _same_bits(x, y) and _same_bits(x, z)
    assert (p[1] > 0).any() and (p[1] == 0).any()


@pytest.mark.parametrize("series", [False, True])
def test_ragged_rate_long_rows_take_the_tiled_path(card, series):
    """K3 has no row-length limit: a row of 70,000 slots does not fit in
    shared memory, so its windows are walked in slot tiles."""
    rng = np.random.default_rng(10)
    S, T = 64, 70_000
    ts = np.arange(T, dtype=np.int64) * 10_000
    plan = fused.build_plan(ts, np.arange(2000, T + 1, 60) * 10_000,
                            20_000_000)
    lo, hi, _ = plan.ragged_stage
    assert (hi - lo) * 4 * 2 > SMEM
    raw = np.cumsum(rng.exponential(10.0, size=(S, T)), axis=1)
    raw[rng.random((S, T)) < 0.3] = np.nan
    raw[0, 30_000:45_000] = np.nan
    vals = fused.pad_values(torch.from_numpy(raw.astype(np.float32)),
                            torch.from_numpy(rng.random(S) * 1e3), plan,
                            device=card)
    rows = plan.device_rows(card)
    if series:
        args = (vals.vals_p, vals.vbase_p, rows, S, "rate_family", True,
                True, True)
        a, p = fused.fused_per_series(*args), fused.fused_per_series_plain(
            *args)
    else:
        pg = fused.pad_groups(rng.integers(0, 5, size=S), S, 5, device=card)
        Gp = fused.pad_group_count(5)
        args = (vals.vals_p, vals.vbase_p, pg.csr,
                fused.chunk_plan(pg.csr.offsets, Gp, card), rows, Gp, True,
                True)
        a, p = fused.fused_rate_ragged(*args), fused.fused_rate_ragged_plain(
            *args)
    torch.cuda.synchronize()
    for x, z in zip(a, p):
        assert _same_bits(x, z)


@pytest.mark.parametrize("ragged", [False, True])
def test_drops_kernel_one_row_per_block(card, ragged):
    """Rows of 40,000 slots: one staged row per block and one stage, each
    lane's window straight into its sum."""
    args = _inputs(card, 70, 40_000, (3,), 0.1 if ragged else 0.0, 12,
                   resets=6)
    a = fused.fused_rate_drops(*args, True, True, ragged)
    p = fused.fused_rate_drops_plain(*args, True, True, ragged)
    torch.cuda.synchronize()
    for x, z in zip(a if ragged else (a,), p if ragged else (p,)):
        assert _same_bits(x, z)


@pytest.mark.parametrize("drops", [False, True])
def test_staged_kernels_refuse_misaligned_rows(card, drops):
    """The staged kernels copy 16 bytes at a time: a row stride that is not
    a multiple of 4 slots, or a base that is not 16-byte aligned, raises
    (never another path)."""
    vals_p, vbase_p, csr, chunks, rows, Gp = _inputs(card, 64, 100, (3,),
                                                      0.1, 2)
    call = (fused.fused_rate_drops if drops else fused.fused_rate_ragged)
    extra = (True,) if drops else ()
    odd = vals_p[:, :126].contiguous()
    odd_rows = rows._replace(tsrow=rows.tsrow[:126].contiguous())
    with pytest.raises(ValueError, match="multiple of 4"):
        call(odd, vbase_p, csr, chunks, odd_rows, Gp, True, True, *extra)
    flat = torch.empty(vals_p.numel() + 1, device=card)
    shifted = flat[1:].view(vals_p.shape)
    shifted.copy_(vals_p)
    with pytest.raises(ValueError, match="16-byte aligned"):
        call(shifted, vbase_p, csr, chunks, rows, Gp, True, True, *extra)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused.fused_per_series(shifted, vbase_p, rows, 10, "rate_family",
                               True, True, True, drops)


@pytest.mark.parametrize("series", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_drops_kernel_many_drops_a_lane(card, ragged, series):
    """Samples in random order drop at about every other slot, so K2's
    lanes carry many drops each — still to the plain version's bits."""
    rng = np.random.default_rng(13)
    S, T = 500, 300
    ts = np.arange(T, dtype=np.int64) * 10_000
    plan = fused.build_plan(ts, np.arange(300_000, int(ts[-1]) + 1, 60_000),
                            300_000)
    raw = rng.random((S, T)) * 100.0
    raw[::3, :] = np.cumsum(rng.exponential(1.0, size=(len(raw[::3]), T)),
                            axis=1)
    if ragged:
        raw[rng.random((S, T)) < 0.2] = np.nan
    vals = fused.pad_values(torch.from_numpy(raw.astype(np.float32)),
                            torch.from_numpy(rng.random(S) * 1e3), plan,
                            device=card)
    rows = plan.device_rows(card)
    if series:
        args = (vals.vals_p, vals.vbase_p, rows, S, "rate_family", ragged,
                True, True, True)
        a, p = fused.fused_per_series(*args), \
            fused.fused_per_series_plain(*args)
    else:
        pg = fused.pad_groups(rng.integers(0, 6, size=S), S, 6, device=card)
        Gp = fused.pad_group_count(6)
        args = (vals.vals_p, vals.vbase_p, pg.csr,
                fused.chunk_plan(pg.csr.offsets, Gp, card), rows, Gp, True,
                True, ragged)
        a, p = fused.fused_rate_drops(*args), \
            fused.fused_rate_drops_plain(*args)
    torch.cuda.synchronize()
    a = a if isinstance(a, tuple) else (a,)
    p = p if isinstance(p, tuple) else (p,)
    for x, z in zip(a, p):
        if x is not None:
            assert _same_bits(x, z)


@pytest.mark.parametrize("case", ["k2_dense", "k2_ragged", "k3_window"])
def test_staged_kernels_refuse_rows_too_long_for_shared_memory(card, case):
    """K2 keeps its limit (one row of 58,112 slots dense, 51,648 ragged,
    whose tables take 0.5 B a slot) and K3 refuses only a window wider than
    shared memory: the launcher returns kNoFit and the wrapper raises
    ValueError, counting no launch.  Dense K2 still runs a 55,000-slot
    row."""
    rng = np.random.default_rng(14)
    S, T = 6, (61_000 if case == "k3_window" else 55_000)
    ts = np.arange(T, dtype=np.int64) * 10_000
    range_ms = 600_000_000 if case == "k3_window" else 300_000
    plan = fused.build_plan(ts, np.array([T - 1], np.int64) * 10_000,
                            range_ms)
    raw = np.cumsum(rng.exponential(10.0, size=(S, T)), axis=1)
    raw[:, ::7] = np.nan
    vals = fused.pad_values(torch.from_numpy(raw.astype(np.float32)),
                            torch.from_numpy(rng.random(S) * 1e3), plan,
                            device=card)
    pg = fused.pad_groups(np.arange(S) % 2, S, 2, device=card)
    Gp = fused.pad_group_count(2)
    args = (vals.vals_p, vals.vbase_p, pg.csr,
            fused.chunk_plan(pg.csr.offsets, Gp, card),
            plan.device_rows(card), Gp, True, True)
    if case == "k3_window":
        call, name = fused.fused_rate_ragged, "fused_rate_ragged"
    else:
        ragged = case == "k2_ragged"
        args = args + (ragged,)
        call = fused.fused_rate_drops
        name = kernels._kernel_name("rate_family", ragged, True)
        assert 51_648 < plan.span <= 58_112
    n0 = kernels.LAUNCHES[name]
    if case == "k2_dense":
        a = call(*args)
        p = fused.fused_rate_drops_plain(*args)
        torch.cuda.synchronize()
        assert _same_bits(a, p) and kernels.LAUNCHES[name] == n0 + 1
        return
    with pytest.raises(ValueError, match="shared memory"):
        call(*args)
    assert kernels.LAUNCHES[name] == n0


# ------------------------------------------- K8, the column-selection probe

@pytest.mark.parametrize("rows", [1, 777, 4096])
@pytest.mark.parametrize("strategy", ["gather", "two_gathers",
                                      "onehot_matmul"])
def test_probe_kernels_match_plain_to_the_bit(card, strategy, rows):
    """Each K8 kernel (csrc/probe_select.cu) against its plain version at
    the probe's widths (K 768, 110 selections of 128 columns) and at row
    counts that are not a multiple of a tile."""
    from filodb_tpu_torch.ops import probe
    from filodb_tpu_torch.tools import probe_slice as ps
    x, o, i1, i2 = ps.inputs(1, card)
    x = torch.randn((rows, ps.TP), generator=torch.Generator(
        device=card).manual_seed(rows), device=card)
    kern, plain = {
        "gather": (lambda: probe.probe_gather(x, i1, ps.W, ps.WP),
                   lambda: probe.probe_gather_plain(x, i1, ps.W, ps.WP)),
        "two_gathers": (lambda: probe.probe_two_gathers(x, i1, i2, ps.W,
                                                        ps.WP),
                        lambda: probe.probe_two_gathers_plain(
                            x, i1, i2, ps.W, ps.WP)),
        "onehot_matmul": (lambda: probe.probe_onehot_matmul(x, o),
                          lambda: probe.probe_onehot_matmul_plain(x, o)),
    }[strategy]
    name = "probe_" + strategy
    n0 = kernels.LAUNCHES[name]
    got = kern()
    assert kernels.LAUNCHES[name] == n0 + 1
    want = plain()
    assert got.shape == want.shape == (rows, ps.WP)
    assert torch.equal(got, want)
    assert torch.equal(kern(), got)


def test_probe_matmul_is_a_full_product(card):
    """probe_onehot_matmul computes the whole product, not only one-hot
    selections: on a dense matrix it agrees with the FP32 library product
    to FP32 rounding."""
    from filodb_tpu_torch.ops import probe
    g = torch.Generator(device=card).manual_seed(3)
    x = torch.randn((1000, 768), generator=g, device=card)
    m = torch.randn((768, 132), generator=g, device=card)
    got = probe.probe_onehot_matmul(x, m)
    want = probe.probe_onehot_matmul_plain(x.double(), m.double())
    assert (got.double() - want).abs().max() < 1e-3


@pytest.mark.parametrize("rows", [1, 777, 4096, 262_144])
def test_probe_product_adversarial_inputs_to_the_bit(card, rows):
    """probe_onehot_matmul against x @ o (FP32, TF32 off) on inputs that
    hold +-Inf, NaN and -0.0 in x and an all-zero column, a +1/-1 pair,
    three non-unit nonzeros, a NaN and a +Inf in o
    (probe_slice.adversarial_inputs): the same bits with NaN in the same
    cells, two runs the same, one launch a call."""
    from filodb_tpu_torch.ops import probe
    from filodb_tpu_torch.tools import probe_slice as ps
    x, o = ps.adversarial_inputs(rows, card, seed=rows)
    n0 = kernels.LAUNCHES["probe_onehot_matmul"]
    got = probe.probe_onehot_matmul(x, o)
    again = probe.probe_onehot_matmul(x, o)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["probe_onehot_matmul"] == n0 + 2
    want = probe.probe_onehot_matmul_plain(x, o)
    assert got.shape == want.shape == (rows, ps.WP)
    assert _same_bits(got, want) and _same_bits(got, again)
    assert torch.isnan(got[:, ps.ADV_NAN]).all()


def test_probe_product_sign_of_zero_at_an_underflow(card):
    """A product that underflows to -0 (x = -2^-149 times 0.5): the sum in
    ascending k stays -0 in row 0, whose other x are all negative, and
    turns +0 in row 1 at a positive x; the kernel stores +0 in both, as
    x @ o (FP32, TF32 off) and the reference's jnp.dot give."""
    from filodb_tpu_torch.ops import probe
    x = -torch.ones((2, 64), device=card)
    x[:, 10] = -torch.finfo(torch.float32).smallest_normal * 2.0 ** -23
    x[1, 40] = 1.0
    o = torch.zeros((64, 4), device=card)
    o[10, 0] = 0.5
    got = probe.probe_onehot_matmul(x, o)
    assert got.view(torch.int32).eq(0).all()
    assert _same_bits(got, probe.probe_onehot_matmul_plain(x, o))


def test_probe_product_refuses_a_non_contiguous_x(card):
    from filodb_tpu_torch.ops import probe
    from filodb_tpu_torch.tools import probe_slice as ps
    x, o, _, _ = ps.inputs(1, card)
    wide = torch.zeros((x.shape[0], ps.TP + 4), device=card)
    n0 = kernels.LAUNCHES["probe_onehot_matmul"]
    with pytest.raises(ValueError, match="contiguous"):
        probe.probe_onehot_matmul(wide[:, :ps.TP], o)
    assert kernels.LAUNCHES["probe_onehot_matmul"] == n0


def test_probe_product_refuses_a_row_wider_than_the_ring(card):
    """A row of x has to fit one stage of the shared-memory ring: at K =
    16,384 (64 KB a row) the launcher reports no fit and the wrapper
    raises instead of launching."""
    from filodb_tpu_torch.ops import probe
    x = torch.ones((3, 16_384), device=card)
    o = torch.zeros((16_384, 8), device=card)
    n0 = kernels.LAUNCHES["probe_onehot_matmul"]
    with pytest.raises(ValueError, match="does not fit"):
        probe.probe_onehot_matmul(x, o)
    assert kernels.LAUNCHES["probe_onehot_matmul"] == n0


# ------------------------------------------- native histograms, end to end

@pytest.mark.parametrize("ragged", [False, True])
def test_native_histogram_leaf_on_the_card_matches_the_cpu(card, ragged):
    """histogram_quantile(0.9, sum(rate(h[5m])) by (_ns_)) over 300 native
    histograms x 16 buckets x 720 samples: the fused leaf on the card (K1
    dense, K3 ragged over S*B bucket rows) against the same query through
    the plain versions on the CPU.  Ragged drops ~1% of whole scrapes."""
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.core.partkey import PartKey
    from filodb_tpu_torch.query.engine import QueryEngine
    rng = np.random.default_rng(21)
    S, T, B = 300, 720, 16
    t0 = 1_600_000_000_000
    les = np.append(0.005 * 2.0 ** np.arange(B - 1), np.inf)
    h = np.cumsum(np.cumsum(rng.poisson(2.0, (S, T, B)), 1), 2) \
        .astype(np.float64)
    if ragged:
        h[rng.random((S, T)) < 0.01] = np.nan
    keys = [PartKey.make("http_latency", {"_ws_": "demo",
                                          "_ns_": f"App-{i % 20}",
                                          "instance": f"Instance-{i}"})
            for i in range(S)]
    ts = np.broadcast_to(t0 + np.arange(T, dtype=np.int64) * 10_000, (S, T))
    panel = "histogram_quantile(0.9, sum(rate(http_latency[5m])) by (_ns_))"
    name = "fused_rate_ragged" if ragged else "fused_rate_dense"
    out = {}
    for dev in ("cpu", card):
        ms = TimeSeriesMemStore(device=dev)
        ms.setup("prometheus", 0).ingest_columns(
            "prom-histogram", keys, ts,
            {"h": h, "count": h[..., -1], "sum": h[..., -1] * 0.1},
            bucket_les=les)
        eng = QueryEngine("prometheus", ms, device=dev)
        n0 = kernels.LAUNCHES[name]
        res = eng.query_range(panel, t0 // 1000 + 600, 60,
                              t0 // 1000 + (T - 1) * 10)
        assert res.error is None, res.error
        assert kernels.LAUNCHES[name] == \
            n0 + (torch.device(dev).type == "cuda")
        out[str(dev)] = {k: np.asarray(v) for k, _, v in res.series()}
    got, want = out[str(card)], out["cpu"]
    assert set(got) == set(want) and len(want) == 20
    for k in want:
        assert (np.isnan(got[k]) == np.isnan(want[k])).all()
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-9,
                                   equal_nan=True)


# ------------------------------- the host route and a plan node, end to end

def _counter_engines(card, S=300, T=720, seed=23):
    """S counters x T samples with one reset each, _ns_ = App-{i % 20}, in
    a CPU engine and a card engine."""
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.core.partkey import PartKey
    from filodb_tpu_torch.query.engine import QueryEngine
    rng = np.random.default_rng(seed)
    t0 = 1_600_000_000_000
    v = np.cumsum(rng.exponential(10.0, size=(S, T)), axis=1)
    at = rng.integers(T // 2, T, size=S)
    v = np.where(np.arange(T)[None, :] >= at[:, None],
                 v - v[np.arange(S), at - 1][:, None], v)
    keys = [PartKey.make("request_total", {"_ws_": "demo",
                                           "_ns_": f"App-{i % 20}",
                                           "instance": f"Instance-{i}"})
            for i in range(S)]
    ts = np.broadcast_to(t0 + np.arange(T, dtype=np.int64) * 10_000, (S, T))
    engines = {}
    for dev in ("cpu", card):
        ms = TimeSeriesMemStore(device=dev)
        ms.setup("prometheus", 0).ingest_columns("prom-counter", keys, ts,
                                                 {"count": v})
        engines[torch.device(dev).type] = QueryEngine("prometheus", ms,
                                                      device=dev)
    return engines, t0 // 1000 + 600, t0 // 1000 + (T - 1) * 10


def _series_of(res):
    assert res.error is None, res.error
    return [(k.labels, np.asarray(v)) for k, _, v in res.series()]


@pytest.mark.parametrize("promql, kernel, routed", [
    # the raw values through the host gather, then the general path on
    # the card
    ("sum by (_ns_) (changes(request_total[5m]))", None, 0),
    ("max by (_ns_) (resets(request_total[5m]))", None, 0),
    # the router, switched on for the card run: a working set under
    # query.host_route_max_samples is numpy
    ("sum by (_ns_) (rate(request_total[5m]))", None, 1),
    ("max by (_ns_) (max_over_time(request_total[5m]))", None, 1),
    # a plan node over K1
    ("sort_desc(sum by (_ns_) (rate(request_total[5m])))",
     "fused_rate_dense", 0),
])
def test_host_route_and_plan_node_on_the_card_match_the_cpu(
        card, monkeypatch, promql, kernel, routed):
    """The same query on the card and through the plain path on the CPU
    (the router off): the same series in the same order, values within
    rtol 2e-4 / atol 1e-3; the card run, with the router switched on
    (FILODB_TPU_FORCE_HOST_ROUTE) where `routed`, launches `kernel` (none
    where None) and routes `routed` leaves to the host."""
    from filodb_tpu_torch.utils.counters import counters
    engines, start_s, end_s = _counter_engines(card)
    want = _series_of(engines["cpu"].query_range(promql, start_s, 60,
                                                 end_s))
    if routed:
        monkeypatch.setenv("FILODB_TPU_FORCE_HOST_ROUTE", "1")
    n0, r0 = dict(kernels.LAUNCHES), counters.get("leaf_host_routed")
    got = _series_of(engines["cuda"].query_range(promql, start_s, 60,
                                                 end_s))
    launched = {k for k, v in kernels.LAUNCHES.items() if v > n0.get(k, 0)}
    assert launched == ({kernel} if kernel else set())
    assert counters.get("leaf_host_routed") - r0 == routed
    assert [k for k, _ in got] == [k for k, _ in want] and len(want) == 20
    for (k, w), (_, g) in zip(want, got):
        assert (np.isnan(g) == np.isnan(w)).all(), k
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=1e-3,
                                   equal_nan=True)


# --------------------------------- the mirror under live ingest, on the card

LES = np.append(0.005 * 2.0 ** np.arange(7), np.inf)


def _live_store(dev, S=512, T=120, seed=31, hist=False):
    """S counters (hist: native histograms of 8 buckets) x T samples, one
    reset each, in a shard on `dev`, with the values to append later:
    -> (memstore, shard, keys, ts_row, cols) where each column is
    [S, T + 40] ([S, T + 40, 8] for `h`)."""
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.core.partkey import PartKey
    rng = np.random.default_rng(seed)
    n = T + 40
    shape = (S, n, len(LES)) if hist else (S, n)
    v = np.cumsum(rng.exponential(10.0, size=shape), axis=1) + 1e9
    if hist:
        v = np.cumsum(v, axis=2)
    at = rng.integers(1, n, size=S)
    after = np.arange(n)[None, :] >= at[:, None]
    before = v[np.arange(S), at - 1][:, None]
    v = np.where(after[..., None] if hist else after, v - before + 1.0, v)
    metric = "http_latency" if hist else "request_total"
    keys = [PartKey.make(metric, {"_ws_": "demo", "_ns_": f"App-{i % 16}",
                                  "instance": f"Instance-{i}"})
            for i in range(S)]
    ts_row = 1_600_000_000_000 + np.arange(n, dtype=np.int64) * 10_000
    cols = ({"h": v, "count": v[..., -1], "sum": v[..., -1] * 0.1} if hist
            else {"count": v})
    ms = TimeSeriesMemStore(device=dev)
    sh = ms.setup("prometheus", 0)
    sh.ingest_columns("prom-histogram" if hist else "prom-counter", keys,
                      np.broadcast_to(ts_row[:T], (S, T)),
                      {k: c[:, :T] for k, c in cols.items()},
                      bucket_les=LES if hist else None)
    return ms, sh, keys, ts_row, cols


def _scrape(sh, keys, ts_row, cols, j, rows=None):
    """Append sample j of every series (or of `rows`) as one grid batch
    through the per-record ingest."""
    from filodb_tpu_torch.core.records import RecordBatch
    rows = np.arange(len(keys)) if rows is None else rows
    hist = "h" in cols
    batch = RecordBatch.from_grid(
        sh.schemas["prom-histogram" if hist else "prom-counter"],
        [keys[i] for i in rows.tolist()], np.full((len(rows), 1), ts_row[j]),
        {k: c[rows, j:j + 1] for k, c in cols.items()},
        LES if hist else None)
    return sh.ingest(batch)


def _abs_state(snap):
    out = {"ts": snap.ts_off.cpu().numpy()}
    for name, col in snap.cols.items():
        c = col.double().cpu().numpy()
        vb = snap.vbases[name].cpu().numpy()
        out[name] = c + (vb[:, None, :] if c.ndim == 3 else vb[:, None])
    return out


@pytest.mark.parametrize("hist", [False, True])
def test_incremental_mirror_matches_full_upload_on_the_card(card, hist):
    """Scrapes (one ragged: a quarter of the series miss it) update the
    card mirror incrementally; after each, it equals a fresh full upload
    of the same store on the card: timestamps to the bit, absolutes
    within rtol 1e-6 / atol 1e-6 (the reference's bound), the same
    counts, col_finite and tail state; and the grid stays uniform until
    the ragged scrape.  Counters, and native histograms ([S, T, B])."""
    from filodb_tpu_torch.core.devicecache import DeviceMirror
    from filodb_tpu_torch.utils.counters import counters
    _, sh, keys, ts_row, v = _live_store(card, hist=hist)
    store = sh.stores["prom-histogram" if hist else "prom-counter"]
    mirror = DeviceMirror(device=card)
    mirror.ensure_fresh(store)
    err0 = counters.get("device_mirror_incremental_errors")
    for j in range(120, 140):
        rows = np.arange(len(keys))
        if j == 135:
            rows = rows[rows % 4 != 1]
        _scrape(sh, keys, ts_row, v, j, rows)
        assert mirror.ensure_fresh(store)
        assert mirror.last_refresh_kind == "incremental"
        snap = mirror.snapshot()
        assert snap.uniform_grid == (j < 135)
        fresh = DeviceMirror(device=card)
        fresh.ensure_fresh(store)
        fsnap = fresh.snapshot()
        a, b = _abs_state(snap), _abs_state(fsnap)
        np.testing.assert_array_equal(a.pop("ts"), b.pop("ts"))
        assert set(a) == set(b)
        for name in b:
            np.testing.assert_allclose(a[name], b[name], rtol=1e-6,
                                       atol=1e-6, equal_nan=True,
                                       err_msg=name)
        np.testing.assert_array_equal(snap.counts, fsnap.counts)
        assert snap.col_finite == fsnap.col_finite
        assert set(snap.tail_last_raw) == set(fsnap.tail_last_raw)
        for name in fsnap.tail_last_raw:
            np.testing.assert_array_equal(snap.tail_last_raw[name],
                                          fsnap.tail_last_raw[name])
            np.testing.assert_allclose(snap.tail_cum_drop[name],
                                       fsnap.tail_cum_drop[name],
                                       rtol=1e-12)
    assert counters.get("device_mirror_incremental_errors") == err0


def test_background_rebuild_publishes_while_queries_read(card):
    """A query thread reads snapshots through the engine while the store
    is evicted and its mirror rebuilt on a background thread: every
    answer equals the card's answer before the eviction (no torn or
    stale snapshot: the store's samples in the window are unchanged),
    queries fall back to the host gather until the rebuild publishes,
    and the mirror is fresh afterwards."""
    import threading
    import time
    from filodb_tpu_torch.query.engine import QueryEngine
    from filodb_tpu_torch.utils.counters import counters
    ms, sh, keys, ts_row, v = _live_store(card)
    for j in range(120, 130):
        _scrape(sh, keys, ts_row, v, j)
    eng = QueryEngine("prometheus", ms, device=card)
    q = "sum by (_ns_) (rate(request_total[5m]))"
    start_s, end_s = int(ts_row[60]) // 1000, int(ts_row[129]) // 1000

    def answer():
        return _series_of(eng.query_range(q, start_s, 60, end_s))

    want = answer()
    store = sh.stores["prom-counter"]
    mirror = store.device_mirror
    stop = threading.Event()
    got, errors = [], []

    def reader():
        while not stop.is_set():
            try:
                got.append(answer())
            except Exception as e:  # noqa: BLE001
                errors.append(e)
                return

    fb0 = counters.get("device_mirror_query_fallbacks")
    rb0 = counters.get("device_mirror_bg_rebuilds")
    t = threading.Thread(target=reader)
    t.start()
    try:
        # keep the samples the query reads (its first window's range
        # starts 30 samples before ts_row[60]): evict only older ones
        sh.enforce_memory(budget_bytes=1, active_tail_rows=110)
        # the reader's next query requests the rebuild; wait for it to
        # publish
        deadline = time.monotonic() + 60.0
        while counters.get("device_mirror_bg_rebuilds") == rb0 \
                and time.monotonic() < deadline:
            mirror.join_rebuild(timeout=0.5)
            time.sleep(0.01)
        got.append(answer())
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and not errors, errors[:3]
    assert counters.get("device_mirror_bg_rebuilds") > rb0
    assert counters.get("device_mirror_query_fallbacks") > fb0
    assert mirror.is_fresh(store)
    for ans in got:
        assert [k for k, _ in ans] == [k for k, _ in want]
        for (k, w), (_, g) in zip(want, ans):
            assert (np.isnan(g) == np.isnan(w)).all(), k
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=1e-3,
                                       equal_nan=True)


# ---------------------------- batched expressions and the serving stack


def test_batch_shares_one_k1_launch_bit_identical_to_single(card,
                                                            monkeypatch):
    """Three rate panels over one working set (sum and avg by _ns_, sum by
    instance) share ONE K1 group-mode launch in query_range_batch, and
    each answer is bit-identical to the panel run alone with the
    expression compiler off: a group's reduction order does not depend
    on which panels share the launch."""
    from filodb_tpu_torch.config import settings
    engines, start_s, end_s = _counter_engines(card)
    eng = engines["cuda"]
    panels = ["sum by (_ns_) (rate(request_total[5m]))",
              "avg by (_ns_) (rate(request_total[5m]))",
              "sum by (instance) (rate(request_total[5m]))"]
    monkeypatch.setattr(settings().query, "exprfuse_enabled", False)
    alone = [_series_of(eng.query_range(q, start_s, 60, end_s))
             for q in panels]
    monkeypatch.setattr(settings().query, "exprfuse_enabled", True)
    n0 = kernels.LAUNCHES["fused_rate_dense"]
    got = eng.query_range_batch(panels, start_s, 60, end_s)
    assert kernels.LAUNCHES["fused_rate_dense"] - n0 == 1
    for q, a, g in zip(panels, alone, got):
        g = _series_of(g)
        assert [k for k, _ in g] == [k for k, _ in a], q
        for (k, av), (_, gv) in zip(a, g):
            assert gv.tobytes() == av.tobytes(), (q, k)


def test_result_cache_splices_cuda_values_on_the_host(card):
    """A result block whose values are a CUDA tensor goes through the
    result cache: the entry holds host rows only, a full hit and a
    partial hit come back as numpy blocks, and their bits are the
    tensor's."""
    from filodb_tpu_torch.query.rangevector import (QueryResult,
                                                    RangeVectorKey,
                                                    ResultBlock)
    from filodb_tpu_torch.query.resultcache import ResultCache
    keys = [RangeVectorKey.make({"s": str(i)}) for i in range(4)]
    full = torch.rand((4, 20), dtype=torch.float64, device=card)

    def run(s, e):
        wends = np.arange(s, e + 1, 60, dtype=np.int64) * 1000
        lo = (s - 60) // 60
        return QueryResult([ResultBlock(keys, wends,
                                        full[:, lo:lo + len(wends)])])

    cache = ResultCache()
    first = cache.query_range(run, "up", 60, 60, 600, "pp",
                              (("tok",), 300_000))
    assert isinstance(first.blocks[0].values, torch.Tensor)
    hit = cache.query_range(run, "up", 60, 60, 300, "pp",
                            (("tok",), 300_000))
    part = cache.query_range(run, "up", 60, 60, 900, "pp",
                             (("tok",), 300_000))
    assert (hit.stats.result_cache, part.stats.result_cache) == \
        ("hit", "partial")
    want = full.cpu().numpy()
    for res, n in ((hit, 5), (part, 15)):
        vals = res.blocks[0].values
        assert isinstance(vals, np.ndarray)
        assert vals.tobytes() == want[:, :n].tobytes()
    for ent in cache._entries.values():
        assert all(isinstance(r, np.ndarray) for r in ent.series.values())


# ------------------------------------- the kernel ledger and the HBM model


def test_ledger_seconds_cover_the_k1_launch(card, monkeypatch):
    """A warm fused panel's ledger entry (`fused_rate`, from the launch
    through the readback) is positive and covers at least the CUDA-event
    time of the K1 launch inside it; the query's device_seconds is its
    ledger sum."""
    from filodb_tpu_torch.utils.devicetelem import telem
    engines, start_s, end_s = _counter_engines(card)
    eng = engines["cuda"]
    q = "sum by (_ns_) (rate(request_total[5m]))"
    eng.query_range(q, start_s, 60, end_s)          # cold: build, upload
    events = []
    k1 = kernels.fused_rate_dense_cuda

    def timed_k1(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = k1(*a, **kw)
        ev[1].record()
        events.append(ev)
        return out
    monkeypatch.setattr(kernels, "fused_rate_dense_cuda", timed_k1)
    res = eng.query_range(q, start_s, 60, end_s)
    torch.cuda.synchronize()
    assert res.error is None and len(events) == 1
    k1_s = events[0][0].elapsed_time(events[0][1]) / 1e3
    ledger = [e for e in telem.recent(limit=100, kind="kernel")
              if e["origin"] == res.trace_id]
    rate = [e for e in ledger if e["kernel"] == "fused_rate"]
    assert len(rate) == 1 and rate[0]["device"] == "cuda:0"
    assert rate[0]["seconds"] > 0 and rate[0]["seconds"] >= k1_s - 1e-6
    assert res.stats.device_seconds == pytest.approx(
        sum(e["seconds"] for e in ledger), abs=1e-5)


def test_booked_hot_is_the_mirror_bytes(card, monkeypatch):
    """The HBM model books the mirror's tensors to the byte under `hot`,
    within what the caching allocator holds; a dropped mirror gives its
    booking back."""
    import gc

    import filodb_tpu_torch.core.devicecache as devicecache
    from filodb_tpu_torch.utils.devicetelem import DeviceTelemetry
    telem = DeviceTelemetry()
    monkeypatch.setattr(devicecache, "telem", telem)
    engines, start_s, end_s = _counter_engines(card)
    eng = engines["cuda"]
    assert eng.query_range("sum(rate(request_total[5m]))", start_s, 60,
                           end_s).error is None
    store = eng.source.get_shard("prometheus", 0).stores["prom-counter"]
    snap = store.device_mirror.snapshot()
    tensors = [snap.ts_off, *snap.cols.values(), *snap.vbases.values()]
    assert all(t.device == card for t in tensors)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    assert telem.hbm_booked(card, "hot") == nbytes
    assert nbytes <= torch.cuda.memory_allocated(card)
    del snap, tensors
    store.device_mirror = None
    gc.collect()
    assert telem.hbm_booked(card, "hot") == 0


def test_explain_launches_nothing_and_analyze_launches_k1(card):
    """explain=true materializes the plan only: no launch, no device
    memory; analyze=true runs it once, K1 included."""
    from filodb_tpu_torch.http.routes import PromHttpApi
    engines, start_s, end_s = _counter_engines(card)
    api = PromHttpApi({"prometheus": engines["cuda"]})
    args = {"query": "sum by (_ns_) (rate(request_total[5m]))",
            "start": str(start_s), "end": str(end_s), "step": "60"}
    assert api.handle("GET", "/api/v1/query_range", args)[0] == 200
    torch.cuda.synchronize()
    n0, m0 = dict(kernels.LAUNCHES), torch.cuda.memory_allocated(card)
    for path, extra in (("/api/v1/query_range", {"explain": "true"}),
                        ("/api/v1/query", {"explain": "true",
                                           "time": str(end_s)}),
                        ("/api/v1/explain", {})):
        st, p = api.handle("GET", path, {**args, **extra})
        assert st == 200 and p["data"]["resultType"] == "execPlan"
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == n0
    assert torch.cuda.memory_allocated(card) == m0
    st, p = api.handle("GET", "/api/v1/explain", {**args,
                                                   "analyze": "true"})
    assert st == 200 and p["data"]["resultType"] == "execPlanAnalysis"
    assert kernels.LAUNCHES["fused_rate_dense"] == \
        n0["fused_rate_dense"] + 1


def test_cold_tier_panel_launches_k1_over_cuda_blocks(card, tmp_path):
    """The persisted tier on the card: counters flushed to a disk store
    and compacted into two segments; a PersistedClusterPlanner panel
    pages both into the cold region as CUDA tensors (booked `cold` in the
    HBM model), merges them on the card and runs K1 over the merged
    block; the warm run hits the region and launches K1 again with the
    same bits; the answer agrees with the same tier on the CPU."""
    from filodb_tpu_torch.core.devicecache import ColdSegmentCache
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.core.partkey import PartKey
    from filodb_tpu_torch.parallel.shardmapper import ShardEvent, ShardMapper
    from filodb_tpu_torch.persist.compactor import SegmentCompactor
    from filodb_tpu_torch.persist.localstore import LocalDiskColumnStore
    from filodb_tpu_torch.persist.segments import PersistedTier, SegmentStore
    from filodb_tpu_torch.query.engine import QueryEngine
    from filodb_tpu_torch.query.planners import PersistedClusterPlanner
    from filodb_tpu_torch.utils.devicetelem import telem
    window = 2 * 3600 * 1000
    t0 = 1_600_000_000_000 - 1_600_000_000_000 % window
    S, T = 400, 1440
    rng = np.random.default_rng(31)
    v = np.cumsum(rng.exponential(10.0, size=(S, T)), axis=1)
    v[:, 720:] -= v[:, 720:721] - 1.0          # a reset on the boundary
    keys = [PartKey.make("request_total", {"_ws_": "demo",
                                           "_ns_": f"App-{i % 20}",
                                           "instance": f"Instance-{i}"})
            for i in range(S)]
    ts = np.broadcast_to(t0 + np.arange(T, dtype=np.int64) * 10_000, (S, T))
    cs = LocalDiskColumnStore(str(tmp_path))
    sh = TimeSeriesMemStore(column_store=cs, device="cpu").setup(
        "prometheus", 0)
    sh.ingest_columns("prom-counter", keys, ts, {"count": v})
    sh.flush_all_groups()
    seg = SegmentStore(str(tmp_path))
    assert SegmentCompactor(cs, seg, "prometheus", 1, window_ms=window,
                            closed_lag_ms=0).compact_all(
        now_ms=t0 + 10 * window) == 2
    mapper = ShardMapper(1)
    mapper.update_from_event(ShardEvent("IngestionStarted", "prometheus", 0,
                                        "n"))
    q = "sum by (_ns_) (rate(request_total[5m]))"
    start_s, end_s = t0 // 1000 + 600, t0 // 1000 + (T - 1) * 10
    res = {}
    for dev in ("cpu", card):
        tier = PersistedTier(seg, "prometheus", 1,
                             ColdSegmentCache(1 << 30, device=dev))
        eng = QueryEngine("prometheus", TimeSeriesMemStore(device=dev),
                          mapper, planner=PersistedClusterPlanner(
                              "prometheus", mapper, tier), device=dev)
        n0 = kernels.LAUNCHES.get("fused_rate_dense", 0)
        cold = eng.query_range(q, start_s, 60, end_s)
        warm = eng.query_range(q, start_s, 60, end_s)
        assert (cold.stats.cold_tier, warm.stats.cold_tier) == \
            ("cold_paged", "cold_hit")
        a, b = _series_of(cold), _series_of(warm)
        assert [k for k, _ in a] == [k for k, _ in b]
        for (_, x), (_, y) in zip(a, b):
            assert np.array_equal(x, y, equal_nan=True)
        res[torch.device(dev).type] = a
        if dev == card:
            assert kernels.LAUNCHES["fused_rate_dense"] - n0 == 2
            blocks = tier.cold_cache.blocks()
            assert len(blocks) == 2
            assert all(b.ts_off.is_cuda and b.cols["count"].is_cuda
                       for b in blocks)
            assert telem.hbm_booked(card, "cold") == \
                tier.cold_cache.bytes_booked == sum(b.nbytes for b in blocks)
            tier.cold_cache.clear()
            assert telem.hbm_booked(card, "cold") == 0
    assert [k for k, _ in res["cpu"]] == [k for k, _ in res["cuda"]]
    for (_, x), (_, y) in zip(res["cpu"], res["cuda"]):
        np.testing.assert_allclose(y, x, rtol=2e-4, atol=1e-3)


def test_wal_replay_onto_the_card_launches_k1_bit_identical(card, tmp_path):
    """A node on the card writes its ingest through the WAL in the door's
    sequence (append without waiting, ingest at the seq, one commit),
    crashes without a flush, and a new memstore on the card replays the
    log: the replayed panel launches K1 and is bit-identical to the
    answer of the store that wrote the log."""
    from filodb_tpu_torch.config import WalConfig
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.core.partkey import PartKey
    from filodb_tpu_torch.query.engine import QueryEngine
    from filodb_tpu_torch.wal import WalManager
    S, T, slab = 3000, 360, 1000
    rng = np.random.default_rng(41)
    t0 = 1_600_000_000_000
    ts = np.broadcast_to(t0 + np.arange(T, dtype=np.int64) * 10_000,
                         (slab, T))
    q = "sum by (_ns_) (rate(request_total[5m]))"
    start_s, end_s = t0 // 1000 + 600, t0 // 1000 + (T - 1) * 10
    wal = WalManager(str(tmp_path), "prometheus", WalConfig())
    ms = TimeSeriesMemStore(device=card)
    sh = ms.setup("prometheus", 0)
    seq = -1
    for i0 in range(0, S, slab):
        keys = [PartKey.make("request_total", {
            "_ws_": "demo", "_ns_": f"App-{i % 50}",
            "instance": f"Instance-{i}"}) for i in range(i0, i0 + slab)]
        vals = np.cumsum(rng.integers(0, 20, size=(slab, T)),
                         axis=1).astype(np.float64)
        seq = wal.append_grid(0, "prom-counter", keys, ts, {"count": vals},
                              wait=False)
        sh.ingest_columns("prom-counter", keys, ts, {"count": vals},
                          offset=seq)
    wal.commit(seq)
    before = _series_of(QueryEngine("prometheus", ms, device=card)
                        .query_range(q, start_s, 60, end_s))
    wal.close()
    del ms, sh
    ms2 = TimeSeriesMemStore(device=card)
    wal2 = WalManager(str(tmp_path), "prometheus", WalConfig())
    try:
        st = wal2.replay(ms2, {0: -1})
        assert (st.records, st.samples, st.skipped_records,
                st.corrupt_segments) == (S // slab, S * T, 0, 0)
        assert ms2.get_shard("prometheus", 0).device == card
        n0 = kernels.LAUNCHES.get("fused_rate_dense", 0)
        after = _series_of(QueryEngine("prometheus", ms2, device=card)
                           .query_range(q, start_s, 60, end_s))
        assert kernels.LAUNCHES["fused_rate_dense"] == n0 + 1
        assert [k for k, _ in after] == [k for k, _ in before]
        for (_, x), (_, y) in zip(before, after):
            assert np.array_equal(x, y, equal_nan=True)
        assert wal2.append_grid(0, "prom-counter", keys, ts[:, :1],
                                {"count": vals[:, -1:] + 1}) == S // slab
    finally:
        wal2.close()


def test_remote_write_into_a_card_store_launches_k1(card, tmp_path):
    """One Prometheus remote-write request through PromHttpApi's
    /api/v1/write (a GatewayPipeline with a WAL) into a store on the
    card: the existing counters gain the samples in their own schema, the
    next panel pays an incremental refresh and launches K1, and its
    answer equals the same panel over a store that ingested the same
    values directly."""
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.core.partkey import PartKey
    from filodb_tpu_torch.gateway.router import GatewayPipeline
    from filodb_tpu_torch.http import remotepb
    from filodb_tpu_torch.http.routes import PromHttpApi
    from filodb_tpu_torch.parallel.shardmapper import ShardMapper
    from filodb_tpu_torch.query.engine import QueryEngine
    from filodb_tpu_torch.utils import snappy
    from filodb_tpu_torch.wal import WalManager
    S, T = 2000, 120
    rng = np.random.default_rng(43)
    t0 = 1_600_000_000_000
    ts = np.broadcast_to(t0 + np.arange(T, dtype=np.int64) * 10_000, (S, T))
    labels = [{"_ws_": "demo", "_ns_": f"App-{i % 50}",
               "instance": f"Instance-{i}"} for i in range(S)]
    keys = [PartKey.make("request_total", lb) for lb in labels]
    vals = np.cumsum(rng.exponential(10.0, size=(S, T + 1)), axis=1)
    q = "sum by (_ns_) (rate(request_total[5m]))"
    start_s, end_s = t0 // 1000 + 600, t0 // 1000 + T * 10
    stores = []
    for _ in range(2):
        ms = TimeSeriesMemStore(device=card)
        ms.setup("prometheus", 0).ingest_columns(
            "prom-counter", keys, ts, {"count": vals[:, :T]})
        eng = QueryEngine("prometheus", ms, device=card)
        eng.query_range(q, start_s, 60, end_s - 10)     # the mirror
        stores.append((ms, eng))
    (ms, eng), (ms2, eng2) = stores
    ms2.get_shard("prometheus", 0).ingest_columns(
        "prom-counter", keys, np.full((S, 1), t0 + T * 10_000),
        {"count": vals[:, T:]})
    wal = WalManager(str(tmp_path), "prometheus")
    try:
        gw = GatewayPipeline(ms, "prometheus", ShardMapper(1))
        gw.wal = wal
        api = PromHttpApi({"prometheus": eng}, gateways={"prometheus": gw})
        body = snappy.compress(remotepb.encode_write_request([
            remotepb.PromTimeSeries(
                [("__name__", "request_total")] + sorted(lb.items()),
                [(float(vals[i, T]), t0 + T * 10_000)])
            for i, lb in enumerate(labels)]))
        status, _ = api.handle("POST", "/api/v1/write", {}, body)
        assert status == 204
        assert wal.writer.committed_seq == 0
        sh = ms.get_shard("prometheus", 0)
        assert list(sh.stores) == ["prom-counter"]
        assert sh.stores["prom-counter"].counts[:S].tolist() == [T + 1] * S
        n0 = kernels.LAUNCHES.get("fused_rate_dense", 0)
        got = _series_of(eng.query_range(q, start_s, 60, end_s))
        assert kernels.LAUNCHES["fused_rate_dense"] == n0 + 1
        assert sh.stores["prom-counter"].device_mirror.last_refresh_kind \
            == "incremental"
        want = _series_of(eng2.query_range(q, start_s, 60, end_s))
        assert [k for k, _ in got] == [k for k, _ in want]
        for (_, x), (_, y) in zip(got, want):
            assert np.array_equal(x, y, equal_nan=True)
    finally:
        wal.close()


def test_recording_rule_launches_k1_on_the_card(card):
    """A recording rule over counters on the card: its evaluation is an
    instant query through the frontend that launches K1 once; the
    recorded vector is bit-identical to the same instant query and
    equals the rule evaluated over a CPU store (rtol 2e-4 / atol 1e-3)."""
    from filodb_tpu_torch.config import RulesConfig
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.core.partkey import PartKey
    from filodb_tpu_torch.query.engine import QueryEngine
    from filodb_tpu_torch.query.frontend import QueryFrontend
    from filodb_tpu_torch.rules import (MemstoreSink, Rule, RuleGroup,
                                        Ruler, WebhookNotifier)
    S, T = 2000, 120
    rng = np.random.default_rng(15)
    t0 = 1_600_000_000_000
    ts = np.broadcast_to(t0 + np.arange(T, dtype=np.int64) * 10_000, (S, T))
    keys = [PartKey.make("request_total", {
        "_ws_": "demo", "_ns_": f"App-{i % 50}", "instance": f"I-{i}"})
        for i in range(S)]
    vals = np.cumsum(rng.exponential(10.0, size=(S, T)), axis=1)
    expr = "sum by (_ws_, _ns_) (rate(request_total[5m]))"
    end_s = t0 // 1000 + (T - 1) * 10
    got = {}
    for dev in (card, "cpu"):
        ms = TimeSeriesMemStore(device=dev)
        ms.setup("prometheus", 0).ingest_columns(
            "prom-counter", keys, ts, {"count": vals})
        fe = QueryFrontend(QueryEngine("prometheus", ms, device=dev))
        ruler = Ruler(fe, MemstoreSink(ms, "prometheus"), groups=[
            RuleGroup("g", 60.0, (Rule("ns:rate5m", expr, "recording"),))],
            config=RulesConfig(),
            notifier=WebhookNotifier(sleep=lambda s: None))
        n0 = kernels.LAUNCHES.get("fused_rate_dense", 0)
        assert ruler.evaluate_group("g", ts=end_s)
        if dev is card:
            assert kernels.LAUNCHES["fused_rate_dense"] == n0 + 1
        rec = fe.query_instant("ns:rate5m", end_s)
        hand = fe.query_instant(expr, end_s)
        got[str(dev)] = {k.labels_dict["_ns_"]: float(np.asarray(v)[-1])
                         for k, _, v in rec.series()}
        assert got[str(dev)] == {
            k.labels_dict["_ns_"]: float(np.asarray(v)[-1])
            for k, _, v in hand.series()}
    a, b = got[str(card)], got["cpu"]
    assert a.keys() == b.keys() and len(a) == 50
    for k in a:
        assert abs(a[k] - b[k]) <= 1e-3 + 2e-4 * abs(b[k])


def test_downsample_store_gauge_panel_launches_k5(card):
    """Gauges flushed through a ShardDownsampler into a downsample store
    on the card: a sum_over_time panel reads the ds-gauge `sum` column
    through K5 and equals the same store built on the CPU."""
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.core.store import (InMemoryColumnStore,
                                             InMemoryMetaStore)
    from filodb_tpu_torch.downsample import (DownsampleClusterPlanner,
                                             DownsampledTimeSeriesStore,
                                             ShardDownsampler)
    from filodb_tpu_torch.ingest.generator import gauge_batch
    from filodb_tpu_torch.parallel.shardmapper import (ShardEvent,
                                                       ShardMapper)
    from filodb_tpu_torch.query.engine import QueryEngine
    t0 = 1_600_000_000_000
    mapper = ShardMapper(1)
    mapper.update_from_event(ShardEvent("IngestionStarted", "prometheus",
                                        0, "local"))
    raw = TimeSeriesMemStore(column_store=InMemoryColumnStore(),
                             meta_store=InMemoryMetaStore(), device="cpu")
    sh = raw.setup("prometheus", 0)
    sh.ingest(gauge_batch(512, 720, start_ms=t0))
    dsr = ShardDownsampler(resolutions=(60_000,))
    sh.shard_downsampler = dsr
    sh.flush_all_groups()
    drain = dsr.result_batches()
    q = "sum by (_ns_) (sum_over_time(heap_usage[10m]))"
    s0 = (t0 // 60_000) * 60 + 1260
    got = {}
    for dev in (card, "cpu"):
        store = DownsampledTimeSeriesStore("prometheus", resolutions=(60_000,),
                                           device=dev)
        store.setup_shard(0)
        store.ingest_downsample_batches(0, drain)
        eng = QueryEngine("prometheus", store, mapper, device=dev,
                          planner=DownsampleClusterPlanner(store, mapper))
        n0 = dict(kernels.LAUNCHES)
        res = eng.query_range(q, s0, 300, s0 + 5820)
        assert res.error is None, res.error
        if dev is card:
            k5 = [k for k, v in kernels.LAUNCHES.items()
                  if k.startswith("fused_over_time") and v > n0.get(k, 0)]
            assert k5, "the panel launched no K5"
        got[str(dev)] = _series_of(res)
    a, b = got[str(card)], got["cpu"]
    assert [k for k, _ in a] == [k for k, _ in b] and a
    for (_, x), (_, y) in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=2e-4, atol=1e-3)


def test_filoserver_warmup_and_first_panel_launch_k1(card):
    """A FiloServer on the card with one warmup_shapes entry: start()'s
    warmup thread builds the kernel libraries and launches K1 at that
    shape; then the first dashboard panel over counters ingested into
    the node launches K1 again and equals the same node on the CPU
    (rtol 2e-4 / atol 1e-3)."""
    from filodb_tpu_torch.config import FilodbSettings
    from filodb_tpu_torch.core.partkey import PartKey
    from filodb_tpu_torch.standalone import DatasetConfig, FiloServer
    from filodb_tpu_torch.utils.metrics import registry
    S, T = 2048, 120
    rng = np.random.default_rng(16)
    t0 = 1_600_000_000_000
    ts = np.broadcast_to(t0 + np.arange(T, dtype=np.int64) * 10_000, (S, T))
    keys = [PartKey.make("request_total", {
        "_ws_": "demo", "_ns_": f"App-{i % 40}", "instance": f"I-{i}"})
        for i in range(S)]
    vals = np.cumsum(rng.exponential(10.0, size=(S, T)), axis=1)
    q = "sum by (_ns_) (rate(request_total[5m]))"
    s0 = t0 // 1000
    got = {}
    for dev in (card, "cpu"):
        cfg = FilodbSettings()
        cfg.warmup_shapes = "4096x120x90x40" if dev is card else ""
        srv = FiloServer([DatasetConfig("prometheus", 1)], config=cfg,
                         device=dev)
        try:
            errors = registry.counter("warmup_compile_errors").value
            n0 = kernels.LAUNCHES["fused_rate_dense"]
            srv.start(background_flush=False)
            if dev is card:
                srv.warmup_thread.join(300)
                assert not srv.warmup_thread.is_alive()
                assert registry.counter("warmup_compile_errors").value \
                    == errors
                assert kernels.LAUNCHES["fused_rate_dense"] == n0 + 1
            srv.memstore.get_shard("prometheus", 0).ingest_columns(
                "prom-counter", keys, ts, {"count": vals})
            n1 = kernels.LAUNCHES["fused_rate_dense"]
            st, payload = srv.api.handle("GET", "/api/v1/query_range", {
                "query": q, "start": str(s0 + 600), "end": str(s0 + 1190),
                "step": "60"})
            assert st == 200, payload
            if dev is card:
                assert kernels.LAUNCHES["fused_rate_dense"] == n1 + 1
            got[str(dev)] = {
                r["metric"]["_ns_"]: np.array([float(v) for _, v in
                                               r["values"]])
                for r in payload["data"]["result"]}
        finally:
            srv.shutdown()
    a, b = got[str(card)], got["cpu"]
    assert a.keys() == b.keys() and len(a) == 40
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=2e-4, atol=1e-3)



@pytest.mark.parametrize("pushdown", [True, False])
def test_two_node_cluster_on_the_card_launches_k1_on_the_nodes(card,
                                                               pushdown):
    """testcluster.make_two_node_cluster on cuda:0 (two NodeQueryServers
    on loopback TCP, two shards each): the data nodes launch K1 once a
    shard, and the pushed answer equals the single store's within rtol
    2e-4 / atol 1e-3, pushdown on and off the same bits."""
    from filodb_tpu_torch.ingest.generator import counter_batch
    from filodb_tpu_torch.parallel.shardmapper import SpreadProvider
    from filodb_tpu_torch.parallel.testcluster import make_two_node_cluster
    from filodb_tpu_torch.query.engine import QueryEngine
    from filodb_tpu_torch.query.rangevector import PlannerParams
    start = 1_600_000_020_000
    c = make_two_node_cluster([counter_batch(512, 180, start_ms=start)],
                              with_truth=True, device=card)
    try:
        truth = QueryEngine("prometheus", c.truth, c.mapper,
                            SpreadProvider(default_spread=1), device=card)
        q = "sum by (_ns_) (rate(request_total[5m]))"
        s = start // 1000
        n0 = kernels.LAUNCHES["fused_rate_dense"]
        res = c.engine.query_range(q, s + 600, 60, s + 1790, PlannerParams(
            aggregation_pushdown=pushdown))
        assert res.error is None, res.error
        assert kernels.LAUNCHES["fused_rate_dense"] == n0 + 4
        assert res.stats.pushdown_pushed == (2 if pushdown else 0)
        again = c.engine.query_range(q, s + 600, 60, s + 1790, PlannerParams(
            aggregation_pushdown=not pushdown))
        want = truth.query_range(q, s + 600, 60, s + 1790)
        got = {k.labels: np.asarray(v) for k, _, v in res.series()}
        other = {k.labels: np.asarray(v) for k, _, v in again.series()}
        exp = {k.labels: np.asarray(v) for k, _, v in want.series()}
        assert got.keys() == exp.keys() == other.keys() and got
        for k in got:
            assert got[k].tobytes() == other[k].tobytes()
            np.testing.assert_allclose(got[k], exp[k], rtol=2e-4, atol=1e-3)
    finally:
        c.stop()


def _replicated_on_card(card, n_series=256, n_samples=180):
    """testcluster.make_replicated_cluster on the card: three nodes, two
    shards, RF 2, every store on cuda:0, fed with counters through the
    quorum fan-out."""
    from filodb_tpu_torch.core.partkey import PartKey
    from filodb_tpu_torch.parallel.testcluster import make_replicated_cluster
    start = 1_600_000_020_000
    c = make_replicated_cluster(nodes=("A", "B", "C"), num_shards=2,
                                device=card)
    ts = np.repeat(start + np.arange(n_samples, dtype=np.int64)[None, :]
                   * 10_000, n_series, axis=0)
    rng = np.random.default_rng(5)
    for s in range(2):
        keys = [PartKey.make("request_total", {
            "_ws_": "demo", "_ns_": f"App-{i % 7}", "shard": str(s),
            "instance": str(i)}) for i in range(n_series)]
        vals = np.cumsum(rng.integers(0, 9, (n_series, n_samples)),
                         axis=1).astype(np.float64)
        c.ingest_grid(s, "prom-counter", keys, ts, {"count": vals})
    return c, start // 1000


def test_rf2_failover_answer_launches_k1_on_the_replica(card):
    """Kill shard 0's primary: the panel stays full, served by the
    replica's store on the card (K1 launches again, once a shard, and
    query_replica_failovers rises), with the bits of the answer before
    the kill (the replica received the same slabs in the same order)."""
    from filodb_tpu_torch.parallel.breaker import breakers
    from filodb_tpu_torch.query.rangevector import PlannerParams
    from filodb_tpu_torch.utils.metrics import registry
    breakers.reset()
    c, s = _replicated_on_card(card)
    try:
        q = "sum by (_ns_) (rate(request_total[5m]))"
        pp = PlannerParams(allow_partial_results=True)
        before = c.engine.query_range(q, s + 600, 60, s + 1790, pp)
        assert before.error is None and not before.partial
        victim = c.mapper.node_for_shard(0)
        replica = c.mapper.replicas[0][0]
        fo = registry.counter("query_replica_failovers", peer=replica)
        fo0, n0 = fo.value, kernels.LAUNCHES["fused_rate_dense"]
        c.kill(victim)
        res = c.engine.query_range(q, s + 600, 60, s + 1790, pp)
        assert res.error is None and not res.partial
        assert kernels.LAUNCHES["fused_rate_dense"] == n0 + 2
        assert fo.value > fo0
        sh = c.stores[replica].get_shard("prometheus", 0)
        mirror = sh.stores["prom-counter"].device_mirror
        assert mirror is not None and mirror.device.type == "cuda"
        got = {k.labels: np.asarray(v) for k, _, v in res.series()}
        want = {k.labels: np.asarray(v) for k, _, v in before.series()}
        assert got.keys() == want.keys() and got
        for k in got:
            assert got[k].tobytes() == want[k].tobytes()
    finally:
        c.stop()
        breakers.reset()


def test_handoff_tombstone_gives_the_card_memory_back(card):
    """After the tombstone the old owner's mirror and its padded-values
    cache entries leave the card: torch.cuda.memory_allocated() and the
    booked `hot` bytes fall by at least the dropped mirror's bytes."""
    from filodb_tpu_torch.replication import HandoffCoordinator
    from filodb_tpu_torch.utils.devicetelem import telem
    c, s = _replicated_on_card(card, n_series=2048)
    try:
        q = "sum by (_ns_) (rate(request_total[5m]))"
        res = c.engine.query_range(q, s + 600, 60, s + 1790)
        assert res.error is None
        src = c.mapper.node_for_shard(0)
        mirror = c.stores[src].get_shard("prometheus", 0) \
            .stores["prom-counter"].device_mirror
        booked = mirror.booked_bytes
        assert booked > 0
        target = next(n for n in ("A", "B", "C")
                      if n not in c.mapper.owners(0))
        torch.cuda.synchronize()
        alloc0 = torch.cuda.memory_allocated(card)
        hot0 = telem.hbm_booked(card, "hot")
        summary = HandoffCoordinator("prometheus", c.mapper,
                                     lambda n: c.repl_clients[n]
                                     ).handoff(0, target)
        assert summary["states"][-1] == "done"
        torch.cuda.synchronize()
        assert alloc0 - torch.cuda.memory_allocated(card) >= booked
        assert hot0 - telem.hbm_booked(card, "hot") >= booked
        assert mirror.booked_bytes == 0 and mirror.snapshot() is None
        after = c.engine.query_range(q, s + 600, 60, s + 1790)
        assert after.error is None
        got = {k.labels: np.asarray(v) for k, _, v in after.series()}
        want = {k.labels: np.asarray(v) for k, _, v in res.series()}
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    finally:
        c.stop()


def test_one_card_mesh_launches_k1_once_per_slot(card):
    """A 4 x 1 mesh whose four slots name the one card: the rate panel
    launches K1 once per slot and equals the same mesh over the host
    (the kernels' plain versions) within the kernel-to-plain tolerance
    (rtol 1e-6, atol 1e-5); the in-process merge runs on the card."""
    from filodb_tpu_torch.core.index import Equals
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.ingest.generator import counter_batch
    from filodb_tpu_torch.ops.timewindow import make_window_ends
    from filodb_tpu_torch.parallel.mesh import MeshExecutor, make_mesh
    from filodb_tpu_torch.utils.counters import counters
    start = 1_600_000_000_000
    ms = TimeSeriesMemStore(device="cpu")
    for s in range(4):
        ms.setup("prometheus", s).ingest(
            counter_batch(512, 360, start_ms=start, seed=40 + s))
    end = start + 359 * 10_000
    w = make_window_ends(start + 600_000, end, 60_000)
    f = [Equals("_metric_", "request_total")]

    def run(mesh):
        ex = MeshExecutor(ms, "prometheus", mesh)
        pk = ex.lookup_and_pack(f, start, end, by=("_ns_",), fn_name="rate")
        return ex.run_agg(pk, w, range_ms=300_000, fn_name="rate",
                          agg_op="sum")
    want, wl = run(make_mesh(4, 1, devices=["cpu"] * 4))
    n0 = kernels.LAUNCHES["fused_rate_dense"]
    c0 = counters.get("mesh_partials_collective_merge")
    got, gl = run(make_mesh(4, 1, devices=[card] * 4))
    assert kernels.LAUNCHES["fused_rate_dense"] == n0 + 4
    assert counters.get("mesh_partials_collective_merge") == c0 + 1
    assert gl == wl and (np.isnan(got) == np.isnan(want)).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5,
                               equal_nan=True)


def _object_store_of_two_segments(root, S=400, seed=37):
    """S counters x 4 h at 10 s, flushed on the host and compacted into
    two 2 h segments, uploaded to a LocalObjectStore -> (store, the
    panel's span)."""
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.core.partkey import PartKey
    from filodb_tpu_torch.persist.compactor import SegmentCompactor
    from filodb_tpu_torch.persist.localstore import LocalDiskColumnStore
    from filodb_tpu_torch.persist.objectstore import (LocalObjectStore,
                                                      SegmentUploader)
    from filodb_tpu_torch.persist.segments import SegmentStore
    window = 2 * 3600 * 1000
    t0 = 1_600_000_000_000 - 1_600_000_000_000 % window
    T = 1440
    rng = np.random.default_rng(seed)
    v = np.cumsum(rng.exponential(10.0, size=(S, T)), axis=1)
    keys = [PartKey.make("request_total", {"_ws_": "demo",
                                           "_ns_": f"App-{i % 20}",
                                           "instance": f"Instance-{i}"})
            for i in range(S)]
    ts = np.broadcast_to(t0 + np.arange(T, dtype=np.int64) * 10_000, (S, T))
    cs = LocalDiskColumnStore(str(root))
    sh = TimeSeriesMemStore(column_store=cs, device="cpu").setup(
        "prometheus", 0)
    sh.ingest_columns("prom-counter", keys, ts, {"count": v})
    sh.flush_all_groups()
    seg = SegmentStore(str(root))
    assert SegmentCompactor(cs, seg, "prometheus", 1, window_ms=window,
                            closed_lag_ms=0).compact_all(
        now_ms=t0 + 10 * window) == 2
    store = LocalObjectStore(str(root / "bucket"), name="card-bucket")
    up = SegmentUploader(store, seg, "prometheus", 1)
    up.mount()
    assert up.run_once() == 2
    return store, (t0 // 1000 + 600, 60, t0 // 1000 + (T - 1) * 10)


def _query_tier_engine(store, device, **kw):
    from filodb_tpu_torch.core.devicecache import ColdSegmentCache
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.parallel.shardmapper import ShardEvent, ShardMapper
    from filodb_tpu_torch.persist.objectstore import RemoteSegmentStore
    from filodb_tpu_torch.persist.segments import PersistedTier
    from filodb_tpu_torch.query.engine import QueryEngine
    from filodb_tpu_torch.query.planners import PersistedClusterPlanner
    mapper = ShardMapper(1)
    mapper.update_from_event(ShardEvent("IngestionStarted", "prometheus", 0,
                                        "n"))
    remote = RemoteSegmentStore(store, "prometheus", 1, **kw)
    remote.mount()
    tier = PersistedTier(remote, "prometheus", 1,
                         ColdSegmentCache(1 << 30, device=device))
    return QueryEngine("prometheus", TimeSeriesMemStore(device=device),
                       mapper, planner=PersistedClusterPlanner(
                           "prometheus", mapper, tier), device=device)


def test_cold_read_cluster_on_the_card_answers_as_a_local_tier(card,
                                                                 tmp_path):
    """A data node and two query-only nodes on the card over one object
    store: the cold leaves revive against the receiving node's tier on
    the card; four rounds, then two with the data node stopped, each
    launches K1 and is bit-identical to a local query tier's answer."""
    from filodb_tpu_torch.parallel.testcluster import make_cold_read_cluster
    store, span = _object_store_of_two_segments(tmp_path)
    q = "sum by (_ns_) (rate(request_total[5m]))"
    want = _series_of(_query_tier_engine(store, card).query_range(q, *span))
    c = make_cold_read_cluster(store, num_shards=1, dataset="prometheus",
                               data_nodes=("data0",),
                               query_nodes=("q1", "q2"), device=card)
    try:
        for i in range(6):
            if i == 4:
                c.servers["data0"].stop()
            n0 = kernels.LAUNCHES["fused_rate_dense"]
            got = _series_of(c.engine.query_range(q, *span))
            assert kernels.LAUNCHES["fused_rate_dense"] - n0 == 1
            assert [k for k, _ in got] == [k for k, _ in want]
            for (_, x), (_, y) in zip(got, want):
                assert np.array_equal(x, y, equal_nan=True)
        assert all(b.ts_off.is_cuda for b in c.tier.cold_cache.blocks())
    finally:
        c.tier.cold_cache.clear()
        c.stop()


@pytest.mark.parametrize("partial", [True, False])
def test_dead_object_store_on_the_card_is_shard_unavailable(card, tmp_path,
                                                            partial):
    """objectstore.get faulted under a query tier on the card: a flagged
    partial with allow_partial_results, a shard_unavailable error
    without."""
    from filodb_tpu_torch.parallel.breaker import breakers
    from filodb_tpu_torch.query.rangevector import PlannerParams
    from filodb_tpu_torch.utils.faults import faults
    store, span = _object_store_of_two_segments(tmp_path)
    eng = _query_tier_engine(store, card, ttl_s=1_000.0)
    breakers.configure(failure_threshold=2, open_base_s=0.05,
                       open_max_s=0.1, jitter=0.0)
    try:
        with faults.plan("objectstore.get", "error", first_k=1_000_000):
            res = eng.query_range("sum by (_ns_) (rate(request_total[5m]))",
                                  *span, PlannerParams(
                                      allow_partial_results=partial))
    finally:
        faults.disarm()
        breakers.configure()
        breakers.reset()
    if partial:
        assert res.error is None and res.partial and res.num_series == 0
    else:
        assert res.error.startswith(
            "shard_unavailable: shard 0: cold tier unavailable")
