"""filodb_tpu_torch's CUDA kernels (K1 dense and K3 ragged rate, K2 rate
over raw counters, K4 last_over_time, K5 sum/avg/count_over_time, each
also in its per-series mode K6) against their plain torch versions, on
the card.  Marked `cuda`: without a card they
skip.  This file imports neither jax nor filodb_tpu, so it also runs on
a machine with only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from filodb_tpu_torch.ops import fused, kernels

pytestmark = pytest.mark.cuda


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
    """Rows too long for eight in shared memory stage fewer per block
    (12,000 slots: 48 KB each, four per block), still bit-identical."""
    args = _inputs(card, 300, 12_000, (3,), 0.0, 7, resets=5)
    assert args[4].span * 4 * 8 > kernels.SMEM_BYTES
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
