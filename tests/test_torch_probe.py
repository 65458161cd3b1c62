"""The column-selection probe (K8): the port's strategies
(filodb_tpu_torch/ops/probe.py, plain versions on the CPU) against
tools/probe_slice.py's five Pallas bodies run in interpret mode on a cut
grid, on the probe's own inputs; and the port's entry point,
`python -m filodb_tpu_torch.tools.probe_slice`, which refuses to run
without a card unless given --device cpu."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from filodb_tpu_torch.ops import probe
from filodb_tpu_torch.tools import probe_slice as tps

ROOT = Path(__file__).resolve().parents[1]
GRID = 2


@pytest.fixture(scope="module")
def ref():
    """tools/probe_slice.py on a grid of GRID blocks (GRID x 256 rows)."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import probe_slice
    finally:
        sys.path.remove(str(ROOT / "tools"))
    probe_slice.GRID = GRID
    return probe_slice


def _port_inputs():
    return tps.inputs(GRID, "cpu")


PORTED = {
    "k_dyngather": lambda x, o, i1, i2: probe.probe_gather(x, i1, tps.W,
                                                           tps.WP),
    "k_tiled_gather": lambda x, o, i1, i2: probe.probe_gather(x, i1, tps.W,
                                                              tps.WP),
    "k_two_gathers": lambda x, o, i1, i2: probe.probe_two_gathers(
        x, i1, i2, tps.W, tps.WP),
    "k_tiled_two": lambda x, o, i1, i2: probe.probe_two_gathers(
        x, i1, i2, tps.W, tps.WP),
    "k_matmul": lambda x, o, i1, i2: probe.probe_onehot_matmul(x, o),
}


def test_port_builds_the_reference_inputs(ref):
    x, o, i1, i2 = _port_inputs()
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        x.numpy(), rng.standard_normal((GRID * ref.BS, ref.TP)).astype(
            np.float32))
    np.testing.assert_array_equal(i1.numpy(), ref.IDX)
    np.testing.assert_array_equal(i2.numpy(), ref.IDX + (ref.STRIDE - 1))
    assert (tps.BS, tps.TP, tps.WP, tps.F0, tps.STRIDE, tps.W) == \
        (ref.BS, ref.TP, ref.WP, ref.F0, ref.STRIDE, ref.W)
    assert o.sum() == ref.W and (o.numpy().argmax(0)[:ref.W]
                                 == ref.IDX[:ref.W]).all()


@pytest.mark.parametrize("body", sorted(PORTED))
def test_strategy_matches_the_pallas_body(ref, body):
    """Each Pallas body (interpret mode) and its port give the same bits."""
    x, o, i1, i2 = _port_inputs()
    want = np.asarray(ref.run(getattr(ref, body), x.numpy(), o.numpy(),
                              i1.numpy()[None, :], i2.numpy()[None, :],
                              interpret=True))
    got = PORTED[body](x, o, i1, i2).numpy()
    assert got.shape == want.shape == (GRID * ref.BS, ref.WP)
    np.testing.assert_array_equal(got, want)


def _bits(a):
    """float32 bits with every NaN as one pattern."""
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_product_on_adversarial_inputs_matches_the_pallas_body(ref, seed):
    """The product (plain version on the CPU) against k_matmul in interpret
    mode on probe_slice.adversarial_inputs: +-Inf, NaN and -0.0 in x; an
    all-zero column, a +1/-1 pair, three non-unit nonzeros, a NaN and a
    +Inf in o.  Same bits, NaN in the same cells, and the NaN rule cell by
    cell: y[r, j] is NaN wherever a non-finite x[r, k] meets o[k, j] == 0."""
    x, o = tps.adversarial_inputs(GRID * ref.BS, "cpu", seed=seed)
    xs, os_ = x.numpy(), o.numpy()
    idx = np.zeros((1, ref.TP), np.int32)
    want = np.asarray(ref.run(ref.k_matmul, xs, os_, idx, idx,
                              interpret=True))
    got = probe.probe_onehot_matmul(x, o).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    rule = ((~np.isfinite(xs)).astype(np.int64)
            @ (os_ == 0).astype(np.int64)) > 0
    assert rule.any() and np.isnan(got[rule]).all()
    with np.errstate(invalid="ignore"):
        exact = xs.astype(np.float64) @ os_.astype(np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exact))
    assert np.isnan(got[:, tps.ADV_NAN]).all()
    # -0.0 selected by a 1 gives +0.0
    zero = np.arange(len(xs)) % 10 == 0
    onehot = [w for w in range(tps.W) if w not in (
        tps.ADV_PAIR, tps.ADV_THREE, tps.ADV_NAN, tps.ADV_INF)]
    assert (_bits(got[np.ix_(zero, onehot)]) == 0).all()


def test_wrappers_take_the_plain_version_on_the_cpu():
    x, o, i1, i2 = _port_inputs()
    assert torch.equal(probe.probe_gather(x, i1, tps.W, tps.WP),
                       probe.probe_gather_plain(x, i1, tps.W, tps.WP))
    assert torch.equal(probe.probe_onehot_matmul(x, o), x @ o)
    two = probe.probe_two_gathers(x, i1, i2, tps.W, tps.WP)
    assert (two[:, tps.W:] == 0).all()
    assert torch.equal(two[:, :tps.W],
                       x[:, i2[:tps.W].long()] - x[:, i1[:tps.W].long()])


def _run_tool(*args):
    return subprocess.run([sys.executable, "-m",
                           "filodb_tpu_torch.tools.probe_slice", *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)


def test_entry_point_on_the_cpu_prints_one_line_a_strategy():
    out = _run_tool("--device", "cpu", "--grid", str(GRID))
    assert out.returncode == 0, out.stderr
    recs = [json.loads(ln) for ln in out.stdout.strip().splitlines()]
    assert [r["strategy"] for r in recs] == ["tiled_gather", "tiled_two",
                                             "matmul"]
    assert all(r["max_abs_err"] == 0.0 for r in recs)


def test_entry_point_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = _run_tool("--grid", str(GRID))
    assert out.returncode != 0
    assert "NoCudaDevice" in out.stderr and not out.stdout.strip()
