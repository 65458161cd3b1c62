"""The device rule: the port's entry points default to the card and never
carry on on the host unless asked; a kernel wrapper handed a non-CPU
tensor launches the kernel or raises, with no fallback to the plain
version."""
import numpy as np
import pytest
import torch

from filodb_tpu_torch.core.devicecache import DeviceMirror
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.ops import fused, kernels
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.utils.device import NoCudaDevice, resolve_device


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("make", [
    lambda: TimeSeriesMemStore(),
    lambda: TimeSeriesMemStore(device="cuda"),
    lambda: DeviceMirror(),
    lambda: QueryEngine("prometheus", TimeSeriesMemStore(device="cpu")),
    lambda: resolve_device("cuda:0"),
    lambda: fused.pad_values(
        np.zeros((8, 40), np.float32), np.zeros(8),
        fused.build_plan(np.arange(40, dtype=np.int64) * 10_000,
                         np.arange(100_000, 390_001, 30_000), 60_000)),
    lambda: __import__("filodb_tpu_torch.core.devicecache",
                       fromlist=["x"]).ColdSegmentCache(1 << 20),
], ids=["memstore", "memstore_cuda", "mirror", "engine", "resolve",
        "pad_values_numpy", "cold_cache"])
def test_entry_points_raise_without_a_card(no_card, make):
    with pytest.raises(NoCudaDevice):
        make()


def test_entry_points_run_on_the_host_when_asked(no_card):
    ms = TimeSeriesMemStore(device="cpu")
    eng = QueryEngine("prometheus", ms, device="cpu")
    assert eng.device.type == "cpu" and ms.device.type == "cpu"
    assert DeviceMirror(device="cpu").device.type == "cpu"


def test_engine_refuses_a_source_on_another_device():
    ms = TimeSeriesMemStore(device="cpu")
    ms.device = torch.device("cuda", 0)
    with pytest.raises(ValueError):
        QueryEngine("prometheus", ms, device="cpu")


def _tiny_inputs(device):
    ts = np.arange(40, dtype=np.int64) * 10_000
    plan = fused.build_plan(ts, np.arange(100_000, 390_001, 30_000), 60_000)
    vals = fused.pad_values(torch.zeros((8, 40)), torch.zeros(8), plan,
                            device=device)
    g = fused.pad_groups(np.zeros(8, np.int32), 8, 1, device=device)
    Gp = fused.pad_group_count(1)
    chunks = fused.chunk_plan(g.csr.offsets, Gp, device)
    return vals, g, chunks, plan.device_rows(device), Gp


@pytest.mark.parametrize("wrapper", ["dense", "ragged"])
def test_wrapper_without_cuda_tensor_raises_not_falls_back(wrapper):
    """A tensor that is not on the CPU never reaches the plain version:
    the wrapper hands it to the CUDA launcher, which refuses it."""
    vals, g, chunks, rows, Gp = _tiny_inputs("meta")
    fn = fused.fused_rate_dense if wrapper == "dense" \
        else fused.fused_rate_ragged
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA kernel given a tensor on meta"):
        fn(vals.vals_p, vals.vbase_p, g.csr, chunks, rows, Gp, True, True)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("wrapper", ["dense", "ragged"])
def test_cuda_launch_without_the_library_raises(wrapper, monkeypatch,
                                                tmp_path):
    """Past the device checks, a missing library is built; with no nvcc
    the build fails loudly and nothing is launched."""
    vals, g, chunks, rows, Gp = _tiny_inputs("cpu")
    monkeypatch.setattr(kernels, "_check_common",
                        lambda *a: (torch.device("cpu"), vals.vals_p.shape[1],
                                    rows.idx1.numel(), chunks.lo.numel()))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "find_nvcc", lambda: (_ for _ in ()).throw(
        kernels.KernelBuildError("nvcc not found")))
    launch = kernels.fused_rate_dense_cuda if wrapper == "dense" \
        else kernels.fused_rate_ragged_cuda
    before = dict(kernels.LAUNCHES)
    with pytest.raises(kernels.KernelBuildError):
        launch(vals.vals_p, vals.vbase_p, g.csr.order, chunks, rows, Gp,
               True, True)
    assert kernels.LAUNCHES == before


def test_cpu_wrapper_uses_the_plain_version():
    vals, g, chunks, rows, Gp = _tiny_inputs("cpu")
    before = dict(kernels.LAUNCHES)
    out = fused.fused_rate_dense(vals.vals_p, vals.vbase_p, g.csr, chunks,
                                 rows, Gp, True, True)
    assert out.shape == (Gp, rows.idx1.numel())
    assert kernels.LAUNCHES == before
