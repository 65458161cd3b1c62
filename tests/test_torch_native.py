"""The port's C++ host library (filodb_tpu_torch/native: xxhash32 and
xxhash64, NibblePack, iter_rate), built by g++ at first use into
filodb_tpu_torch/build/, held bit for bit against the JAX package's
pure-Python and numpy paths on seeded inputs.  Skipped only where no
C++ compiler exists (the port then keeps its own Python and numpy
paths, which test_torch_flush.py and the codec tests cover)."""
import ctypes
import os
import shutil

import numpy as np
import pytest

from filodb_tpu.memory import nibblepack as REF_NP
from filodb_tpu.utils import hashing as REF_H
from filodb_tpu_torch import native
from filodb_tpu_torch.memory import nibblepack as NP
from filodb_tpu_torch.utils import hashing as H

pytestmark = pytest.mark.skipif(
    not (os.environ.get("CXX") or shutil.which("g++")),
    reason="no C++ compiler: the port keeps its Python and numpy paths")


@pytest.fixture(scope="module")
def lib():
    got = native.lib
    assert got is not None, native.build_error()
    return got


def _ref_xxhash32(data, seed=0):
    # the reference swaps its own native build in when it has one; its
    # pure-Python implementation stays reachable under _py_xxhash32
    return getattr(REF_H, "_py_xxhash32", REF_H.xxhash32)(data, seed)


def _ref_xxhash64(data, seed=0):
    return getattr(REF_H, "_py_xxhash64", REF_H.xxhash64)(data, seed)


def test_library_is_built_into_the_build_directory(lib):
    path = native.library_path()
    assert lib.path == path and path.exists()
    assert path.parent == native.BUILD_DIR
    assert path.parent.name == "build" and \
        path.parent.parent.name == "filodb_tpu_torch"
    # nothing written beside the source, no marker, not the reference's
    assert sorted(p.name for p in native.SOURCE.parent.iterdir()
                  if not p.name.startswith("__pycache__")) == \
        ["__init__.py", "filodb_native.cc"]
    assert "filodb_tpu/native" not in str(path)
    # the short calls keep the interpreter lock (a lock handoff per hash
    # under several threads costs more than the hash); the long one drops it
    assert type(lib._c) is ctypes.PyDLL and type(lib._long) is ctypes.CDLL
    ref_src = native.SOURCE.parents[2] / "filodb_tpu" / "native" / \
        "filodb_native.cc"
    assert native.SOURCE.read_text().split("extern \"C\"", 1)[1] == \
        ref_src.read_text().split("extern \"C\"", 1)[1]


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 15, 16, 17, 31, 32, 33, 255,
                               1024])
def test_xxhash32_equals_the_reference_python(lib, n):
    data = np.random.default_rng(1600 + n).integers(
        0, 256, n, dtype=np.uint8).tobytes()
    for seed in (0, 1, 0xDEADBEEF):
        want = _ref_xxhash32(data, seed)
        assert lib.xxhash32(data, seed) == want
        assert H.xxhash32(data, seed) == want
        assert H._py_xxhash32(data, seed) == want
    assert H.hash32_signed(data) == REF_H.hash32_signed(data)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 31, 32, 33, 255, 1024])
def test_xxhash64_equals_the_reference_python(lib, n):
    data = np.random.default_rng(1700 + n).integers(
        0, 256, n, dtype=np.uint8).tobytes()
    for seed in (0, 7, 2**63):
        want = _ref_xxhash64(data, seed)
        assert lib.xxhash64(data, seed) == want
        assert H.xxhash64(data, seed) == want
        assert H._py_xxhash64(data, seed) == want


def test_part_key_hashes_equal_the_reference(lib):
    from filodb_tpu.core.partkey import PartKey as RefPartKey
    from filodb_tpu_torch.core.partkey import PartKey
    for i in range(50):
        tags = {"_ws_": "demo", "_ns_": f"App-{i % 7}",
                "instance": f"Instance-{i}"}
        a = PartKey.make("request_total", tags)
        b = RefPartKey.make("request_total", tags)
        assert a.to_bytes() == b.to_bytes()
        assert a.partition_hash() == b.partition_hash()
        assert a.shard_key_hash() == b.shard_key_hash()


def _nibble_case(case, rng):
    if case == "zeros":
        return np.zeros(64, dtype=np.uint64)
    if case == "small":
        return rng.integers(0, 16, 64).astype(np.uint64)
    if case == "large":
        return rng.integers(0, 2**62, 64).astype(np.uint64)
    if case == "mixed":
        vals = rng.integers(0, 2**30, 1000).astype(np.uint64)
        vals[::3] = 0
        return vals
    if case == "full64":
        return np.full(16, 0xFFFFFFFFFFFFFFFF, dtype=np.uint64)
    if case == "empty":
        return np.zeros(0, dtype=np.uint64)
    return rng.integers(0, 1000, 13).astype(np.uint64)   # not a multiple of 8


@pytest.mark.parametrize("case", ["zeros", "small", "large", "mixed",
                                  "full64", "empty", "ragged"])
def test_nibblepack_equals_the_reference_paths(lib, case):
    vals = _nibble_case(case, np.random.default_rng(1800))
    packed = lib.nibble_pack(vals)
    # the reference's pure-Python and numpy paths, and the port's codec
    assert packed == REF_NP._pack_py(vals)
    if len(vals):
        assert packed == REF_NP._pack_vec(vals)
    assert NP.pack(vals) == packed
    n = len(vals)
    for blob in (packed, REF_NP._pack_py(vals)):
        np.testing.assert_array_equal(lib.nibble_unpack(blob, n), vals)
        np.testing.assert_array_equal(NP.unpack(blob, n), vals)
    np.testing.assert_array_equal(REF_NP._unpack_py(packed, n), vals)
    if n:
        np.testing.assert_array_equal(REF_NP._unpack_vec(packed, n), vals)


def test_nibblepack_fuzz_equals_the_reference(lib):
    rng = np.random.default_rng(1801)
    for _ in range(50):
        n = int(rng.integers(1, 300))
        shift = int(rng.integers(0, 12)) * 4
        vals = (rng.integers(0, 2**52, n).astype(np.uint64)
                << np.uint64(shift))
        vals[rng.random(n) < 0.2] = 0
        packed = lib.nibble_pack(vals)
        assert packed == REF_NP._pack_py(vals) == REF_NP._pack_vec(vals)
        np.testing.assert_array_equal(lib.nibble_unpack(packed, n), vals)


@pytest.mark.parametrize("cut", [0, 1, 3, 10])
def test_truncated_input_raises_as_the_reference(lib, cut):
    vals = np.arange(1, 17, dtype=np.uint64) * np.uint64(0x1234567)
    packed = lib.nibble_pack(vals)
    with pytest.raises(ValueError):
        lib.nibble_unpack(packed[:cut], 16)
    with pytest.raises(ValueError):
        REF_NP._unpack_py(packed[:cut], 16)
    with pytest.raises(ValueError):
        REF_NP._unpack_vec(packed[:cut], 16)
    with pytest.raises(ValueError):
        NP.unpack(packed[:cut], 16)


def test_timestamp_and_double_codecs_equal_the_reference(lib):
    rng = np.random.default_rng(1802)
    ts = 1_600_000_000_000 + np.arange(720, dtype=np.int64) * 10_000
    ts[37] += 3
    assert NP.pack_timestamps(ts) == REF_NP.pack_timestamps(ts)
    base, slope, payload = NP.pack_timestamps(ts)
    np.testing.assert_array_equal(
        NP.unpack_timestamps(base, slope, payload, len(ts)), ts)
    vals = np.cumsum(rng.integers(0, 20, 720)).astype(np.float64)
    vals[100] = np.nan
    assert NP.pack_f64_xor(vals) == REF_NP.pack_f64_xor(vals)
    np.testing.assert_array_equal(
        NP.unpack_f64_xor(NP.pack_f64_xor(vals), 720), vals)


def _numpy_rates(ts_row, vals, wends, range_ms):
    """Per-(series, window) extrapolated rate in f64 numpy, the
    reference's numpy baseline before its group sum (bench.py's
    numpy_vectorized_baseline, :71-95)."""
    lo = np.searchsorted(ts_row, wends - range_ms + 1, side="left")
    hi = np.searchsorted(ts_row, wends, side="right") - 1
    n = hi - lo + 1
    ok = n >= 2
    lo_c = np.minimum(lo, len(ts_row) - 1)
    t1 = ts_row[lo_c].astype(np.float64)
    t2 = ts_row[hi].astype(np.float64)
    v1 = vals[:, lo_c].astype(np.float64)
    v2 = vals[:, hi].astype(np.float64)
    wstart = (wends - range_ms).astype(np.float64)
    wend = wends.astype(np.float64)
    dur_start = (t1 - wstart) / 1000.0
    dur_end = (wend - t2) / 1000.0
    sampled = (t2 - t1) / 1000.0
    avg = sampled / np.maximum(n - 1, 1)
    delta = v2 - v1
    with np.errstate(invalid="ignore", divide="ignore"):
        dur_zero = sampled * (v1 / delta)
        ds = np.where((delta > 0) & (v1 >= 0) & (dur_zero < dur_start),
                      dur_zero, dur_start)
        threshold = avg * 1.1
        extrap = (sampled + np.where(ds < threshold, ds, avg / 2)
                  + np.where(dur_end < threshold, dur_end, avg / 2))
        rate = delta * (extrap / sampled) / (wend - wstart) * 1000.0
    return np.where(ok & (sampled > 0), rate, np.nan)


def test_iter_rate_equals_the_numpy_baseline_and_the_reference(lib):
    rng = np.random.default_rng(1803)
    S, T = 64, 180
    ts_row = 1_600_000_000_000 + np.arange(T, dtype=np.int64) * 10_000
    vals = np.cumsum(rng.integers(0, 20, (S, T)), axis=1).astype(np.float64)
    vals[::5, 90:] -= vals[::5, 90:91]           # a reset in every 5th row
    wends = ts_row[30] + np.arange(0, (T - 30) * 10_000, 60_000)
    got = lib.iter_rate(ts_row, vals, wends, 300_000)
    want = _numpy_rates(ts_row, vals, wends, 300_000)
    assert got.tobytes() == want.tobytes()
    ref_lib = getattr(__import__("filodb_tpu.native", fromlist=["lib"]),
                      "lib", None)
    if ref_lib is not None:
        assert ref_lib.iter_rate(ts_row, vals, wends, 300_000).tobytes() == \
            got.tobytes()
