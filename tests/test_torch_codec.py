"""The port's NibblePack codec and chunk encoding
(filodb_tpu_torch/memory/nibblepack.py, memory/chunks.py,
memory/histogram.py) against the JAX package's: the payload bytes the
port writes equal the JAX package's on the same input, for counter,
gauge, long and histogram columns (the chunk id is not payload), and
decode round trips to the bit.  Both of the port's implementations (the
vectorized numpy path and the pure-Python one) are held to the same
bytes.
"""
import numpy as np
import pytest

from filodb_tpu.memory import chunks as jchunks
from filodb_tpu.memory import nibblepack as jnp_pack
from filodb_tpu.memory.histogram import HistogramBuckets as JBuckets
from filodb_tpu_torch.memory import chunks, nibblepack
from filodb_tpu_torch.memory.histogram import HistogramBuckets

START = 1_600_000_000_000
INGEST_MS = 1_700_000_000_000


def _u64(rng, n, kind):
    if kind == "small":
        return rng.integers(0, 300, size=n).astype(np.uint64)
    if kind == "sparse":
        v = rng.integers(0, 1 << 40, size=n).astype(np.uint64)
        v[rng.random(n) < 0.7] = 0
        return v
    return rng.integers(0, np.iinfo(np.int64).max, size=n,
                        dtype=np.int64).astype(np.uint64) << np.uint64(1)


@pytest.mark.parametrize("n", [0, 1, 7, 31, 32, 33, 1000])
def test_nibblepack_bytes_match_jax(n):
    """Every value shape (small, sparse, full-width u64) at each size,
    below and above the vectorized path's 32-value threshold."""
    for kind in ("small", "sparse", "wide"):
        _nibblepack_case(n, kind)


def _nibblepack_case(n, kind):
    rng = np.random.default_rng(n + len(kind))
    v = _u64(rng, n, kind)
    packed = nibblepack.pack(v)
    assert packed == jnp_pack.pack(v)
    np.testing.assert_array_equal(nibblepack.unpack(packed, n), v)
    # both of the port's implementations, whichever pack() picked
    assert nibblepack._pack_py(v) == packed
    if n:
        assert nibblepack._pack_vec(v) == packed
        np.testing.assert_array_equal(nibblepack._unpack_vec(packed, n), v)
    np.testing.assert_array_equal(nibblepack._unpack_py(packed, n), v)
    x = rng.normal(0, 1e6, size=n)
    assert nibblepack.pack_f64_xor(x) == jnp_pack.pack_f64_xor(x)
    assert nibblepack.unpack_f64_xor(nibblepack.pack_f64_xor(x), n) \
        .tobytes() == x.tobytes()
    if n:
        with pytest.raises(ValueError):
            nibblepack.unpack(packed[:-1] if packed[-1:] != b"\x00"
                              else b"", n)


def _columns(kind, rng, n):
    """-> (columns, col_types, les) for encode_chunkset."""
    if kind == "counter":             # integral counts: delta-delta longs
        return ({"count": np.cumsum(rng.integers(0, 50, n)).astype(float)},
                {"count": "double"}, None)
    if kind == "counter_frac":        # fractional: XOR-packed doubles
        return ({"count": np.cumsum(rng.exponential(10.0, n))},
                {"count": "double"}, None)
    if kind == "gauge_nan":
        v = rng.normal(100, 20, n)
        v[rng.random(n) < 0.1] = np.nan
        return {"value": v}, {"value": "double"}, None
    if kind == "long":
        return ({"n": np.cumsum(rng.integers(-5, 9, n))}, {"n": "long"}, None)
    les = 2.0 * 2.0 ** np.arange(6)
    hist = np.cumsum(np.cumsum(rng.poisson(3.0, (n, 6)), axis=0), axis=1)
    return ({"h": hist.astype(float), "count": hist[:, -1].astype(float)},
            {"h": "hist", "count": "double"}, les)


def _same_chunk(got, want):
    assert got.info.num_rows == want.info.num_rows
    assert got.info.start_time_ms == want.info.start_time_ms
    assert got.info.end_time_ms == want.info.end_time_ms
    assert got.info.ingestion_time_ms == want.info.ingestion_time_ms
    assert list(got.columns) == list(want.columns)
    for name, c in want.columns.items():
        g = got.columns[name]
        assert (g.kind, g.base, g.slope, g.num_buckets) == \
            (c.kind, c.base, c.slope, c.num_buckets), name
        assert g.payload == c.payload, name
    if want.bucket_scheme is None:
        assert got.bucket_scheme is None
    else:
        assert got.bucket_scheme.les == want.bucket_scheme.les


@pytest.mark.parametrize("kind", ["counter", "counter_frac", "gauge_nan",
                                  "long", "hist"])
@pytest.mark.parametrize("n", [1, 20, 720])
def test_chunk_payloads_byte_equal_and_round_trip(kind, n):
    rng = np.random.default_rng(n)
    ts = START + np.arange(n, dtype=np.int64) * 10_000
    ts[n // 2:] += 7                   # a jittered scrape
    cols, types, les = _columns(kind, rng, n)
    got = chunks.encode_chunkset(ts, cols, types, INGEST_MS,
                                 None if les is None
                                 else HistogramBuckets.custom(les))
    want = jchunks.encode_chunkset(ts, cols, types, INGEST_MS,
                                   None if les is None
                                   else JBuckets.custom(les))
    _same_chunk(got, want)
    dec = chunks.decode_chunkset(got)
    np.testing.assert_array_equal(dec["timestamp"], ts)
    for name, v in cols.items():
        assert dec[name].astype(v.dtype).tobytes() == v.tobytes(), name
