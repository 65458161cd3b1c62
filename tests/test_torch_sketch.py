"""The port's quantile sketch (filodb_tpu_torch/ops/sketch.py) against the
JAX package's (filodb_tpu/ops/sketch.py).

Sketches built, merged and presented over tests/test_sketch.py's cases
must be the reference's to the bit; the map, reduce and present phases
of quantile() must ship and present the reference's sketch; and
`quantile by (...)` through both engines over the same seeded gauges
must agree within rtol 2e-4 / atol 1e-3.
"""
import numpy as np
import pytest
import torch

from filodb_tpu.ops import sketch as jsk

from filodb_tpu_torch.ops import sketch as tsk


@pytest.fixture(autouse=True, scope="module")
def _clear_compile_journal():
    """The JAX engine journals jit compiles under its queries' trace ids,
    which the reference's health model reads as a compile storm for the
    next 120 s: clear it after this file."""
    yield
    from filodb_tpu.utils.events import journal
    journal.clear()


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(a).dtype == np.asarray(b).dtype


def _cases():
    rng = np.random.default_rng(1)
    holes = rng.normal(10, 4, size=(40, 6))
    holes[rng.random(holes.shape) < 0.15] = np.nan
    rng = np.random.default_rng(3)
    return {
        "under_k_with_holes": (holes, (np.arange(40) % 3).astype(np.int64),
                               3),
        "at_scale": (rng.normal(100, 15, size=(20_000, 3)),
                     np.zeros(20_000, np.int64), 1),
        "f32_groups": (np.random.default_rng(5).lognormal(0, 2, (700, 4))
                       .astype(np.float32),
                       (np.arange(700) % 5).astype(np.int64), 5),
        "empty_group": (np.ones((5, 2)), np.zeros(5, np.int64), 3),
    }


@pytest.mark.parametrize("case", sorted(_cases()))
@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.9, 1.0, -0.5, 1.5])
def test_build_and_present_equal_reference(case, q):
    vals, gids, g = _cases()[case]
    sk = tsk.sketch_from_values(vals, gids, g)
    _same(sk, jsk.sketch_from_values(vals, gids, g))
    with np.errstate(invalid="ignore"):
        _same(tsk.sketch_quantile(sk, q), jsk.sketch_quantile(sk, q))


@pytest.mark.parametrize("shards", [2, 8])
def test_merge_equals_reference(shards):
    rng = np.random.default_rng(4)
    per = [rng.exponential(7.0, size=(int(rng.integers(1, 5_000)), 2))
           for _ in range(shards)]
    sks = [tsk.sketch_from_values(v, np.zeros(len(v), np.int64), 1)
           for v in per]
    cat = np.concatenate(sks, axis=2)
    merged = tsk.merge_sketches(cat)
    _same(merged, jsk.merge_sketches(cat))
    assert merged.shape[2] == tsk.K_DEFAULT
    allv = np.concatenate(per, axis=0)
    for q in (0.5, 0.95):
        _same(tsk.sketch_quantile(merged, q), jsk.sketch_quantile(merged, q))
        np.testing.assert_allclose(tsk.sketch_quantile(merged, q)[0],
                                   np.quantile(allv, q, axis=0), rtol=0.05)


def test_dead_centroids_equal_reference():
    sk = np.zeros((1, 1, 3, 2))
    sk[0, 0, :, 0] = [10.0, 20.0, np.nan]
    sk[0, 0, :, 1] = [5.0, 5.0, 0.0]
    for q in (1.0, 0.9, 0.1):
        _same(tsk.sketch_quantile(sk, q), jsk.sketch_quantile(sk, q))
    assert tsk.sketch_quantile(sk, 1.0)[0, 0] == 20.0


def _blocks(pkg, n, w, seed):
    """Three shards' ResultBlocks of the same values in one package."""
    if pkg == "jax":
        from filodb_tpu.query.rangevector import RangeVectorKey, ResultBlock
    else:
        from filodb_tpu_torch.query.rangevector import (RangeVectorKey,
                                                        ResultBlock)
    rng = np.random.default_rng(seed)
    wends = np.arange(w, dtype=np.int64) * 60_000
    out = []
    for shard in range(3):
        keys = [RangeVectorKey.make({"_ns_": f"App-{i % 2}",
                                     "instance": f"s{shard}-{i}"})
                for i in range(n)]
        vals = rng.normal(0, 1, size=(n, w)).astype(np.float32)
        out.append(ResultBlock(keys, wends, vals if pkg == "jax"
                               else torch.from_numpy(vals)))
    return out


@pytest.mark.parametrize("n", [20, 500])
@pytest.mark.parametrize("compress", [True, False])
def test_partials_reduce_and_present_equal_reference(n, compress):
    """quantile()'s partial is the sketch in both packages, O(groups) in
    size; reduce (compressed, or the node-level concatenation) and present
    answer the reference's bits."""
    from filodb_tpu.query import exec as jexec
    from filodb_tpu.query.rangevector import QueryContext as JCtx
    from filodb_tpu.query.rangevector import QueryStats as JStats

    from filodb_tpu_torch.query import execbase as texec
    from filodb_tpu_torch.query.rangevector import QueryContext, QueryStats
    from filodb_tpu_torch.query.transformers import AggregateMapReduce
    jm = jexec.AggregateMapReduce("quantile", (0.9,), ("_ns_",))
    tm = AggregateMapReduce("quantile", (0.9,), ("_ns_",))
    jp = [jm.apply(b, JCtx(), JStats()) for b in _blocks("jax", n, 7, 5)]
    tp = [tm.apply(b, QueryContext(), QueryStats())
          for b in _blocks("torch", n, 7, 5)]
    for a, b in zip(tp, jp):
        assert a.cand_vals is None and a.sketch.shape == (2, 7, 64, 2)
        _same(a.sketch, b.sketch)
    tr_ = texec.reduce_partials(tp, compress=compress)
    jr = jexec.reduce_partials(jp, compress=compress)
    _same(tr_.sketch, jr.sketch)
    assert tr_.sketch.shape[2] == (64 if compress else 3 * 64)
    with np.errstate(invalid="ignore"):
        _same(texec.present_partial(tr_).values,
              jexec.present_partial(jr).values)


def _engines(num_series):
    from filodb_tpu.core.memstore import TimeSeriesMemStore as JStore
    from filodb_tpu.ingest.generator import gauge_batch as jgauge
    from filodb_tpu.query.engine import QueryEngine as JEngine

    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.ingest.generator import gauge_batch
    from filodb_tpu_torch.query.engine import QueryEngine
    start = 1_600_000_020_000
    js = JStore()
    js.setup("prometheus", 0).ingest(jgauge(num_series, 180, start_ms=start))
    ts = TimeSeriesMemStore(device="cpu")
    ts.setup("prometheus", 0).ingest(gauge_batch(num_series, 180,
                                                 start_ms=start))
    return (JEngine("prometheus", js),
            QueryEngine("prometheus", ts, device="cpu"), start // 1000)


@pytest.mark.parametrize("num_series, q", [
    (48, "quantile(0.9, heap_usage)"),
    (400, "quantile by (_ns_) (0.5, heap_usage)"),
    (400, "quantile(0.99, rate(heap_usage[5m]))"),
])
def test_quantile_through_both_engines(num_series, q):
    jeng, teng, s = _engines(num_series)
    want = jeng.query_range(q, s + 600, 60, s + 1700)
    got = teng.query_range(q, s + 600, 60, s + 1700)
    assert want.error is None and got.error is None
    w = {k.labels: np.asarray(v, np.float64) for k, _, v in want.series()}
    g = {k.labels: np.asarray(v, np.float64) for k, _, v in got.series()}
    assert set(w) == set(g) and w
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=2e-4, atol=1e-3,
                                   equal_nan=True)
