"""The port's mesh executor (filodb_tpu_torch/parallel/mesh.py) against
the JAX package's (filodb_tpu/parallel/mesh.py), on the CPU.

Both packages build the same 4-shard memstore (the same seeded counters,
routed by the reference shard math with spread 2, as tests/test_mesh.py
routes them); the JAX MeshExecutor runs on a 4 x 2 mesh of the harness's
8 virtual CPU devices, the port's on a 4 x 2 mesh of slots that all name
the one CPU device.  Every panel must agree within rtol 2e-4 / atol 1e-3
(the rate family's tolerance against the general path,
__graft_entry__.py:221) with the same NaN pattern and the same group
labels in the same order.  The JAX fused path runs as its own tests run
it: its Pallas kernel in interpret mode (FILODB_TPU_FUSED_INTERPRET=1),
or its host route (ops/hostleaf, the default off the TPU); the port's
per-slot dispatch runs the kernels' plain versions (the wrappers' CPU
branch), and under FILODB_TPU_FORCE_HOST_ROUTE its own host route.
"""
import numpy as np
import pytest

import jax

from filodb_tpu.core.index import Equals as JEquals
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.core.records import RecordBatch as JRecordBatch
from filodb_tpu.ingest import generator as jgen
from filodb_tpu.parallel import mesh as jmesh
from filodb_tpu.parallel.shardmapper import ShardMapper as JShardMapper

from filodb_tpu_torch.core.index import Equals
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.core.records import RecordBatch
from filodb_tpu_torch.ingest import generator as pgen
from filodb_tpu_torch.ops import agg as agg_ops
from filodb_tpu_torch.ops.timewindow import PAD_TS, make_window_ends, \
    to_offsets
from filodb_tpu_torch.parallel import mesh as pmesh
from filodb_tpu_torch.parallel.shardmapper import ShardMapper
from filodb_tpu_torch.utils.counters import counters

START_MS = 1_600_000_000_000
START_S = START_MS // 1000
NUM_SAMPLES = 720
QEND_S = START_S + 3600
STEP_S = 60
RANGE_MS = 300_000
TOL = dict(rtol=2e-4, atol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _clear_compile_journal():
    """The JAX mesh's interpret-mode runs journal jit compiles, which the
    reference's health model reads as a compile storm for the next 120 s
    in whatever file this process runs next: clear it after this file."""
    yield
    from filodb_tpu.utils.events import journal
    journal.clear()


def _routed(batch, mapper, record_cls, num_shards=4):
    shard_of = np.asarray([
        mapper.ingestion_shard(pk.shard_key_hash(), pk.partition_hash(), 2)
        for pk in batch.part_keys])
    for s in range(num_shards):
        keep = shard_of[batch.part_idx] == s
        if keep.any():
            yield s, record_cls(batch.schema, batch.part_keys,
                                batch.part_idx[keep], batch.timestamps[keep],
                                {k: v[keep] for k, v in
                                 batch.columns.items()},
                                batch.bucket_les)


def _holes(batch, record_cls, seed):
    v = batch.columns["count"].copy()
    v[np.random.default_rng(seed).random(v.shape) < 0.1] = np.nan
    return record_cls(batch.schema, batch.part_keys, batch.part_idx,
                      batch.timestamps, {"count": v}, batch.bucket_les)


def stores(n_series=64, ragged=False, seed=7):
    """(the JAX memstore, the port's) over the same routed counters."""
    jms, pms = JMemStore(), TimeSeriesMemStore(device="cpu")
    for s in range(4):
        jms.setup("prometheus", s)
        pms.setup("prometheus", s)
    jb = jgen.counter_batch(n_series, NUM_SAMPLES, start_ms=START_MS,
                            seed=seed)
    pb = pgen.counter_batch(n_series, NUM_SAMPLES, start_ms=START_MS,
                            seed=seed)
    if ragged:
        jb, pb = _holes(jb, JRecordBatch, seed), _holes(pb, RecordBatch, seed)
    for s, sub in _routed(jb, JShardMapper(4), JRecordBatch):
        jms.get_shard("prometheus", s).ingest(sub)
    for s, sub in _routed(pb, ShardMapper(4), RecordBatch):
        pms.get_shard("prometheus", s).ingest(sub)
    return jms, pms


@pytest.fixture(scope="module")
def both():
    return stores()


@pytest.fixture(scope="module")
def meshes():
    return (jmesh.make_mesh(4, 2, devices=jax.devices("cpu")[:8]),
            pmesh.make_mesh(4, 2, devices=["cpu"] * 8))


WINDOW = ((START_S + 600) * 1000 - RANGE_MS, QEND_S * 1000)


def wends():
    return make_window_ends((START_S + 600) * 1000, QEND_S * 1000,
                            STEP_S * 1000)


def run_both(both, meshes, fn, op, by=("_ns_",), filters=(), jroute=None,
             monkeypatch=None, window=WINDOW):
    """The same panel through both executors -> ((jax values, labels),
    (port values, labels)).  jroute "interpret" runs the JAX fused path
    in its Pallas interpret mode."""
    jms, pms = both
    jm, pm = meshes
    jf = [JEquals("_metric_", "request_total")] + \
        [JEquals(k, v) for k, v in filters]
    pf = [Equals("_metric_", "request_total")] + \
        [Equals(k, v) for k, v in filters]
    if jroute == "interpret":
        monkeypatch.setenv("FILODB_TPU_FUSED_INTERPRET", "1")
    jex = jmesh.MeshExecutor(jms, "prometheus", jm)
    jp = jex.lookup_and_pack(jf, *window, by=by, fn_name=fn)
    jo, jl = jex.run_agg(jp, wends(), range_ms=RANGE_MS, fn_name=fn,
                         agg_op=op)
    if monkeypatch is not None:
        monkeypatch.delenv("FILODB_TPU_FUSED_INTERPRET", raising=False)
    pex = pmesh.MeshExecutor(pms, "prometheus", pm)
    pp = pex.lookup_and_pack(pf, *window, by=by, fn_name=fn)
    po, pl = pex.run_agg(pp, wends(), range_ms=RANGE_MS, fn_name=fn,
                         agg_op=op)
    return (np.asarray(jo), jl), (po, pl)


def assert_agree(j, p, **tol):
    (jo, jl), (po, pl) = j, p
    assert pl == jl
    assert po.shape == jo.shape
    assert (np.isnan(po) == np.isnan(jo)).all()
    np.testing.assert_allclose(po, jo, equal_nan=True, **(tol or TOL))


def test_make_mesh_shape_gauges_and_too_few_devices():
    from filodb_tpu_torch.utils.metrics import registry
    m = pmesh.make_mesh(2, 1, devices=["cpu"] * 8)
    assert m.shape == {"shard": 2, "time": 1}
    assert registry.gauge("mesh_unused_devices").value == 6
    m = pmesh.make_mesh(4, 2, devices=["cpu"] * 8)
    assert m.devices.shape == (4, 2) and m.addressable
    assert registry.gauge("mesh_shard_axis").value == 4
    assert registry.gauge("mesh_time_axis").value == 2
    assert registry.gauge("mesh_unused_devices").value == 0
    with pytest.raises(ValueError, match="need 8 devices"):
        pmesh.make_mesh(4, 2, devices=["cpu"] * 7)


def test_pack_shards_equals_the_reference():
    """pack_shards is host numpy: the port's copy packs the same blocks
    into the same arrays, slots, sizes and eligibility flags."""
    rng = np.random.default_rng(3)
    blocks = []
    for d in range(3):
        n = 5 + d
        ts = np.cumsum(np.full((n, 40), 10_000, np.int64), axis=1)
        vals = rng.random((n, 40))
        if d == 1:
            vals[0, 3] = np.nan
        labels = [{"_ns_": f"App-{(i + d) % 3}", "inst": f"{d}-{i}"}
                  for i in range(n)]
        blocks.append((to_offsets(ts, np.full(n, 40), 0), vals, labels,
                       rng.random(n)))
    blocks.append((np.full((1, 1), PAD_TS, np.int32), np.full((1, 1), np.nan),
                   []))
    a = pmesh.pack_shards(blocks, by=("_ns_",))
    b = jmesh.pack_shards(blocks, by=("_ns_",))
    for name in ("ts_off", "values", "group_ids", "n_series", "vbase",
                 "gsize", "shared_ts_row"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    assert a.group_labels == b.group_labels
    assert (a.num_groups, a.dense) == (b.num_groups, b.dense) == (3, False)


FUSED_PANELS = [("rate", "sum"), ("rate", "avg"), ("rate", "count"),
                ("increase", "sum"), ("delta", "avg"),
                ("sum_over_time", "sum"), ("avg_over_time", "avg"),
                ("count_over_time", "count"), ("last_over_time", "sum")]


@pytest.mark.parametrize("jroute", ["host", "interpret"])
@pytest.mark.parametrize("fn,op", FUSED_PANELS)
def test_fused_panels_match_jax(both, meshes, monkeypatch, fn, op, jroute):
    """The per-slot fused dispatch (K1 rate family, K4, K5) against the
    JAX mesh's fused route, in both of its CPU routes."""
    k0 = counters.get("mesh_fused_kernel")
    c0 = counters.get("mesh_fused_count_host")
    j, p = run_both(both, meshes, fn, op, jroute=jroute,
                    monkeypatch=monkeypatch)
    assert_agree(j, p)
    if op == "count":
        assert counters.get("mesh_fused_count_host") == c0 + 1
    else:
        assert counters.get("mesh_fused_kernel") == k0 + 1


GENERAL_PANELS = [("rate", "min"), ("rate", "max"), ("rate", "stddev"),
                  ("irate", "sum"), ("min_over_time", "min"),
                  ("max_over_time", "max"), ("sum_over_time", "stdvar"),
                  ("last_over_time", "group")]


@pytest.mark.parametrize("fn,op", GENERAL_PANELS)
def test_general_panels_match_jax(both, meshes, fn, op):
    """The general mesh path (range function and map phase on every slot,
    the merge with each component's combiner) against the JAX mesh's
    shard_map with psum/pmin/pmax."""
    k0 = counters.get("mesh_fused_kernel")
    j, p = run_both(both, meshes, fn, op)
    assert_agree(j, p, **(TOL if op not in ("stddev", "stdvar")
                          else dict(rtol=5e-4, atol=5e-3)))
    assert counters.get("mesh_fused_kernel") == k0


@pytest.mark.parametrize("by", [(), ("instance",), ("_ns_", "dc")])
def test_group_by_matches_jax(both, meshes, by):
    j, p = run_both(both, meshes, "rate", "sum", by=by,
                    filters=(("_ns_", "App-0"),))
    assert_agree(j, p)


@pytest.mark.parametrize("agg_op", ["sum", "avg", "count"])
def test_ragged_pack_runs_k3_and_matches_jax(meshes, monkeypatch, agg_op):
    """A uniform-grid pack with NaN holes keeps its shared grid and runs
    the ragged kernel (K3, presence merged as a second partial)."""
    both = stores(n_series=32, ragged=True, seed=11)
    k0 = counters.get("mesh_fused_kernel")
    j, p = run_both(both, meshes, "rate", agg_op, jroute="interpret",
                    monkeypatch=monkeypatch, window=(START_MS, QEND_S * 1000))
    assert_agree(j, p, rtol=5e-4, atol=1e-4)
    assert counters.get("mesh_fused_kernel") == k0 + 1


def test_ragged_last_over_time_takes_the_general_path(meshes):
    both = stores(n_series=32, ragged=True, seed=12)
    k0 = counters.get("mesh_fused_kernel")
    j, p = run_both(both, meshes, "last_over_time", "sum",
                    window=(START_MS, QEND_S * 1000))
    assert_agree(j, p)
    assert counters.get("mesh_fused_kernel") == k0


def test_nonuniform_pack_takes_the_general_path(meshes):
    """Shards on different grids: no shared row, the general path."""
    jms, pms = JMemStore(), TimeSeriesMemStore(device="cpu")
    for ms, gen in ((jms, jgen), (pms, pgen)):
        for s in range(4):
            ms.setup("prometheus", s)
        ms.get_shard("prometheus", 0).ingest(
            gen.counter_batch(8, NUM_SAMPLES, start_ms=START_MS))
        ms.get_shard("prometheus", 1).ingest(
            gen.counter_batch(8, NUM_SAMPLES // 2, start_ms=START_MS + 5_000,
                              seed=3))
    pex = pmesh.MeshExecutor(pms, "prometheus", meshes[1])
    pp = pex.lookup_and_pack([Equals("_metric_", "request_total")],
                             START_MS, QEND_S * 1000, by=("_ns_",),
                             fn_name="rate")
    assert pp.shared_ts_row is None
    k0 = counters.get("mesh_fused_kernel")
    j, p = run_both((jms, pms), meshes, "rate", "sum",
                    window=(START_MS, QEND_S * 1000))
    assert_agree(j, p)
    assert counters.get("mesh_fused_kernel") == k0


def test_empty_shard_contributes_nothing():
    """Shard rows with no series must not poison the merge."""
    m = pmesh.make_mesh(4, 2, devices=["cpu"] * 8)
    ts = np.cumsum(np.full((4, 50), 10_000, np.int64), axis=1)
    blocks = [(to_offsets(ts, np.full(4, 50), 0), np.ones((4, 50)),
               [{"instance": f"i{i}"} for i in range(4)])]
    blocks += [(np.full((1, 1), PAD_TS, np.int32), np.full((1, 1), np.nan),
                [])] * 3
    packed = pmesh.device_put_packed(pmesh.pack_shards(blocks), m)
    w = np.asarray([200_000, 300_000, 400_000, 500_000], np.int32)
    out = pmesh.distributed_window_agg(
        m, packed.ts_off, packed.values, packed.group_ids, w,
        range_ms=100_000, fn_name="sum_over_time", agg_op="sum",
        num_groups=packed.num_groups)
    np.testing.assert_allclose(agg_ops.present("sum", out).numpy()[0], 40.0)
    # the same from host arrays, each slot uploading its row
    host = pmesh.pack_shards(blocks)
    out2 = pmesh.distributed_window_agg(
        m, host.ts_off, host.values, host.group_ids, w, range_ms=100_000,
        fn_name="sum_over_time", agg_op="sum", num_groups=host.num_groups)
    assert out2.numpy().tobytes() == out.numpy().tobytes()


def test_raw_path_keeps_the_sharded_layout(meshes):
    rng = np.random.default_rng(0)
    blocks = []
    for d in range(4):
        ts = np.cumsum(np.full((8, 100), 10_000, np.int64), axis=1)
        blocks.append((to_offsets(ts, np.full(8, 100), 0), rng.random((8, 100)),
                       [{"instance": f"i{d}-{i}"} for i in range(8)]))
    w = np.arange(100_000, 1_050_001, 50_000, dtype=np.int32)
    jp = jmesh.device_put_packed(jmesh.pack_shards(blocks), meshes[0])
    want = np.asarray(jmesh.distributed_window_raw(
        meshes[0], jp.ts_off, jp.values, jax.device_put(w), range_ms=60_000,
        fn_name="sum_over_time"))
    pp = pmesh.device_put_packed(pmesh.pack_shards(blocks), meshes[1])
    got = pmesh.distributed_window_raw(meshes[1], pp.ts_off, pp.values, w,
                                       range_ms=60_000,
                                       fn_name="sum_over_time").numpy()
    assert got.shape == want.shape == (4, 8, w.shape[0])
    np.testing.assert_allclose(got, want, equal_nan=True, **TOL)


def test_run_agg_batch_is_one_launch_and_equals_single_panels(both, meshes):
    """A dashboard's panels over ONE pack and ONE launch per slot
    (disjoint group-id ranges) equal the panels run one at a time; the
    max panel runs alone on the general path; a warm repeat gives the
    same bits; and the answers equal the JAX mesh's batch."""
    _, pms = both
    ex = pmesh.MeshExecutor(pms, "prometheus", meshes[1])
    filters = [Equals("_metric_", "request_total"), Equals("_ws_", "demo")]
    panels = [(("_ns_",), (), "sum"), (("dc",), (), "avg"),
              (("_ns_", "dc"), (), "sum"), (("dc",), (), "count"),
              (("_ns_",), (), "max")]
    want = []
    for by, wo, op in panels:
        pk = ex.lookup_and_pack(filters, *WINDOW, by=by, without=wo,
                                fn_name="rate")
        want.append(ex.run_agg(pk, wends(), range_ms=RANGE_MS,
                               fn_name="rate", agg_op=op))
    k0 = counters.get("mesh_fused_kernel")
    b0 = counters.get("mesh_fused_batch_panels")
    d0 = counters.get("mesh_fused_perdevice_dispatches")
    got = ex.run_agg_batch(filters, *WINDOW, wends(), range_ms=RANGE_MS,
                           fn_name="rate", panels=panels)
    assert counters.get("mesh_fused_kernel") - k0 == 1
    assert counters.get("mesh_fused_batch_panels") - b0 == 3
    assert counters.get("mesh_fused_perdevice_dispatches") - d0 == 8
    for (w_out, w_lab), (g_out, g_lab) in zip(want, got):
        assert g_lab == w_lab
        np.testing.assert_allclose(g_out, w_out, rtol=1e-6, atol=1e-9,
                                   equal_nan=True)
    again = ex.run_agg_batch(filters, *WINDOW, wends(), range_ms=RANGE_MS,
                             fn_name="rate", panels=panels)
    for (g_out, _), (a_out, _) in zip(got, again):
        assert g_out.tobytes() == a_out.tobytes()
    jms, _ = both
    jex = jmesh.MeshExecutor(jms, "prometheus", meshes[0])
    jgot = jex.run_agg_batch(
        [JEquals("_metric_", "request_total"), JEquals("_ws_", "demo")],
        *WINDOW, wends(), range_ms=RANGE_MS, fn_name="rate", panels=panels)
    for j, p in zip(jgot, got):
        assert_agree((np.asarray(j[0]), j[1]), p)


@pytest.mark.parametrize("same_set", [True, False])
def test_binop_agg_matches_jax(both, meshes, same_set):
    """sum(rate) / sum(count) matched on _ns_: one batch when both sides
    select the same working set, two packs otherwise."""
    jms, pms = both
    rf = [("_ws_", "demo")] if not same_set else []
    kw = dict(range_ms=RANGE_MS, fn_name="rate", op="/", agg_op_l="sum",
              agg_op_r="count", by=("_ns_",))
    jo, jl = jmesh.MeshExecutor(jms, "prometheus", meshes[0]).run_binop_agg(
        [JEquals("_metric_", "request_total")],
        [JEquals("_metric_", "request_total")] + [JEquals(*f) for f in rf],
        *WINDOW, wends(), **kw)
    po, pl = pmesh.MeshExecutor(pms, "prometheus", meshes[1]).run_binop_agg(
        [Equals("_metric_", "request_total")],
        [Equals("_metric_", "request_total")] + [Equals(*f) for f in rf],
        *WINDOW, wends(), **kw)
    assert_agree((np.asarray(jo), jl), (po, pl))
    assert len(pl) == 10


@pytest.mark.parametrize("fn,op", [("rate", "sum"), ("rate", "avg"),
                                   ("sum_over_time", "sum")])
def test_host_route_matches_kernel_route_and_jax(both, meshes, monkeypatch,
                                                 fn, op):
    """Under FILODB_TPU_FORCE_HOST_ROUTE a dense pack with host views runs
    ops/hostleaf per shard (mesh_fused_host), as the JAX mesh's default
    CPU route does."""
    j, p = run_both(both, meshes, fn, op)
    h0 = counters.get("mesh_fused_host")
    monkeypatch.setenv("FILODB_TPU_FORCE_HOST_ROUTE", "1")
    _, pms = both
    ex = pmesh.MeshExecutor(pms, "prometheus", meshes[1])
    pk = ex.lookup_and_pack([Equals("_metric_", "request_total")], *WINDOW,
                            by=("_ns_",), fn_name=fn)
    assert pk.host_values is not None
    ho, hl = ex.run_agg(pk, wends(), range_ms=RANGE_MS, fn_name=fn,
                        agg_op=op)
    assert counters.get("mesh_fused_host") == h0 + 1
    assert_agree(j, (ho, hl))
    assert_agree((p[0], p[1]), (ho, hl), rtol=1e-6, atol=1e-6)


def test_pack_cache_hits_and_invalidates_on_ingest():
    _, pms = stores(n_series=16, seed=5)
    ex = pmesh.MeshExecutor(pms, "prometheus",
                            pmesh.make_mesh(4, 1, devices=["cpu"] * 4))
    f = [Equals("_metric_", "request_total")]
    a = ex.lookup_and_pack(f, *WINDOW, by=("_ns_",), fn_name="rate")
    h0 = counters.get("mesh_pack_cache_hits")
    assert ex.lookup_and_pack(f, *WINDOW, by=("_ns_",), fn_name="rate") is a
    assert counters.get("mesh_pack_cache_hits") == h0 + 1
    extra = pgen.counter_batch(16, 2, start_ms=START_MS + NUM_SAMPLES * 10_000,
                               seed=5)
    for s, sub in _routed(extra, ShardMapper(4), RecordBatch):
        pms.get_shard("prometheus", s).ingest(sub)
    assert ex.lookup_and_pack(f, *WINDOW, by=("_ns_",),
                              fn_name="rate") is not a


def test_mesh_fused_call_equals_the_per_slot_dispatch(both, meshes,
                                                      monkeypatch):
    """_mesh_fused_call (the reference's A/B entry; here the per-slot
    dispatch and merge that run_agg's fused route runs through) gives the
    bits of run_agg's fused route, one dispatch per slot."""
    from filodb_tpu_torch.ops import fused
    _, pms = both
    ex = pmesh.MeshExecutor(pms, "prometheus", meshes[1])
    f = [Equals("_metric_", "request_total")]
    pk = ex.lookup_and_pack(f, *WINDOW, by=("_ns_",), fn_name="rate")
    wp, W = ex._prep_wends(pk, wends())
    plans, wvalid, _ = ex._fused_plans(pk, wp, RANGE_MS)
    csrs = ex._slot_csrs(pk, [(None, pk.num_groups, "sum", pk.gsize)], [0],
                         None)
    calls = []
    orig = pmesh._device_fused_call

    def counted(*a, **k):
        calls.append(a[1])
        return orig(*a, **k)
    monkeypatch.setattr(pmesh, "_device_fused_call", counted)
    sums = pmesh._mesh_fused_call(meshes[1], pk, csrs, plans,
                                  G=pk.num_groups, is_counter=True,
                                  is_rate=True)
    assert sorted(calls) == sorted(s for s, _ in meshes[1].local_slots())
    got = fused.present_sum(sums[:, :W],
                            pmesh._host_counts(pk.gsize, wvalid)[:, :W])
    want, _ = ex.run_agg(pk, wends(), range_ms=RANGE_MS, fn_name="rate",
                         agg_op="sum")
    assert got.tobytes() == want.tobytes()


def test_fused_failure_raises_and_never_falls_back(both, meshes,
                                                   monkeypatch):
    """No except routes a failure of the fused path to the general path:
    it reaches the caller."""
    _, pms = both
    ex = pmesh.MeshExecutor(pms, "prometheus", meshes[1])
    pk = ex.lookup_and_pack([Equals("_metric_", "request_total")], *WINDOW,
                            by=("_ns_",), fn_name="rate")

    def broken(*a, **k):
        raise RuntimeError("kernel launch failed")
    monkeypatch.setattr(pmesh, "_device_fused_call", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        ex.run_agg(pk, wends(), range_ms=RANGE_MS, fn_name="rate",
                   agg_op="sum")
