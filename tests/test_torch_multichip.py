"""The port's multi-device pieces against the JAX package's
(tests/test_multichip.py), on the CPU: the MirrorPlacer and the sharded
mirror mode, the per-slot fused dispatch and its fan-out, the partial
merges, the pack layout memo and the mesh gauges.

- The placer's bookkeeping runs over torch.device("cuda", i) objects,
  which need no card; its bookings feed the device telemetry's HBM model
  per device and region, as the reference's do.
- The engine with sharded placement forced (FILODB_TPU_FORCE_SHARDED_
  MIRROR=1: a memstore on the host places its mirrors through the placer
  over its one device) answers the reference's five multichip queries
  with the bits of the unforced engine, and within rtol 2e-4 / atol 1e-3
  of the JAX engine with its sharded mirrors over 8 virtual devices.
- The in-process merge on the first slot's device and the host merge are
  the same reduce, bit for bit, for sum, min and max.
"""
import numpy as np
import pytest
import torch

import jax

from filodb_tpu.core.index import Equals as JEquals
from filodb_tpu.ingest import generator as jgen
from filodb_tpu.parallel import mesh as jmesh

from filodb_tpu_torch.core import devicecache as dc
from filodb_tpu_torch.core.index import Equals
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.core.records import RecordBatch
from filodb_tpu_torch.ingest import generator as pgen
from filodb_tpu_torch.ops.timewindow import make_window_ends
from filodb_tpu_torch.parallel import mesh as pmesh
from filodb_tpu_torch.parallel.shardmapper import (ShardEvent, ShardMapper,
                                                   SpreadProvider)
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.utils.counters import counters
from filodb_tpu_torch.utils.devicetelem import telem
from filodb_tpu_torch.utils.metrics import registry

from test_query_engine import _mk_engine
from test_torch_mesh import NUM_SAMPLES, QEND_S, START_MS, START_S, \
    STEP_S, TOL, _routed, stores

CARDS = [torch.device("cuda", i) for i in range(4)]


@pytest.fixture(autouse=True, scope="module")
def _clear_compile_journal():
    """The JAX engine's interpret-mode queries journal jit compiles, which
    the reference's health model reads as a compile storm for the next
    120 s in whatever file this process runs next: clear it after this
    file."""
    yield
    from filodb_tpu.utils.events import journal
    journal.clear()


@pytest.fixture
def cards():
    """A placer over four card devices (bookkeeping only)."""
    p = dc.MirrorPlacer(devices=list(CARDS))
    yield p


def test_placer_prefers_home_and_respects_the_limit(cards):
    limit = 1000
    d0 = cards.assign(0, 600, limit)
    assert d0 == CARDS[0] and cards.booked(d0) == 600
    # shard 4's home is card 0, which no longer fits: the least-booked
    # card that fits takes it
    d_spill = cards.assign(4, 600, limit)
    assert d_spill != d0 and cards.booked(d_spill) == 600
    # nothing fits: still placed, and the overflow counted
    o0 = registry.counter("device_mirror_placement_overflow").value
    for d in CARDS:
        cards.book(d, limit)
    assert cards.assign(1, 600, limit) in CARDS
    assert registry.counter("device_mirror_placement_overflow").value \
        == o0 + 1
    assert registry.gauge("device_mirror_devices_used").value == 4


def test_placer_matches_the_reference_choices(cards):
    """The same sequence of assignments and bookings places every shard
    on the card index the reference's placer picks over four devices."""
    from filodb_tpu.core.devicecache import MirrorPlacer as JPlacer
    jdevs = jax.devices("cpu")[:4]
    jp = JPlacer()
    orig = jax.local_devices
    jax.local_devices = lambda: jdevs
    try:
        seq = [(0, 500), (1, 700), (2, 300), (3, 900), (4, 400), (5, 800),
               (6, 100), (7, 600), (8, 950)]
        for shard, est in seq:
            want = jdevs.index(jp.assign(shard, est, 1200))
            got = CARDS.index(cards.assign(shard, est, 1200))
            assert got == want, (shard, est)
        for i in range(4):
            assert cards.booked(CARDS[i]) == jp.booked(jdevs[i])
    finally:
        jax.local_devices = orig


def test_placer_books_the_hbm_model_per_device_and_region(cards):
    before = {d: telem.hbm_booked(d, "hot") for d in CARDS}
    d = cards.assign(2, 4096, 1 << 20)
    assert telem.hbm_booked(d, "hot") == before[d] + 4096
    cards.book(d, -1000)
    assert telem.hbm_booked(d, "hot") == before[d] + 3096
    c0 = telem.hbm_booked(CARDS[1], "cold")
    cards.assign(1, 512, 1 << 20, region="cold")
    assert telem.hbm_booked(CARDS[1], "cold") == c0 + 512
    cards.book(CARDS[1], -512, region="cold")
    cards.book(d, -3096)
    assert telem.hbm_booked(d, "hot") == before[d]


def test_sharded_mirrors_enabled_rule(monkeypatch):
    from filodb_tpu_torch.config import StoreConfig
    cfg = StoreConfig()
    monkeypatch.delenv("FILODB_TPU_FORCE_SHARDED_MIRROR", raising=False)
    assert not dc.sharded_mirrors_enabled(cfg, "cpu")
    monkeypatch.setenv("FILODB_TPU_FORCE_SHARDED_MIRROR", "1")
    assert dc.sharded_mirrors_enabled(cfg, "cpu")
    cfg.device_mirror_sharded = False
    assert not dc.sharded_mirrors_enabled(cfg, "cpu")
    cfg.device_mirror_sharded = True
    monkeypatch.setattr(dc.placer, "devices", list(CARDS))
    assert dc.sharded_mirrors_enabled(cfg, CARDS[0])
    monkeypatch.setattr(dc.placer, "devices", CARDS[:1])
    assert not dc.sharded_mirrors_enabled(cfg, CARDS[0])


def _store_with_series(n=16):
    ms = TimeSeriesMemStore(device="cpu")
    sh = ms.setup("prometheus", 0)
    sh.ingest(pgen.counter_batch(n, 64, start_ms=START_MS))
    (store,) = sh.stores.values()
    return sh, store


def test_placed_mirror_adjusts_its_reservation_and_releases_it():
    """A placed mirror starts with the placer's reservation, _book moves
    it to the upload's bytes, and release gives it back to the placer
    (and through it to the HBM model)."""
    sh, store = _store_with_series()
    cpu = torch.device("cpu")
    est = dc.store_nbytes(store)
    b0 = dc.placer.booked(cpu)
    dev = dc.placer.assign(0, est, 1 << 30, like=cpu)
    assert dev == cpu and dc.placer.booked(cpu) == b0 + est
    m = dc.DeviceMirror(1 << 30, device=dev, shard_num=0,
                        reserved_bytes=est, placed=True)
    with sh._write_locked("test"):
        assert m.ensure_fresh(store)
    assert dc.placer.booked(cpu) == b0 + m.booked_bytes
    assert m.booked_bytes == dc.snapshot_nbytes(m.snapshot())
    m.release()
    assert dc.placer.booked(cpu) == b0


def test_placed_mirror_over_the_device_limit_raises(monkeypatch):
    """The occupancy check of a placed card: co-located mirrors over the
    card's memory (MirrorPlacer.capacity) refuse the upload
    (MirrorCapExceeded), counted and journaled, and leave nothing
    booked."""
    sh, store = _store_with_series()
    cpu = torch.device("cpu")
    nb = dc.store_nbytes(store)
    b0 = dc.placer.booked(cpu)
    monkeypatch.setattr(dc.MirrorPlacer, "capacity",
                        lambda self, d: b0 + 10 * nb)
    dc.placer.book(cpu, 10 * nb)           # another shard's mirror
    try:
        m = dc.DeviceMirror(1 << 30, device=cpu, shard_num=0,
                            reserved_bytes=0, placed=True)
        c0 = counters.get("device_mirror_device_over_cap")
        with sh._write_locked("test"), \
                pytest.raises(dc.MirrorCapExceeded, match="over its memory"):
            m.ensure_fresh(store)
        assert counters.get("device_mirror_device_over_cap") == c0 + 1
        assert m.booked_bytes == 0 and m.snapshot() is None
    finally:
        dc.placer.book(cpu, -10 * nb)
    assert dc.placer.booked(cpu) == b0


def test_placed_mirrors_over_the_per_card_limit_still_answer(monkeypatch):
    """Four shards' mirrors placed over two devices whose limit holds one
    mirror each but not two: the placer overflows and the mirrors still
    answer, with the bits of unplaced mirrors, as long as the card's
    memory holds them.  The limit caps each mirror and chooses placement;
    it is not a card's total."""
    cpu = torch.device("cpu")
    p = dc.MirrorPlacer(devices=[cpu, cpu])
    monkeypatch.setattr(dc, "placer", p)
    shards = [_store_with_series() for _ in range(4)]
    nb = dc.store_nbytes(shards[0][1])
    limit = nb + nb // 2
    monkeypatch.setattr(dc.MirrorPlacer, "capacity",
                        lambda self, d: 4 * nb)
    o0 = registry.counter("device_mirror_placement_overflow").value
    rows = np.arange(16)
    mirrors = []
    for i, (sh, store) in enumerate(shards):
        dev = p.assign(i, nb, limit)
        placed = dc.DeviceMirror(limit, device=dev, shard_num=i,
                                 reserved_bytes=nb, placed=True)
        flat = dc.DeviceMirror(limit, device=cpu, shard_num=i)
        with sh._write_locked("test"):
            assert placed.ensure_fresh(store) and flat.ensure_fresh(store)
        got = placed.gather_cached(rows, placed.snapshot())
        want = flat.gather_cached(rows, flat.snapshot())
        assert got[0].numpy().tobytes() == want[0].numpy().tobytes()
        for name, col in want[1].items():
            assert got[1][name].numpy().tobytes() \
                == col.numpy().tobytes(), name
        mirrors.append(placed)
    booked = p.booked(cpu)
    assert booked == sum(m.booked_bytes for m in mirrors) > 2 * limit
    assert registry.counter(
        "device_mirror_placement_overflow").value == o0 + 3
    for m in mirrors:
        m.release()
    assert p.booked(cpu) == 0


def test_placed_mirror_growth_checks_the_card(monkeypatch):
    """The incremental path books the grown size and checks the card's
    memory before it uploads, as the reference does: within it the
    append goes up incrementally; past it the full path refuses."""
    sh, store = _store_with_series()
    cpu = torch.device("cpu")
    b0 = dc.placer.booked(cpu)
    nb = dc.store_nbytes(store)
    cap = [b0 + 4 * nb]
    monkeypatch.setattr(dc.MirrorPlacer, "capacity",
                        lambda self, d: cap[0])
    dev = dc.placer.assign(0, nb, 1 << 30, like=cpu)
    m = dc.DeviceMirror(1 << 30, device=dev, shard_num=0,
                        reserved_bytes=nb, placed=True)

    def grow(k):
        sh.ingest(pgen.counter_batch(16, 8, start_ms=START_MS
                                     + (64 + 8 * k) * 10_000))
    try:
        with sh._write_locked("test"):
            assert m.ensure_fresh(store)
        grow(0)
        with sh._write_locked("test"):
            assert m.ensure_fresh(store)
        assert m.last_refresh_kind == "incremental"
        assert dc.placer.booked(cpu) == b0 + m.booked_bytes
        grow(1)
        cap[0] = b0 + m.booked_bytes        # the growth no longer fits
        c0 = counters.get("device_mirror_device_over_cap")
        with sh._write_locked("test"), \
                pytest.raises(dc.MirrorCapExceeded, match="over its memory"):
            m.ensure_fresh(store)
        assert counters.get("device_mirror_device_over_cap") == c0 + 1
        assert m.booked_bytes == 0
    finally:
        m.release()
    assert dc.placer.booked(cpu) == b0


def test_cold_cache_places_blocks_through_the_placer(monkeypatch):
    """ColdSegmentCache with the placer on: each block goes to the card
    the placer assigns its shard, booked there under `cold`; eviction and
    clear() give it back; the budget wait of the port stays."""
    p = dc.MirrorPlacer(devices=list(CARDS))
    monkeypatch.setattr(dc, "placer", p)

    class Block:
        def __init__(self, device, nbytes):
            self.device, self.nbytes = device, nbytes

    cache = dc.ColdSegmentCache(1000, device="cpu", use_placer=True)
    blk, verdict = cache.get(("a",), 400, 1, lambda d: Block(d, 300))
    assert verdict == "cold_paged" and blk.device == CARDS[1]
    assert p.booked(CARDS[1]) == 300 and cache.bytes_booked == 300
    blk2, _ = cache.get(("b",), 400, 2, lambda d: Block(d, 400))
    assert blk2.device == CARDS[2] and p.booked(CARDS[2]) == 400
    assert cache.get(("a",), 400, 1, None) == (blk, "cold_hit")
    # a third block evicts the least recently used ("b")
    cache.get(("c",), 500, 3, lambda d: Block(d, 500))
    assert p.booked(CARDS[2]) == 0 and p.booked(CARDS[3]) == 500
    cache.clear()
    assert all(p.booked(d) == 0 for d in CARDS)
    assert cache.bytes_booked == 0


QUERIES = [
    'sum by (_ns_) (rate(request_total{_ws_="demo"}[5m]))',
    'avg by (_ns_) (rate(request_total{_ws_="demo"}[5m]))',
    'max by (_ns_) (rate(request_total{_ws_="demo"}[5m]))',
    'sum by (instance) (increase(request_total{_ws_="demo",_ns_="App-0"}[10m]))',
    'histogram_quantile(0.9, sum by (_ns_) (rate(http_latency{_ws_="demo"}[5m])))',
]


def _ragged(gen, record_cls, n, seed):
    rng = np.random.default_rng(seed)
    cb = gen.counter_batch(n, NUM_SAMPLES, start_ms=START_MS, seed=seed)
    v = cb.columns["count"].copy()
    v[rng.random(v.shape) < 0.1] = np.nan
    return record_cls(cb.schema, cb.part_keys, cb.part_idx, cb.timestamps,
                      {"count": v}, cb.bucket_les)


def _batches(gen, record_cls):
    return [gen.counter_batch(96, NUM_SAMPLES, start_ms=START_MS),
            _ragged(gen, record_cls, 32, 11),
            gen.histogram_batch(24, NUM_SAMPLES, num_buckets=8,
                                start_ms=START_MS)]


def _port_engine():
    ms = TimeSeriesMemStore(device="cpu")
    mapper = ShardMapper(4)
    for s in range(4):
        ms.setup("prometheus", s)
        mapper.update_from_event(
            ShardEvent("IngestionStarted", "prometheus", s, "local"))
    for batch in _batches(pgen, RecordBatch):
        for s, sub in _routed(batch, mapper, RecordBatch):
            ms.get_shard("prometheus", s).ingest(sub)
    return QueryEngine("prometheus", ms, mapper,
                       SpreadProvider(default_spread=2), device="cpu")


def _answers(eng):
    out = {}
    for q in QUERIES:
        res = eng.query_range(q, START_S + 600, STEP_S, QEND_S)
        assert res.error is None, res.error
        out[q] = {tuple(sorted(k.labels_dict.items())): np.asarray(v)
                  for k, _, v in res.series()}
    return out


@pytest.fixture(scope="module")
def jax_sharded_answers():
    """The JAX engine with its sharded mirrors over 8 virtual devices and
    its fused kernel in interpret mode."""
    mp = pytest.MonkeyPatch()
    mp.setenv("FILODB_TPU_FUSED_INTERPRET", "1")
    mp.setenv("FILODB_TPU_FORCE_SHARDED_MIRROR", "1")
    try:
        from filodb_tpu.core.records import RecordBatch as JRecordBatch
        return _answers(_mk_engine(_batches(jgen, JRecordBatch),
                                   num_shards=4, spread=2))
    finally:
        mp.undo()


def test_engine_sharded_placement_forced_is_bit_identical(
        monkeypatch, jax_sharded_answers):
    """The port's engine with its mirrors placed through the placer
    answers with the bits of the unplaced engine, and within the rate
    family's tolerance of the JAX engine with sharded mirrors."""
    monkeypatch.delenv("FILODB_TPU_FORCE_SHARDED_MIRROR", raising=False)
    flat = _answers(_port_engine())
    monkeypatch.setenv("FILODB_TPU_FORCE_SHARDED_MIRROR", "1")
    eng = _port_engine()
    sharded = _answers(eng)
    placed = [st.device_mirror for s in range(4)
              for st in eng.source.get_shard("prometheus", s).stores.values()
              if getattr(st, "device_mirror", None) is not None]
    assert placed and all(m.placed for m in placed)
    for q in QUERIES:
        assert flat[q].keys() == sharded[q].keys() \
            == jax_sharded_answers[q].keys(), q
        for k, want in flat[q].items():
            assert sharded[q][k].tobytes() == want.tobytes(), (q, k)
            np.testing.assert_allclose(
                want, jax_sharded_answers[q][k], equal_nan=True,
                err_msg=f"{q} {k}", **TOL)


def _mk_store4(n_series=64, ragged=False):
    return stores(n_series=n_series, ragged=ragged, seed=7)


@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
def test_perslot_dispatch_fans_out_and_matches_jax(monkeypatch, ragged):
    """run_agg's fused route launches the single-card kernel once per
    slot (8 on a 4 x 2 mesh), one `mesh_fused` ledger entry each, and
    equals the port's general mesh path and the JAX per-device
    dispatch."""
    jms, pms = _mk_store4(ragged=ragged)
    m = pmesh.make_mesh(4, 2, devices=["cpu"] * 8)
    ex = pmesh.MeshExecutor(pms, "prometheus", m)
    packed = ex.lookup_and_pack([Equals("_metric_", "request_total")],
                                START_MS, QEND_S * 1000, by=("_ns_",),
                                fn_name="rate")
    assert packed.shared_ts_row is not None
    assert packed.dense is (not ragged)
    w = make_window_ends((START_S + 600) * 1000, QEND_S * 1000,
                         STEP_S * 1000)
    k0 = counters.get("mesh_fused_kernel")
    d0 = counters.get("mesh_fused_perdevice_dispatches")
    led0 = telem.snapshot()["devices"].get("cpu", {}).get(
        "kernels", {}).get("mesh_fused", {}).get("count", 0)
    fused_out, labels = ex.run_agg(packed, w, range_ms=300_000,
                                   fn_name="rate", agg_op="sum")
    assert counters.get("mesh_fused_kernel") == k0 + 1
    assert counters.get("mesh_fused_perdevice_dispatches") == d0 + 8
    led = telem.snapshot()["devices"]["cpu"]["kernels"]["mesh_fused"]
    assert led["count"] == led0 + 8
    from filodb_tpu_torch.ops import agg as agg_ops
    wp, W = ex._prep_wends(packed, w)
    parts = pmesh.distributed_window_agg(
        m, packed.ts_off, packed.values, packed.group_ids, wp,
        range_ms=300_000, fn_name="rate", agg_op="sum",
        num_groups=packed.num_groups, base_ms=packed.base_ms,
        vbase=packed.vbase, precorrected=packed.precorrected,
        dense=packed.dense)
    general = agg_ops.present("sum", parts).numpy()[:, :W]
    assert (np.isnan(fused_out) == np.isnan(general)).all()
    np.testing.assert_allclose(fused_out, general, rtol=2e-5, atol=1e-4,
                               equal_nan=True)
    monkeypatch.setenv("FILODB_TPU_FUSED_INTERPRET", "1")
    jex = jmesh.MeshExecutor(jms, "prometheus",
                             jmesh.make_mesh(4, 2,
                                             devices=jax.devices()[:8]))
    jp = jex.lookup_and_pack([JEquals("_metric_", "request_total")],
                             START_MS, QEND_S * 1000, by=("_ns_",),
                             fn_name="rate")
    jo, jl = jex.run_agg(jp, w, range_ms=300_000, fn_name="rate",
                         agg_op="sum")
    assert jl == labels
    np.testing.assert_allclose(fused_out, np.asarray(jo), equal_nan=True,
                               **(TOL if not ragged
                                  else dict(rtol=5e-4, atol=1e-4)))


@pytest.mark.parametrize("comb", ["sum", "min", "max"])
def test_collective_merge_equals_the_host_merge_bit_for_bit(comb):
    """The in-process merge on the first slot's device and the host merge
    are the same f64 reduce in ascending shard order: the same bits;
    both equal the reference's merge of the same f32 partials."""
    m = pmesh.make_mesh(4, 2, devices=["cpu"] * 8)
    rng = np.random.default_rng(0)
    G, W = 16, 37
    host = {(s, t): rng.standard_normal((G, W)).astype(np.float32)
            for s in range(4) for t in range(2)}
    parts = {k: torch.from_numpy(v) for k, v in host.items()}
    h0 = counters.get("mesh_partials_collective_merge")
    via_coll = pmesh.merge_device_partials(parts, m, comb, collective=True)
    assert counters.get("mesh_partials_collective_merge") == h0 + 1
    via_host = pmesh.merge_device_partials(parts, m, comb, collective=False)
    assert via_coll.shape == via_host.shape == (G, 2 * W)
    assert via_coll.tobytes() == via_host.tobytes()
    jm = jmesh.make_mesh(4, 2, devices=jax.devices()[:8])
    jparts = {k: jax.device_put(v, jm.devices[k]) for k, v in host.items()}
    want = jmesh.merge_device_partials(jparts, jm, comb, collective=False)
    assert via_host.tobytes() == np.asarray(want, np.float64).tobytes()
    # the default on host slots is the host merge
    d0 = counters.get("mesh_partials_host_merge")
    pmesh.merge_device_partials(parts, m, comb)
    assert counters.get("mesh_partials_host_merge") == d0 + 1


def test_pack_layout_memo_hits_on_repoll():
    """A re-poll after value-only ingest repacks the values but hits the
    layout memo (no per-series regrouping)."""
    _, pms = _mk_store4()
    ex = pmesh.MeshExecutor(pms, "prometheus",
                            pmesh.make_mesh(4, 2, devices=["cpu"] * 8))
    f = [Equals("_metric_", "request_total")]
    t0, t1 = START_MS, QEND_S * 1000
    h0 = counters.get("mesh_pack_memo_hits")
    ex.lookup_and_pack(f, t0, t1, by=("_ns_",), fn_name="rate")
    extra = pgen.counter_batch(64, 4, start_ms=START_MS + NUM_SAMPLES * 10_000)
    for s, sub in _routed(extra, ShardMapper(4), RecordBatch):
        pms.get_shard("prometheus", s).ingest(sub)
    ex.lookup_and_pack(f, t0, t1 + 40_000, by=("_ns_",), fn_name="rate")
    assert counters.get("mesh_pack_memo_hits") > h0


def test_placed_pack_holds_one_copy_per_row_and_device():
    """A shard row's block lives once on each distinct device of its
    slots: a 4 x 2 mesh over one device holds 4 blocks; the kernels read
    the padded block, the general path its leading [S, T] view."""
    _, pms = _mk_store4(n_series=16)
    ex = pmesh.MeshExecutor(pms, "prometheus",
                            pmesh.make_mesh(4, 2, devices=["cpu"] * 8))
    pk = ex.lookup_and_pack([Equals("_metric_", "request_total")], START_MS,
                            QEND_S * 1000, by=("_ns_",), fn_name="rate")
    assert len(pk.values.parts) == len(pk.ts_off.parts) == 4
    assert pk.values.kernel_block(0, "cpu").shape[1] % 128 == 0
    assert pk.values.block(0, "cpu").shape == tuple(pk.values.shape[1:])
