"""The port's device telemetry (filodb_tpu_torch/utils/devicetelem.py)
against the JAX package's (filodb_tpu/utils/devicetelem.py), on the CPU.

- The ledger's snapshot has the reference's keys, and record_dispatch
  feeds the exec tally in lockstep, as the reference's does.
- Over a fused panel (K1's plain version), a general panel and a
  dashboard batch, on tests/test_torch_explain.py's two-shard store and
  on one shard: QueryStats.device_seconds equals the sum of the ledger's
  kernel seconds booked under that query's trace id, by kernel, and
  stats.devices is filled (the reference's parity test,
  tests/test_devicetelem.py).  Over a batch the sum over its panels
  holds as well.
- hbm_book / hbm_set move the booked bytes and the high water as the
  reference's do for the same calls; a mirror books its snapshot's bytes
  under `hot`, and gives them back when it is collected.
- A kernel-library build is one `jit_compile` journal event (its nvcc
  step stubbed here), every other library call a cache hit.
"""
import gc

import pytest
import torch

from filodb_tpu.utils import devicetelem as jax_devicetelem
from filodb_tpu.utils.events import journal as jax_journal
from filodb_tpu_torch.core.devicecache import snapshot_nbytes
from filodb_tpu_torch.http.routes import PromHttpApi
from filodb_tpu_torch.ops import kernels
from filodb_tpu_torch.utils import devicetelem
from filodb_tpu_torch.utils.devicetelem import DeviceTelemetry, telem
from filodb_tpu_torch.utils.events import journal
from filodb_tpu_torch.utils.metrics import exec_tally, registry

from test_torch_explain import build_stores

S0 = 600                    # query grid [S0, S1] s, 1 m steps
S1 = 3000
FUSED = "sum by (job) (rate(http_requests[5m]))"
GENERAL = "sum by (job) (irate(http_requests[5m]))"
BATCH = [FUSED, "avg by (group) (rate(http_requests[5m]))",
         "max by (job) (increase(http_requests[5m]))", GENERAL,
         "sum(sum_over_time(m[5m]))"]


@pytest.fixture(autouse=True, scope="module")
def _clear_compile_journal():
    """The JAX engine's queries journal jit compiles under their trace
    ids, which the reference's health model reads as a compile storm in
    the next test file this process runs; clear the journal after."""
    yield
    jax_journal.clear()


@pytest.fixture(autouse=True)
def _clean_telem():
    telem.clear()
    devicetelem.set_enabled(True)
    yield
    telem.clear()
    devicetelem.set_enabled(True)


@pytest.fixture(scope="module", params=[2, 1], ids=["two-shards", "one"])
def engine(request):
    return build_stores(shards=request.param)[1]


def _ledger_by_kernel(trace_ids):
    out = {}
    for e in telem.recent(limit=10_000, kind="kernel"):
        if e["origin"] in trace_ids:
            cell = out.setdefault(f'{e["device"]}|{e["kernel"]}', [0.0, 0])
            cell[0] += e["seconds"]
            cell[1] += 1
    return out


def _assert_parity(stats_calls, device_seconds, ledger):
    assert set(stats_calls) == set(ledger)
    for key, (secs, n) in ledger.items():
        assert stats_calls[key][1] == n, key
        # the ring rounds each entry's seconds to 1e-6
        assert stats_calls[key][0] == pytest.approx(secs, abs=1e-5 * n)
    assert device_seconds == pytest.approx(
        sum(c[0] for c in stats_calls.values()), rel=1e-12, abs=1e-12)


# ------------------------------------------------------------ the ledger

def test_snapshot_keys_are_the_reference_keys():
    mine, ref = DeviceTelemetry(), jax_devicetelem.DeviceTelemetry()
    for t in (mine, ref):
        t.record_dispatch("k", device="dev0", shape="S4", seconds=0.25,
                          bytes_in=8, bytes_out=4, note=False)
        t.hbm_book("dev0", "hot", 1 << 20)
    a, b = mine.snapshot(), ref.snapshot()
    assert set(a) == set(b)
    assert set(a["devices"]["dev0"]) == set(b["devices"]["dev0"])
    assert set(a["recent"][0]) == set(b["recent"][0])
    assert a["devices"]["dev0"]["kernels"] == b["devices"]["dev0"]["kernels"]


def test_ledger_feeds_exec_tally_in_lockstep():
    snap = exec_tally.snapshot()
    try:
        telem.record_dispatch("fused_rate", device="cpu", seconds=0.5)
        telem.record_dispatch("fused_rate", device="cpu", seconds=0.25)
        telem.record_dispatch("mirror_gather", device="cpu", seconds=0.125)
        assert exec_tally.device_s == pytest.approx(0.875)
        assert exec_tally.device_calls == {
            ("cpu", "fused_rate"): [0.75, 2],
            ("cpu", "mirror_gather"): [0.125, 1]}
        # transfers never feed the device tally
        telem.record_dispatch("mirror_upload_full", device="cpu",
                              seconds=9.0, kind="transfer", note=False)
        assert exec_tally.device_s == pytest.approx(0.875)
        devicetelem.set_enabled(False)
        telem.record_dispatch("fused_rate", device="cpu", seconds=1.0)
        assert exec_tally.device_s == pytest.approx(1.875)
    finally:
        exec_tally.snapshot()
        exec_tally.restore(snap, 0.0)


@pytest.mark.parametrize("promql", [FUSED, GENERAL])
def test_stats_device_seconds_equal_the_ledger(engine, promql):
    res = engine.query_range(promql, S0, 60, S1)
    assert res.error is None and res.trace_id
    st = res.stats
    assert st.device_seconds > 0 and st.to_dict()["devices"]
    ledger = _ledger_by_kernel({res.trace_id})
    _assert_parity(st.device_calls, st.device_seconds, ledger)
    kernels_run = {k.split("|")[1] for k in ledger}
    assert "mirror_gather" in kernels_run
    assert ("fused_rate" in kernels_run) == (promql == FUSED)
    devs = st.to_dict()["devices"]
    assert sum(c["seconds"] for d in devs.values() for c in d.values()) \
        == pytest.approx(st.device_seconds, abs=1e-5)


def test_batch_device_seconds_equal_the_ledger(engine):
    results = engine.query_range_batch(BATCH, S0, 60, S1)
    tids = {r.trace_id for r in results}
    assert len(tids) == len(BATCH)
    for r in results:
        assert r.error is None, r.error
        assert r.stats.to_dict()["devices"], r.trace_id
        _assert_parity(r.stats.device_calls, r.stats.device_seconds,
                       _ledger_by_kernel({r.trace_id}))
    total = sum(r.stats.device_seconds for r in results)
    ledger = _ledger_by_kernel(tids)
    assert total == pytest.approx(sum(c[0] for c in ledger.values()),
                                  abs=1e-5 * len(ledger) + 1e-5)
    # the two rate panels merge into one launch a shard, one ledger
    # entry booked to one panel
    assert sum(c[1] for k, c in ledger.items()
               if k.endswith("|fused_rate")) == \
        engine.shard_mapper.num_shards


def test_http_stats_all_device_split(engine):
    api = PromHttpApi({"prometheus": engine})
    st, p = api.handle("GET", "/api/v1/query_range",
                       {"query": FUSED, "start": str(S0), "end": str(S1),
                        "step": "60", "stats": "all"})
    assert st == 200
    s = p["stats"]
    assert s["phases"]["device_s"] > 0
    split = sum(c["seconds"] for d in s["devices"].values()
                for c in d.values())
    assert split == pytest.approx(s["phases"]["device_s"], abs=1e-5)
    assert "fused_rate" in s["devices"]["cpu"]


# ------------------------------------------------------------ HBM model

def test_hbm_booking_and_high_water_move_as_the_reference():
    mine, ref = DeviceTelemetry(), jax_devicetelem.DeviceTelemetry()
    steps = [("book", "hot", 8 << 20), ("book", "hot", 512 << 10),
             ("book", "cold", 3 << 20), ("set", "hot", 2 << 20),
             ("book", "hot", 64 << 20), ("book", "hot", -(256 << 20)),
             ("set", "cold", 0), ("book", "hot", 1 << 20)]
    dev = "devHW"
    j0, r0 = journal.next_seq, jax_journal.next_seq
    for op, region, n in steps:
        for t in (mine, ref):
            (t.hbm_book if op == "book" else t.hbm_set)(dev, region, n)
        a = mine.snapshot()["devices"].get(dev)
        b = ref.snapshot()["devices"].get(dev)
        assert (a is None) == (b is None)
        if a is not None:
            assert a["hbm"] == b["hbm"]
            assert a["hbmHighWaterBytes"] == b["hbmHighWaterBytes"]
        assert mine.hbm_booked(dev) == ref.hbm_booked(dev)

    def high_waters(j, since):
        return [(e["bytes"], e["region"])
                for e in j.since(since - 1, kind="device_hbm_high_water")
                if e.get("device") == dev]
    assert high_waters(journal, j0) == high_waters(jax_journal, r0)
    assert high_waters(journal, j0)


def test_mirror_books_its_snapshot_and_releases_it(monkeypatch):
    import filodb_tpu_torch.core.devicecache as devicecache
    telem = DeviceTelemetry()            # this test's HBM model alone
    monkeypatch.setattr(devicecache, "telem", telem)
    _, eng = build_stores(shards=1)
    res = eng.query_range(FUSED, S0, 60, S1)
    assert res.error is None
    store = eng.source.get_shard("prometheus", 0).stores["prom-counter"]
    mirror = store.device_mirror
    snap = mirror.snapshot()
    cpu = torch.device("cpu")
    want = snapshot_nbytes(snap)
    assert want == (snap.ts_off.nbytes
                    + sum(t.nbytes for t in snap.cols.values())
                    + sum(t.nbytes for t in snap.vbases.values()))
    assert mirror.booked_bytes == want
    assert telem.hbm_booked(cpu, "hot") == want
    del mirror, snap
    store.device_mirror = None
    gc.collect()
    assert telem.hbm_booked(cpu, "hot") == 0


# ------------------------------------------------------------ compiles

def test_library_build_is_one_compile_then_hits(monkeypatch, tmp_path):
    """A build of a kernel library journals one jit_compile carrying the
    source's name and the current trace id; a second call is a hit.
    nvcc is a stub script writing the output file, and loading it is
    stubbed too: no CUDA toolchain is needed."""
    from filodb_tpu_torch.utils.metrics import trace_context
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo built > "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: ("lib", path))
    monkeypatch.setitem(kernels._BINDERS, "fused_rate", lambda lib: None)
    seq0 = journal.next_seq
    hits = registry.counter("jit_cache_events", kernel="fused_rate",
                            event="hit")
    h0 = hits.value
    with trace_context("cafe" * 8):
        lib = kernels.library("fused_rate")
        assert lib[0] == "lib"
        assert kernels.library("fused_rate") is lib
    evs = [e for e in journal.since(seq0 - 1, kind="jit_compile")
           if e.get("kernel") == "fused_rate"]
    assert len(evs) == 1 and evs[0]["origin"] == "cafe" * 8
    assert hits.value - h0 == 1
    comp = telem.recent(limit=10, kind="compile")
    assert [e["kernel"] for e in comp] == ["fused_rate"]
    assert telem.snapshot()["devices"]["default"]["compiles"] == 1
    journal.clear()
