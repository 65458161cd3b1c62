"""The port's fault points and traced filters (utils/faults.py at
core/shard.py's ingest.batch and flush.persist and core/devicecache.py's
device.upload; TimeSeriesShard.set_traced_filters) against the JAX
package's, on the CPU.

- ingest.batch raises in `ingest` and `ingest_columns` of both packages
  and leaves the shard as it was; the next batch lands.
- flush.persist raises before a chunk is written and seals nothing; the
  next flush writes what the reference's does.
- device.upload fails one full mirror refresh before anything is
  allocated: the query reports the fault, nothing is booked, and once
  disarmed the answer is bit-identical to the one before the fault.  In
  a background rebuild the fault is the `mirror_rebuild` job's error,
  which the health model shows, as the reference's does.
- Traced filters log the same creations, ingests and lookups as the
  reference's for the same filters and the same batches.
"""
import gc
import logging

import numpy as np
import pytest
import torch

from filodb_tpu.core.memstore import TimeSeriesMemStore as JaxMemStore
from filodb_tpu.core.store import InMemoryColumnStore as JaxColumnStore
from filodb_tpu.ingest.generator import counter_batch
from filodb_tpu.utils.faults import faults as jax_faults
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.core.store import InMemoryColumnStore
from filodb_tpu_torch.utils.faults import faults
from filodb_tpu_torch.utils.health import HealthEvaluator

from test_torch_explain import build_stores
from test_torch_ingest import to_port

START = 1_600_000_000_000
Q = "sum by (job) (rate(http_requests[5m]))"


@pytest.fixture(autouse=True, scope="module")
def _clear_compile_journal():
    """The JAX engine's queries journal jit compiles under their trace
    ids, which the reference's health model reads as a compile storm in
    the next test file this process runs; clear the journal after."""
    yield
    from filodb_tpu.utils.events import journal
    journal.clear()


@pytest.fixture(autouse=True)
def _disarmed():
    faults.disarm()
    jax_faults.disarm()
    yield
    faults.disarm()
    jax_faults.disarm()


def _shards(column_stores=False):
    jms = JaxMemStore(column_store=JaxColumnStore() if column_stores
                      else None)
    pms = TimeSeriesMemStore(
        column_store=InMemoryColumnStore() if column_stores else None,
        device="cpu")
    return jms.setup("prometheus", 0), pms.setup("prometheus", 0)


def _state(sh):
    st = sh.stores.get("prom-counter")
    return (sh.num_partitions, sh.stats.rows_ingested, sh.ingested_offset,
            None if st is None else (st.generation, st.counts.tolist()))


@pytest.mark.parametrize("door", ["ingest", "ingest_columns"])
def test_ingest_batch_fault_leaves_the_shard_unchanged(door):
    jsh, psh = _shards()
    first = counter_batch(20, 30, start_ms=START, seed=3)
    jsh.ingest(first, offset=1)
    psh.ingest(to_port(first), offset=1)
    before = (_state(jsh), _state(psh))
    nxt = counter_batch(20, 60, start_ms=START, seed=3)
    keep = nxt.timestamps >= START + 30 * 10_000
    if door == "ingest":
        from filodb_tpu.core.records import RecordBatch
        jb = RecordBatch(nxt.schema, nxt.part_keys, nxt.part_idx[keep],
                         nxt.timestamps[keep],
                         {k: v[keep] for k, v in nxt.columns.items()})
        calls = [lambda: jsh.ingest(jb, offset=2),
                 lambda: psh.ingest(to_port(jb), offset=2)]
    else:
        from filodb_tpu_torch.core.partkey import PartKey
        ts = np.broadcast_to(START + np.arange(30, 60) * 10_000,
                             (20, 30)).copy()
        vals = np.cumsum(np.ones((20, 30)), axis=1) + 1e6
        jkeys = list(nxt.part_keys)
        pkeys = [PartKey.make(k.metric, k.tags_dict) for k in jkeys]
        calls = [lambda: jsh.ingest_columns("prom-counter", jkeys, ts,
                                            {"count": vals}, offset=2),
                 lambda: psh.ingest_columns("prom-counter", pkeys, ts,
                                            {"count": vals}, offset=2)]
    with jax_faults.plan("ingest.batch", "error", first_k=1), \
            faults.plan("ingest.batch", "error", first_k=1):
        for call in calls:
            with pytest.raises(ConnectionError, match="ingest.batch"):
                call()
        assert (_state(jsh), _state(psh)) == before
        # the plan fired once: the retry lands in both
        n = [call() for call in calls]
    assert n[0] == n[1] > 0
    assert _state(jsh)[:3] == _state(psh)[:3]
    assert _state(jsh)[3][1] == _state(psh)[3][1]


def test_flush_persist_fault_seals_nothing():
    jsh, psh = _shards(column_stores=True)
    b = counter_batch(16, 40, start_ms=START, seed=4)
    jsh.ingest(b, offset=1)
    psh.ingest(to_port(b), offset=1)
    with jax_faults.plan("flush.persist", "error", first_k=10**6), \
            faults.plan("flush.persist", "error", first_k=10**6):
        for sh in (jsh, psh):
            with pytest.raises(ConnectionError, match="flush.persist"):
                sh.flush_all_groups()
    # disarmed: the flush writes what the reference writes
    assert jsh.flush_all_groups() == psh.flush_all_groups() > 0


@pytest.fixture
def one_shard():
    return build_stores(shards=1)[1]


def _answer(eng):
    res = eng.query_range(Q, 600, 60, 3000)
    return res, {k.labels: np.asarray(v).copy() for k, _, v in res.series()}


def test_device_upload_fault_fails_one_refresh(one_shard, monkeypatch):
    import filodb_tpu_torch.core.devicecache as devicecache
    from filodb_tpu_torch.utils.devicetelem import DeviceTelemetry
    telem = DeviceTelemetry()            # this test's HBM model alone
    monkeypatch.setattr(devicecache, "telem", telem)
    eng = one_shard
    res, before = _answer(eng)
    assert res.error is None and before
    shard = eng.source.get_shard("prometheus", 0)
    store = shard.stores["prom-counter"]
    cpu = torch.device("cpu")
    booked0 = telem.hbm_booked(cpu, "hot")
    store.device_mirror = None           # the next query builds it anew
    gc.collect()
    freed = telem.hbm_booked(cpu, "hot")
    assert freed == 0 < booked0
    with faults.plan("device.upload", "error", first_k=1) as plan:
        res, _ = _answer(eng)
        assert plan.fired == 1
    assert res.error is not None and "device.upload" in res.error
    mirror = store.device_mirror
    assert mirror.snapshot() is None and mirror.booked_bytes == 0
    assert telem.hbm_booked(cpu, "hot") == freed
    res, after = _answer(eng)
    assert res.error is None
    assert after.keys() == before.keys()
    for k in before:
        np.testing.assert_array_equal(after[k], before[k])
    assert telem.hbm_booked(cpu, "hot") == booked0


def test_device_upload_fault_in_the_background_rebuild(one_shard,
                                                       monkeypatch):
    """The fault in a background rebuild: the mirror_rebuild job records
    the error and the health model's jobs verdict degrades; the next
    rebuild resets the streak."""
    import filodb_tpu_torch.utils.jobs as jobs_mod
    monkeypatch.setattr(jobs_mod, "jobs", jobs_mod.JobRegistry())
    eng = one_shard
    shard = eng.source.get_shard("prometheus", 0)
    store = shard.stores["prom-counter"]
    _, before = _answer(eng)
    store.device_mirror = None
    with faults.plan("device.upload", "error", first_k=2):
        res, _ = _answer(eng)            # the inline first build fails
        fault_err = res.error
        mirror = store.device_mirror
        assert mirror.request_background_refresh(shard, store)
        assert mirror.join_rebuild(30)
    assert "device.upload" in fault_err
    key = f"mirror_rebuild:prometheus/{shard.shard_num}"
    jv = HealthEvaluator()._jobs_verdict()
    assert jv["jobs"][key]["status"] == "degraded"
    assert "device.upload" in jv["jobs"][key]["lastError"]
    res, after = _answer(eng)            # inline: the rebuild failed
    assert res.error is None
    for k in before:
        np.testing.assert_array_equal(after[k], before[k])
    assert mirror.request_background_refresh(shard, store)
    assert mirror.join_rebuild(30)
    jv = HealthEvaluator()._jobs_verdict()
    assert jv["jobs"][key]["status"] == "ok"
    snap = [j for j in jobs_mod.jobs.snapshot()
            if j["job"] == "mirror_rebuild"]
    assert len(snap) == 1 and snap[0]["errors"] == 1
    assert snap[0]["runs"] == 2 and snap[0]["consecutiveErrors"] == 0


def test_traced_filters_log_the_reference_touches(caplog):
    jsh, psh = _shards()
    filters = [{"_ns_": "App-3"}, {"instance": "Instance-7"}]
    b1 = counter_batch(30, 20, start_ms=START, seed=5)
    b2 = counter_batch(30, 40, start_ms=START, seed=5)
    keep = b2.timestamps >= START + 20 * 10_000
    from filodb_tpu.core.index import Equals as JaxEquals
    from filodb_tpu.core.records import RecordBatch
    from filodb_tpu_torch.core.index import Equals
    b2 = RecordBatch(b2.schema, b2.part_keys, b2.part_idx[keep],
                     b2.timestamps[keep],
                     {k: v[keep] for k, v in b2.columns.items()})
    logs = []
    for sh, conv, eq in ((jsh, lambda b: b, JaxEquals),
                         (psh, to_port, Equals)):
        with caplog.at_level(logging.INFO, logger="filodb.shard"):
            caplog.clear()
            sh.ingest(conv(b1), offset=1)          # created before
            matched = sh.set_traced_filters(filters)
            sh.ingest(conv(b2), offset=2)
            sh.lookup_partitions([eq("_ns_", "App-3")], 0, 2**62)
            sh.lookup_partitions([eq("_ns_", "App-3")], 0, 2**62)
            logs.append([r.getMessage() for r in caplog.records
                         if "TRACED" in r.getMessage()])
        sh.set_traced_filters([])
    assert logs[0] == logs[1]
    kinds = [ln.split(":")[0] for ln in logs[0]]
    assert kinds.count("TRACED series matched filter") == matched > 1
    assert kinds.count("TRACED series ingest") == matched
    # two lookups (the second from the memo) of the App-3 series
    assert 0 < kinds.count("TRACED series query_lookup") < 2 * matched
