"""The port's replication layer (filodb_tpu_torch/replication) against
the JAX package's: every case of tests/test_replication.py on the port
(placement math, ingest fan-out + lag journal edges, WAL-segment
catch-up, query-time replica failover + gather dedup, the live-handoff
state machine, health/admin surfaces), each store on `device="cpu"`.

Beside them: the same data through both packages' replicated clusters
answers the same; a mixed cluster (a port node and a JAX node, each the
other's replica) replicates, fails over, catches up and hands off as
either package alone; the replication door's frames, client and server
side, are the reference's byte for byte; the handoff journal and the
/admin/shards payload equal the reference's.

The traffic-under-handoff drill keeps the reference's `replication`
marker (implies slow); a smaller handoff under polling queries runs in
tier-1.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.schemas import PROM_COUNTER
from filodb_tpu_torch.parallel.shardmanager import (DatasetResourceSpec,
                                                    ShardManager)
from filodb_tpu_torch.parallel.shardmapper import (ShardEvent, ShardMapper,
                                                   ShardStatus)
from filodb_tpu_torch.parallel.testcluster import make_replicated_cluster
from filodb_tpu_torch.query.rangevector import PlannerParams
from filodb_tpu_torch.utils.events import journal
from filodb_tpu_torch.utils.jobs import jobs

DS = "prometheus"
START = 1_600_000_000_000


def _keys(n, ns="n"):
    return [PartKey.make("repl_total",
                         {"_ws_": "w", "_ns_": ns, "i": str(i)})
            for i in range(n)]


def _grid(n_series, n_samples, base_idx=0):
    ts = (np.arange(n_samples, dtype=np.int64)[None, :]
          + base_idx) * 10_000 + START
    ts = np.repeat(ts, n_series, axis=0)
    vals = (np.arange(n_samples, dtype=np.float64)[None, :] + base_idx) \
        * 5.0 + np.arange(n_series, dtype=np.float64)[:, None]
    return ts, vals


# ------------------------------------------------------------- placement


def test_mapper_ordered_owners_and_promotion():
    m = ShardMapper(4, replication_factor=2)
    m.update_from_event(ShardEvent("IngestionStarted", DS, 0, "A"))
    m.register_replica(0, "B", status=ShardStatus.ACTIVE)
    assert m.owners(0) == ["A", "B"]
    assert m.live_owners(0) == ["A", "B"]
    # registering the primary as replica is a no-op
    m.register_replica(0, "A")
    assert m.owners(0) == ["A", "B"]
    old = m.promote_replica(0, "B", demote_old=True)
    assert old == "A"
    assert m.owners(0) == ["B", "A"]
    assert m.node_for_shard(0) == "B"
    # promoted replica carried its ACTIVE status into the primary column
    assert m.statuses[0] == ShardStatus.ACTIVE
    m.unassign_replica(0, "A")
    assert m.owners(0) == ["B"]
    with pytest.raises(ValueError):
        m.promote_replica(0, "Z")


def test_mapper_replica_events_never_touch_primary():
    m = ShardMapper(2)
    m.update_from_event(ShardEvent("IngestionStarted", DS, 0, "A"))
    m.update_from_event(ShardEvent("ReplicaAssigned", DS, 0, "B"))
    assert m.owner_status(0, "B") == ShardStatus.ASSIGNED
    m.update_from_event(ShardEvent("ReplicaActive", DS, 0, "B"))
    assert m.owner_status(0, "B") == ShardStatus.ACTIVE
    assert m.statuses[0] == ShardStatus.ACTIVE      # primary untouched
    # a ShardDown addressed to the REPLICA node removes only the replica
    m.update_from_event(ShardEvent("ShardDown", DS, 0, "B"))
    assert m.owners(0) == ["A"]
    assert m.node_for_shard(0) == "A"
    assert m.statuses[0] == ShardStatus.ACTIVE
    # ReplicaPromoted event = the atomic cutover
    m.update_from_event(ShardEvent("ReplicaAssigned", DS, 0, "C"))
    m.update_from_event(ShardEvent("ReplicaPromoted", DS, 0, "C"))
    assert m.node_for_shard(0) == "C"
    assert "A" not in m.owners(0)


def test_manager_rf2_never_colocates():
    sm = ShardManager(replication_factor=2)
    for n in ("a", "b", "c"):
        sm.add_member(n)
    mapper = sm.setup_dataset(DS, DatasetResourceSpec(8, 3))
    for s in range(8):
        owners = mapper.owners(s)
        assert len(owners) == 2, f"shard {s}: {owners}"
        assert len(set(owners)) == 2, f"shard {s} co-located: {owners}"


def test_manager_promotes_replica_on_primary_death():
    sm = ShardManager(replication_factor=2)
    for n in ("a", "b", "c"):
        sm.add_member(n)
    mapper = sm.setup_dataset(DS, DatasetResourceSpec(8, 3))
    # all copies live
    for s in range(8):
        sm.on_shard_event(ShardEvent("IngestionStarted", DS, s,
                                     mapper.node_for_shard(s)))
        for n in list(mapper.replicas[s]):
            sm.on_shard_event(ShardEvent("ReplicaActive", DS, s, n))
    victim = mapper.node_for_shard(0)
    owned = mapper.shards_for_node(victim)
    sm.remove_member(victim)
    for s in owned:
        # never Down: the live replica was promoted in place
        assert mapper.statuses[s] == ShardStatus.ACTIVE, \
            f"shard {s} went {mapper.statuses[s]} instead of promoting"
        assert mapper.node_for_shard(s) != victim
    # the dead node is gone from every assignment list
    assert not mapper.replica_shards_for_node(victim)
    # replicas refilled on surviving capacity (2 nodes left -> every
    # shard can still hold 2 distinct owners)
    for s in range(8):
        assert len(set(mapper.owners(s))) == 2


def test_mapper_replication_off_unchanged():
    m = ShardMapper(4)
    assert m.replication_factor == 1
    assert m.replicas == [[], [], [], []]
    m.update_from_event(ShardEvent("IngestionStarted", DS, 1, "A"))
    assert m.owners(1) == ["A"]


# -------------------------------------------- satellite: mapper edge math


def test_mapper_rejects_non_power_of_two():
    with pytest.raises(AssertionError):
        ShardMapper(6)
    with pytest.raises(AssertionError):
        ShardMapper(0)


def test_shard_down_clears_node_assignment():
    m = ShardMapper(4)
    m.update_from_event(ShardEvent("IngestionStarted", DS, 2, "A"))
    assert m.node_for_shard(2) == "A"
    m.update_from_event(ShardEvent("ShardDown", DS, 2, "A"))
    assert m.node_for_shard(2) is None
    assert m.statuses[2] == ShardStatus.DOWN
    assert not m.active_shards([2])


def test_query_shards_run_boundaries():
    """queryShards returns the full 2^spread-wide aligned run the shard
    key can land on — and clamps spread past log2(numShards)."""
    m = ShardMapper(8)
    h = 0b10110  # arbitrary shard-key hash
    assert m.query_shards(h, 0) == [h & 7]
    run = m.query_shards(h, 2)
    assert len(run) == 4
    base = run[0]
    assert base % 4 == 0                     # aligned to the run width
    assert run == [base, base + 1, base + 2, base + 3]
    # ingestion_shard always lands inside the query run
    for ph in range(64):
        assert m.ingestion_shard(h, ph, 2) in run
    # spread beyond log2(numShards) clamps to all shards
    assert m.query_shards(h, 10) == list(range(8))


# ---------------------------------------------------------- ingest fan-out


def test_fanout_quorum_ack_and_lag_journal_edges():
    cluster = make_replicated_cluster(num_shards=2, device="cpu")
    try:
        keys = _keys(8)
        ts, vals = _grid(8, 16)
        res = cluster.ingest_grid(0, PROM_COUNTER.name, keys, ts,
                                  {"count": vals})
        owners = cluster.mapper.owners(0)
        assert sorted(res.acked) == sorted(owners)
        for n in owners:
            sh = cluster.stores[n].get_shard(DS, 0)
            assert sh.num_partitions == 8
        # kill one replica owner -> fan-out marks it lagging (journal
        # edge fires once), primary ack keeps ingest available
        replica = cluster.mapper.replicas[0][0]
        seq0 = journal.next_seq
        cluster.kill(replica)
        for b in range(3):
            ts2, vals2 = _grid(8, 4, base_idx=16 + b * 4)
            res2 = cluster.ingest_grid(0, PROM_COUNTER.name, keys, ts2,
                                       {"count": vals2})
            assert cluster.mapper.node_for_shard(0) in res2.acked
            assert replica not in res2.acked
        lag_events = [e for e in journal.since(seq0 - 1)
                      if e["kind"] == "replica_lagging"
                      and e.get("peer") == replica]
        assert len(lag_events) == 1, "lagging edge must fire exactly once"
        snap = cluster.manager.snapshot()
        lagging = [p for p in snap if p["peer"] == replica]
        assert lagging and lagging[0]["lagging"]
    finally:
        cluster.stop()


def test_fanout_requires_some_owner():
    from filodb_tpu_torch.replication.replicator import ReplicationSendError
    cluster = make_replicated_cluster(num_shards=2, device="cpu")
    try:
        for n in list(cluster.mapper.owners(1)):
            cluster.kill(n)
        keys = _keys(4)
        ts, vals = _grid(4, 4)
        with pytest.raises(ReplicationSendError):
            cluster.manager.replicate(1, PROM_COUNTER.name, keys, ts,
                                      {"count": vals},
                                      require_primary=True)
    finally:
        cluster.stop()


# ------------------------------------------------------- WAL catch-up


def test_catchup_streams_segments_and_registers_job(tmp_path):
    from filodb_tpu_torch.replication import (ReplicaClient,
                                              ReplicationServer,
                                              catchup_shards)
    from filodb_tpu_torch.wal import WalManager
    ms_primary = TimeSeriesMemStore(device="cpu")
    ms_primary.setup(DS, 0)
    ms_primary.setup(DS, 1)
    wal = WalManager(str(tmp_path), DS)
    keys = _keys(6)
    for shard in (0, 1):
        for b in range(4):
            ts, vals = _grid(6, 8, base_idx=b * 8)
            seq = wal.append_grid(shard, PROM_COUNTER.name, keys, ts,
                                  {"count": vals})
            ms_primary.get_shard(DS, shard).ingest_columns(
                PROM_COUNTER.name, keys, ts, {"count": vals}, offset=seq)
    srv = ReplicationServer(ms_primary, node="P", wals={DS: wal}).start()
    try:
        cli = ReplicaClient(*srv.address)
        replica = TimeSeriesMemStore(device="cpu")
        stats = catchup_shards(cli, DS, replica, shards=[1], node="R")
        assert stats.records == 4
        assert stats.samples == 4 * 6 * 8
        # only the filtered shard materialized
        assert replica.get_shard(DS, 0) is None
        sh = replica.get_shard(DS, 1)
        assert sh.num_partitions == 6
        # replayed data answers identically to the primary's copy
        a = ms_primary.get_shard(DS, 1).stores[PROM_COUNTER.name]
        b = sh.stores[PROM_COUNTER.name]
        assert a.num_series == b.num_series
        # resume point: nothing replays twice
        stats2 = catchup_shards(cli, DS, replica, shards=[1],
                                since={1: stats.last_seq}, node="R")
        assert stats2.records == 0
        # the job registry saw the runs
        h = jobs.get("replication_catchup", dataset=DS)
        assert h is not None and h.runs >= 2 and h.consecutive_errors == 0
        caught = [e for e in journal.since(0)
                  if e["kind"] == "replica_caught_up"
                  and e.get("node") == "R"]
        assert caught
    finally:
        srv.stop()
        wal.close()


def _segmented_door(tmp_path):
    """A door over a WAL of several small segments: 6 slabs of each of
    shards 0 and 1, interleaved."""
    from filodb_tpu_torch.config import WalConfig
    from filodb_tpu_torch.replication import ReplicationServer
    from filodb_tpu_torch.wal import WalManager
    wal = WalManager(str(tmp_path), DS,
                     config=WalConfig(segment_max_bytes=256))
    keys = _keys(6)
    for b in range(6):
        for shard in (0, 1):
            ts, vals = _grid(6, 8, base_idx=b * 8)
            wal.append_grid(shard, PROM_COUNTER.name, keys, ts,
                            {"count": vals})
    ms = TimeSeriesMemStore(device="cpu")
    srv = ReplicationServer(ms, node="P", wals={DS: wal}).start()
    return wal, srv


class _CountingSource:
    """A door client whose segment stream counts what it has yielded."""

    def __init__(self, cli):
        self.cli = cli
        self.fetched = 0

    def fetch_segments(self, dataset, since_seq=-1):
        for seg in self.cli.fetch_segments(dataset, since_seq):
            self.fetched += 1
            yield seg

    def reset(self):
        self.cli.reset()


class _RecordingSink:
    """A door client that records each relayed append, with how many
    source segments had arrived by then; raises at append `fail_at`."""

    def __init__(self, src, fail_at=None):
        self.src, self.fail_at, self.calls = src, fail_at, []

    def append_record(self, dataset, body, seq=-1, restore=False,
                      trace=""):
        if self.fail_at is not None and len(self.calls) == self.fail_at:
            raise RuntimeError("sink refused")
        self.calls.append((dataset, bytes(body), seq, restore,
                           self.src.fetched))
        return {"ok": True}


def test_relay_wal_streams_one_segment_at_a_time(tmp_path):
    """The handoff's WAL tail holds one source segment at a time, and
    relays the records the reference's relay_wal relays, in its order
    and to the byte."""
    from filodb_tpu.replication.catchup import relay_wal as ref_relay
    from filodb_tpu_torch.replication import ReplicaClient
    from filodb_tpu_torch.replication.catchup import relay_wal
    wal, srv = _segmented_door(tmp_path)
    try:
        nseg = len(wal.writer.snapshot_segments()[0])
        assert nseg >= 4
        got, want = {}, {}
        for relay, out in ((relay_wal, got), (ref_relay, want)):
            src = _CountingSource(ReplicaClient(*srv.address))
            sink = _RecordingSink(src)
            n = relay(src, sink, DS, shards=[1], since_seq=2)
            assert n == len(sink.calls)
            out["calls"], out["nseg"] = sink.calls, src.fetched
        assert [c[:4] for c in got["calls"]] == \
            [c[:4] for c in want["calls"]]
        assert [c[2] for c in got["calls"]] == [3, 5, 7, 9, 11]
        # the segments holding seq 2 and later, each once
        assert got["nseg"] == want["nseg"] == sum(
            last >= 2 for _, last, _, _ in wal.writer.snapshot_segments()[0])
        # each record left before the next segment arrived
        seen = [c[4] for c in got["calls"]]
        assert seen == sorted(seen) and seen[0] < got["nseg"] \
            and len(set(seen)) > 1
    finally:
        srv.stop()
        wal.close()


def test_relay_wal_failure_drops_the_source_stream(tmp_path):
    """A relay that fails mid-stream drops the source's connection, so
    the next call on that client reads its own reply, not the rest of
    the stream; a source without a WAL relays nothing."""
    from filodb_tpu_torch.replication import ReplicaClient, ReplicationServer
    from filodb_tpu_torch.replication.catchup import relay_wal
    wal, srv = _segmented_door(tmp_path)
    bare = ReplicationServer(TimeSeriesMemStore(device="cpu"),
                             node="Q").start()
    try:
        cli = ReplicaClient(*srv.address)
        src = _CountingSource(cli)
        with pytest.raises(RuntimeError, match="sink refused"):
            relay_wal(src, _RecordingSink(src, fail_at=1), DS)
        assert src.fetched < len(wal.writer.snapshot_segments()[0])
        assert cli.ping()["node"] == "P"
        assert cli.horizons(DS) == {}
        empty = ReplicaClient(*bare.address)
        assert relay_wal(empty, _RecordingSink(src), DS) == 0
        assert empty.ping()["node"] == "Q"
    finally:
        bare.stop()
        srv.stop()
        wal.close()


def test_replicated_cluster_holds_its_clients_to_the_append_timeout():
    cluster = make_replicated_cluster(nodes=("A", "B", "C"), num_shards=2,
                                      append_timeout_s=42.0, device="cpu")
    try:
        assert cluster.manager.cfg.append_timeout_s == 42.0
        assert {c.timeout_s for c in cluster.repl_clients.values()} \
            == {42.0}
    finally:
        cluster.stop()
    cluster = make_replicated_cluster(nodes=("A", "B"), num_shards=2,
                                      device="cpu")
    try:
        assert {c.timeout_s for c in cluster.repl_clients.values()} \
            == {10.0}
    finally:
        cluster.stop()


def test_wal_snapshot_segments_safe_bytes(tmp_path):
    """The active segment's snapshot byte range decodes completely —
    whole frames only, no torn tail inside safe_bytes."""
    from filodb_tpu_torch.wal.segment import WalRecord, read_records
    from filodb_tpu_torch.wal.writer import WalWriter
    w = WalWriter(str(tmp_path), dataset=DS)
    keys = _keys(4)
    for b in range(5):
        ts, vals = _grid(4, 8, base_idx=b * 8)
        w.append(WalRecord(0, 0, PROM_COUNTER.name, keys, ts,
                           {"count": vals}))
    segs, committed = w.snapshot_segments()
    assert committed == 4
    assert segs, "active segment must appear in the snapshot"
    first, last, path, safe = segs[-1]
    assert last == 4
    data = open(path, "rb").read(safe)
    clone = str(tmp_path / "clone.seg")
    with open(clone, "wb") as f:
        f.write(data)
    tables = {}
    seqs = [WalRecord.decode(body, tables).seq
            for body in read_records(clone)]
    assert seqs == [0, 1, 2, 3, 4]
    w.close()


# ------------------------------------------------- query-time failover


def _fill_cluster(cluster, n_series=32, n_samples=64):
    keys = _keys(n_series)
    ts, vals = _grid(n_series, n_samples)
    for s in range(cluster.mapper.num_shards):
        skeys = [PartKey.make("repl_total",
                             {"_ws_": "w", "_ns_": f"s{s}",
                              "i": str(i)}) for i in range(n_series)]
        cluster.ingest_grid(s, PROM_COUNTER.name, skeys, ts,
                            {"count": vals})
    return keys, ts, vals


QUERY = 'sum by (_ns_)(rate(repl_total[5m]))'
QS = START // 1000 + 600
QE = START // 1000 + 630


def _payload(res):
    from filodb_tpu_torch.query.engine import QueryEngine
    p = QueryEngine.to_prom_matrix(res)
    p.pop("traceID", None)
    return json.dumps(p, sort_keys=True)


def test_failover_serves_full_results_through_node_kill():
    from filodb_tpu_torch.parallel.breaker import breakers
    from filodb_tpu_torch.utils.metrics import registry
    breakers.reset()
    cluster = make_replicated_cluster(num_shards=2, with_truth=True,
                                      device="cpu")
    try:
        _fill_cluster(cluster)
        pp = PlannerParams(allow_partial_results=True)
        baseline = cluster.engine.query_range(QUERY, QS, 30, QE, pp)
        assert baseline.error is None and not baseline.partial
        groups = {k.labels_dict.get("_ns_")
                  for k, _, _ in baseline.series()}
        assert groups == {"s0", "s1"}
        # kill one node: every query stays FULL via replica failover
        victim = cluster.mapper.node_for_shard(0)
        fo0 = registry.counter("query_replica_failovers",
                               peer=cluster.mapper.replicas[0][0]).value
        cluster.kill(victim)
        for _ in range(4):
            res = cluster.engine.query_range(QUERY, QS, 30, QE, pp)
            assert res.error is None, res.error
            assert not res.partial, "failover must beat the partial path"
            got = {k.labels_dict.get("_ns_") for k, _, _ in res.series()}
            assert got == {"s0", "s1"}, f"missing groups: {got}"
            assert _payload(res) == _payload(baseline)
        fo1 = registry.counter("query_replica_failovers",
                               peer=cluster.mapper.replicas[0][0]).value
        assert fo1 > fo0, "failover counter must prove the replica served"
    finally:
        cluster.stop()
        breakers.reset()


def test_partials_only_when_all_owners_dead():
    from filodb_tpu_torch.parallel.breaker import breakers
    breakers.reset()
    cluster = make_replicated_cluster(num_shards=2, device="cpu")
    try:
        _fill_cluster(cluster)
        # kill EVERY owner of shard 0; shard 1 keeps at least one owner
        dead = set(cluster.mapper.owners(0))
        survivors = [n for n in cluster.mapper.owners(1)
                     if n not in dead]
        assert survivors, "fixture must leave shard 1 an owner"
        for n in dead:
            cluster.kill(n)
        pp = PlannerParams(allow_partial_results=True)
        res = cluster.engine.query_range(QUERY, QS, 30, QE, pp)
        assert res.error is None, res.error
        assert res.partial, "all owners dead -> flagged partial"
        got = {k.labels_dict.get("_ns_") for k, _, _ in res.series()}
        assert "s0" not in got
    finally:
        cluster.stop()
        breakers.reset()


# ------------------------------------------------------- gather dedup


def test_gather_dedups_duplicate_shard_children():
    """Both owners of a shard materialized (handoff window): the shard
    contributes exactly once to concat AND aggregation."""
    from filodb_tpu_torch.core.index import Equals
    from filodb_tpu_torch.query.exec import (AggregateMapReduce,
                                             AggregatePresenter,
                                             LocalPartitionDistConcatExec,
                                             MultiSchemaPartitionsExec,
                                             PeriodicSamplesMapper,
                                             ReduceAggregateExec)
    from filodb_tpu_torch.query.rangevector import QueryContext
    from filodb_tpu_torch.utils.metrics import registry
    ms = TimeSeriesMemStore(device="cpu")
    ms.setup(DS, 0)
    keys = _keys(8)
    ts, vals = _grid(8, 64)
    ms.get_shard(DS, 0).ingest_columns(PROM_COUNTER.name, keys, ts,
                                       {"count": vals})

    def leaf():
        lf = MultiSchemaPartitionsExec(
            QueryContext(), DS, 0, [Equals("_metric_", "repl_total")],
            START, START + 64 * 10_000)
        lf.add_transformer(PeriodicSamplesMapper(
            QS * 1000, 30_000, QE * 1000, 300_000, "rate", ()))
        lf.add_transformer(AggregateMapReduce("sum", (), ("_ns_",), ()))
        return lf

    single = ReduceAggregateExec(QueryContext(), [leaf()], "sum")
    single.add_transformer(AggregatePresenter("sum", ()))
    want = single.execute(ms)
    assert want.error is None

    before = registry.counter("query_shard_dedup").value
    dup = ReduceAggregateExec(QueryContext(), [leaf(), leaf()], "sum")
    dup.add_transformer(AggregatePresenter("sum", ()))
    got = dup.execute(ms)
    assert got.error is None
    assert registry.counter("query_shard_dedup").value > before
    np.testing.assert_allclose(np.asarray(got.blocks[0].values),
                               np.asarray(want.blocks[0].values))

    # concat path too: series count must not double
    def leaf_raw():
        lf = MultiSchemaPartitionsExec(
            QueryContext(), DS, 0, [Equals("_metric_", "repl_total")],
            START, START + 64 * 10_000)
        lf.add_transformer(PeriodicSamplesMapper(
            QS * 1000, 30_000, QE * 1000, 300_000, "rate", ()))
        return lf

    single_cat = LocalPartitionDistConcatExec(QueryContext(),
                                              [leaf_raw()])
    want_cat = single_cat.execute(ms)
    cat = LocalPartitionDistConcatExec(QueryContext(),
                                       [leaf_raw(), leaf_raw()])
    res = cat.execute(ms)
    assert res.error is None
    assert len(res.blocks[0].keys) == len(want_cat.blocks[0].keys)


def test_gather_never_dedups_different_selectors_on_one_shard():
    """Regression: a ShardKeyRegexPlanner fan-out legitimately puts two
    same-shard leaves with DIFFERENT selectors under one concat — the
    dedup key must include the selector, or one combo's data silently
    vanishes from a FULL result."""
    from filodb_tpu_torch.core.index import Equals
    from filodb_tpu_torch.query.exec import (LocalPartitionDistConcatExec,
                                             MultiSchemaPartitionsExec,
                                             PeriodicSamplesMapper)
    from filodb_tpu_torch.query.rangevector import QueryContext
    ms = TimeSeriesMemStore(device="cpu")
    ms.setup(DS, 0)
    ts, vals = _grid(4, 64)
    for ns in ("a", "b"):
        keys = [PartKey.make("repl_total",
                             {"_ws_": "w", "_ns_": ns, "i": str(i)})
                for i in range(4)]
        ms.get_shard(DS, 0).ingest_columns(PROM_COUNTER.name, keys, ts,
                                           {"count": vals})

    def leaf(ns):
        lf = MultiSchemaPartitionsExec(
            QueryContext(), DS, 0,
            [Equals("_metric_", "repl_total"), Equals("_ns_", ns)],
            START, START + 64 * 10_000)
        lf.add_transformer(PeriodicSamplesMapper(
            QS * 1000, 30_000, QE * 1000, 300_000, "rate", ()))
        return lf

    cat = LocalPartitionDistConcatExec(QueryContext(),
                                       [leaf("a"), leaf("b")])
    res = cat.execute(ms)
    assert res.error is None
    got_ns = {k.labels_dict.get("_ns_") for k in res.blocks[0].keys}
    assert got_ns == {"a", "b"}, \
        f"a shard-key combo was wrongly deduped away: {got_ns}"


def test_gather_twin_absorbs_shard_unavailable():
    """First-listed owner dead, duplicate twin healthy: the twin answers
    — no partial flag, no error (the handoff-window contract)."""
    from filodb_tpu_torch.core.index import Equals
    from filodb_tpu_torch.query.exec import (AggregateMapReduce,
                                             AggregatePresenter,
                                             MultiSchemaPartitionsExec,
                                             PeriodicSamplesMapper,
                                             QueryError,
                                             ReduceAggregateExec)
    from filodb_tpu_torch.query.execbase import PlanDispatcher
    from filodb_tpu_torch.query.rangevector import QueryContext
    ms = TimeSeriesMemStore(device="cpu")
    ms.setup(DS, 0)
    keys = _keys(4)
    ts, vals = _grid(4, 64)
    ms.get_shard(DS, 0).ingest_columns(PROM_COUNTER.name, keys, ts,
                                       {"count": vals})

    class _DeadDispatcher(PlanDispatcher):
        def dispatch(self, plan, source):
            raise QueryError("shard_unavailable", "owner SIGKILLed")

    def leaf(dead=False):
        lf = MultiSchemaPartitionsExec(
            QueryContext(), DS, 0, [Equals("_metric_", "repl_total")],
            START, START + 64 * 10_000)
        lf.add_transformer(PeriodicSamplesMapper(
            QS * 1000, 30_000, QE * 1000, 300_000, "rate", ()))
        lf.add_transformer(AggregateMapReduce("sum", (), ("_ns_",), ()))
        if dead:
            lf.dispatcher = _DeadDispatcher()
        return lf

    want = ReduceAggregateExec(QueryContext(), [leaf()], "sum")
    want.add_transformer(AggregatePresenter("sum", ()))
    base = want.execute(ms)

    plan = ReduceAggregateExec(QueryContext(),
                               [leaf(dead=True), leaf()], "sum")
    plan.add_transformer(AggregatePresenter("sum", ()))
    res = plan.execute(ms)
    assert res.error is None, res.error
    assert not res.partial
    np.testing.assert_allclose(np.asarray(res.blocks[0].values),
                               np.asarray(base.blocks[0].values))


# ------------------------------------------------------------- handoff


def test_handoff_state_machine_and_journal():
    cluster = make_replicated_cluster(nodes=("A", "B", "C"),
                                      num_shards=2, with_truth=True,
                                      device="cpu")
    try:
        _fill_cluster(cluster)
        pp = PlannerParams()
        baseline = cluster.engine.query_range(QUERY, QS, 30, QE, pp)
        assert baseline.error is None
        shard = 0
        from_node = cluster.mapper.node_for_shard(shard)
        owners = set(cluster.mapper.owners(shard))
        target = next(n for n in ("A", "B", "C") if n not in owners)
        from filodb_tpu_torch.replication import HandoffCoordinator
        coord = HandoffCoordinator(DS, cluster.mapper,
                                   lambda n: cluster.repl_clients[n])
        seq0 = journal.next_seq
        summary = coord.handoff(shard, target)
        assert summary["states"][-1] == "done"
        assert cluster.mapper.node_for_shard(shard) == target
        assert from_node not in cluster.mapper.owners(shard)
        # the old owner's copy was tombstoned
        assert cluster.stores[from_node].get_shard(DS, shard) is None
        # the new owner answers; results byte-identical to pre-handoff
        res = cluster.engine.query_range(QUERY, QS, 30, QE, pp)
        assert res.error is None and not res.partial
        assert _payload(res) == _payload(baseline)
        kinds = [e["kind"] for e in journal.since(seq0 - 1)]
        assert "shard_handoff_started" in kinds
        assert "shard_handoff_done" in kinds
        states = [e["state"] for e in journal.since(seq0 - 1)
                  if e["kind"] == "shard_handoff"]
        assert states == ["register", "stream_snapshot",
                          "stream_wal_tail", "cutover", "tombstone",
                          "done"]
    finally:
        cluster.stop()


def test_handoff_failure_journals_and_rolls_back():
    from filodb_tpu_torch.replication import (HandoffCoordinator,
                                              HandoffError, ReplicaClient)
    cluster = make_replicated_cluster(nodes=("A", "B", "C"),
                                      num_shards=2, device="cpu")
    try:
        _fill_cluster(cluster)
        shard = 0
        owners_before = list(cluster.mapper.owners(shard))
        target = next(n for n in ("A", "B", "C")
                      if n not in owners_before)
        # target's replication door is dead -> the snapshot stream fails
        cluster.repl_servers[target].stop()
        dead_client = ReplicaClient(*cluster.repl_servers[target].address,
                                    timeout_s=1.0)

        def client_for(n):
            return dead_client if n == target \
                else cluster.repl_clients[n]

        coord = HandoffCoordinator(DS, cluster.mapper, client_for)
        seq0 = journal.next_seq
        with pytest.raises(HandoffError):
            coord.handoff(shard, target)
        fails = [e for e in journal.since(seq0 - 1)
                 if e["kind"] == "shard_handoff_failed"]
        assert fails and fails[0]["state"] in ("register",
                                               "stream_snapshot")
        # rollback: the half-registered target left the assignment list
        assert cluster.mapper.owners(shard) == owners_before
    finally:
        cluster.stop()


# ------------------------------------------------- health + admin surface


def test_health_degrades_on_zero_live_replicas():
    from filodb_tpu_torch.utils.health import (DEGRADED, FAILED, OK,
                                               HealthEvaluator, SERVING)
    ev = HealthEvaluator(phase=SERVING)
    m = ShardMapper(2, replication_factor=2)
    ev.shard_mappers = {DS: m}
    for s in (0, 1):
        m.update_from_event(ShardEvent("IngestionStarted", DS, s, "A"))
        m.register_replica(s, "B", status=ShardStatus.ACTIVE)
    assert ev._shards_verdict()["status"] == OK
    # replica of shard 0 dies: primary serves, but one failure from
    # partials -> degraded
    m.unassign_replica(0, "B")
    sv = ev._shards_verdict()
    assert sv["status"] == DEGRADED
    assert sv["datasets"][DS]["underReplicated"] == 1
    # every owner of shard 0 dead -> failed
    m.update_from_event(ShardEvent("ShardDown", DS, 0, "A"))
    sv = ev._shards_verdict()
    assert sv["status"] == FAILED
    assert sv["datasets"][DS]["noLiveOwners"] == 1


def test_ready_503_while_draining():
    from filodb_tpu_torch.utils.health import HealthEvaluator, SERVING
    ev = HealthEvaluator(phase=SERVING)
    ok, _ = ev.ready()
    assert ok
    ev.draining = "drained 4 shard(s) off A"
    ok, reason = ev.ready()
    assert not ok and "draining" in reason


def test_admin_shards_route_and_cli_shape():
    from filodb_tpu_torch.http.routes import PromHttpApi
    api = PromHttpApi({})
    m = ShardMapper(2, replication_factor=2)
    m.update_from_event(ShardEvent("IngestionStarted", DS, 0, "A"))
    m.register_replica(0, "B", status=ShardStatus.ACTIVE)
    api.shard_mappers[DS] = m
    st, payload = api.handle("GET", "/admin/shards", {})
    assert st == 200
    ent = payload["data"]["datasets"][DS]
    assert ent["replicationFactor"] == 2
    row = ent["shards"][0]
    assert row["primary"] == "A"
    assert row["replicas"] == [{"node": "B", "status": "Active"}]
    assert row["liveOwners"] == 2
    st, _ = api.handle("GET", "/admin/shards", {"dataset": "nope"})
    assert st == 404
    # handoff route without a coordinator is a clean 400
    st, payload = api.handle("POST", "/admin/shards/0/handoff",
                             {"to": "B"}, b"")
    assert st == 400


def test_admin_shards_handoff_route_drives_coordinator():
    cluster = make_replicated_cluster(nodes=("A", "B", "C"),
                                      num_shards=2, device="cpu")
    try:
        _fill_cluster(cluster)
        from filodb_tpu_torch.http.routes import PromHttpApi
        from filodb_tpu_torch.replication import HandoffCoordinator
        api = PromHttpApi({})
        api.default_dataset = DS
        api.shard_mappers[DS] = cluster.mapper
        api.handoffs[DS] = HandoffCoordinator(
            DS, cluster.mapper, lambda n: cluster.repl_clients[n])
        shard = 0
        owners = set(cluster.mapper.owners(shard))
        target = next(n for n in ("A", "B", "C") if n not in owners)
        st, payload = api.handle(
            "POST", f"/admin/shards/{shard}/handoff",
            {"drain": "true"},
            json.dumps({"to": target}).encode())
        assert st == 200, payload
        assert payload["data"]["to"] == target
        assert cluster.mapper.node_for_shard(shard) == target
        # drain=true flipped readiness
        ok, reason = api.health.ready()
        assert not ok and "handed off" in reason
        # a bad target is a structured 409, not a 500
        st, payload = api.handle(
            "POST", f"/admin/shards/{shard}/handoff", {},
            json.dumps({"to": target}).encode())
        assert st == 409
    finally:
        cluster.stop()


# ----------------------------------- chaos-style: traffic through handoff


@pytest.mark.replication
def test_live_handoff_under_traffic_zero_failed_queries():
    """The acceptance drill: ingest+query traffic runs while a shard
    hands off — zero failed queries, zero partials, and the final
    query_range is byte-identical to an undisturbed truth store."""
    cluster = make_replicated_cluster(nodes=("A", "B", "C"),
                                      num_shards=2, with_truth=True,
                                      device="cpu")
    try:
        n_series, n_samples = 16, 64
        skeys = {s: [PartKey.make("repl_total",
                                  {"_ws_": "w", "_ns_": f"s{s}",
                                   "i": str(i)})
                     for i in range(n_series)]
                 for s in range(2)}
        ts, vals = _grid(n_series, n_samples)
        for s in range(2):
            cluster.ingest_grid(s, PROM_COUNTER.name, skeys[s], ts,
                                {"count": vals})
        stop = threading.Event()
        qerrs, qpartials, qok = [], [], [0]
        tick = [n_samples]

        def query_loop():
            pp = PlannerParams(allow_partial_results=True)
            while not stop.is_set():
                res = cluster.engine.query_range(QUERY, QS, 30, QE, pp)
                if res.error is not None:
                    qerrs.append(res.error)
                elif res.partial:
                    qpartials.append(True)
                else:
                    qok[0] += 1
                time.sleep(0.02)

        def ingest_loop():
            while not stop.is_set():
                b = tick[0]
                tick[0] += 1
                for s in range(2):
                    ts2, vals2 = _grid(n_series, 1, base_idx=b)
                    cluster.ingest_grid(s, PROM_COUNTER.name, skeys[s],
                                        ts2, {"count": vals2})
                time.sleep(0.02)

        threads = [threading.Thread(target=query_loop, daemon=True),
                   threading.Thread(target=ingest_loop, daemon=True)]
        for t in threads:
            t.start()
        time.sleep(1.0)
        from filodb_tpu_torch.replication import HandoffCoordinator
        shard = 0
        owners = set(cluster.mapper.owners(shard))
        target = next(n for n in ("A", "B", "C") if n not in owners)
        coord = HandoffCoordinator(DS, cluster.mapper,
                                   lambda n: cluster.repl_clients[n])
        summary = coord.handoff(shard, target)
        assert summary["states"][-1] == "done"
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(timeout=10)
        assert not qerrs, f"queries failed during handoff: {qerrs[:3]}"
        assert not qpartials, "no partials during a handoff"
        # CPU XLA recompiles per fresh-shape poll make the loop slow;
        # the gates above cover every query that DID run
        assert qok[0] >= 1
        # quiesce: final answer identical to the undisturbed truth store
        res = cluster.engine.query_range(QUERY, QS, 30, QE,
                                         PlannerParams())
        from filodb_tpu_torch.query.engine import QueryEngine
        tmapper = ShardMapper(2)
        for s in range(2):
            tmapper.update_from_event(
                ShardEvent("IngestionStarted", DS, s, "local"))
        truth_engine = QueryEngine(DS, cluster.truth, tmapper,
                                   device="cpu")
        want = truth_engine.query_range(QUERY, QS, 30, QE,
                                        PlannerParams())
        assert res.error is None and want.error is None
        got = {k.labels_dict["_ns_"]: np.asarray(v)
               for k, _, v in res.series()}
        exp = {k.labels_dict["_ns_"]: np.asarray(v)
               for k, _, v in want.series()}
        assert set(got) == {"s0", "s1"}
        for g in got:
            np.testing.assert_allclose(got[g], exp[g])
    finally:
        cluster.stop()


# ------------------------------------- small handoff under polling queries


def test_handoff_under_polling_queries_zero_failed():
    """Tier-1's counterpart of the drill above: a client thread polls
    the panel while a shard hands off — no failed query, no partial,
    and the answer after the tombstone equals the one before."""
    cluster = make_replicated_cluster(nodes=("A", "B", "C"),
                                      num_shards=2, device="cpu")
    try:
        _fill_cluster(cluster, n_series=16)
        pp = PlannerParams(allow_partial_results=True)
        baseline = cluster.engine.query_range(QUERY, QS, 30, QE, pp)
        assert baseline.error is None and not baseline.partial
        stop = threading.Event()
        outcomes = []

        def poll():
            while not stop.is_set():
                res = cluster.engine.query_range(QUERY, QS, 30, QE, pp)
                outcomes.append((res.error, res.partial))

        t = threading.Thread(target=poll, daemon=True)
        t.start()
        time.sleep(0.2)
        from filodb_tpu_torch.replication import HandoffCoordinator
        owners = set(cluster.mapper.owners(0))
        target = next(n for n in ("A", "B", "C") if n not in owners)
        coord = HandoffCoordinator(DS, cluster.mapper,
                                   lambda n: cluster.repl_clients[n])
        assert coord.handoff(0, target)["states"][-1] == "done"
        time.sleep(0.2)
        stop.set()
        t.join(timeout=10)
        assert outcomes
        assert [o for o in outcomes if o[0] is not None] == []
        assert not any(p for _, p in outcomes)
        res = cluster.engine.query_range(QUERY, QS, 30, QE, pp)
        assert _payload(res) == _payload(baseline)
    finally:
        cluster.stop()


# ------------------------------------------------- against the reference


@pytest.fixture(autouse=True, scope="module")
def _clear_compile_journal():
    """The JAX engine journals jit compiles under its queries' trace ids,
    which the reference's health model reads as a compile storm for the
    next 120 s: clear it after this file."""
    yield
    from filodb_tpu.utils.events import journal as jjournal
    jjournal.clear()


class _Pkg:
    """One package's replication surface, by name."""

    def __init__(self, name):
        self.name = name
        if name == "jax":
            from filodb_tpu import replication
            from filodb_tpu.core.memstore import TimeSeriesMemStore as Ms
            from filodb_tpu.core.partkey import PartKey as Pk
            from filodb_tpu.http.routes import PromHttpApi
            from filodb_tpu.parallel import testcluster
            from filodb_tpu.parallel.shardmapper import (ShardEvent as Ev,
                                                         ShardMapper as Mp)
            from filodb_tpu.parallel.transport import (NodeQueryServer,
                                                       RemoteNodeDispatcher)
            from filodb_tpu.query.engine import QueryEngine
            from filodb_tpu.query.planner import SingleClusterPlanner
            from filodb_tpu.query.rangevector import PlannerParams as Pp
            from filodb_tpu.utils.events import journal as jr
            from filodb_tpu.wal import WalManager
            from filodb_tpu.wal.segment import WalRecord
            kw = {}
        else:
            from filodb_tpu_torch import replication
            from filodb_tpu_torch.core.memstore import TimeSeriesMemStore as Ms
            from filodb_tpu_torch.core.partkey import PartKey as Pk
            from filodb_tpu_torch.http.routes import PromHttpApi
            from filodb_tpu_torch.parallel import testcluster
            from filodb_tpu_torch.parallel.shardmapper import (
                ShardEvent as Ev, ShardMapper as Mp)
            from filodb_tpu_torch.parallel.transport import (
                NodeQueryServer, RemoteNodeDispatcher)
            from filodb_tpu_torch.query.engine import QueryEngine
            from filodb_tpu_torch.query.planner import SingleClusterPlanner
            from filodb_tpu_torch.query.rangevector import PlannerParams as Pp
            from filodb_tpu_torch.utils.events import journal as jr
            from filodb_tpu_torch.wal import WalManager
            from filodb_tpu_torch.wal.segment import WalRecord
            kw = {"device": "cpu"}
        self.repl, self.PartKey, self.Api = replication, Pk, PromHttpApi
        self.testcluster, self.Event, self.Mapper = testcluster, Ev, Mp
        self.Server, self.Dispatcher = NodeQueryServer, RemoteNodeDispatcher
        self.Engine, self.Planner, self.Params = (QueryEngine,
                                                  SingleClusterPlanner, Pp)
        self.journal, self.Wal, self.Record = jr, WalManager, WalRecord
        self.kw = kw
        self._Ms = Ms

    def store(self):
        return self._Ms(**self.kw)

    def cluster(self, **kw):
        return self.testcluster.make_replicated_cluster(**kw, **self.kw)

    def engine(self, store, mapper, **kw):
        return self.Engine(DS, store, mapper, **kw, **self.kw)

    def keys(self, s, n=32):
        return [self.PartKey.make("repl_total",
                                  {"_ws_": "w", "_ns_": f"s{s}",
                                   "i": str(i)}) for i in range(n)]


PORT, REF = _Pkg("port"), _Pkg("jax")
GAUGE_Q = 'sum by (_ns_)(repl_total)'


def _series_of(res):
    assert res.error is None, res.error
    return {k.labels_dict["_ns_"]: np.asarray(v, np.float64)
            for k, _, v in res.series()}


def _assert_same(got, want, exact):
    assert set(got) == set(want) and got
    for g in want:
        if exact:
            np.testing.assert_array_equal(got[g], want[g], err_msg=g)
        else:
            np.testing.assert_allclose(got[g], want[g], rtol=2e-4,
                                       atol=1e-3, err_msg=g)


def _fill_pkg(pkg, cluster, n_series=32, n_samples=64):
    ts, vals = _grid(n_series, n_samples)
    for s in range(cluster.mapper.num_shards):
        cluster.ingest_grid(s, PROM_COUNTER.name, pkg.keys(s, n_series),
                            ts, {"count": vals})


def test_same_data_answers_as_reference_cluster():
    """Both packages' RF-2 clusters over the same slabs: the same full
    answers before and after the same node's death."""
    from filodb_tpu.parallel.breaker import breakers as jbreakers
    from filodb_tpu_torch.parallel.breaker import breakers
    breakers.reset()
    jbreakers.reset()
    clusters = {p.name: p.cluster(num_shards=2) for p in (PORT, REF)}
    try:
        for p in (PORT, REF):
            _fill_pkg(p, clusters[p.name])
        assert clusters["port"].mapper.owners(0) == \
            clusters["jax"].mapper.owners(0)
        for step in ("full", "killed"):
            for q, exact in ((GAUGE_Q, True), (QUERY, False)):
                got = {}
                for p in (PORT, REF):
                    c = clusters[p.name]
                    res = c.engine.query_range(
                        q, QS, 30, QE,
                        p.Params(allow_partial_results=True))
                    assert not res.partial
                    got[p.name] = _series_of(res)
                _assert_same(got["port"], got["jax"], exact)
            if step == "full":
                for c in clusters.values():
                    c.kill(c.mapper.node_for_shard(0))
    finally:
        for c in clusters.values():
            c.stop()
        breakers.reset()
        jbreakers.reset()


def _mixed_cluster(coord_pkg, wal_root):
    """Two nodes: "P" (a port memstore behind the port's query server and
    replication door, with a port WAL) and "J" (the same of the JAX
    package).  Shard 0's primary is P with J its replica, shard 1's the
    reverse.  `coord_pkg` builds the mapper, the fan-out manager and the
    coordinator."""
    nodes = {}
    for name, pkg in (("P", PORT), ("J", REF)):
        ms = pkg.store()
        for s in (0, 1):
            ms.setup(DS, s)
        wal = pkg.Wal(os.path.join(wal_root, name), DS)
        nodes[name] = {
            "pkg": pkg, "store": ms, "wal": wal,
            "query": pkg.Server(ms).start(),
            "repl": pkg.repl.ReplicationServer(ms, node=name,
                                               wals={DS: wal}).start()}
    mapper = coord_pkg.Mapper(2, replication_factor=2)
    for s, (primary, replica) in enumerate((("P", "J"), ("J", "P"))):
        mapper.update_from_event(coord_pkg.Event("IngestionStarted", DS, s,
                                                 primary))
        mapper.update_from_event(coord_pkg.Event("ReplicaAssigned", DS, s,
                                                 replica))
        mapper.update_from_event(coord_pkg.Event("ReplicaActive", DS, s,
                                                 replica))
    clients = {n: coord_pkg.repl.ReplicaClient(*nd["repl"].address)
               for n, nd in nodes.items()}
    manager = coord_pkg.repl.ReplicationManager(DS, mapper,
                                                lambda n: clients[n])
    disp = {n: coord_pkg.Dispatcher(*nd["query"].address)
            for n, nd in nodes.items()}
    from_mod = coord_pkg.repl.failover_dispatcher_factory
    planner = coord_pkg.Planner(DS, mapper,
                                dispatcher_factory=from_mod(
                                    mapper, lambda n: disp[n]))
    engine = coord_pkg.engine(coord_pkg.store(), mapper, planner=planner)
    return nodes, mapper, manager, clients, engine


def _stop_mixed(nodes, manager):
    manager.stop()
    for nd in nodes.values():
        for srv in (nd["query"], nd["repl"]):
            try:
                srv.stop()
            except OSError:
                pass
        nd["wal"].close()


@pytest.mark.parametrize("coord", ["port", "jax"])
def test_mixed_cluster_replicates_and_fails_over(tmp_path, coord):
    """A port primary with a JAX replica and the reverse, driven by
    either package's fan-out and coordinator: both copies of each shard
    hold the slabs, the answer equals the coordinator package's single
    store of everything, and after either node dies it stays full and
    the same."""
    from filodb_tpu.parallel.breaker import breakers as jbreakers
    from filodb_tpu_torch.parallel.breaker import breakers
    breakers.reset()
    jbreakers.reset()
    pkg = PORT if coord == "port" else REF
    nodes, mapper, manager, _, engine = _mixed_cluster(pkg, str(tmp_path))
    truth = pkg.store()
    tmapper = pkg.Mapper(2)
    ts, vals = _grid(32, 64)
    try:
        for s in (0, 1):
            res = manager.replicate(s, PROM_COUNTER.name, pkg.keys(s), ts,
                                    {"count": vals}, require_primary=True)
            assert sorted(res.acked) == ["J", "P"]
            truth.setup(DS, s).ingest_columns(
                PROM_COUNTER.name, pkg.keys(s), ts, {"count": vals})
            tmapper.update_from_event(pkg.Event("IngestionStarted", DS, s,
                                                "t"))
            for nd in nodes.values():
                assert nd["store"].get_shard(DS, s).num_partitions == 32
        single = pkg.engine(truth, tmapper)
        pp = pkg.Params(allow_partial_results=True)
        want = {q: _series_of(single.query_range(q, QS, 30, QE))
                for q in (GAUGE_Q, QUERY)}
        for q, exact in ((GAUGE_Q, True), (QUERY, False)):
            res = engine.query_range(q, QS, 30, QE, pp)
            assert not res.partial
            _assert_same(_series_of(res), want[q], exact)
        victim = "P" if coord == "port" else "J"
        nodes[victim]["query"].stop()
        nodes[victim]["repl"].stop()
        for q, exact in ((GAUGE_Q, True), (QUERY, False)):
            res = engine.query_range(q, QS, 30, QE, pp)
            assert res.error is None and not res.partial
            _assert_same(_series_of(res), want[q], exact)
    finally:
        _stop_mixed(nodes, manager)
        breakers.reset()
        jbreakers.reset()


@pytest.mark.parametrize("src, dst", [("J", "P"), ("P", "J")])
def test_mixed_catchup_and_handoff_across_packages(tmp_path, src, dst):
    """WAL catch-up from one package's door into the other's memstore,
    and a live handoff between the two packages' doors: the moved copy
    answers as the source did."""
    from filodb_tpu.parallel.breaker import breakers as jbreakers
    from filodb_tpu_torch.parallel.breaker import breakers
    breakers.reset()
    jbreakers.reset()
    nodes, mapper, manager, clients, engine = _mixed_cluster(
        PORT, str(tmp_path))
    ts, vals = _grid(32, 64)
    try:
        for s in (0, 1):
            manager.replicate(s, PROM_COUNTER.name, PORT.keys(s), ts,
                              {"count": vals}, require_primary=True)
        # catch-up: a fresh store of dst's package replays src's WAL
        fresh = nodes[dst]["pkg"].store()
        cli = nodes[dst]["pkg"].repl.ReplicaClient(
            *nodes[src]["repl"].address)
        stats = nodes[dst]["pkg"].repl.catchup_shards(
            cli, DS, fresh, shards=[0, 1], node=dst)
        assert stats.records == 2 and stats.samples == 2 * 32 * 64
        for s in (0, 1):
            a = nodes[src]["store"].get_shard(DS, s)
            b = fresh.get_shard(DS, s)
            ra = a.stores[PROM_COUNTER.name]
            rb = b.stores[PROM_COUNTER.name]
            assert ra.num_series == rb.num_series == 32
            np.testing.assert_array_equal(
                ra.cols["count"][:32, :64], rb.cols["count"][:32, :64])
        # handoff: the shard whose primary is src moves to a third,
        # empty node of dst's package
        pkg3 = nodes[dst]["pkg"]
        ms3 = pkg3.store()
        q3 = pkg3.Server(ms3).start()
        r3 = pkg3.repl.ReplicationServer(ms3, node="N").start()
        clients["N"] = PORT.repl.ReplicaClient(*r3.address)
        try:
            shard = 0 if src == "P" else 1
            pp = PlannerParams(allow_partial_results=True)
            before = _series_of(engine.query_range(QUERY, QS, 30, QE, pp))
            coord = PORT.repl.HandoffCoordinator(DS, mapper,
                                                 lambda n: clients[n])
            disp = PORT.Dispatcher(*q3.address)
            summary = coord.handoff(shard, "N")
            assert summary["states"][-1] == "done"
            assert nodes[src]["store"].get_shard(DS, shard) is None
            assert ms3.get_shard(DS, shard).num_partitions == 32
            from filodb_tpu_torch.replication import \
                failover_dispatcher_factory
            base = {n: PORT.Dispatcher(*nd["query"].address)
                    for n, nd in nodes.items()}
            base["N"] = disp
            engine.planner.dispatcher_factory = \
                failover_dispatcher_factory(mapper, lambda n: base[n])
            after = _series_of(engine.query_range(QUERY, QS, 30, QE, pp))
            _assert_same(after, before, True)
        finally:
            q3.stop()
            r3.stop()
    finally:
        _stop_mixed(nodes, manager)
        breakers.reset()
        jbreakers.reset()


class _Recorder:
    """A fake replication door: records every byte a client sends and
    answers each verb with a canned reply (the frames' framing is the
    shared transport's: magic, u64 length, payload)."""

    REPLIES = {
        "ping": [{"ok": True, "node": "R", "owned": {}}],
        "append": [{"ok": True, "seq": 7, "ingested": 0,
                    "buffered": False}],
        "horizon": [{"ok": True, "horizons": {"0": 7}}],
        "drop_shard": [{"ok": True, "dropped": True}],
        "fetch_wal": [{"ok": True, "done": True, "segments": 0,
                       "committed_seq": -1}],
        "snapshot": [{"ok": True, "done": True, "records": 0,
                      "samples": 0}],
        "end_restore": [{"ok": True, "applied": 0}],
    }

    def __init__(self):
        import socketserver
        from filodb_tpu.parallel.transport import (_recv_frame,
                                                   recv_json_frame,
                                                   send_json_frame)
        self.raw = bytearray()
        outer = self

        class _Sock:
            def __init__(self, sock):
                self.sock = sock

            def recv(self, n):
                got = self.sock.recv(n)
                outer.raw += got
                return got

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = _Sock(self.request)
                try:
                    while True:
                        req = recv_json_frame(sock)
                        if req["cmd"] == "append":
                            _recv_frame(sock)
                        for r in outer.REPLIES.get(req["cmd"],
                                                   [{"ok": True}]):
                            send_json_frame(self.request, r)
                except (ConnectionError, OSError, ValueError):
                    return

        self.server = socketserver.ThreadingTCPServer(("127.0.0.1", 0),
                                                      _Handler)
        self.server.daemon_threads = True
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    @property
    def address(self):
        return self.server.server_address

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


def _client_verbs(pkg, rec):
    """Every client verb, and one fan-out through the package's manager,
    against the recorder; returns the bytes it received."""
    rec.raw.clear()
    cli = pkg.repl.ReplicaClient(*rec.address)
    ts, vals = _grid(4, 8)
    body = pkg.Record(3, 1, PROM_COUNTER.name, pkg.keys(1, 4), ts,
                      {"count": vals}).encode()
    cli.ping()
    cli.append_record(DS, body, seq=3)
    cli.append_record(DS, body, seq=4, restore=True, trace="ab" * 8)
    cli.begin_restore(DS, 1)
    cli.end_restore(DS, 1)
    cli.abort_restore(DS, 1)
    assert cli.horizons(DS) == {0: 7}
    assert list(cli.fetch_segments(DS, since_seq=2)) == []
    assert list(cli.snapshot_shard(DS, 1)) == []
    assert cli.drop_shard(DS, 1)
    mapper = pkg.Mapper(2, replication_factor=2)
    mapper.update_from_event(pkg.Event("IngestionStarted", DS, 1, "R"))
    manager = pkg.repl.ReplicationManager(DS, mapper, lambda n: cli)
    res = manager.replicate(1, PROM_COUNTER.name, pkg.keys(1, 4), ts,
                            {"count": vals}, seq=5)
    assert res.acked == ["R"]
    manager.stop()
    cli.reset()
    time.sleep(0.05)
    return bytes(rec.raw)


def test_replication_client_frames_equal_reference():
    rec = _Recorder()
    try:
        got = _client_verbs(PORT, rec)
        want = _client_verbs(REF, rec)
    finally:
        rec.stop()
    assert got and got == want


def _server_conversation(pkg, wal_root):
    """One scripted conversation with a package's replication door over
    a store and WAL built from the same slabs; returns every byte the
    door sent back."""
    from filodb_tpu.parallel.transport import (_recv_exact, _send_frame,
                                               send_json_frame)
    ms = pkg.store()
    wal = pkg.Wal(wal_root, DS)
    srv = pkg.repl.ReplicationServer(ms, node="S", wals={DS: wal}).start()
    out = bytearray()
    ts, vals = _grid(6, 16)
    # wait=True appends: one commit per record, so the segment bytes do
    # not depend on the committer thread's timing
    for s in (0, 1):
        seq = wal.append_grid(s, PROM_COUNTER.name, pkg.keys(s, 6), ts,
                              {"count": vals})
        ms.setup(DS, s).ingest_columns(PROM_COUNTER.name, pkg.keys(s, 6),
                                       ts, {"count": vals}, offset=seq)
    ts2, vals2 = _grid(6, 4, base_idx=16)
    body = pkg.Record(0, 1, PROM_COUNTER.name, pkg.keys(1, 6), ts2,
                      {"count": vals2}).encode()
    script = [
        ({"cmd": "ping"}, None, 1),
        ({"cmd": "horizon", "dataset": DS}, None, 1),
        ({"cmd": "begin_restore", "dataset": DS, "shard": 1}, None, 1),
        ({"cmd": "append", "dataset": DS, "seq": 9}, body, 1),
        ({"cmd": "end_restore", "dataset": DS, "shard": 1}, None, 1),
        ({"cmd": "horizon", "dataset": DS}, None, 1),
        ({"cmd": "snapshot", "dataset": DS, "shard": 1}, None, None),
        ({"cmd": "fetch_wal", "dataset": DS, "since_seq": -1}, None, None),
        ({"cmd": "abort_restore", "dataset": DS, "shard": 0}, None, 1),
        ({"cmd": "drop_shard", "dataset": DS, "shard": 1}, None, 1),
        ({"cmd": "nope"}, None, 1),
    ]
    import json as _json
    import socket as _socket
    sock = _socket.create_connection(srv.address, timeout=10)
    try:
        for hdr, frame, n in script:
            send_json_frame(sock, hdr)
            if frame is not None:
                _send_frame(sock, frame)
            while True:
                head = _recv_exact(sock, 12)
                ln = int.from_bytes(head[4:], "little")
                payload = _recv_exact(sock, ln)
                out += head + payload
                if n == 1:
                    break
                ctl = _json.loads(payload)
                if ctl.get("done"):
                    break
                if ctl.get("record") or "segment" in ctl:
                    head = _recv_exact(sock, 12)
                    ln = int.from_bytes(head[4:], "little")
                    out += head + _recv_exact(sock, ln)
    finally:
        sock.close()
        srv.stop()
        wal.close()
    return bytes(out)


def test_replication_server_frames_equal_reference(tmp_path):
    """The door's replies — acks, restore windows, horizons, snapshot
    grids, WAL segments, drops, errors — byte for byte."""
    got = _server_conversation(PORT, str(tmp_path / "port"))
    want = _server_conversation(REF, str(tmp_path / "jax"))
    assert len(got) > 1000
    assert got == want


def _handoff_journal(pkg):
    """One handoff on a 3-node RF-2 cluster of a package: its journal
    events (without their clock fields) and the /admin/shards payload
    after it."""
    c = pkg.cluster(nodes=("A", "B", "C"), num_shards=2)
    try:
        _fill_pkg(pkg, c, n_series=8, n_samples=16)
        owners = set(c.mapper.owners(0))
        target = next(n for n in ("A", "B", "C") if n not in owners)
        coord = pkg.repl.HandoffCoordinator(DS, c.mapper,
                                            lambda n: c.repl_clients[n])
        seq0 = pkg.journal.next_seq
        summary = coord.handoff(0, target)
        evs = [{k: v for k, v in e.items()
                if k not in ("seq", "unixSeconds", "elapsed_s")}
               for e in pkg.journal.since(seq0 - 1)
               if e["kind"].startswith("shard_handoff")]
        api = pkg.Api({})
        api.shard_mappers[DS] = c.mapper
        api.replicators[DS] = c.manager
        st, payload = api.handle("GET", "/admin/shards", {})
        assert st == 200
        for row in payload["data"]["datasets"][DS]["replicaLag"]:
            row.pop("lagSeconds")
        summary.pop("elapsedSeconds")
        return summary, evs, payload
    finally:
        c.stop()


def test_handoff_journal_and_admin_shards_equal_reference():
    got = _handoff_journal(PORT)
    want = _handoff_journal(REF)
    assert got[0] == want[0]
    assert [e["state"] for e in got[1] if "state" in e] == \
        ["register", "stream_snapshot", "stream_wal_tail", "cutover",
         "tombstone", "done"]
    assert got[1] == want[1]
    assert got[2] == want[2]
