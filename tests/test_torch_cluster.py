"""The port's control plane against the JAX package's: the shard manager,
the cluster coordinator and its node agents, seed discovery, the network
chunk store, and a three-process `nodeapp` cluster with a node killed.

The shard managers of both packages, driven through the same joins,
deaths, ingest events and a recovery, must publish the same events and
hold the same assignments and snapshots.  A port coordinator serves a
reference agent and the reverse.  A port chunk-store client flushes
through the reference's chunk service and the reverse, the bytes read
back equal.  Three `python -m filodb_tpu_torch.parallel.nodeapp
--device cpu` processes join a port coordinator (tests/test_cluster_e2e.py's
shape), over a shared directory and over a netstore service: the
scatter-gather answers as a single store, and after one owner is
SIGKILLed the standby recovers its shards and answers the same.  A node
started in the reference's form, `--platform cpu`, joins and answers
too; an unknown platform, or a --device that disagrees, is an argparse
error.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from filodb_tpu.parallel import bootstrap as jboot
from filodb_tpu.parallel import shardmanager as jsm
from filodb_tpu.parallel.shardmapper import ShardEvent as JEvent

from filodb_tpu_torch.parallel import bootstrap as tboot
from filodb_tpu_torch.parallel import shardmanager as tsm
from filodb_tpu_torch.parallel.cluster import (ClusterClient,
                                               ClusterCoordinator, NodeAgent,
                                               _rpc)
from filodb_tpu_torch.parallel.shardmapper import ShardEvent

START = 1_600_000_000_000
NUM_SHARDS = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------- shard manager


def _drive(mod, event_cls):
    """One scripted history through a package's ShardManager -> every
    published event, return value and snapshot along the way."""
    now = [1000.0]
    m = mod.ShardManager(reassignment_min_interval_s=60.0,
                         clock=lambda: now[0])
    log = []
    m.subscribe("ds", lambda ev: log.append(repr(ev)))
    out = [m.add_member("n1"), m.add_member("n2")]
    m.setup_dataset("ds", mod.DatasetResourceSpec(8, 3))
    out.append(m.add_member("n3"))
    out.append(m.snapshot("ds"))
    m.on_shard_event(event_cls("IngestionStarted", "ds", 0, "n3"))
    m.on_shard_event(event_cls("IngestionError", "ds", 1, "n3"))
    out.append(m.snapshot("ds"))
    out.append(m.remove_member("n2"))
    out.append(m.snapshot("ds"))
    now[0] += 61.0
    out.append(m.add_member("n4"))
    out.append(m.remove_member("n1"))
    out.append(m.snapshot("ds"))
    r = mod.ShardManager(clock=lambda: now[0])
    r.recover({"ds": mod.DatasetResourceSpec(8, 3)}, ["n3", "n4", "n5"],
              {"ds": m.snapshot("ds")})
    out.append(r.snapshot("ds"))
    out.append(r.members)
    return [repr(o) for o in out], log


def test_shard_manager_history_equals_reference():
    got, got_log = _drive(tsm, ShardEvent)
    want, want_log = _drive(jsm, JEvent)
    assert got == want
    assert got_log == want_log and got_log


@pytest.mark.parametrize("nodes, shards, rf", [(3, 8, 1), (4, 16, 2),
                                               (3, 4, 1)])
def test_assignments_equal_reference(nodes, shards, rf):
    def run(mod):
        m = mod.ShardManager(replication_factor=rf,
                             reassignment_min_interval_s=0)
        for i in range(nodes):
            m.add_member(f"n{i}")
        mapper = m.setup_dataset("ds", mod.DatasetResourceSpec(shards,
                                                                nodes))
        before = (list(mapper.nodes), [list(r) for r in mapper.replicas])
        m.remove_member("n0")
        return before, (list(mapper.nodes),
                        [list(r) for r in mapper.replicas]), \
            repr(m.snapshot("ds"))
    assert run(tsm) == run(jsm)


# --------------------------------------------- coordinator and agents


def _wait(pred, timeout_s=20.0):
    t_end = time.time() + timeout_s
    while time.time() < t_end:
        if pred():
            return True
        time.sleep(0.05)
    return False


@pytest.mark.parametrize("agents", ["port", "reference"])
def test_coordinator_agents_liveness_and_reassignment(agents):
    """A port coordinator with two agents (the port's or the
    reference's: one JSON protocol): assignments, Active on heartbeat,
    deathwatch reassigning a silent node's shards, and a state payload
    equal to the reference coordinator's for the same history."""
    from filodb_tpu.parallel.cluster import NodeAgent as JAgent
    agent_cls = NodeAgent if agents == "port" else JAgent
    coord = ClusterCoordinator(tsm.ShardManager(
        reassignment_min_interval_s=0), liveness_timeout_s=1.0,
        check_interval_s=0.1).start()
    coord.setup_dataset("prometheus", NUM_SHARDS, min_num_nodes=2)
    got = {"A": [], "B": []}
    ags = {n: agent_cls(n, coord.address, ("127.0.0.1", 9000 + i),
                        lambda ds, s, n=n: got[n].append(s),
                        heartbeat_interval_s=0.1).start()
           for i, n in enumerate(("A", "B"))}
    try:
        cli = ClusterClient(coord.address)
        assert _wait(lambda: cli.state()["datasets"]["prometheus"]
                     ["statuses"] == ["Active"] * NUM_SHARDS)
        assert sorted(got["A"] + got["B"]) == list(range(NUM_SHARDS))
        mapper, addrs = cli.mapper("prometheus")
        assert addrs == {"A": ("127.0.0.1", 9000), "B": ("127.0.0.1", 9001)}
        assert [mapper.node_for_shard(s) for s in range(NUM_SHARDS)] == \
            cli.state()["datasets"]["prometheus"]["nodes"]
        ags["B"].stop()
        assert _wait(lambda: "B" not in cli.state()["members"])
        st = cli.state()["datasets"]["prometheus"]
        assert set(st["nodes"]) <= {"A", None}
        assert _rpc(coord.address, {"cmd": "bogus"})["ok"] is False
    finally:
        for a in ags.values():
            a.stop()
        coord.stop()


def test_state_payload_equals_reference():
    from filodb_tpu.parallel.cluster import ClusterCoordinator as JCoord
    out = []
    for cls, mod in ((ClusterCoordinator, tsm), (JCoord, jsm)):
        c = cls(mod.ShardManager(reassignment_min_interval_s=0))
        c.setup_dataset("ds", 8, 2)
        for n in ("x", "y", "z"):
            c._handle({"cmd": "register", "node": n,
                       "query_addr": ["127.0.0.1", 1]})
        c._handle({"cmd": "heartbeat", "node": "x",
                   "active": {"ds": [0, 1, 2]}})
        st = c._handle({"cmd": "state"})
        out.append(json.dumps(st, sort_keys=True))
        c._server.server_close()
    assert out[0] == out[1]


# ------------------------------------------------------ seed discovery


def test_seed_discovery_equals_reference():
    members = [("10.0.0.1", 2552), ("10.0.0.2", 2552)]
    assert tboot.members_payload(members) == jboot.members_payload(members)
    joined = []
    self_addr = ("10.0.0.9", 2552)
    assert tboot.bootstrap(tboot.ExplicitListSeedDiscovery(
        members + [self_addr]), self_addr, joined.append) == members
    assert joined == [members]
    assert tboot.bootstrap(tboot.ExplicitListSeedDiscovery([]), self_addr,
                           joined.append, retries=2) == [self_addr]
    srv = tboot.DnsSrvSeedDiscovery("_filodb._tcp",
                                    resolver=lambda name: members)
    assert srv.discover() == members
    with pytest.raises(RuntimeError):
        tboot.DnsSrvSeedDiscovery("_x").discover()


def test_http_members_discovery_reads_a_live_member():
    import http.server
    members = [("127.0.0.1", 7001)]
    body = json.dumps(tboot.members_payload(members)).encode()

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200 if self.path == "/__members" else 404)
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        dead = ("127.0.0.1", 1)
        d = tboot.HttpMembersSeedDiscovery([dead, srv.server_address],
                                           timeout_s=2.0)
        assert d.discover() == members
        assert jboot.HttpMembersSeedDiscovery(
            [srv.server_address], timeout_s=2.0).discover() == members
    finally:
        srv.shutdown()
        srv.server_close()


# ----------------------------------------------------------- netstore


def _flush_through(pkg, remote_cs, remote_meta):
    """A memstore of `pkg` flushed through a remote column store."""
    if pkg == "port":
        from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
        from filodb_tpu_torch.ingest.generator import gauge_batch
        ms = TimeSeriesMemStore(column_store=remote_cs,
                                meta_store=remote_meta, device="cpu")
    else:
        from filodb_tpu.core.memstore import TimeSeriesMemStore
        from filodb_tpu.ingest.generator import gauge_batch
        ms = TimeSeriesMemStore(column_store=remote_cs,
                                meta_store=remote_meta)
    sh = ms.setup("prometheus", 0)
    sh.ingest(gauge_batch(8, 240, start_ms=START + 20_000))
    sh.flush_all_groups()


@pytest.mark.parametrize("client, service", [("port", "reference"),
                                             ("reference", "port")])
def test_netstore_contract_across_packages(tmp_path, client, service):
    from filodb_tpu.persist import localstore as jls
    from filodb_tpu.persist import netstore as jns

    from filodb_tpu_torch.persist import localstore as tls
    from filodb_tpu_torch.persist import netstore as tns
    ls, ns = (tls, tns) if service == "port" else (jls, jns)
    root = str(tmp_path / "store")
    srv = ns.ChunkServiceServer(ls.LocalDiskColumnStore(root),
                                ls.LocalDiskMetaStore(root)).start()
    try:
        cns = tns if client == "port" else jns
        remote = cns.RemoteColumnStore(*srv.address)
        meta = cns.RemoteMetaStore(*srv.address)
        _flush_through(client, remote, meta)
        local = srv.column_store
        recs = remote.read_part_keys("prometheus", 0)
        assert len(recs) == len(local.read_part_keys("prometheus", 0)) == 8
        rec = recs[0]
        a = local.read_chunks("prometheus", 0, rec.part_key, 0, 1 << 62)
        b = remote.read_chunks("prometheus", 0, rec.part_key, 0, 1 << 62)
        c = remote.read_chunks_multi("prometheus", 0,
                                     [(rec.part_key, 0, 1 << 62)])[0]
        assert len(a) == len(b) == len(c) == 1
        for name in a[0].columns:
            assert a[0].columns[name].payload == b[0].columns[name].payload \
                == c[0].columns[name].payload
        assert len(list(remote.scan_chunks_by_ingestion_time(
            "prometheus", 0, 0, 1 << 62))) == 8
        assert remote.num_chunksets("prometheus", 0) == 8
        assert remote.delete_part_keys("prometheus", 0, [rec.part_key]) == 1
        meta.write_checkpoint("ds", 1, 3, 99)
        assert meta.read_checkpoints("ds", 1) == {3: 99}
    finally:
        srv.stop()


# ------------------------------------------- three nodeapp processes


def _lines(num_series=24, num_samples=90):
    out = []
    for t in range(num_samples):
        ts_ns = (START + t * 10_000) * 1_000_000
        for i in range(num_series):
            out.append(f"cluster_metric,_ws_=demo,_ns_=App-{i % 4},inst=i{i} "
                       f"value={t * 3.0 + i} {ts_ns}")
    return out


def _spawn(name, coord_port, data_dir, store_url="",
           where=("--device", "cpu")):
    os.makedirs(str(data_dir), exist_ok=True)
    errpath = os.path.join(str(data_dir), f"{name}.stderr")
    cmd = [sys.executable, "-m", "filodb_tpu_torch.parallel.nodeapp",
           "--name", name, "--coordinator", f"127.0.0.1:{coord_port}",
           "--data-dir", str(data_dir), *where,
           "--heartbeat-interval", "0.3"]
    if store_url:
        cmd += ["--store-url", store_url]
    with open(errpath, "w") as errf:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=errf,
                                text=True, cwd=REPO)
    box = {}
    t = threading.Thread(target=lambda: box.update(
        line=proc.stdout.readline()), daemon=True)
    t.start()
    t.join(timeout=90)
    if not box.get("line"):
        proc.kill()
        with open(errpath) as f:
            raise RuntimeError(f"node {name} failed to start: "
                               f"{f.read()[-2000:]}")
    info = json.loads(box["line"])
    assert info["ready"] and isinstance(info["replication_port"], int)
    assert info["replication_port"] > 0
    return proc, info


def _wait_state(cli, pred, timeout_s, what):
    t_end = time.time() + timeout_s
    while time.time() < t_end:
        st = cli.state()
        if pred(st):
            return st
        time.sleep(0.3)
    raise AssertionError(f"timed out waiting for {what}: {cli.state()}")


def _query(cli, q, pp=None):
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.parallel.shardmapper import SpreadProvider
    from filodb_tpu_torch.parallel.transport import RemoteNodeDispatcher
    from filodb_tpu_torch.query.engine import QueryEngine
    from filodb_tpu_torch.query.planner import SingleClusterPlanner
    mapper, addrs = cli.mapper("prometheus")
    planner = SingleClusterPlanner(
        "prometheus", mapper, SpreadProvider(default_spread=1),
        dispatcher_factory=lambda s: RemoteNodeDispatcher(
            *addrs[mapper.node_for_shard(s)]))
    eng = QueryEngine("prometheus", TimeSeriesMemStore(device="cpu"),
                      mapper, planner=planner, device="cpu")
    res = eng.query_range(q, START // 1000 + 120, 60, START // 1000 + 880,
                          pp)
    assert res.error is None, res.error
    return {str(k): np.asarray(v) for k, _, v in res.series()}, res


@pytest.mark.parametrize("backend", ["shared_dir", "netstore"])
def test_nodeapp_cluster_ingest_query_failover(tmp_path, backend):
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.gateway.influx import influx_lines_to_batches
    from filodb_tpu_torch.gateway.router import split_batch_by_shard
    from filodb_tpu_torch.parallel.shardmapper import SpreadProvider
    from filodb_tpu_torch.query.engine import QueryEngine
    from filodb_tpu_torch.query.rangevector import PlannerParams
    svc = None
    store_url = ""
    if backend == "netstore":
        svc = subprocess.Popen(
            [sys.executable, "-m", "filodb_tpu_torch.persist.netstore",
             "--root", str(tmp_path / "central")], stdout=subprocess.PIPE,
            text=True, cwd=REPO)
        store_url = f"127.0.0.1:{json.loads(svc.stdout.readline())['port']}"

    def node_dir(name):
        return tmp_path if backend == "shared_dir" else tmp_path / name
    q = 'sum by (_ns_)(cluster_metric{_ws_="demo"})'
    coord = ClusterCoordinator(tsm.ShardManager(
        reassignment_min_interval_s=0), liveness_timeout_s=2.5,
        check_interval_s=0.3).start()
    coord.setup_dataset("prometheus", NUM_SHARDS, min_num_nodes=2)
    procs = []
    try:
        infos = {}
        for name in ("A", "B", "C"):
            p, infos[name] = _spawn(name, coord.address[1], node_dir(name),
                                    store_url)
            procs.append(p)
        cli = ClusterClient(coord.address)
        st = _wait_state(cli, lambda s: s["datasets"]["prometheus"][
            "statuses"] == ["Active"] * NUM_SHARDS, 60, "shards active")
        owners = sorted(set(st["datasets"]["prometheus"]["nodes"]))
        assert owners == ["A", "B"]
        lines = _lines()
        for info in infos.values():
            r = _rpc(("127.0.0.1", info["control_port"]),
                     {"cmd": "ingest_lines", "lines": lines, "offset": 1},
                     timeout_s=120)
            assert r["ok"], r
        truth = TimeSeriesMemStore(device="cpu")
        t_mapper, _ = cli.mapper("prometheus")
        spread = SpreadProvider(default_spread=1)
        for s in range(NUM_SHARDS):
            truth.setup("prometheus", s)
        for batch in influx_lines_to_batches(lines):
            for s, sub in split_batch_by_shard(batch, t_mapper,
                                               spread).items():
                truth.get_shard("prometheus", s).ingest(sub)
        want_res = QueryEngine("prometheus", truth, t_mapper, spread,
                               device="cpu").query_range(
            q, START // 1000 + 120, 60, START // 1000 + 880)
        want = {str(k): np.asarray(v) for k, _, v in want_res.series()}
        assert len(want) == 4
        got, res = _query(cli, q)
        assert res.stats.pushdown_pushed == 2
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-9,
                                       equal_nan=True)
        for name in owners:
            r = _rpc(("127.0.0.1", infos[name]["control_port"]),
                     {"cmd": "flush"}, timeout_s=120)
            assert r["ok"], r
        procs[1].kill()                        # B, without ceremony
        procs[1].wait()
        # before deathwatch notices: the typed error, or a flagged partial
        _, part = _query(cli, q, PlannerParams(allow_partial_results=True))
        assert part.partial or len(part.blocks) and not part.error
        _wait_state(cli, lambda s: "B" not in s["members"]
                    and set(s["datasets"]["prometheus"]["nodes"])
                    == {"A", "C"} and s["datasets"]["prometheus"][
                        "statuses"] == ["Active"] * NUM_SHARDS, 60,
                    "failover to C")
        got2, _ = _query(cli, q)
        assert set(got2) == set(want)
        for k in want:
            np.testing.assert_allclose(got2[k], want[k], rtol=1e-9,
                                       equal_nan=True)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        coord.stop()
        if svc is not None:
            svc.kill()
            svc.wait()


def test_nodeapp_takes_the_reference_platform_flag(tmp_path):
    """One node started as the reference's launch scripts start it,
    `--platform cpu` and no --device, owns every shard and answers the
    query as a single store."""
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.gateway.influx import influx_lines_to_batches
    from filodb_tpu_torch.gateway.router import split_batch_by_shard
    from filodb_tpu_torch.parallel.shardmapper import SpreadProvider
    from filodb_tpu_torch.query.engine import QueryEngine
    q = 'sum by (_ns_)(cluster_metric{_ws_="demo"})'
    coord = ClusterCoordinator(tsm.ShardManager(
        reassignment_min_interval_s=0), liveness_timeout_s=2.5,
        check_interval_s=0.3).start()
    coord.setup_dataset("prometheus", NUM_SHARDS, min_num_nodes=1)
    proc = None
    try:
        proc, info = _spawn("P", coord.address[1], tmp_path,
                            where=("--platform", "cpu"))
        cli = ClusterClient(coord.address)
        _wait_state(cli, lambda s: s["datasets"]["prometheus"][
            "statuses"] == ["Active"] * NUM_SHARDS, 60, "shards active")
        lines = _lines(num_series=8, num_samples=90)
        r = _rpc(("127.0.0.1", info["control_port"]),
                 {"cmd": "ingest_lines", "lines": lines, "offset": 1},
                 timeout_s=120)
        assert r["ok"] and r["ingested"] == len(lines), r
        t_mapper, _ = cli.mapper("prometheus")
        spread = SpreadProvider(default_spread=1)
        truth = TimeSeriesMemStore(device="cpu")
        for s in range(NUM_SHARDS):
            truth.setup("prometheus", s)
        for batch in influx_lines_to_batches(lines):
            for s, sub in split_batch_by_shard(batch, t_mapper,
                                               spread).items():
                truth.get_shard("prometheus", s).ingest(sub)
        want = {str(k): np.asarray(v) for k, _, v in QueryEngine(
            "prometheus", truth, t_mapper, spread, device="cpu").query_range(
            q, START // 1000 + 120, 60, START // 1000 + 880).series()}
        got, _ = _query(cli, q)
        assert len(want) == 4 and set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-9,
                                       equal_nan=True)
    finally:
        if proc is not None:
            proc.kill()
            proc.wait()
        coord.stop()


@pytest.mark.parametrize("where, says", [
    (["--platform", "tpu"], "choose from"),
    (["--platform", "cpu", "--device", "cuda"], "disagree")])
def test_nodeapp_refuses_an_unknown_or_contrary_platform(capsys, where,
                                                         says):
    from filodb_tpu_torch.parallel import nodeapp
    with pytest.raises(SystemExit) as ei:
        nodeapp.main(["--name", "X", "--coordinator", "127.0.0.1:1",
                      "--data-dir", "unused", *where])
    assert ei.value.code == 2
    err = capsys.readouterr().err
    assert says in err and "--platform" in err
