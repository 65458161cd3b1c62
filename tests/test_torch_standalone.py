"""The port's composition root (filodb_tpu_torch/standalone.py: FiloServer,
DatasetConfig, IndexCompactionLoop) against the JAX package's FiloServer
over the same settings:

- a boot that replays a WAL, then start and shutdown, gives the same
  phase sequence (booting, replaying_wal, booted, serving, stopping) and
  the same journal event kinds in both packages;
- a WAL written by the reference's node replays into the port's node:
  the same stores and answers (rtol 2e-4 / atol 1e-3);
- the downsample fan-out, the persisted tier over a disk store, the ruler
  and self-monitoring are wired as the reference wires them (explain
  payloads equal to the string, stitched answers and recorded series
  within tolerance);
- bad settings raise the reference's ConfigError; federation and
  replication boot as the reference's do;
- /cluster/<ds>/status and /admin/shards equal the reference's payloads;
- without device="cpu" the constructor raises when no card is present.
"""
import shutil
import time
import types

import numpy as np
import pytest
import torch

from test_torch_ingest import _clear_compile_journal  # noqa: F401
from torch_doors import assert_same_stores

DS = "prometheus"
PKGS = ("jax", "port")
START = 1_600_000_000_000
RTOL, ATOL = 2e-4, 1e-3


def _pkg(pkg):
    """The names a test needs from one package."""
    if pkg == "jax":
        from filodb_tpu import config, standalone
        from filodb_tpu.http import remotepb
        from filodb_tpu.ingest import generator
        from filodb_tpu.persist import LocalDiskColumnStore, LocalDiskMetaStore
        from filodb_tpu.utils import snappy
        from filodb_tpu.utils.events import journal
        from filodb_tpu.utils.jobs import jobs
        from filodb_tpu.utils.metrics import registry
        kw = {}
    else:
        from filodb_tpu_torch import config, standalone
        from filodb_tpu_torch.http import remotepb
        from filodb_tpu_torch.ingest import generator
        from filodb_tpu_torch.persist import (LocalDiskColumnStore,
                                              LocalDiskMetaStore)
        from filodb_tpu_torch.utils import snappy
        from filodb_tpu_torch.utils.events import journal
        from filodb_tpu_torch.utils.jobs import jobs
        from filodb_tpu_torch.utils.metrics import registry
        kw = {"device": "cpu"}
    return types.SimpleNamespace(
        config=config, FiloServer=standalone.FiloServer,
        DatasetConfig=standalone.DatasetConfig, remotepb=remotepb,
        generator=generator, Disk=LocalDiskColumnStore,
        DiskMeta=LocalDiskMetaStore, snappy=snappy, journal=journal,
        jobs=jobs, registry=registry, kw=kw)


def _server(pkg, shards=2, settings=None, datasets=None, **kw):
    p = _pkg(pkg)
    cfg = p.config.FilodbSettings()
    for path, value in (settings or {}).items():
        section, field = path.split(".")
        setattr(getattr(cfg, section), field, value)
    ds = datasets or [p.DatasetConfig(DS, num_shards=shards)]
    return p.FiloServer(ds, config=cfg, **p.kw, **kw)


def _write(pkg, srv, n=12, k=30, t0=START, seed=0):
    """One remote-write request of n counters x k samples at 10 s."""
    p = _pkg(pkg)
    rng = np.random.default_rng(seed)
    series = []
    for i in range(n):
        labels = [("__name__", "req_total"), ("_ws_", "demo"),
                  ("_ns_", f"App-{i % 3}"), ("inst", str(i))]
        vals = np.cumsum(rng.integers(0, 10, k)).astype(float)
        series.append(p.remotepb.PromTimeSeries(
            labels, [(float(v), t0 + j * 10_000)
                     for j, v in enumerate(vals)]))
    body = p.snappy.compress(p.remotepb.encode_write_request(series))
    st, payload = srv.api.handle("POST", "/api/v1/write", {}, body,
                                 headers={})
    assert st == 204, payload


def _matrix(payload):
    assert payload["status"] == "success", payload
    return {tuple(sorted(r["metric"].items())):
            np.array([float(v) for _, v in r["values"]])
            for r in payload["data"]["result"]}


def _assert_same_matrix(got, want):
    a, b = _matrix(got), _matrix(want)
    assert sorted(a) == sorted(b) and a
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL,
                                   equal_nan=True)


def _range(srv, q, start_s, end_s, step=60):
    st, payload = srv.api.handle("GET", "/api/v1/query_range", {
        "query": q, "start": str(start_s), "end": str(end_s),
        "step": str(step)})
    assert st == 200, payload
    return payload


# ------------------------------------------------------------ boot phases

def test_boot_phases_and_journal_kinds_equal_the_reference(tmp_path):
    seen = {}
    for pkg in PKGS:
        p = _pkg(pkg)
        wal = {"wal.enabled": True, "wal.dir": str(tmp_path / f"wal-{pkg}")}
        first = _server(pkg, settings=wal)
        _write(pkg, first)
        first.shutdown()
        seq0 = p.journal.next_seq
        srv = _server(pkg, settings=wal)
        assert srv.health.phase == "booted"
        st, ready = srv.api.handle("GET", "/ready", {})
        assert st == 503 and ready["reason"] == "phase=booted"
        srv.start(background_flush=False)
        assert srv.api.handle("GET", "/ready", {})[0] == 200
        srv.shutdown()
        events = p.journal.since(seq0 - 1)
        seen[pkg] = ([e["kind"] for e in events],
                     [(e["frm"], e["to"]) for e in events
                      if e["kind"] == "phase"])
    assert seen["port"] == seen["jax"]
    assert seen["port"][1] == [("booting", "replaying_wal"),
                               ("replaying_wal", "booted"),
                               ("booted", "serving"),
                               ("serving", "stopping")]


def test_boot_without_a_wal_skips_the_replay_phase():
    phases = {}
    for pkg in PKGS:
        p = _pkg(pkg)
        seq0 = p.journal.next_seq
        srv = _server(pkg, shards=1)
        srv.start(background_flush=False)
        srv.shutdown()
        phases[pkg] = [(e["frm"], e["to"])
                       for e in p.journal.since(seq0 - 1, kind="phase")]
    assert phases["port"] == phases["jax"] == [
        ("booting", "booted"), ("booted", "serving"),
        ("serving", "stopping")]


# -------------------------------------------------------- WAL across packages

def test_wal_written_by_the_reference_replays_into_the_port(tmp_path):
    ref_dir = tmp_path / "wal-ref"
    settings = {"wal.enabled": True, "wal.dir": str(ref_dir)}
    writer = _server("jax", settings=settings)
    for i in range(3):
        _write("jax", writer, t0=START + i * 300_000, seed=i)
    writer.shutdown()
    shutil.copytree(ref_dir, tmp_path / "wal-port")
    nodes = {"jax": _server("jax", settings=settings),
             "port": _server("port", settings={
                 "wal.enabled": True, "wal.dir": str(tmp_path / "wal-port")})}
    try:
        assert_same_stores(nodes["jax"].memstore, nodes["port"].memstore)
        health = {pkg: srv.api.handle("GET", "/api/v1/status/health", {})[1]
                  ["data"]["subsystems"]["wal"]["datasets"][DS]
                  for pkg, srv in nodes.items()}
        for key in ("enabled", "replayDone", "replayRecords",
                    "replaySamples"):
            assert health["port"][key] == health["jax"][key], key
        assert health["port"]["replayRecords"] == 6     # 3 requests x 2 shards
        s = START // 1000
        for q in ("sum by (_ns_) (rate(req_total[5m]))", "req_total"):
            got = _range(nodes["port"], q, s + 300, s + 1170)
            want = _range(nodes["jax"], q, s + 300, s + 1170)
            _assert_same_matrix(got, want)
        # the recovered writer continues the reference's sequence
        assert nodes["port"].wals[DS].writer.next_seq == \
            nodes["jax"].wals[DS].writer.next_seq
    finally:
        for srv in nodes.values():
            srv.shutdown()


# ----------------------------------------------------------------- wiring

RULES = {"recorded": {"interval": 60, "rules": {"r1": {
    "record": "ns:req:rate5m",
    "expr": "sum by (_ns_) (rate(request_total[5m]))"}}}}


def _wired(pkg, root):
    p = _pkg(pkg)
    cfg = p.config.FilodbSettings()
    cfg.rules.enabled = True
    cfg.rules.groups = RULES
    cfg.selfmon.enabled = True
    cfg.selfmon.interval_s = 3600.0       # scrape_once by hand
    cfg.index.compaction_interval_s = 3600.0
    srv = p.FiloServer(
        [p.DatasetConfig(DS, num_shards=1, downsample_resolutions=(60_000,))],
        column_store=p.Disk(str(root / "chunks")),
        meta_store=p.DiskMeta(str(root / "meta")), config=cfg, **p.kw)
    shard = srv.memstore.get_shard(DS, 0)
    shard.ingest(p.generator.counter_batch(24, 720, start_ms=START),
                 offset=0)
    shard.ingest(p.generator.gauge_batch(12, 720, start_ms=START), offset=1)
    return p, srv


def test_downsample_tier_ruler_and_selfmon_are_wired(tmp_path):
    nodes = {pkg: _wired(pkg, tmp_path / pkg) for pkg in PKGS}
    try:
        for pkg, (p, srv) in nodes.items():
            assert srv.api.ruler is srv.ruler is not None
            assert srv.ruler.group_names() == ["recorded"]
            assert srv.selfmon is not None
            assert set(srv.ds_stores) == set(srv.persisted_tiers) == \
                set(srv.compaction_schedulers) == {DS}
            assert srv.memstore.get_shard(DS, 0).shard_downsampler \
                is not None
            assert srv.cold_cache is not None
        assert nodes["port"][1].cold_cache.device == torch.device("cpu")
        drained = {pkg: srv.flush_and_downsample(DS)
                   for pkg, (_, srv) in nodes.items()}
        assert drained["port"] == drained["jax"] > 0
        s = START // 1000
        # raw retention pinned to the 60th minute: the first hour comes
        # from the downsample store, the rest raw, stitched
        for _, srv in nodes.values():
            srv._earliest_cache[DS] = (START + 3_600_000, time.monotonic())
        for q in ("sum by (_ns_) (rate(request_total[5m]))",
                  "max(max_over_time(heap_usage[10m]))"):
            args = {"query": q, "start": str(s + 1200),
                    "end": str(s + 7140), "step": "300"}
            plans = {pkg: srv.api.handle("GET", "/api/v1/explain",
                                         dict(args))
                     for pkg, (_, srv) in nodes.items()}
            assert plans["port"] == plans["jax"], q
            assert "::ds::" in str(plans["port"]), q
            _assert_same_matrix(_range(nodes["port"][1], q, s + 1200,
                                       s + 7140, 300),
                                _range(nodes["jax"][1], q, s + 1200,
                                       s + 7140, 300))
        # started (the ruler's and selfmon's loops, the index compaction
        # job), the ruler writes through the server's frontend and sink
        for pkg, (p, srv) in nodes.items():
            srv.start(background_flush=False)
            assert "index_compaction" in {
                j["job"] for j in p.jobs.snapshot()}, pkg
        t_eval = s + 7000
        for _, srv in nodes.values():
            srv.ruler.evaluate_group("recorded", ts=t_eval)
        recorded = {}
        for pkg, (_, srv) in nodes.items():
            st, payload = srv.api.handle("GET", "/api/v1/query", {
                "query": "ns:req:rate5m", "time": str(t_eval)})
            assert st == 200
            recorded[pkg] = {r["metric"]["_ns_"]: float(r["value"][1])
                             for r in payload["data"]["result"]}
        assert sorted(recorded["port"]) == sorted(recorded["jax"])
        for ns, v in recorded["port"].items():
            np.testing.assert_allclose(v, recorded["jax"][ns], rtol=RTOL,
                                       atol=ATOL)
        # selfmon writes the registry into the served dataset
        for pkg, (_, srv) in nodes.items():
            assert srv.selfmon.scrape_once() > 0, pkg
            wss = {v[0] if isinstance(v, tuple) else v for v in
                   srv.memstore.get_shard(DS, 0).index.label_values("_ws_")}
            assert wss == {"demo", "_self_"}, (pkg, wss)
    finally:
        for _, srv in nodes.values():
            srv.shutdown()


def test_node_over_flushed_data_answers_with_downsampling_on(tmp_path):
    """A node booted over a data directory whose history is only on disk
    (nothing paged in yet), with a downsample resolution configured: the
    raw retention floor must come from the recovered partitions, so the
    panel pages raw data back and answers as a node without downsampling.
    The reference reads the stores' empty-slot sentinel (int64 max) as
    the floor and routes the whole range to the (empty) downsample store:
    it answers nothing (ROADMAP Queue 3)."""
    writer = _server("jax", shards=1, column_store=_pkg("jax").Disk(
        str(tmp_path / "chunks")), meta_store=_pkg("jax").DiskMeta(
        str(tmp_path / "meta")))
    writer.memstore.get_shard(DS, 0).ingest(
        _pkg("jax").generator.counter_batch(16, 720, start_ms=START),
        offset=0)
    writer.memstore.get_shard(DS, 0).flush_all_groups()
    writer.shutdown()
    s = START // 1000
    q = "sum by (_ns_) (rate(request_total[5m]))"
    got = {}
    for pkg in PKGS:
        p = _pkg(pkg)
        for res in ((), (60_000,)):
            srv = _server(pkg, datasets=[p.DatasetConfig(
                DS, 1, downsample_resolutions=res)],
                column_store=p.Disk(str(tmp_path / "chunks")),
                meta_store=p.DiskMeta(str(tmp_path / "meta")))
            try:
                got[pkg, res] = _range(srv, q, s + 600, s + 7190)
                floor = srv._earliest_raw_time(DS)
                assert floor == (START if pkg == "port"
                                 else np.iinfo(np.int64).max)
            finally:
                srv.shutdown()
    assert got["jax", (60_000,)]["data"]["result"] == []
    _assert_same_matrix(got["port", (60_000,)], got["jax", ()])
    _assert_same_matrix(got["port", ()], got["jax", ()])


def test_restarted_node_reads_its_store_only_once_it_holds_chunks(
        tmp_path, monkeypatch):
    """A node restarted from its WAL over the default InMemoryColumnStore
    has nothing to page before its first flush: no query reads the store,
    not even one reaching before the data, and the answers equal the
    reference node's over the same log.  Once a flush has put chunks in
    the store, a query reaching below the data pages from it again."""
    settings = {"wal.enabled": True, "wal.dir": str(tmp_path / "wal-port")}
    first = _server("port", settings=settings)
    for i in range(2):
        _write("port", first, t0=START + i * 300_000, seed=i)
    first.shutdown()
    shutil.copytree(tmp_path / "wal-port", tmp_path / "wal-ref")
    ref = _server("jax", settings={"wal.enabled": True,
                                   "wal.dir": str(tmp_path / "wal-ref")})
    srv = _server("port", settings=settings)
    reads = []
    store = srv.column_store
    monkeypatch.setattr(store, "read_chunks", lambda *a: reads.append(a))
    monkeypatch.setattr(store, "read_chunks_multi",
                        lambda ds, sh, reqs: reads.append(reqs)
                        or [[] for _ in reqs])
    s = START // 1000
    q = "sum by (_ns_) (rate(req_total[5m]))"
    try:
        assert not any(store.holds_chunks(DS, sh) for sh in range(2))
        for start in (s + 300, s - 600):
            _assert_same_matrix(_range(srv, q, start, s + 570),
                                _range(ref, q, start, s + 570))
        assert reads == []
        for sh in srv.memstore.shards_for(DS):
            sh.flush_all_groups()
        assert all(store.holds_chunks(DS, sh) for sh in range(2))
        _assert_same_matrix(_range(srv, q, s - 900, s + 570),
                            _range(ref, q, s - 900, s + 570))
        assert reads
    finally:
        srv.shutdown()
        ref.shutdown()


def test_shutdown_hands_back_the_active_query_log(tmp_path):
    from filodb_tpu_torch.query.activequeries import active_queries
    wal_dir = tmp_path / "wal"
    srv = _server("port", settings={"wal.enabled": True,
                                    "wal.dir": str(wal_dir)})
    assert active_queries.path == str(wal_dir / "queries.active")
    srv.shutdown()
    assert active_queries.path == ""


def test_warmup_shape_runs_in_the_background():
    p = _pkg("port")
    cfg = p.config.FilodbSettings()
    cfg.warmup_shapes = "64x60x10x4"
    errors = p.registry.counter("warmup_compile_errors")
    e0 = errors.value
    srv = p.FiloServer([p.DatasetConfig(DS, 1)], config=cfg, **p.kw)
    try:
        srv.start(background_flush=False)
        srv.warmup_thread.join(120)
        assert not srv.warmup_thread.is_alive()
        assert errors.value == e0
        assert p.registry.gauge("warmup_compile_seconds").value > 0
    finally:
        srv.shutdown()


# ------------------------------------------------------------ bad settings

def _refusal(pkg, settings, datasets=None):
    p = _pkg(pkg)
    with pytest.raises(p.config.ConfigError) as e:
        _server(pkg, settings=settings,
                datasets=[p.DatasetConfig(*d) for d in datasets or []]
                or None)
    return str(e.value)


@pytest.mark.parametrize("settings", [
    {"query.tenant_shares": {"acme": 0}},
    {"query.tenant_shares": {"acme": "many"}},
    {"query.tenant_shares": {"acme": -2.5}},
    {"query.tenant_max_queue_depth": -1},
    {"query.shuffle_shard_factor": -1},
    {"rules.enabled": True, "rules.dataset": "nosuch"},
    {"selfmon.enabled": True, "selfmon.dataset": "nosuch"},
])
def test_bad_settings_raise_the_reference_config_error(settings):
    assert _refusal("port", settings) == _refusal("jax", settings)


@pytest.mark.parametrize("section", ["federation", "replication"])
def test_unported_layers_are_refused_at_construction(section):
    """Both layers, refused until they were ported, now boot as the
    reference's do: the federation door and registry (the planner stack
    gains the FederationPlanner outermost) or the replication door, with
    the same admin payloads."""
    out = {}
    for pkg in ("jax", "port"):
        srv = _server(pkg, settings={f"{section}.enabled": True})
        try:
            if section == "federation":
                assert srv.federation_door.port > 0
                st, payload = srv.api.handle("GET", "/admin/federation", {})
            else:
                assert srv.replication_server is not None
                assert srv.replicators == {}
                st, payload = srv.api.handle("GET", "/admin/shards", {})
            out[pkg] = (st, payload,
                        type(srv.engines[DS].planner).__name__)
        finally:
            srv.shutdown()
    assert out["port"] == out["jax"]
    assert out["port"][0] == 200


def test_no_card_refuses_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is served")
    from filodb_tpu_torch.standalone import DatasetConfig, FiloServer
    from filodb_tpu_torch.utils.device import NoCudaDevice
    with pytest.raises(NoCudaDevice):
        FiloServer([DatasetConfig(DS, 1)])


# --------------------------------------------------------- mapper routes

@pytest.mark.parametrize("path, params", [
    ("/cluster/prometheus/status", {}),
    ("/cluster/other/status", {}),
    ("/cluster/nosuch/status", {}),
    ("/admin/shards", {}),
    ("/admin/shards", {"dataset": "other"}),
    ("/admin/shards", {"dataset": "nosuch"}),
])
def test_mapper_routes_equal_the_reference(path, params):
    answers = {}
    for pkg in PKGS:
        p = _pkg(pkg)
        srv = _server(pkg, datasets=[p.DatasetConfig(DS, num_shards=4),
                                     p.DatasetConfig("other", num_shards=1)],
                      node_name="node-a")
        try:
            answers[pkg] = srv.api.handle("GET", path, dict(params))
        finally:
            srv.shutdown()
    assert answers["port"] == answers["jax"]
    assert answers["port"][0] != 501
