"""The port's self-scrape loop (filodb_tpu_torch/utils/selfmon.py)
against the JAX package's, modelled on the selfmon cases of
tests/test_selfobs.py.

Both packages' scrapers read the same fixed registry snapshot (each
package's registry.snapshot_samples patched) into two-shard CPU
memstores at the same timestamp: the series keys, their shards and their
values must be the reference's.  The rest runs the port alone: the
scraped metrics answer PromQL through the HTTP API, a job-error streak
fires an alert through the ruler, and the loop runs as a job.
"""
import time

import numpy as np
import pytest

NOW_MS = 1_700_000_000_000
SAMPLES = [
    ("probe_requests_total", (("dataset", "prometheus"),), 7.0),
    ("probe_depth", (), 3.5),
    ("job_runs_total", (("job", "victim"),), 4.0),
    ("probe_seconds_bucket", (("le", "0.005"),), 1.0),
    ("probe_seconds_bucket", (("le", "+Inf"),), 2.0),
    ("probe_seconds_sum", (), 0.75),
    ("probe_seconds_count", (), 2.0),
] + [(f"probe_wide_{i}", (("shard", str(i % 5)),), float(i))
     for i in range(40)]


def _node(pkg, shards=2):
    if pkg == "jax":
        from filodb_tpu.core.memstore import TimeSeriesMemStore
        from filodb_tpu.parallel.shardmapper import ShardEvent, ShardMapper
        from filodb_tpu.utils import selfmon
        from filodb_tpu.utils.metrics import registry
        kw = {}
    else:
        from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
        from filodb_tpu_torch.parallel.shardmapper import (ShardEvent,
                                                           ShardMapper)
        from filodb_tpu_torch.utils import selfmon
        from filodb_tpu_torch.utils.metrics import registry
        kw = {"device": "cpu"}
    ms = TimeSeriesMemStore(**kw)
    mapper = ShardMapper(shards)
    for s in range(shards):
        ms.setup("filodb_self", s)
        mapper.update_from_event(ShardEvent("IngestionStarted",
                                            "filodb_self", s, "local"))
    return ms, mapper, selfmon, registry


def _stored(ms, shards=2):
    """{(shard, part key bytes): stored values} of the gauge stores."""
    out = {}
    for s in range(shards):
        sh = ms.get_shard("filodb_self", s)
        store = sh.stores["gauge"]
        for pid, info in enumerate(sh.partitions):
            if info is None:
                continue
            n = int(store.counts[info.row])
            out[(s, info.part_key.to_bytes())] = (
                store.ts[info.row, :n].tolist(),
                store.cols["value"][info.row, :n].tolist())
    return out


def test_scrape_writes_the_reference_series(monkeypatch):
    got = {}
    for pkg in ("jax", "port"):
        ms, mapper, selfmon, registry = _node(pkg)
        monkeypatch.setattr(registry, "snapshot_samples",
                            lambda: list(SAMPLES))
        sc = selfmon.SelfScraper(ms, "filodb_self", mapper,
                                 node_name="node-a")
        assert sc.scrape_once(now_ms=NOW_MS) == len(SAMPLES)
        assert sc.scrape_once(now_ms=NOW_MS + 15_000) == len(SAMPLES)
        got[pkg] = _stored(ms)
        assert sc.scrapes == 2 and sc.last_series == len(SAMPLES)
    assert got["port"] == got["jax"]
    assert len({s for s, _ in got["port"]}) == 2      # both shards used
    assert len(got["port"]) == len(SAMPLES)


def test_key_memo_and_identity_labels():
    ms, mapper, selfmon, _ = _node("port")
    sc = selfmon.SelfScraper(ms, "filodb_self", mapper, node_name="n1")
    pk = sc._part_key("job_runs_total", (("job", "victim"),))
    assert sc._part_key("job_runs_total", (("job", "victim"),)) is pk
    assert pk.metric == "job_runs_total"
    assert pk.tags_dict == {"_ws_": "_self_", "_ns_": "selfmon",
                            "job": "filodb", "instance": "n1",
                            "exported_job": "victim"}
    from filodb_tpu.utils.selfmon import SelfScraper as JScraper
    jms, jmapper, _, _ = _node("jax")
    jpk = JScraper(jms, "filodb_self", jmapper, node_name="n1")._part_key(
        "job_runs_total", (("job", "victim"),))
    assert pk.to_bytes() == jpk.to_bytes()


@pytest.fixture()
def api():
    from filodb_tpu_torch.http.routes import PromHttpApi
    from filodb_tpu_torch.query.engine import QueryEngine
    ms, mapper, selfmon, _ = _node("port")
    eng = QueryEngine("filodb_self", ms, mapper, device="cpu")
    a = PromHttpApi({"filodb_self": eng})
    a.scraper = selfmon.SelfScraper(ms, "filodb_self", mapper,
                                    interval_s=3600.0)
    return a


def _instant(api, q, t):
    st, p = api.handle("GET", "/api/v1/query", {"query": q, "time": str(t)})
    assert st == 200, p
    return p["data"]["result"]


def test_scrape_makes_metrics_promql_queryable(api):
    from filodb_tpu_torch.utils.metrics import registry
    registry.counter("selfmon_probe", dataset="prometheus").increment(7)
    registry.histogram("selfmon_probe_seconds",
                       dataset="prometheus").record(0.004)
    assert api.scraper.scrape_once() > 0
    now = int(time.time()) + 1
    (row,) = _instant(api, 'selfmon_probe_total{job="filodb",'
                           'dataset="prometheus"}', now)
    assert float(row["value"][1]) == 7.0
    assert row["metric"]["_ws_"] == "_self_"
    assert row["metric"]["instance"] == "local"
    (row,) = _instant(api, "selfmon_probe_seconds_count", now)
    assert float(row["value"][1]) == 1.0
    assert len(_instant(api, 'selfmon_probe_seconds_bucket{le="+Inf"}',
                        now)) == 1
    # a counter incremented between two scrapes answers both values
    registry.counter("selfmon_probe", dataset="prometheus").increment(5)
    time.sleep(1.1)
    api.scraper.scrape_once()
    st, p = api.handle("GET", "/api/v1/query_range", {
        "query": 'selfmon_probe_total{dataset="prometheus"}',
        "start": str(now - 30), "end": str(int(time.time()) + 1),
        "step": "1"})
    assert st == 200
    vals = sorted({float(v) for _, v in p["data"]["result"][0]["values"]})
    assert vals == [7.0, 12.0]


def test_alert_fires_on_a_job_error_streak(api):
    """A job-error streak -> the scraped job_consecutive_errors series ->
    a ruler alert evaluated through the frontend -> firing; recovery
    resolves it."""
    from filodb_tpu_torch.config import RulesConfig
    from filodb_tpu_torch.rules import (MemstoreSink, Rule, RuleGroup,
                                        Ruler, WebhookNotifier)
    from filodb_tpu_torch.utils.jobs import jobs
    ruler = Ruler(api.frontends["filodb_self"],
                  MemstoreSink(api.scraper.sink.memstore, "filodb_self",
                               api.scraper.sink.mapper),
                  groups=[RuleGroup("self_monitoring", 10.0, (Rule(
                      "BackgroundJobFailing",
                      'max by (exported_job) (job_consecutive_errors'
                      '{job="filodb"}) > 2', "alerting",
                      labels=(("severity", "page"),)),))],
                  config=RulesConfig(),
                  notifier=WebhookNotifier(sleep=lambda s: None))
    api.ruler = ruler
    h = jobs.register("victim", dataset="prometheus")
    try:
        for _ in range(3):
            h.note_error("induced failure")
        api.scraper.scrape_once()
        assert ruler.evaluate_group("self_monitoring", ts=time.time() + 1)
        st, p = api.handle("GET", "/api/v1/alerts", {})
        mine = [a for a in p["data"]["alerts"]
                if a["labels"].get("exported_job") == "victim"]
        assert [a["state"] for a in mine] == ["firing"]
        h.note_ok()
        api.scraper.scrape_once()
        assert ruler.evaluate_group("self_monitoring", ts=time.time() + 2)
        st, p = api.handle("GET", "/api/v1/alerts", {})
        assert not [a for a in p["data"]["alerts"]
                    if a["labels"].get("exported_job") == "victim"]
    finally:
        jobs.unregister("victim", dataset="prometheus")


def test_loop_runs_as_a_job_and_stops():
    from filodb_tpu_torch.utils.jobs import jobs
    ms, mapper, selfmon, registry = _node("port")
    sc = selfmon.SelfScraper(ms, "filodb_self", mapper, interval_s=0.05)
    assert sc.interval_s == 0.05
    assert sc.start() is sc and sc.start() is sc      # idempotent
    try:
        deadline = time.time() + 10
        while sc.scrapes < 2 and time.time() < deadline:
            time.sleep(0.02)
    finally:
        sc.stop()
    assert sc.scrapes >= 2 and sc._thread is None
    h = jobs.get("selfmon", dataset="filodb_self")
    assert h is not None and h.snapshot()["runs"] >= 2
    assert registry.gauge("selfmon_series").value == sc.last_series
    n = sc.scrapes
    time.sleep(0.2)
    assert sc.scrapes == n                            # stopped


def test_selfmon_tenant_accounted_but_scan_exempt():
    from filodb_tpu_torch.utils import selfmon
    from filodb_tpu_torch.utils.usage import INTERNAL_WORKSPACES, usage
    assert selfmon.TENANT_WS == "_self_" and "_self_" in INTERNAL_WORKSPACES
    assert usage.admit("_self_", "selfmon", warn_limit=1,
                       fail_limit=1) is None
    assert np.isfinite(selfmon._SCRAPE_BOUNDS).all()
