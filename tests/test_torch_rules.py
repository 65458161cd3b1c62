"""The rules engine of the port (filodb_tpu_torch/rules/) against the JAX
package's (filodb_tpu/rules/), modelled on tests/test_rules.py.

Both packages get the same counters (numpy, from a seed) in a one-shard
CPU memstore with a QueryFrontend over it; the same rule groups evaluate
at the same driven timestamps.  Held to each other: config loading and
its refusals, recorded values (rtol 2e-4 / atol 1e-3; the port's recorded
sample is bit-identical to its own ad-hoc instant query), the alert state
machine's transitions and notifications, restore after a restart, the
failure domain (a dead shard, a failed write-back), hot reload, and the
/api/v1/rules, /api/v1/alerts and /admin/rules/reload payloads with the
timing field `evaluationTime` masked.
"""
import dataclasses
import json
import time

import numpy as np
import pytest

START = 1_600_000_000_000
S_SEC = START // 1000
T = 120                                    # 20 min of 10 s scrapes
DATA_END_S = S_SEC + (T - 1) * 10
RTOL, ATOL = 2e-4, 1e-3

EXPR = 'sum by (_ns_)(rate(request_total[5m]))'
REC = "ns:request_total:rate5m"
PKGS = ("jax", "port")


@pytest.fixture(autouse=True, scope="module")
def _clear_compile_journal():
    """The JAX engine journals its jit compiles; the reference's health
    model reads them as a compile storm in the next test file."""
    yield
    from filodb_tpu.utils.events import journal
    journal.clear()


class _Pkg:
    """The modules of one package under one set of names."""

    def __init__(self, pkg):
        self.pkg = pkg
        if pkg == "jax":
            from filodb_tpu import config, rules
            from filodb_tpu.core.memstore import TimeSeriesMemStore
            from filodb_tpu.core.partkey import PartKey
            from filodb_tpu.http.routes import PromHttpApi
            from filodb_tpu.ingest.generator import counter_batch
            from filodb_tpu.query.engine import QueryEngine
            from filodb_tpu.query.frontend import QueryFrontend
            from filodb_tpu.rules import ruler as ruler_mod
            from filodb_tpu.utils.faults import faults
            from filodb_tpu.utils.metrics import registry
            kw = {}
        else:
            from filodb_tpu_torch import config, rules
            from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
            from filodb_tpu_torch.core.partkey import PartKey
            from filodb_tpu_torch.http.routes import PromHttpApi
            from filodb_tpu_torch.ingest.generator import counter_batch
            from filodb_tpu_torch.query.engine import QueryEngine
            from filodb_tpu_torch.query.frontend import QueryFrontend
            from filodb_tpu_torch.rules import ruler as ruler_mod
            from filodb_tpu_torch.utils.faults import faults
            from filodb_tpu_torch.utils.metrics import registry
            kw = {"device": "cpu"}
        self.config, self.rules, self.ruler_mod = config, rules, ruler_mod
        self.TimeSeriesMemStore, self.QueryEngine = TimeSeriesMemStore, \
            QueryEngine
        self.QueryFrontend, self.PromHttpApi = QueryFrontend, PromHttpApi
        self.counter_batch, self.faults = counter_batch, faults
        self.registry, self.kw, self.PartKey = registry, kw, PartKey

    def rule(self, *a, **kw):
        return self.rules.Rule(*a, **kw)

    def group(self, name, interval, rules):
        return self.rules.RuleGroup(name, interval, tuple(
            r if isinstance(r, self.rules.Rule) else self.rule(*r)
            for r in rules))


class _FlakySource:
    """Source wrapper whose shards can be 'killed': get_shard raises a
    ConnectionError for dead shards."""

    def __init__(self, inner):
        self.inner = inner
        self.dead = set()

    @property
    def device(self):
        return getattr(self.inner, "device", None)

    def get_shard(self, dataset, shard):
        if shard in self.dead:
            raise ConnectionError(f"injected: shard {shard} dead")
        return self.inner.get_shard(dataset, shard)

    def shards_for(self, dataset):
        return self.inner.shards_for(dataset)


def _values(S, seed):
    """[S, T] counters: linear (seed None, as tests/test_rules.py) or
    seeded increments."""
    if seed is None:
        return (np.arange(T, dtype=np.float64)[None, :] * 5.0
                + np.arange(S, dtype=np.float64)[:, None])
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(4.0, size=(S, T)), axis=1)


class _Fix:
    """S counter series on one shard of dataset "d", a frontend over
    them and the ruler's sink."""

    def __init__(self, pkg, S=20, flaky=False, seed=None):
        p = self.p = _Pkg(pkg)
        self.ms = p.TimeSeriesMemStore(**p.kw)
        sh = self.ms.setup("d", 0)
        base = p.counter_batch(S, 1, start_ms=START)
        ts2d = np.broadcast_to(START + np.arange(T, dtype=np.int64)
                               * 10_000, (S, T))
        sh.ingest_columns("prom-counter", base.part_keys, ts2d,
                          {"count": _values(S, seed)})
        self.source = _FlakySource(self.ms) if flaky else self.ms
        self.eng = p.QueryEngine("d", self.source, **p.kw)
        self.fe = p.QueryFrontend(self.eng)
        self.sink = p.rules.MemstoreSink(self.ms, "d")

    def ruler(self, groups, **kw):
        p = self.p
        kw.setdefault("notifier", p.rules.WebhookNotifier(
            sleep=lambda s: None))
        kw.setdefault("config", p.config.RulesConfig())
        return p.rules.Ruler(self.fe, self.sink, groups=groups, **kw)

    def vec(self, q, ts):
        res = self.fe.query_instant(q, ts)
        assert res.error is None, res.error
        return {tuple(sorted(k.labels_dict.items())):
                float(np.asarray(v)[-1]) for k, _, v in res.series()}


def _close(a, b):
    return abs(a - b) <= ATOL + RTOL * abs(b)


def _mask(payload):
    """A rules/alerts payload with evaluationTime masked and each alert's
    `value` string parsed (held with tolerance by _same_payload)."""
    if isinstance(payload, dict):
        return {k: ("<t>" if k == "evaluationTime" else
                    float(v) if k == "value" else _mask(v))
                for k, v in payload.items()}
    if isinstance(payload, list):
        return [_mask(x) for x in payload]
    return payload


def _same_payload(got, want, where=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (where, got, want)
        for k in want:
            _same_payload(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), \
            (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _same_payload(g, w, f"{where}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert _close(got, want), (where, got, want)
    else:
        assert got == want, (where, got, want)


# ------------------------------------------------------------ config


def _groups_of(pkg, cfg_kw):
    p = _Pkg(pkg)
    return [dataclasses.asdict(g)
            for g in p.rules.load_rule_groups(p.config.RulesConfig(**cfg_kw))]


def test_config_loads_inline_and_file_like_the_reference(tmp_path):
    f = tmp_path / "rules.json"
    f.write_text(json.dumps({"groups": [
        {"name": "filegroup", "interval": "1m", "rules": [
            {"record": "file:metric", "expr": "sum(request_total)"},
            {"alert": "FileAlert", "expr": "sum(request_total) > 0",
             "for": "90s", "keep_firing_for": 120,
             "labels": {"severity": "page"},
             "annotations": {"summary": "hot"}},
        ]}]}))
    conf = tmp_path / "rules.conf"
    conf.write_text("rules {\n  groups {\n    confgroup {\n"
                    "      interval = 45s\n      rules {\n        r {\n"
                    '          record = "c:m"\n'
                    '          expr = "sum(x)"\n'
                    "        }\n      }\n    }\n  }\n}\n")
    kw = dict(file=str(f), groups={
        "inline": {"interval": 15, "rules": {
            "r": {"record": "inline:metric", "expr": "sum(heap_usage)"}}}})
    got = _groups_of("port", kw)
    assert got == _groups_of("jax", kw)
    by = {g["name"]: g for g in got}
    assert set(by) == {"filegroup", "inline"}
    assert by["filegroup"]["interval_s"] == 60.0
    al = by["filegroup"]["rules"][1]
    assert (al["kind"], al["for_s"], al["keep_firing_for_s"]) == \
        ("alerting", 90.0, 120.0)
    hk = dict(file=str(conf))
    assert _groups_of("port", hk) == _groups_of("jax", hk)
    assert _groups_of("port", hk)[0]["interval_s"] == 45.0


@pytest.mark.parametrize("raw", [
    {"record": "bad name", "expr": "sum(x)"},        # bad metric name
    {"record": "ok", "expr": "sum(("},               # bad PromQL
    {"record": "ok", "expr": "sum(x)", "for": "1m"},  # for on recording
    {"alert": "A"},                                  # missing expr
    {"record": "ok", "alert": "A", "expr": "x"},     # both kinds
    {"record": "ok", "expr": "x", "bogus": 1},       # unknown key
    {"alert": "A", "expr": "x", "for": True},        # not a duration
    {"alert": "A", "expr": "x", "labels": {"bad-label": "v"}},
])
def test_config_refusals_equal_the_reference(raw):
    errs = []
    for pkg in PKGS:
        p = _Pkg(pkg)
        cfg = p.config.RulesConfig(groups={"g": {"rules": {"r": raw}}})
        with pytest.raises(p.rules.RulesConfigError) as e:
            p.rules.load_rule_groups(cfg)
        errs.append(str(e.value))
    # the parser's own message may word a bad expr differently
    if raw.get("expr") == "sum((":
        assert all(e.startswith("rules group 'g'.rules.r: bad expr:")
                   for e in errs)
    else:
        assert errs[0] == errs[1]


def test_config_rejects_duplicate_groups(tmp_path):
    f = tmp_path / "rules.json"
    f.write_text(json.dumps({"groups": [
        {"name": "g", "rules": [{"record": "a:b", "expr": "sum(x)"}]}]}))
    errs = []
    for pkg in PKGS:
        p = _Pkg(pkg)
        cfg = p.config.RulesConfig(file=str(f), groups={
            "g": {"rules": {"r": {"record": "a:b", "expr": "sum(x)"}}}})
        with pytest.raises(p.rules.RulesConfigError,
                           match="defined twice") as e:
            p.rules.load_rule_groups(cfg)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_settings_overlay_parses_rules_block():
    p = _Pkg("port")
    s = p.config.FilodbSettings()
    s.overlay({"rules": {"enabled": True, "default_interval_s": 15,
                         "groups": {"g": {"rules": {
                             "r": {"record": "a:b", "expr": "sum(x)"}}}}}})
    assert s.rules.enabled is True
    assert p.rules.load_rule_groups(s.rules)[0].interval_s == 15.0


# --------------------------------------------------------- recording


def test_recorded_identical_to_adhoc_and_to_the_reference():
    ticks = [DATA_END_S - 60, DATA_END_S - 30, DATA_END_S]
    rec = {}
    for pkg in PKGS:
        fx = _Fix(pkg, S=48, seed=15)
        ruler = fx.ruler([fx.p.group("g", 30.0, [(REC, EXPR, "recording")])])
        for ts in ticks:
            assert ruler.evaluate_group("g", ts=ts)
        rec[pkg] = []
        for ts in ticks:
            hand = fx.vec(EXPR, ts)
            got = fx.vec(REC, ts)
            assert len(hand) == 10
            # the recorded sample IS the evaluated value, to the bit
            assert {k: v for k, v in got.items()} == {
                tuple(sorted(dict(k, _metric_=REC).items())): v
                for k, v in hand.items()}, (pkg, ts)
            rec[pkg].append(got)
    for want, got in zip(rec["jax"], rec["port"]):
        assert set(got) == set(want)
        assert all(_close(got[k], want[k]) for k in want)


def test_later_rules_see_earlier_rules_output():
    for pkg in PKGS:
        fx = _Fix(pkg, seed=15)
        ruler = fx.ruler([fx.p.group("g", 30.0, [
            (REC, EXPR, "recording"),
            ("total:rate5m", f"sum({REC})", "recording")])])
        assert ruler.evaluate_group("g", ts=DATA_END_S)
        first = fx.vec(REC, DATA_END_S)
        (second,) = fx.vec("total:rate5m", DATA_END_S).values()
        np.testing.assert_allclose(second, sum(first.values()), rtol=1e-6)


def test_recording_labels_override_and_rename():
    fx = _Fix("port")
    ruler = fx.ruler([fx.p.group("g", 30.0, [fx.p.rule(
        REC, EXPR, "recording", labels=(("tier", "gold"),))])])
    assert ruler.evaluate_group("g", ts=DATA_END_S)
    res = fx.fe.query_instant(REC + '{tier="gold"}', DATA_END_S)
    assert res.error is None and res.num_series > 0
    for k, _, _v in res.series():
        assert k.labels_dict["_metric_"] == REC
        assert k.labels_dict["tier"] == "gold"


def test_fractional_tick_records_at_eval_timestamp():
    fx = _Fix("port")
    ruler = fx.ruler([fx.p.group("g", 30.0, [
        (REC, EXPR, "recording"), ("total:sum", f"sum({REC})",
                                   "recording")])])
    assert ruler.evaluate_group("g", ts=DATA_END_S + 0.345)
    res = fx.fe.query_instant("total:sum", DATA_END_S)
    assert res.error is None and res.num_series == 1
    assert [int(np.asarray(w)[-1]) for _, w, _ in res.series()] == \
        [DATA_END_S * 1000]


# ------------------------------------------------------ alert machine


def _alert_run(pkg, steps, rule_kw, cfg_kw=None):
    """Evaluate one alerting rule at each ts of `steps` -> per step
    (ok, alerts payload, notifications so far)."""
    fx = _Fix(pkg)
    kw = {}
    if cfg_kw is not None:
        kw["config"] = fx.p.config.RulesConfig(**cfg_kw)
    ruler = fx.ruler([fx.p.group("g", 30.0, [fx.p.rule(**rule_kw)])], **kw)
    out = []
    for ts in steps:
        ok = ruler.evaluate_group("g", ts=ts)
        out.append((ok, _mask(ruler.alerts_payload()),
                    json.loads(json.dumps(ruler.notifier.snapshot()))))
    return out, fx, ruler


def test_alert_transitions_equal_the_reference():
    rule_kw = dict(name="HighRate", expr="sum(rate(request_total[5m])) > 0",
                   kind="alerting", labels=(("severity", "page"),),
                   annotations=(("summary", "traffic exists"),),
                   for_s=60.0, keep_firing_for_s=120.0)
    t1 = DATA_END_S - 120
    t_gone = DATA_END_S + 400
    steps = [t1, t1 + 30, t1 + 60, t1 + 90, t_gone, t_gone + 60,
             t_gone + 121]
    runs = {pkg: _alert_run(pkg, steps, rule_kw,
                            {"notify_resend_delay_s": 0.0})
            for pkg in PKGS}
    _same_payload([r[:2] for r in runs["port"][0]],
                  [r[:2] for r in runs["jax"][0]])
    assert [r[2] for r in runs["port"][0]] == [r[2] for r in runs["jax"][0]]
    states = [[a["state"] for a in r[1]["alerts"]] for r in runs["port"][0]]
    assert states == [["pending"], ["pending"], ["firing"], ["firing"],
                      ["firing"], ["firing"], []]
    assert len(runs["port"][0][-1][2]) == 1      # one notification
    # the synthetic series are queryable
    _, fx, _ = runs["port"]
    res = fx.fe.query_instant('ALERTS_FOR_STATE{alertname="HighRate"}',
                              t1 + 60)
    assert [float(np.asarray(v)[-1]) for _, _, v in res.series()] == \
        [float(t1)]


def test_pending_alert_clears_without_firing():
    rule_kw = dict(name="A", expr="sum(rate(request_total[5m])) > 0",
                   kind="alerting", for_s=600.0)
    runs = {pkg: _alert_run(pkg, [DATA_END_S, DATA_END_S + 400], rule_kw)[0]
            for pkg in PKGS}
    _same_payload(runs["port"], runs["jax"])
    assert [[a["state"] for a in r[1]["alerts"]] for r in runs["port"]] == \
        [["pending"], []]
    assert runs["port"][-1][2] == []


def test_alert_state_restored_after_restart():
    for pkg in PKGS:
        fx = _Fix(pkg)
        mk = lambda: fx.p.group("g", 30.0, [fx.p.rule(
            "Slow", "sum(rate(request_total[5m])) > 0", "alerting",
            for_s=240.0)])
        t1 = DATA_END_S - 240
        r1 = fx.ruler([mk()])
        assert r1.evaluate_group("g", ts=t1)
        assert r1.alerts_payload()["alerts"][0]["state"] == "pending"
        r2 = fx.ruler([mk()])                   # the restart
        assert r2.evaluate_group("g", ts=t1 + 240)
        alerts = r2.alerts_payload()["alerts"]
        assert [a["state"] for a in alerts] == ["firing"], pkg
        # activeAt is the ORIGINAL activation, not the restart time
        assert alerts[0]["activeAt"] == fx.p.ruler_mod._iso(float(t1))
        assert len(r2.notifier.snapshot()) == 1


def test_resolved_alert_not_resurrected_by_restart():
    got = {}
    for pkg in PKGS:
        fx = _Fix(pkg)
        mk = lambda: fx.p.group("g", 30.0, [fx.p.rule(
            "Any", "sum(rate(request_total[5m])) > 0", "alerting",
            for_s=120.0)])
        r1 = fx.ruler([mk()])
        for ts in (DATA_END_S - 120, DATA_END_S, DATA_END_S + 250,
                   DATA_END_S + 310):
            assert r1.evaluate_group("g", ts=ts)
        assert r1.alerts_payload()["alerts"] == []
        # traffic returns in a second data window
        sh = fx.ms.get_shard("d", 0)
        base = fx.p.counter_batch(20, 1, start_ms=START)
        ts2 = np.broadcast_to((DATA_END_S + 320) * 1000
                              + np.arange(30, dtype=np.int64) * 10_000,
                              (20, 30))
        vals2 = (np.arange(30, dtype=np.float64)[None, :] * 7.0
                 + np.arange(20, dtype=np.float64)[:, None])
        sh.ingest_columns("prom-counter", base.part_keys, ts2,
                          {"count": vals2})
        # a restart inside the lookback of the resolved episode's last
        # ALERTS_FOR_STATE sample: the NaN marker hides it
        r2 = fx.ruler([mk()])
        t_restart = DATA_END_S + 450
        assert r2.evaluate_group("g", ts=t_restart)
        alerts = r2.alerts_payload()["alerts"]
        assert [a["state"] for a in alerts] == ["pending"], pkg
        assert alerts[0]["activeAt"] == fx.p.ruler_mod._iso(
            float(t_restart))
        got[pkg] = _mask(alerts)
    _same_payload(got["port"], got["jax"])


# ------------------------------------------------------ failure domain


def test_dead_shard_fails_iteration_without_partials_or_flapping():
    for pkg in PKGS:
        fx = _Fix(pkg, flaky=True)
        reg = fx.p.registry
        ruler = fx.ruler([fx.p.group("g", 30.0, [
            (REC, EXPR, "recording"),
            ("Any", "sum(rate(request_total[5m])) > 0", "alerting")])])
        t1 = DATA_END_S - 60
        assert ruler.evaluate_group("g", ts=t1)
        assert ruler.alerts_payload()["alerts"][0]["state"] == "firing"
        sh = fx.ms.get_shard("d", 0)
        rows_before = sh.stats.rows_ingested
        fails0 = reg.counter("rule_evaluation_failures", group="g").value
        fx.source.dead.add(0)
        assert ruler.evaluate_group("g", ts=t1 + 30) is False
        assert reg.counter("rule_evaluation_failures",
                           group="g").value - fails0 == 2
        assert sh.stats.rows_ingested == rows_before
        alerts = ruler.alerts_payload()["alerts"]
        assert [a["state"] for a in alerts] == ["firing"]
        assert len(ruler.notifier.snapshot()) == 1
        rules = ruler.rules_payload()["groups"][0]["rules"]
        assert all(r["health"] == "err" and r["lastError"] for r in rules)
        fx.source.dead.discard(0)
        assert ruler.evaluate_group("g", ts=t1 + 60)
        assert sh.stats.rows_ingested > rows_before
        assert all(r["health"] == "ok"
                   for r in ruler.rules_payload()["groups"][0]["rules"])


def test_shard_not_locally_owned_fails_the_write():
    from filodb_tpu_torch.parallel.shardmapper import ShardMapper
    fx = _Fix("port")
    sink = fx.p.rules.MemstoreSink(fx.ms, "d", ShardMapper(4))
    keys = [fx.p.PartKey.make("m", {"_ws_": "w", "_ns_": f"n{i}"})
            for i in range(64)]
    with pytest.raises(ConnectionError, match="is not locally owned"):
        sink.write(keys, START, np.ones(64))


def test_write_back_fault_fails_iteration():
    for pkg in PKGS:
        fx = _Fix(pkg)
        ruler = fx.ruler([fx.p.group("g", 30.0, [(REC, EXPR, "recording")])])
        sh = fx.ms.get_shard("d", 0)
        rows_before = sh.stats.rows_ingested
        with fx.p.faults.plan("ingest.batch", "error", first_k=1):
            assert ruler.evaluate_group("g", ts=DATA_END_S) is False
        assert sh.stats.rows_ingested == rows_before


def test_alert_state_holds_when_synthetic_write_back_fails():
    fx = _Fix("port")
    ruler = fx.ruler([fx.p.group("g", 30.0, [fx.p.rule(
        "Any", "sum(rate(request_total[5m])) > 0", "alerting")])])
    with fx.p.faults.plan("ingest.batch", "error", first_k=1):
        assert ruler.evaluate_group("g", ts=DATA_END_S) is False
    assert ruler.alerts_payload()["alerts"] == []
    assert ruler.evaluate_group("g", ts=DATA_END_S + 30)
    assert ruler.alerts_payload()["alerts"][0]["state"] == "firing"


# ------------------------------------------------------------ notifier


def test_notifier_retry_backoff_and_drop():
    for pkg in PKGS:
        p = _Pkg(pkg)
        sleeps = []
        n = p.rules.WebhookNotifier(retries=3, backoff_s=0.5,
                                    sleep=sleeps.append)
        with p.faults.plan("ruler.notify", "error", first_k=2):
            assert n.notify([{"labels": {"alertname": "A"}}]) is True
        assert sleeps == [0.5, 1.0]
        assert len(n.snapshot()) == 1
        dropped0 = p.registry.counter("rule_notifications_dropped").value
        with p.faults.plan("ruler.notify", "error", first_k=99):
            assert n.notify([{"labels": {"alertname": "A"}}]) is False
        assert p.registry.counter(
            "rule_notifications_dropped").value - dropped0 == 1


def test_notifier_posts_to_a_webhook():
    """URL mode: batches go to a dispatch thread that POSTs the
    Alertmanager-shaped JSON (a stdlib receiver on localhost)."""
    import http.server
    import threading
    got = []

    class H(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            got.append(json.loads(self.rfile.read(
                int(self.headers["Content-Length"]))))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass
    srv = http.server.HTTPServer(("127.0.0.1", 0), H)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        fx = _Fix("port")
        n = fx.p.rules.WebhookNotifier(
            url=f"http://127.0.0.1:{srv.server_port}/hook")
        ruler = fx.ruler([fx.p.group("g", 30.0, [fx.p.rule(
            "Any", "sum(rate(request_total[5m])) > 0", "alerting")])],
            notifier=n)
        assert ruler.evaluate_group("g", ts=DATA_END_S)
        deadline = time.time() + 10
        while not got and time.time() < deadline:
            time.sleep(0.02)
        assert len(got) == 1
        assert got[0]["version"] == "4" and got[0]["status"] == "firing"
        (alert,) = got[0]["alerts"]
        assert alert["status"] == "firing" and alert["endsAt"] == ""
        assert alert["labels"]["alertname"] == "Any"
        assert n.snapshot() == got
    finally:
        srv.shutdown()
        srv.server_close()


# --------------------------------------------------------- hot reload


def test_hot_reload_add_remove_modify_preserves_state():
    for pkg in PKGS:
        fx = _Fix(pkg)
        p = fx.p
        alert = p.rule("Any", "sum(rate(request_total[5m])) > 0",
                       "alerting")
        ga = p.group("a", 30.0, [alert, (REC, EXPR, "recording")])
        gb = p.group("b", 30.0, [("b:m", "sum(heap_usage)", "recording")])
        ruler = fx.ruler([ga, gb])
        assert ruler.evaluate_group("a", ts=DATA_END_S)
        active_at = ruler.alerts_payload()["alerts"][0]["activeAt"]
        ga2 = p.group("a", 30.0, [alert, (REC, EXPR, "recording"),
                                  ("extra:m", "sum(request_total)",
                                   "recording")])
        gc = p.group("c", 60.0, [("c:m", "sum(request_total)",
                                  "recording")])
        assert ruler.reload([ga2, gc]) == {
            "groups": 2, "added": ["c"], "removed": ["b"],
            "changed": ["a"]}
        assert ruler.group_names() == ["a", "c"]
        assert [a["activeAt"] for a in ruler.alerts_payload()["alerts"]] \
            == [active_at]
        assert ruler.evaluate_group("c", ts=DATA_END_S + 30)
        with pytest.raises(KeyError):
            ruler.evaluate_group("b", ts=DATA_END_S + 30)
        with pytest.raises(p.rules.RulesConfigError):
            ruler.reload([gc, gc])
        assert ruler.group_names() == ["a", "c"]


def test_reload_rereads_config_source_and_refuses_without_one():
    fx = _Fix("port")
    RC = fx.p.config.RulesConfig
    cfgs = [RC(groups={"g1": {"interval": 30, "rules": {
                "r": {"record": REC, "expr": EXPR}}}}),
            RC(groups={"g2": {"interval": 60, "rules": {
                "r": {"record": "other:m", "expr": "sum(heap_usage)"}}}})]
    ruler = fx.ruler(None, config_source=lambda: cfgs.pop(0))
    assert ruler.reload()["added"] == ["g1"]
    assert ruler.reload() == {"groups": 1, "added": ["g2"],
                              "removed": ["g1"], "changed": []}
    ruler.config_source = lambda: (_ for _ in ()).throw(OSError("gone"))
    with pytest.raises(fx.p.rules.RulesConfigError):
        ruler.reload()
    assert ruler.group_names() == ["g2"]
    bare = fx.ruler([fx.p.group("g", 30.0, [(REC, EXPR, "recording")])])
    with pytest.raises(fx.p.rules.RulesConfigError, match="no reloadable"):
        bare.reload()
    assert bare.group_names() == ["g"]


def test_reload_rebuilds_owned_notifier():
    fx = _Fix("port")
    RC = fx.p.config.RulesConfig
    grp = {"g": {"interval": 30, "rules": {
        "r": {"record": REC, "expr": EXPR}}}}
    owned = fx.p.rules.Ruler(fx.fe, fx.sink, config=RC(groups=grp))
    assert owned.notifier.url == ""
    owned.config_source = lambda: RC(
        groups=grp, notify_url="http://am.example/webhook",
        notify_retries=1)
    owned.reload()
    assert owned.notifier.url == "http://am.example/webhook"
    assert owned.notifier.retries == 1
    injected = fx.p.rules.WebhookNotifier(sleep=lambda s: None)
    ruler = fx.p.rules.Ruler(fx.fe, fx.sink, config=RC(groups=grp),
                             notifier=injected)
    ruler.config_source = lambda: RC(groups=grp, notify_url="http://x/")
    ruler.reload()
    assert ruler.notifier is injected


# ---------------------------------------------------------- scheduler


def test_scheduler_evaluates_on_interval():
    fx = _Fix("port", S=4)
    offset = DATA_END_S - time.time()
    ruler = fx.ruler([fx.p.group("sched", 0.2, [(REC, EXPR, "recording")])],
                     clock=lambda: time.time() + offset)
    ruler.start()
    try:
        deadline = time.time() + 10.0
        while time.time() < deadline:
            if ruler.rules_payload()["groups"][0]["rules"][0][
                    "health"] == "ok":
                break
            time.sleep(0.05)
        assert ruler.rules_payload()["groups"][0]["rules"][0][
            "health"] == "ok", "scheduler never evaluated the group"
    finally:
        ruler.stop()


def test_stagger_and_deadline_equal_the_reference():
    from filodb_tpu.utils.hashing import xxhash32 as jx
    from filodb_tpu_torch.utils.hashing import xxhash32 as px
    for name in (b"group-one", b"group-two", b"request-rates"):
        assert px(name) == jx(name)
    from filodb_tpu_torch.query.rangevector import compute_deadline
    fx = _Fix("port")
    g = fx.p.group("g", 300.0, [(REC, EXPR, "recording")])
    ruler = fx.ruler([g])
    t0 = time.time()
    pp = ruler._planner_params(g)
    assert pp.deadline_unix_s >= t0 + 299.0
    assert pp.allow_partial_results is False
    assert compute_deadline(pp, 120.0) == pp.deadline_unix_s
    assert ruler.evaluate_group("g", ts=DATA_END_S)


def test_rules_tenant_exempt_from_scan_limits():
    from filodb_tpu_torch.utils.usage import usage
    usage.clear()
    usage.record_query("_rules_", "g", 0.1, 10_000, 0)
    usage.record_query("heavy", "", 0.1, 10_000, 0)
    assert usage.admit("_rules_", "g", 10, 100) is None
    err = usage.admit("heavy", "", 10, 100)
    assert err is not None and "tenant_limit_exceeded" in err
    # the evaluations bill to the `_rules_` bucket
    fx = _Fix("port")
    ruler = fx.ruler([fx.p.group("agg", 30.0, [(REC, EXPR, "recording")])])
    assert ruler.evaluate_group("agg", ts=DATA_END_S)
    assert ("_rules_", "agg") in {(t["ws"], t["ns"])
                                  for t in usage.snapshot()}


# ----------------------------------------------------------- HTTP API


def _api(pkg, cfg_groups):
    fx = _Fix(pkg)
    p = fx.p
    api = p.PromHttpApi({"d": fx.eng})
    ruler = p.rules.Ruler(
        api.frontends["d"], fx.sink, config=p.config.RulesConfig(
            groups=cfg_groups, notify_resend_delay_s=0.0),
        notifier=p.rules.WebhookNotifier(sleep=lambda s: None))
    api.ruler = ruler
    return api, ruler


GROUPS = {"agg": {"interval": "30s", "rules": {
    "r1": {"record": REC, "expr": EXPR},
    "a1": {"alert": "AnyTraffic", "expr": "sum(rate(request_total[5m])) > 0",
           "for": "30s", "labels": {"severity": "page"},
           "annotations": {"summary": "traffic"}}}}}


def test_http_rules_and_alerts_payloads_equal_the_reference():
    got = {}
    for pkg in PKGS:
        api, ruler = _api(pkg, GROUPS)
        seq = []
        for ts in (DATA_END_S - 30, DATA_END_S):
            ruler.evaluate_group("agg", ts=ts)
            for path, params in (("/api/v1/rules", {}),
                                 ("/api/v1/rules", {"type": "record"}),
                                 ("/api/v1/rules", {"type": "alert"}),
                                 ("/api/v1/alerts", {})):
                st, payload = api.handle("GET", path, params)
                assert st == 200, (pkg, path, payload)
                seq.append(_mask(payload))
        st, q = api.handle("GET", "/api/v1/query",
                           {"query": REC, "time": str(DATA_END_S)})
        assert st == 200 and len(q["data"]["result"]) == 10
        got[pkg] = seq
    _same_payload(got["port"], got["jax"])
    rules = got["port"][4]["data"]["groups"][0]["rules"]
    assert [r["health"] for r in rules] == ["ok", "ok"]
    assert rules[1]["state"] == "firing"
    assert [a["state"] for a in got["port"][-1]["data"]["alerts"]] == \
        ["firing"]


def test_http_rules_reload_and_runtimeinfo():
    for pkg in PKGS:
        api, ruler = _api(pkg, GROUPS)
        st, payload = api.handle("POST", "/admin/rules/reload", {})
        assert st == 200 and payload["data"] == {
            "groups": 1, "added": [], "removed": [], "changed": []}, pkg
        st, info = api.handle("GET", "/api/v1/status/runtimeinfo", {})
        assert st == 200 and info["data"]["reloadConfigSuccess"] is True
        ruler.config.groups = {"bad": {"rules": {"r": {"record": "x"}}}}
        st, payload = api.handle("POST", "/admin/rules/reload", {})
        assert st == 400 and "rules reload rejected" in payload["error"]
        st, info = api.handle("GET", "/api/v1/status/runtimeinfo", {})
        assert info["data"]["reloadConfigSuccess"] is False
        assert ruler.group_names() == ["agg"]


def test_http_without_a_ruler_answers_as_the_reference():
    for pkg in PKGS:
        fx = _Fix(pkg)
        api = fx.p.PromHttpApi({"d": fx.eng})
        assert api.ruler is None
        assert api.handle("GET", "/api/v1/rules", {}) == (
            200, {"status": "success", "data": {"groups": []}})
        assert api.handle("GET", "/api/v1/alerts", {}) == (
            200, {"status": "success", "data": {"alerts": []}})
        st, payload = api.handle("POST", "/admin/rules/reload", {})
        assert st == 400 and "no ruler configured" in payload["error"]
        assert api.handle("GET", "/promql/d/api/v1/rules", {})[0] == 200
    # the routes still unported answer 501
    fx = _Fix("port")
    api = fx.p.PromHttpApi({"d": fx.eng})
    for method, path in (("GET", "/admin/shards"),
                         ("GET", "/admin/federation"),
                         ("GET", "/cluster/d/status")):
        st, payload = api.handle(method, path, {})
        assert st == 501 and payload["errorType"] == "not_ported", path


def test_plain_selector_returns_the_stored_sample():
    """ALERTS_FOR_STATE holds activeAt in unix seconds (~1.6e9): lookback
    sampling returns the stored f64 sample, as the reference's does, not
    its f32 rounding (a multiple of 128 there, up to 64 s off)."""
    got = {}
    for pkg in PKGS:
        fx = _Fix(pkg)
        keys = [fx.p.PartKey.make("ALERTS_FOR_STATE", {"alertname": a})
                for a in ("A", "B")]
        sh = fx.ms.get_shard("d", 0)
        for i, v in enumerate((1600000950.0, 1600000957.0, 1600000950.0)):
            sh.ingest_columns("gauge", keys, np.full((2, 1), START
                                                      + i * 30_000),
                              {"value": np.array([[v], [v + 1.0]])})
        got[pkg] = fx.vec("ALERTS_FOR_STATE", START // 1000 + 60)
    assert got["port"] == got["jax"]
    assert sorted(got["port"].values()) == [1600000950.0, 1600000951.0]
