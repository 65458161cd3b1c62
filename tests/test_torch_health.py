"""The port's node operations surface against the JAX package's: the
job registry, the circuit breakers, the freshness tracker, the fault
registry and the health model (utils/jobs.py, parallel/breaker.py,
utils/freshness.py, utils/faults.py, utils/health.py), and the admin
routes of http/routes.py.

Each scenario sends the same sequence of calls to both packages (on
fresh registries and journals, swapped in for the test) and compares
their snapshots and verdicts with the wall-clock fields masked: a job's
error streak, a breaker opening, a freshness breach window, a compile
storm (10 compiles of one kernel within 120 s), sustained mirror
over-cap degrades (3), and readiness while booting and serving.  Then
every ported route answers the reference's status (the write doors the
reference's whole answer), and no route the reference serves answers
501 or the reference's unknown-route 404.
"""
import json
import time
import types

import numpy as np
import pytest

import filodb_tpu.parallel.breaker as jax_breaker
import filodb_tpu.utils.events as jax_events
import filodb_tpu.utils.faults as jax_faults
import filodb_tpu.utils.freshness as jax_freshness
import filodb_tpu.utils.health as jax_health
import filodb_tpu.utils.jobs as jax_jobs
import filodb_tpu_torch.parallel.breaker as breaker
import filodb_tpu_torch.utils.events as events
import filodb_tpu_torch.utils.faults as faults
import filodb_tpu_torch.utils.freshness as freshness
import filodb_tpu_torch.utils.health as health
import filodb_tpu_torch.utils.jobs as jobs
from filodb_tpu.http.routes import PromHttpApi as JaxApi
from filodb_tpu_torch.http.routes import PromHttpApi
from filodb_tpu_torch.utils import devicetelem

from test_torch_explain import build_stores

PKGS = ("port", "ref")
_MODS = {"port": types.SimpleNamespace(
             jobs=jobs, breaker=breaker, freshness=freshness,
             events=events, health=health, faults=faults),
         "ref": types.SimpleNamespace(
             jobs=jax_jobs, breaker=jax_breaker, freshness=jax_freshness,
             events=jax_events, health=jax_health, faults=jax_faults)}


@pytest.fixture(autouse=True, scope="module")
def _clear_compile_journal():
    """The JAX engine's queries journal jit compiles under their trace
    ids, which the reference's health model reads as a compile storm in
    the next test file this process runs; clear the journal after."""
    yield
    jax_events.journal.clear()


@pytest.fixture
def both(monkeypatch):
    """Fresh process-wide registries and journals in both packages."""
    for m in _MODS.values():
        monkeypatch.setattr(m.jobs, "jobs", m.jobs.JobRegistry())
        monkeypatch.setattr(m.breaker, "breakers",
                            m.breaker.BreakerRegistry())
        monkeypatch.setattr(m.freshness, "freshness",
                            m.freshness.FreshnessTracker())
        monkeypatch.setattr(m.events, "journal", m.events.EventJournal())
    return _MODS


_TIME_KEYS = {"lastDurationSeconds", "openRemainingSeconds", "seconds"}


def _mask(x):
    """Wall-clock fields out: every key naming a unix time, durations."""
    if isinstance(x, dict):
        return {k: ("<t>" if "Unix" in k or "unix" in k or k in _TIME_KEYS
                    else _mask(v)) for k, v in x.items()}
    if isinstance(x, list):
        return [_mask(v) for v in x]
    return x


def _same(fn):
    """fn(mods) in both packages -> the port's (masked) result, checked
    equal to the reference's."""
    got = {p: _mask(fn(_MODS[p])) for p in PKGS}
    assert got["port"] == got["ref"]
    return got["port"]


def _evaluator(m, **kw):
    return m.health.HealthEvaluator(**kw)


def test_job_error_streak(both):
    def run(m, fail):
        h = m.jobs.jobs.register("flush", interval_s=1.0, dataset="ds/0",
                                 critical=True)
        try:
            with h.tick():
                h.set_progress("group 3")
                if fail:
                    raise OSError("disk full")
        except OSError:
            pass
        return m.jobs.jobs.snapshot()

    for n in range(1, 6):
        snap = _same(lambda m: run(m, True))
        assert snap[0]["consecutiveErrors"] == n
        v = _same(lambda m: _evaluator(m)._jobs_verdict())
        assert v["status"] == ("failed" if n >= 5 else "degraded")
        r = _same(lambda m: _evaluator(m).ready())
        assert r[0] == (n < 5)
    _same(lambda m: run(m, False))
    v = _same(lambda m: _evaluator(m).evaluate())
    assert v["subsystems"]["jobs"]["status"] == "ok"


def test_breaker_opening(both):
    for m in both.values():
        m.breaker.breakers.configure(failure_threshold=3, open_base_s=60.0,
                                     open_max_s=120.0, jitter=0.0)
    for n in range(4):
        def fail(m):
            b = m.breaker.breakers.get("nodeB:9000")
            b.on_failure()
            return m.breaker.breakers.snapshot()
        snap = _same(fail)
        assert snap[0]["state"] == ("open" if n >= 2 else "closed")
        peers = _same(lambda m: _evaluator(m)._peers_verdict())
        assert peers["open"] == (["nodeB:9000"] if n >= 2 else [])
    _same(lambda m: m.breaker.breakers.get("nodeB:9000").allow())


def test_freshness_breach_window(both):
    for m in both.values():
        m.freshness.freshness.configure(threshold_s=0.5, breach_count=3,
                                        window_s=1.0)

    def batch(m, total_s):
        st = m.freshness.IngestStats(origin="remote_write", dataset="ds",
                                     samples=10, series=2)
        st.total_s = total_s
        m.freshness.freshness.note_batch(st)
        return _evaluator(m)._ingest_verdict()

    _same(lambda m: batch(m, 0.1))
    for n in range(3):
        v = _same(lambda m: batch(m, 1.0))
        assert v["status"] == ("degraded" if n == 2 else "ok")
    assert _same(lambda m: _evaluator(m).evaluate())["subsystems"][
        "ingest"]["status"] == "degraded"
    time.sleep(1.05)                 # the breaches age out of the window
    assert _same(lambda m: _evaluator(m)._ingest_verdict())[
        "status"] == "ok"


def test_compile_storm_at_ten_compiles(both):
    """Compiles of one kernel with a query origin, journaled through each
    package's device telemetry: the 10th inside 120 s flips the device
    verdict; compiles without an origin never count."""
    import filodb_tpu.utils.devicetelem as jax_devicetelem
    tels = {"port": devicetelem.DeviceTelemetry(),
            "ref": jax_devicetelem.DeviceTelemetry()}
    for p in PKGS:
        tels[p].record_compile("boot_warmup", seconds=0.1, origin="")
    for n in range(10):
        def compile_one(m):
            pkg = "port" if m is _MODS["port"] else "ref"
            tels[pkg].record_compile("fused_rate", shape=f"S{n}",
                                     seconds=0.5, origin="q" * 32)
            return _evaluator(m)._device_verdict()
        v = _same(compile_one)
        assert v["recentCompiles"] == n + 1
        assert v["status"] == ("degraded" if n == 9 else "ok")
    assert v["reasons"] == ["compile_storm"]
    assert v["stormKernel"] == "fused_rate"


def test_mirror_over_cap_three_times(both):
    """A mirror over its cap, refreshed three times in each package (the
    port raises MirrorCapExceeded, the reference degrades to the host):
    the mirror verdict degrades at once, the device verdict at the
    third."""
    from filodb_tpu.core.devicecache import DeviceMirror as JaxMirror
    from filodb_tpu_torch.core.devicecache import (DeviceMirror,
                                                   MirrorCapExceeded)
    jeng, eng = build_stores(shards=1)
    stores = {
        "port": eng.source.get_shard("prometheus", 0).stores["gauge"],
        "ref": jeng.source.get_shard("prometheus", 0).stores["gauge"]}
    mirrors = {"port": DeviceMirror(hbm_limit_bytes=64, device="cpu"),
               "ref": JaxMirror(hbm_limit_bytes=64)}
    for n in range(3):
        with pytest.raises(MirrorCapExceeded):
            mirrors["port"].ensure_fresh(stores["port"])
        assert mirrors["ref"].ensure_fresh(stores["ref"]) is False
        v = _same(lambda m: {"mirror": _evaluator(m)._mirror_verdict(),
                             "device": _evaluator(m)._device_verdict()})
        assert v["mirror"]["status"] == "degraded"
        assert v["device"]["status"] == ("degraded" if n == 2 else "ok")
        assert mirrors["port"].snapshot() is None
    assert v["device"]["reasons"] == ["hbm_over_cap"]
    # (the two packages size a mirror differently: nbytes not compared)
    evs = _same(lambda m: [
        {k: e[k] for k in ("kind", "subsystem", "scope", "limit")}
        for e in m.events.journal.since(0, kind="mirror_over_cap")])
    assert len(evs) == 3


def test_ready_booting_then_serving(both):
    evs = {p: _evaluator(_MODS[p], node_name="n1", phase="booting")
           for p in PKGS}
    r = _same(lambda m: evs["port" if m is _MODS["port"] else "ref"]
              .ready())
    assert tuple(r) == (False, "phase=booting")
    v = _same(lambda m: evs["port" if m is _MODS["port"] else "ref"]
              .evaluate())
    assert v["status"] == "degraded" and v["phase"] == "booting"
    for p in PKGS:
        evs[p].set_phase("serving")
    r = _same(lambda m: evs["port" if m is _MODS["port"] else "ref"]
              .ready())
    assert tuple(r) == (True, "serving")
    phases = _same(lambda m: [(e["frm"], e["to"]) for e in
                              m.events.journal.since(0, kind="phase")])
    assert phases == [("booting", "serving")]


def test_fault_registry_schedule(both):
    """first_k and seeded probability fire on the same calls in both."""
    def run(m):
        reg = m.faults.FaultRegistry(env={})
        reg.arm("device.upload", "error", first_k=2)
        reg.arm("ingest.batch", "error", probability=0.3, seed=5)
        fired = []
        for _ in range(20):
            for point in ("device.upload", "ingest.batch"):
                try:
                    reg.fire(point)
                    fired.append(0)
                except m.faults.InjectedFault:
                    fired.append(1)
        return {"fired": fired, "plans": reg.snapshot()}
    out = _same(run)
    assert sum(out["fired"]) > 2


# ------------------------------------------------------------ the routes

@pytest.fixture(scope="module")
def apis():
    jeng, eng = build_stores()
    return JaxApi({"prometheus": jeng}), PromHttpApi({"prometheus": eng})


PORTED = [
    ("GET", "/ready", {}, b""),
    ("GET", "/healthz", {}, b""),
    ("GET", "/api/v1/status/health", {}, b""),
    ("GET", "/api/v1/status/buildinfo", {}, b""),
    ("GET", "/api/v1/status/runtimeinfo", {}, b""),
    ("GET", "/promql/prometheus/api/v1/status/health", {}, b""),
    ("GET", "/admin/devices", {}, b""),
    ("GET", "/admin/devices", {"recent": "5", "kind": "kernel"}, b""),
    ("GET", "/admin/devices", {"recent": "x"}, b""),
    ("GET", "/admin/jobs", {}, b""),
    ("GET", "/admin/breakers", {}, b""),
    ("GET", "/admin/events", {"since_seq": "0", "limit": "5"}, b""),
    ("GET", "/admin/events", {"kind": "phase"}, b""),
    ("GET", "/admin/ingestlog", {}, b""),
    ("POST", "/admin/ingestlog/clear", {}, b""),
    ("GET", "/admin/ingestlog/nosuch", {}, b""),
    ("POST", "/admin/loglevel/filodb.test", {}, b"INFO"),
    ("POST", "/admin/loglevel/filodb.test", {}, b"LOUD"),
    ("GET", "/admin/tenants", {}, b""),
    ("GET", "/admin/traces", {}, b""),
    ("GET", "/admin/traces", {"origin": "nosuch"}, b""),
    ("GET", "/admin/traces/no-such-trace", {}, b""),
    ("POST", "/admin/tracedfilters", {}, b'[{"job": "api-server"}]'),
    ("POST", "/admin/tracedfilters", {}, b"[]"),
    ("POST", "/admin/tracedfilters", {}, b'{"not": "a list"}'),
    ("GET", "/admin/profiler/nosuch", {}, b""),
    ("GET", "/admin/profiler/start", {}, b""),
    ("POST", "/admin/profiler/stop", {}, b""),
]


@pytest.mark.parametrize("method, path, params, body", PORTED)
def test_ported_route_status_is_the_reference(apis, method, path, params,
                                              body):
    (jst, jp), (st, p) = [api.handle(method, path, dict(params), body)
                          for api in apis]
    assert st == jst, (path, p, jp)
    if isinstance(p, dict) and isinstance(jp, dict):
        assert p.get("status") == jp.get("status")
        assert set(p) == set(jp)
        if isinstance(p.get("data"), dict) and \
                isinstance(jp.get("data"), dict):
            assert set(p["data"]) == set(jp["data"]), path


def test_profiler_start_stop_report(apis):
    for api in apis:
        st, p = api.handle("POST", "/admin/profiler/start", {"hz": "200"})
        assert st == 200 and p["status"] == "started"
    deadline = time.time() + 0.3
    while time.time() < deadline:
        sum(i * i for i in range(10_000))
    for api in apis:
        st, p = api.handle("POST", "/admin/profiler/stop", {})
        assert st == 200 and p["samples"] > 0
        st, rep = api.handle("GET", "/admin/profiler/report", {"top": "5"})
        assert st == 200
        st, col = api.handle("GET", "/admin/profiler/report",
                             {"format": "collapsed"})
        assert st == 200 and isinstance(col, str)


def test_ready_and_health_of_a_serving_api(apis):
    _, api = apis
    assert api.handle("GET", "/ready", {}) == (200, {"status": "ready"})
    st, p = api.handle("GET", "/api/v1/status/health", {})
    assert st == 200
    subs = p["data"]["subsystems"]
    assert set(subs) == {"jobs", "peers", "wal", "shards", "mirror",
                         "ingest", "device"}
    assert subs["wal"]["datasets"]["prometheus"]["enabled"] is False
    assert api.handle("GET", "/healthz", {})[1]["phase"] == "serving"
    api.health.set_phase("stopping")
    try:
        st, p = api.handle("GET", "/ready", {})
        assert st == 503 and p["reason"] == "phase=stopping"
    finally:
        api.health.set_phase("serving")


# the replication and federation routes, which answered 501 until those
# layers were ported: over an API built without a handoff coordinator or
# a federation registry both packages give the same answer
NOT_PORTED = [
    ("POST", "/admin/shards/0/handoff"),
    ("GET", "/admin/federation"),
]

# the shard mappers' routes, ported with the composition root since these
# cases were in NOT_PORTED: over an API built without mappers both
# packages give the same answer
CLUSTER_ROUTES = [
    ("GET", "/cluster/prometheus/status"),
    ("GET", "/admin/shards"),
]

# the rules engine's routes, ported since these cases were in NOT_PORTED:
# over an API built without a ruler both packages give the same answer
RULES_ROUTES = [
    ("GET", "/api/v1/rules"),
    ("GET", "/api/v1/alerts"),
    ("GET", "/promql/prometheus/api/v1/rules"),
    ("POST", "/admin/rules/reload"),
]

# the write doors, ported since these cases were in NOT_PORTED: over an
# API built without gateways both packages give the same answer
WRITE_DOORS = [
    ("POST", "/api/v1/write"),
    ("POST", "/api/v1/read"),
    ("GET", "/api/v1/status/tsdb"),
    ("GET", "/api/v1/metering/cardinality"),
    ("POST", "/influx/write"),
]


@pytest.mark.parametrize("method, path", WRITE_DOORS)
def test_write_door_route_answers_as_the_reference(apis, method, path):
    answers = []
    for api in apis:
        st, p = api.handle(method, path, {}, b"")
        if isinstance(p, dict):
            p = {k: v for k, v in p.items() if k != "_headers"}
        answers.append((st, p))
    assert answers[1] == answers[0], path
    assert answers[1][0] != 501


@pytest.mark.parametrize("method, path", RULES_ROUTES)
def test_rules_route_answers_as_the_reference(apis, method, path):
    answers = [api.handle(method, path, {}, b"") for api in apis]
    assert answers[1] == answers[0], path
    assert answers[1][0] != 501


@pytest.mark.parametrize("method, path", CLUSTER_ROUTES)
def test_cluster_route_answers_as_the_reference(apis, method, path):
    answers = [api.handle(method, path, {}, b"") for api in apis]
    assert answers[1] == answers[0], path
    assert answers[1][0] != 501


@pytest.mark.parametrize("method, path", NOT_PORTED)
def test_unported_reference_route_is_501(apis, method, path):
    answers = [api.handle(method, path, {}, b"") for api in apis]
    assert answers[1] == answers[0], path
    st, p = answers[1]
    assert st != 501 and p.get("errorType") != "not_ported", (path, p)
    # the reference serves it (any answer but its unknown-route 404)
    assert not (st == 404 and "no route" in json.dumps(p)), (path, p)


@pytest.mark.parametrize("method, path", [("GET", "/admin/nosuch"),
                                          ("GET", "/api/v1/nosuch"),
                                          ("DELETE", "/admin/jobs")])
def test_unknown_route_keeps_the_reference_404(apis, method, path):
    (jst, _), (st, p) = [api.handle(method, path, {}) for api in apis]
    assert st == jst == 404 and p["errorType"] == "bad_data"


def test_traced_filters_follow_the_same_series(apis, caplog):
    """POST /admin/tracedfilters then a query: the port logs the same
    TRACED lookups as the reference for the same filters."""
    import logging
    body = b'[{"job": "app-server", "instance": "1"}]'
    q = {"query": 'http_requests{job="app-server"}', "start": "600",
         "end": "900", "step": "60"}
    lines = []
    for api in apis:
        with caplog.at_level(logging.INFO, logger="filodb.shard"):
            caplog.clear()
            st, p = api.handle("POST", "/admin/tracedfilters", {}, body)
            assert st == 200 and p["data"]["shards"] == 2
            api.handle("GET", "/api/v1/query_range", q)
            lines.append(sorted(r.getMessage() for r in caplog.records
                                if "TRACED" in r.getMessage()))
        api.handle("POST", "/admin/tracedfilters", {}, b"[]")
    assert lines[0] == lines[1]
    assert any("query_lookup" in ln for ln in lines[0])
    assert np.sum(["matched filter" in ln for ln in lines[0]]) == 2
