"""The port's HTTP layer (filodb_tpu_torch/http/routes.py and server.py)
against the JAX package's PromHttpApi over the same store:
tests/test_torch_frontend.py's 50 seeded counters x 240 samples, in the
JAX memstore and, through plain arrays, in the port's.

Every ported route answers with the JAX API's status and payload shape
(the same keys, recursively); matrix and vector values agree within the
reference's tolerance, rtol 2e-4 / atol 1e-3 (__graft_entry__.py:221),
with the same label sets; metadata answers are equal.  Routes the port
does not serve answer the reference's 404 shape, and a query over a
column its schema lacks answers the reference's 400 with its error.
Both APIs also run behind a FiloHttpServer on port 0.
"""
import json
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

from filodb_tpu.http.routes import PromHttpApi as JaxApi
from filodb_tpu.http.server import FiloHttpServer as JaxServer
from filodb_tpu_torch.http.routes import PromHttpApi
from filodb_tpu_torch.http.server import FiloHttpServer

from test_torch_frontend import PANELS, Q, S_SEC, _Stores

ARGS = {"start": str(S_SEC + 600), "end": str(S_SEC + 2390), "step": "1m"}


@pytest.fixture(autouse=True, scope="module")
def _clear_compile_journal():
    """The JAX engine's queries journal jit compiles under their trace
    ids, which the reference's health model reads as a compile storm in
    the next test file this process runs; clear the journal after."""
    yield
    from filodb_tpu.utils.events import journal
    journal.clear()


@pytest.fixture(scope="module")
def apis():
    st = _Stores()
    return JaxApi({"prometheus": st.jeng}), PromHttpApi({"prometheus": st.eng})


# the `stats` values both packages define exactly: samples, series and
# counts (times, bytes and the per-device split are each package's own;
# so are the exprfuse verdicts: on the CPU the reference sends a kernel
# leaf to its general path, where the port runs K1's plain version)
STATS_EXACT = ("samplesScanned", "seriesScanned", "resultSamples",
               "shardsQueried", "samplesPaged", "partial", "warnings",
               "pushdown")


def _shape(x):
    """The payload's structure: dict keys recursively, list items by the
    first one's shape, scalars by kind.  `stats` by its keys and the
    values of STATS_EXACT."""
    if isinstance(x, dict):
        return {k: (_stats_shape(v) if k == "stats" else _shape(v))
                for k, v in x.items() if k != "traceID"}
    if isinstance(x, list):
        return [_shape(x[0])] if x else []
    return type(x).__name__


def _stats_shape(stats):
    return {"keys": sorted(stats),
            "exact": {k: stats[k] for k in STATS_EXACT if k in stats}}


def _rows(payload, key):
    out = {}
    for r in payload["data"]["result"]:
        pts = r[key] if key == "values" else [r[key]]
        out[tuple(sorted(r["metric"].items()))] = (
            [p[0] for p in pts], np.array([float(p[1]) for p in pts]))
    return out


def _same_values(got, want, key):
    g, w = _rows(got, key), _rows(want, key)
    assert set(g) == set(w) and w
    for k in w:
        assert g[k][0] == w[k][0], k
        np.testing.assert_allclose(g[k][1], w[k][1], rtol=2e-4, atol=1e-3,
                                   err_msg=str(k))


def _both(apis, method, path, params=None, body=b""):
    (jst, jp), (st, p) = [api.handle(method, path, dict(params or {}), body)
                          for api in apis]
    assert st == jst, (path, st, jst, p, jp)
    assert _shape(p) == _shape(jp), path
    return p, jp


@pytest.mark.parametrize("prefix", ["", "/promql/prometheus"])
def test_query_range_and_instant(apis, prefix):
    p, jp = _both(apis, "GET", prefix + "/api/v1/query_range",
                  {"query": Q, **ARGS})
    assert p["status"] == "success" and p["data"]["resultType"] == "matrix"
    _same_values(p, jp, "values")
    p, jp = _both(apis, "GET", prefix + "/api/v1/query",
                  {"query": Q, "time": ARGS["end"]})
    assert p["data"]["resultType"] == "vector"
    _same_values(p, jp, "value")


def test_query_range_stats(apis):
    p, jp = _both(apis, "GET", "/api/v1/query_range",
                  {"query": PANELS[1], **ARGS, "stats": "true"})
    assert set(p["stats"]["phases"]) == set(jp["stats"]["phases"])
    assert p["stats"]["seriesScanned"] == jp["stats"]["seriesScanned"]
    # the kernel ledger fills the device split, as the reference's does
    assert p["stats"]["phases"]["device_s"] > 0 and p["stats"]["devices"]
    _same_values(p, jp, "values")


def test_query_range_batch(apis):
    body = json.dumps({"queries": PANELS + ["sum(rate(nosuch[5m]"],
                       "start": S_SEC + 600, "step": 60,
                       "end": S_SEC + 2390, "stats": True}).encode()
    p, jp = _both(apis, "POST", "/api/v1/query_range_batch", body=body)
    assert len(p["results"]) == len(PANELS) + 1
    for got, want in zip(p["results"][:-1], jp["results"][:-1]):
        _same_values(got, want, "values")
    assert p["results"][-1]["status"] == "error"
    assert p["results"][-1]["errorType"] == jp["results"][-1]["errorType"]


@pytest.mark.parametrize("path, params", [
    ("/api/v1/labels", {}),
    ("/api/v1/label/_ns_/values", {}),
    ("/api/v1/series", {"match[]": 'request_total{_ns_="App-2"}'}),
    ("/promql/prometheus/api/v1/label/instance/values",
     {"match[]": 'request_total{_ns_="App-3"}'}),
])
def test_metadata_routes_equal(apis, path, params):
    p, jp = _both(apis, "GET", path, params)
    assert p["status"] == "success" and p["data"]
    assert p == jp


@pytest.mark.parametrize("method, path, params", [
    ("GET", "/__health", {}),
    ("GET", "/healthz", {}),
    ("GET", "/api/v1/usage", {}),
    ("GET", "/admin/queries", {}),
    ("GET", "/admin/queries", {"tenant": "demo"}),
    ("GET", "/admin/slowlog", {}),
    ("POST", "/admin/slowlog/clear", {}),
    ("GET", "/admin/queries/no-such-id", {}),
    ("POST", "/admin/queries/no-such-id/kill", {}),
    ("GET", "/admin/slowlog/nosuch", {}),
    ("GET", "/api/v1/nosuch", {}),
    ("GET", "/promql/nosuch/api/v1/labels", {}),
    ("GET", "/no/such/route", {}),
    ("GET", "/api/v1/query_range", {"query": Q, "start": "x", "end": "1"}),
    ("GET", "/api/v1/query_range", {"query": Q, **ARGS, "step": "1s1s"}),
    ("GET", "/api/v1/query_range", {"query": "sum(", **ARGS}),
    ("GET", "/api/v1/query_range", {"query": Q, **ARGS, "timeout": "-1"}),
    ("POST", "/api/v1/query_range_batch", {}),
])
def test_status_and_shape_match(apis, method, path, params):
    if path.startswith("/admin/slowlog"):
        # both recorders are process-wide: start them empty
        from filodb_tpu.utils.slowlog import slowlog as jax_slowlog
        from filodb_tpu_torch.utils.slowlog import slowlog
        jax_slowlog.clear()
        slowlog.clear()
    p, jp = _both(apis, method, path, params)
    if isinstance(p, dict) and p.get("status") == "error":
        assert p["errorType"] == jp["errorType"]


def test_metrics_exposition(apis):
    (jst, jtext), (st, text) = [api.handle("GET", "/metrics", {})
                                for api in apis]
    assert st == jst == 200 and isinstance(text, str)
    assert "query_result_cache_misses_total" in text
    (_, om) = apis[1].handle("GET", "/metrics", {"format": "openmetrics"})
    assert om.content_type.startswith("application/openmetrics-text")
    assert apis[1].handle("GET", "/metrics", {"format": "x"})[0] == 400


def test_unknown_column_answers_the_reference_400(apis):
    (jst, jp), (st, p) = [api.handle(
        "GET", "/api/v1/query_range",
        {"query": "sum(rate(request_total::nosuch[5m]))", **ARGS})
        for api in apis]
    assert st == jst == 400
    for x in (p, jp):
        x.pop("traceID", None)
    assert p == jp == {"status": "error", "errorType": "query_error",
                       "error": "KeyError: 'nosuch'"}


def _get(port, path, params=None):
    url = f"http://127.0.0.1:{port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    try:
        with urllib.request.urlopen(url, timeout=30) as f:
            return f.status, f.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_filo_http_server_on_port_zero(apis):
    servers = [JaxServer(apis[0], port=0), FiloHttpServer(apis[1], port=0)]
    for s in servers:
        s.start()
    try:
        (jst, jb), (st, b) = [_get(s.port, "/api/v1/query_range",
                                   {"query": Q, **ARGS}) for s in servers]
        assert st == jst == 200
        _same_values(json.loads(b), json.loads(jb), "values")
        body = json.dumps({"queries": PANELS[:2], "start": S_SEC + 600,
                           "step": 60, "end": S_SEC + 2390}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{servers[1].port}/api/v1/query_range_batch",
            data=body, method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as f:
            assert len(json.load(f)["results"]) == 2
        (jst, _), (st, b) = [_get(s.port, "/no/such") for s in servers]
        assert st == jst == 404 and json.loads(b)["status"] == "error"
        (jst, jb), (st, b) = [_get(s.port, "/api/v1/query_range",
                                   {"query": "sum(rate(request_total::"
                                             "nosuch[5m]))", **ARGS})
                              for s in servers]
        p, jp = json.loads(b), json.loads(jb)
        assert st == jst == 400 and p["errorType"] == jp["errorType"] \
            == "query_error" and p["error"] == jp["error"]
    finally:
        for s in servers:
            s.stop()
