"""Transport-agnostic HTTP route handlers (port of
filodb_tpu/http/routes.py, trimmed to the query-serving routes).

Handlers take (params, body) and return (status_code, payload); the
socket server in server.py is a thin shell, so tests exercise routes
without binding ports.  Routes served:

- /api/v1/query_range, /api/v1/query, POST /api/v1/query_range_batch,
  /api/v1/labels, /api/v1/label/<name>/values, /api/v1/series,
  /api/v1/usage, each also under /promql/<dataset>/api/v1/...;
- /metrics, /__health, /healthz;
- /admin/queries (list, get, POST .../kill) and /admin/slowlog.

Every other route answers the reference's 404 shape.  Still to port,
each with the subsystem it fronts: /ready and the health model, explain
(and analyze), remote write and read, /api/v1/status/*, the rules and
alerts routes, and the other admin routes.  A QueryError("not_ported")
raised below the API answers 501 with an error payload.
"""
from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Tuple

from filodb_tpu_torch.promql.lexer import ParseError, duration_to_ms
from filodb_tpu_torch.query.engine import (QueryEngine,
                                           _attach_partial_fields,
                                           _prom_error_payload,
                                           _prom_labels)
from filodb_tpu_torch.query.execbase import QueryError
from filodb_tpu_torch.query.rangevector import PlannerParams


class PromHttpApi:

    def __init__(self, engines: Dict[str, QueryEngine],
                 shard_mappers: Optional[Dict[str, object]] = None,
                 default_dataset: Optional[str] = None,
                 batch_window_ms: Optional[float] = None,
                 config=None):
        """engines: dataset -> QueryEngine, each already on its device.
        config: a FilodbSettings (None: the settings() singleton); its
        `query` section sets the frontends' knobs."""
        self.engines = engines
        self.shard_mappers = shard_mappers or {}
        self.default_dataset = default_dataset or next(iter(engines), None)
        # query-serving frontend per dataset (query/frontend.py):
        # singleflight, the step-aligned result cache, the weighted-fair
        # scheduler and the window-grid coalescer (query.batch_window_ms
        # > 0: concurrent same-grid requests merge into one
        # engine.query_range_batch)
        from filodb_tpu_torch.query.frontend import QueryFrontend
        if config is None:
            from filodb_tpu_torch.config import settings
            config = settings()
        self._config = config
        self._qconfig = config.query
        if batch_window_ms is None:
            batch_window_ms = config.query.batch_window_ms
        self.frontends = {name: QueryFrontend(eng,
                                              batch_window_ms / 1000.0,
                                              config=config)
                          for name, eng in engines.items()}
        self.coalescers = {name: fe.coalescer
                           for name, fe in self.frontends.items()}

    # ------------------------------------------------------------ dispatch

    def handle(self, method: str, path: str, params: Dict[str, str],
               body: bytes = b"",
               multi_params: Optional[Dict[str, List[str]]] = None,
               headers: Optional[Dict[str, str]] = None
               ) -> Tuple[int, object]:
        parts = [p for p in path.split("/") if p]
        multi = multi_params or {k: [v] for k, v in params.items()}
        try:
            if parts == ["__health"]:
                return 200, {"status": "healthy"}
            if parts == ["healthz"]:
                # liveness: the process and its HTTP loop answered
                return 200, {"status": "alive", "phase": "serving"}
            if parts == ["metrics"]:
                return self._own_metrics(params)
            if parts[:1] == ["promql"] and len(parts) >= 4 \
                    and parts[2] == "api" and parts[3] == "v1":
                return self._api_v1(parts[1], parts[4:], method, params,
                                    body, multi)
            if parts[:2] == ["api", "v1"]:
                if self.default_dataset is None:
                    return 404, _err("no datasets registered")
                return self._api_v1(self.default_dataset, parts[2:], method,
                                    params, body, multi)
            if parts[:2] == ["admin", "slowlog"] and len(parts) in (2, 3):
                return self._slowlog(parts[2] if len(parts) == 3 else None,
                                     params, method)
            if parts[:2] == ["admin", "queries"] and len(parts) <= 4:
                return self._active_queries(parts[2:], params, method)
            return 404, _err(f"no route for {method} {path}")
        except _BadRequest as e:
            return 400, _err(str(e))
        except ParseError as e:
            # PromQL typos in match[] parse outside the engine's own
            # error capture — still the client's fault
            return 400, _err(f"parse error: {e}")
        except QueryError as e:
            if e.code == "not_ported":
                return 501, {"status": "error", "errorType": "not_ported",
                             "error": str(e)}
            return 500, _err(str(e))
        except Exception as e:  # noqa: BLE001 — HTTP edge turns errors into 500s
            return 500, _err(f"{type(e).__name__}: {e}")

    # ----------------------------------------------------------- prom api

    def _api_v1(self, dataset: str, rest: List[str], method: str,
                params: Dict[str, str], body: bytes,
                multi: Dict[str, List[str]]) -> Tuple[int, object]:
        eng = self.engines.get(dataset)
        if eng is None:
            return 404, _err(f"dataset {dataset!r} not found")
        planner_params = _planner_params(params, self._qconfig)
        if rest == ["query_range"]:
            q = params.get("query", "")
            start = _num_param(params, "start")
            end = _num_param(params, "end")
            step = _step_param(params.get("step", "15"))
            res = self.frontends[dataset].query_range(
                q, start, step, end, planner_params)
            payload = QueryEngine.to_prom_matrix(res)
            if res.trace_id:
                payload["traceID"] = res.trace_id
            if _want_stats(params):
                payload["stats"] = res.stats.to_dict()
            status = 200 if payload["status"] == "success" else 400
            return (_throttled_status(res, payload) or status), payload
        if rest == ["usage"]:
            from filodb_tpu_torch.utils.usage import usage
            return 200, {"status": "success", "data": usage.snapshot()}
        if rest == ["query_range_batch"] and method == "POST":
            # dashboard batch: JSON {"queries": [...], "start", "step",
            # "end"} -> a list of matrix payloads, compatible fused leaves
            # merged into single kernel launches
            try:
                req = json.loads(body.decode() or "{}")
                queries = list(req["queries"])
                # the same grid coercion as GET query_range
                start = int(float(req["start"]))
                end = int(float(req["end"]))
                step = _step_param(req.get("step", 15))
            except (KeyError, TypeError, ValueError, OverflowError) as e:
                raise _BadRequest(f"bad batch request: {e}") from None
            results = eng.query_range_batch(queries, start, step, end,
                                            planner_params)
            payloads = []
            want_stats = _want_stats(params) or req.get("stats") in (
                True, "true", "1", "all")
            for res in results:
                p = QueryEngine.to_prom_matrix(res)
                if res.trace_id:
                    p["traceID"] = res.trace_id
                if want_stats:
                    p["stats"] = res.stats.to_dict()
                payloads.append(p)
            return 200, {"status": "success", "results": payloads}
        if rest == ["query"]:
            q = params.get("query", "")
            t = _num_param(params, "time", "0")
            res = self.frontends[dataset].query_instant(
                q, t, planner_params)
            payload = QueryEngine.to_prom_vector(res)
            if res.trace_id:
                payload["traceID"] = res.trace_id
            if _want_stats(params):
                payload["stats"] = res.stats.to_dict()
            status = 200 if payload["status"] == "success" else 400
            return (_throttled_status(res, payload) or status), payload
        if rest == ["labels"]:
            return self._metadata(eng, "labels", params, multi,
                                  planner_params=planner_params)
        if len(rest) == 3 and rest[0] == "label" and rest[2] == "values":
            return self._metadata(eng, "label_values", params, multi,
                                  label=rest[1],
                                  planner_params=planner_params)
        if rest == ["series"]:
            return self._metadata(eng, "series", params, multi,
                                  planner_params=planner_params)
        return 404, _err(f"unknown api/v1 endpoint {'/'.join(rest)}")

    def _metadata(self, eng: QueryEngine, kind: str, params: Dict[str, str],
                  multi: Dict[str, List[str]],
                  label: Optional[str] = None,
                  planner_params: Optional[PlannerParams] = None
                  ) -> Tuple[int, object]:
        from filodb_tpu_torch.promql import ast as A
        from filodb_tpu_torch.promql.parser import _filters, parse_query
        from filodb_tpu_torch.query import logical as lp
        start = _num_param(params, "start", "0") * 1000
        end = _num_param(params, "end", "253402300799") * 1000
        # the Prometheus API unions results over repeated match[]
        matches = (multi.get("match[]") or multi.get("match") or [None])
        merged: Optional[object] = None
        partial = False
        warnings: List[str] = []
        for match in matches:
            filters: Tuple = ()
            if match:
                sel = parse_query(match)
                if not isinstance(sel, A.VectorSelector):
                    return 400, _err("match[] must be a vector selector")
                filters = _filters(sel)
            if kind == "labels":
                plan: lp.LogicalPlan = lp.LabelNames(filters, start, end)
            elif kind == "label_values":
                plan = lp.LabelValues((label,), filters, start, end)
            else:
                plan = lp.SeriesKeysByFilters(filters, start, end)
            res = eng.exec_logical_plan(plan, planner_params)
            if res.error:
                return 400, _prom_error_payload(res)
            partial = partial or res.partial
            warnings.extend(res.stats.warnings)
            data = res.data or []
            if kind == "label_values" and isinstance(data, dict):
                data = sorted(data.get(label, []))
            if merged is None:
                merged = data
            elif isinstance(merged, list):
                seen = {json.dumps(x, sort_keys=True) if isinstance(x, dict)
                        else x for x in merged}
                for x in data:
                    c = json.dumps(x, sort_keys=True) if isinstance(x, dict) \
                        else x
                    if c not in seen:
                        seen.add(c)
                        merged.append(x)
        # label names and values keep their sorted order across the
        # union; series dicts stay in discovery order
        if isinstance(merged, list) and \
                all(isinstance(x, str) for x in merged):
            merged = sorted(merged)
        if kind == "series" and isinstance(merged, list):
            # Prometheus clients key the metric name as __name__
            merged = [_prom_labels(x) if isinstance(x, dict) else x
                      for x in merged]
        return 200, _attach_partial_fields(
            {"status": "success", "data": merged or []}, partial, warnings)

    # ------------------------------------------------------------- admin

    def _own_metrics(self, params: Optional[Dict[str, str]] = None
                     ) -> Tuple[int, str]:
        """The process's own metrics in the Prometheus text format (or
        `?format=openmetrics`); shard gauges and per-tenant query gauges
        refresh on scrape."""
        import time as _time

        from filodb_tpu_torch.query.activequeries import active_queries
        from filodb_tpu_torch.utils.metrics import registry
        now_ms = int(_time.time() * 1000)
        for dataset, eng in self.engines.items():
            source = getattr(eng, "source", None)
            mapper = self.shard_mappers.get(dataset)
            if source is None or mapper is None:
                continue
            for s in mapper.all_shards():
                shard = source.get_shard(dataset, s)
                if shard is None:
                    continue
                tags = {"dataset": dataset, "shard": str(s)}
                registry.gauge("num_partitions", **tags).update(
                    shard.num_partitions)
                registry.gauge("rows_dropped", **tags).update(
                    shard.stats.rows_dropped)
                horizon = shard.append_horizon_ms()
                if 0 < horizon <= now_ms:
                    registry.gauge("append_horizon_lag_seconds",
                                   **tags).update(
                        (now_ms - horizon) / 1000.0)
        active_queries.refresh_gauges()
        for fe in self.frontends.values():
            if fe.scheduler is not None:
                fe.scheduler.refresh_gauges()
        fmt = (params or {}).get("format", "")
        if fmt == "openmetrics":
            return 200, _TextPayload(
                registry.expose_openmetrics(),
                "application/openmetrics-text; version=1.0.0; "
                "charset=utf-8")
        if fmt not in ("", "prometheus"):
            raise _BadRequest(
                f"unknown metrics format {fmt!r} "
                "(prometheus | openmetrics)")
        return 200, registry.expose_prometheus()

    def _slowlog(self, action, params: Dict[str, str],
                 method: str) -> Tuple[int, object]:
        """Slow-query flight recorder (utils/slowlog.py): GET
        /admin/slowlog returns the ring buffer newest-last (?limit=N
        tails it); POST /admin/slowlog/clear empties it."""
        from filodb_tpu_torch.utils.slowlog import slowlog
        if action is None and method == "GET":
            limit = _num_param(params, "limit", "0")
            entries = slowlog.entries(limit)
            return 200, {"status": "success",
                         "data": {"count": len(entries),
                                  "thresholdSeconds": slowlog.threshold_s,
                                  "entries": entries}}
        if action == "clear" and method == "POST":
            return 200, {"status": "success",
                         "data": {"cleared": slowlog.clear()}}
        return 404, _err(f"unknown slowlog action {action!r} ({method})")

    def _active_queries(self, rest: List[str], params: Dict[str, str],
                        method: str) -> Tuple[int, object]:
        """Live query introspection (query/activequeries.py):

        - GET /admin/queries — every in-flight query, with phase, age,
          tenant and live counters; ?tenant=<ws> narrows to one
          workspace.
        - GET /admin/queries/<id> — the entries under one query id.
        - POST /admin/queries/<id>/kill — cooperative kill: flips the
          CancellationToken (?reason= tags the metric; default admin).
          An unknown or finished id answers 404.
        """
        from filodb_tpu_torch.query.activequeries import active_queries
        if not rest and method == "GET":
            rows = active_queries.snapshot()
            want = params.get("tenant", "")
            if want:
                rows = [r for r in rows if r["tenant"]["ws"] == want]
            return 200, {"status": "success",
                         "data": {"count": len(rows), "queries": rows}}
        if len(rest) == 1 and method == "GET":
            ents = active_queries.get(rest[0])
            if not ents:
                return 404, _err(f"no active query {rest[0]!r}")
            return 200, {"status": "success",
                         "data": {"queries": [e.to_dict() for e in ents]}}
        if len(rest) == 2 and rest[1] == "kill" and method == "POST":
            qid = rest[0]
            if not active_queries.get(qid):
                return 404, _err(f"no active query {qid!r} "
                                 "(already completed, or never ran here)")
            reason = params.get("reason", "admin")
            if reason not in ("admin", "disconnect", "deadline"):
                raise _BadRequest(f"unknown kill reason {reason!r} "
                                  "(admin | disconnect | deadline)")
            out = active_queries.kill(qid, reason=reason,
                                      detail="POST /admin/queries/kill")
            return 200, {"status": "success", "data": out}
        return 404, _err(f"unknown queries action {'/'.join(rest)!r} "
                         f"({method})")


class _TextPayload(str):
    """A text route payload carrying its own content type (the server
    shell defaults str payloads to the Prometheus exposition type)."""

    content_type = "text/plain; version=0.0.4"

    def __new__(cls, s: str, content_type: Optional[str] = None):
        out = super().__new__(cls, s)
        if content_type:
            out.content_type = content_type
        return out


class _BadRequest(Exception):
    """Client-side parameter problem → HTTP 400 (internal errors stay 500)."""


def _num_param(params: Dict[str, str], key: str,
               default: Optional[str] = None) -> int:
    raw = params.get(key, default)
    if raw is None:
        raise _BadRequest(f"missing required parameter {key!r}")
    try:
        return int(float(raw))
    except (ValueError, OverflowError):
        raise _BadRequest(f"parameter {key!r} is not a number: {raw!r}")


# the Prometheus duration grammar: units in strictly descending order,
# each at most once, no fractions — "1h30m" yes, "1.5s"/"1s1s"/"1m1h" 400
_DURATION_RE = re.compile(
    r"((\d+)y)?((\d+)w)?((\d+)d)?((\d+)h)?((\d+)m)?((\d+)s)?((\d+)ms)?")


def _step_param(raw) -> int:
    """Prometheus `step`: a float (seconds) or a duration string ("15s",
    "1m", "1h30m") -> whole seconds, floored at 1."""
    try:
        return max(int(float(raw)), 1)
    except (ValueError, OverflowError, TypeError):
        pass
    s = str(raw)
    m = _DURATION_RE.fullmatch(s)
    if not m or not any(m.groups()):       # all-optional grammar: "" is
        raise _BadRequest(                 # a match but not a duration
            f"parameter 'step' is not a number or duration: {raw!r}")
    try:
        return max(duration_to_ms(s) // 1000, 1)
    except (OverflowError, ValueError):
        raise _BadRequest(f"parameter 'step' is out of range: {raw!r}") \
            from None


def _planner_params(params: Dict[str, str],
                    qconfig=None) -> Optional[PlannerParams]:
    """spread / sample-limit / scan-limit / timeout / partial-response
    overrides (the Prometheus `timeout=`; Thanos' `partial_response=`)."""
    pp = PlannerParams()
    if qconfig is not None:
        # server-side default; the per-request params below override it
        pp.allow_partial_results = qconfig.allow_partial_results
    changed = False
    if "spread" in params:
        pp.spread = _num_param(params, "spread")
        changed = True
    if "limit" in params:
        pp.sample_limit = _num_param(params, "limit")
        changed = True
    if "scanLimit" in params:
        pp.scan_limit = _num_param(params, "scanLimit")
        changed = True
    if "timeout" in params:
        # per-request end-to-end budget, capped server-side at
        # query.default_timeout_s by the frontend and the engine
        pp.timeout_s = _timeout_param(params["timeout"])
        changed = True
    # partial_response (the Thanos spelling) and allowPartialResults
    # (the reference's) both work; only explicit booleans are accepted
    partial = params.get("partial_response",
                         params.get("allowPartialResults"))
    if partial is not None:
        if partial in ("true", "1"):
            pp.allow_partial_results = True
        elif partial in ("false", "0"):
            pp.allow_partial_results = False
        else:
            raise _BadRequest(
                "parameter 'partial_response' must be a boolean "
                f"(true/false/1/0): {partial!r}")
        changed = True
    return pp if changed else None


def _timeout_param(raw) -> float:
    """Prometheus `timeout=`: float seconds ("0.5") or a duration string
    ("30s", "1m30s").  Must be positive."""
    try:
        t = float(raw)
    except (ValueError, OverflowError, TypeError):
        s = str(raw)
        m = _DURATION_RE.fullmatch(s)
        if not m or not any(m.groups()):
            raise _BadRequest(
                f"parameter 'timeout' is not a number or duration: {raw!r}")
        try:
            t = duration_to_ms(s) / 1000.0
        except (OverflowError, ValueError):
            raise _BadRequest(
                f"parameter 'timeout' is out of range: {raw!r}") from None
    if not (t > 0):
        raise _BadRequest(f"parameter 'timeout' must be positive: {raw!r}")
    return t


def _want_stats(params: Dict[str, str]) -> bool:
    """`stats=true` / `stats=1` / the Prometheus-style `stats=all`."""
    return params.get("stats") in ("true", "1", "all")


def _err(msg: str) -> Dict[str, str]:
    return {"status": "error", "errorType": "bad_data", "error": msg}


def _throttled_status(res, payload) -> Optional[int]:
    """429 + Retry-After for the read-side throttles (the scheduler's
    `tenant_overloaded` sheds and the scan-limit `tenant_limit_exceeded`
    rejections); None for every other result.  Mutates the payload to
    carry the Retry-After header."""
    err = getattr(res, "error", None) or ""
    if not err.startswith(("tenant_overloaded", "tenant_limit_exceeded")):
        return None
    ra = float(getattr(res, "retry_after_s", 0.0) or 0.0)
    payload["_headers"] = {"Retry-After": str(max(1, int(-(-ra // 1))))}
    return 429
