"""Transport-agnostic HTTP route handlers (port of
filodb_tpu/http/routes.py: the query-serving routes and the node's
operations surface).

Handlers take (params, body) and return (status_code, payload); the
socket server in server.py is a thin shell, so tests exercise routes
without binding ports.  Routes served:

- /api/v1/query_range, /api/v1/query (each with `explain=true`: the exec
  plan tree, nothing run), POST /api/v1/query_range_batch,
  /api/v1/explain (`analyze=true` runs the plan and annotates every
  node), /api/v1/labels, /api/v1/label/<name>/values, /api/v1/series,
  /api/v1/usage, /api/v1/status/{health,buildinfo,runtimeinfo,tsdb},
  /api/v1/metering/cardinality, /api/v1/rules (`type=record|alert`),
  /api/v1/alerts, each also under /promql/<dataset>/api/v1/...;
- the write doors: POST /api/v1/write (Prometheus remote write), POST
  /api/v1/read (remote read), POST /influx/write (Influx line protocol),
  each over the dataset's gateway pipeline (gateway/router.py);
- /metrics, /__health, /healthz (with the health model's phase), /ready;
- /cluster/<dataset>/status and GET /admin/shards, from the shard mappers
  the composition root hands the API (standalone.FiloServer), with each
  replication manager's `replicaLag` table; POST
  /admin/shards/<shard>/handoff (replication/handoff.py) and GET
  /admin/federation (federation/registry.py);
- /admin/queries (list, get, POST .../kill), /admin/slowlog,
  /admin/ingestlog, /admin/devices, /admin/jobs, /admin/breakers,
  /admin/events, /admin/tenants, /admin/traces[/<id>], POST
  /admin/tracedfilters, POST /admin/loglevel/<logger> and
  /admin/profiler/{start,stop,report}, POST /admin/rules/reload (the
  rules engine's, rules/ruler.py; without a ruler the rules and alerts
  routes answer empty lists and the reload 400, as the reference's).

A path the reference does not know keeps its 404.  Remote write
withholds its ack (503) when the WAL commit fails or when a remotely
owned shard's slab lands on no owner (replication/replicator.py).
"""
from __future__ import annotations

import json
import logging
import re
import struct
from typing import Dict, List, Optional, Tuple

from filodb_tpu_torch.promql.lexer import ParseError, duration_to_ms
from filodb_tpu_torch.query.engine import (QueryEngine,
                                           _attach_partial_fields,
                                           _prom_error_payload,
                                           _prom_labels)
from filodb_tpu_torch.query.rangevector import PlannerParams


class PromHttpApi:

    def __init__(self, engines: Dict[str, QueryEngine],
                 gateways: Optional[Dict[str, object]] = None,
                 shard_mappers: Optional[Dict[str, object]] = None,
                 default_dataset: Optional[str] = None,
                 batch_window_ms: Optional[float] = None,
                 config=None, ruler=None, health=None):
        """engines: dataset -> QueryEngine, each already on its device.
        gateways: dataset -> GatewayPipeline (gateway/router.py), the
        write doors' ingest path; its `wal` makes remote write durable.
        config: a FilodbSettings (None: the settings() singleton); its
        `query` section sets the frontends' knobs.  ruler: the rules
        engine (rules/ruler.Ruler) serving /api/v1/rules, /api/v1/alerts
        and /admin/rules/reload; an attribute a caller may set after
        construction, since the ruler needs this API's frontends.
        health: the node's HealthEvaluator (None: one of its own, already
        `serving`)."""
        import time as _time
        self.engines = engines
        self.gateways = gateways or {}
        self.shard_mappers = shard_mappers or {}
        self.default_dataset = default_dataset or next(iter(engines), None)
        # the rules engine (rules/), when this deployment runs one
        self.ruler = ruler
        # the health model (utils/health.py): shard mappers feed the
        # shard verdict; a dataset's WAL is enabled when its gateway
        # pipeline carries one, already replayed (the port's node boots
        # its stores from the log before it builds this API; a caller
        # that replays later reports it with health.note_wal)
        if health is None:
            from filodb_tpu_torch.utils.health import HealthEvaluator
            health = HealthEvaluator()
        self.health = health
        self.health.shard_mappers = self.shard_mappers
        for name in engines:
            wal = getattr(self.gateways.get(name), "wal", None)
            self.health.note_wal(name, enabled=wal is not None,
                                 replay_done=wal is not None)
        self._start_unix = _time.time()
        # last-config-reload status for /api/v1/status/runtimeinfo (the
        # Prometheus reloadConfigSuccess/lastConfigTime pair); rules
        # reloads are the live config-reload surface this server has
        self._last_reload_unix = self._start_unix
        self._last_reload_ok = True
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
        # remote_write sinks, built lazily per dataset (the WAL manager
        # is attached to the gateway pipeline after construction)
        self._rw_sinks: Dict[str, object] = {}
        # replication layer attachments (FiloServer/deployments wire
        # these when replication.enabled): per-dataset ingest fan-out
        # managers (replication/replicator.py — their lag table feeds
        # /admin/shards) and live-handoff coordinators
        # (replication/handoff.py — POST /admin/shards/{s}/handoff)
        self.replicators: Dict[str, object] = {}
        self.handoffs: Dict[str, object] = {}
        # cross-cluster federation registry (federation/registry.py),
        # attached by FiloServer when federation.enabled — feeds
        # GET /admin/federation (ownership + live health per cluster)
        self.federation = None

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
                return 200, {"status": "alive",
                             "phase": self.health.phase}
            if parts == ["ready"]:
                return self._ready()
            if parts == ["metrics"]:
                return self._own_metrics(params)
            if parts[:1] == ["promql"] and len(parts) >= 4 \
                    and parts[2] == "api" and parts[3] == "v1":
                return self._api_v1(parts[1], parts[4:], method, params,
                                    body, multi, headers)
            if parts[:2] == ["api", "v1"]:
                if self.default_dataset is None:
                    return 404, _err("no datasets registered")
                return self._api_v1(self.default_dataset, parts[2:], method,
                                    params, body, multi, headers)
            if parts[:1] == ["cluster"] and len(parts) >= 3 \
                    and parts[2] == "status":
                return self._cluster_status(parts[1])
            if parts[:2] == ["admin", "loglevel"] and len(parts) == 3 \
                    and method == "POST":
                return self._loglevel(parts[2], body.decode().strip())
            if parts[:2] == ["admin", "profiler"] and len(parts) == 3:
                return self._profiler(parts[2], params, method)
            if parts[:2] == ["admin", "slowlog"] and len(parts) in (2, 3):
                return self._slowlog(parts[2] if len(parts) == 3 else None,
                                     params, method)
            if parts[:2] == ["admin", "ingestlog"] and len(parts) in (2, 3):
                return self._ingestlog(
                    parts[2] if len(parts) == 3 else None, params, method)
            if parts[:2] == ["admin", "breakers"] and len(parts) == 2 \
                    and method == "GET":
                return self._breakers()
            if parts == ["admin", "jobs"] and method == "GET":
                return self._jobs()
            if parts == ["admin", "federation"] and method == "GET":
                return self._federation()
            if parts == ["admin", "shards"] and method == "GET":
                return self._shards(params)
            if parts[:2] == ["admin", "shards"] and len(parts) == 4 \
                    and parts[3] == "handoff" and method == "POST":
                return self._shard_handoff(parts[2], params, body)
            if parts[:2] == ["admin", "queries"] and len(parts) <= 4:
                return self._active_queries(parts[2:], params, method)
            if parts == ["admin", "tenants"] and method == "GET":
                return self._tenants()
            if parts == ["admin", "devices"] and method == "GET":
                return self._devices(params)
            if parts == ["admin", "events"] and method == "GET":
                return self._events(params)
            if parts == ["admin", "rules", "reload"] and method == "POST":
                return self._rules_reload()
            if parts[:2] == ["admin", "traces"] and len(parts) in (2, 3):
                return self._traces(parts[2] if len(parts) == 3 else None,
                                    params)
            if parts[:2] == ["admin", "tracedfilters"] and method == "POST":
                return self._traced_filters(body)
            if parts[:1] == ["influx"] and len(parts) == 2 \
                    and parts[1] == "write" and method == "POST":
                return self._influx_write_traced(params, body, headers)
            return 404, _err(f"no route for {method} {path}")
        except _BadRequest as e:
            return 400, _err(str(e))
        except ParseError as e:
            # PromQL typos in match[] and explain parse outside the
            # engine's own error capture — still the client's fault
            return 400, _err(f"parse error: {e}")
        except Exception as e:  # noqa: BLE001 — HTTP edge turns errors into 500s
            return 500, _err(f"{type(e).__name__}: {e}")

    # ----------------------------------------------------------- prom api

    def _api_v1(self, dataset: str, rest: List[str], method: str,
                params: Dict[str, str], body: bytes,
                multi: Dict[str, List[str]],
                headers: Optional[Dict[str, str]] = None
                ) -> Tuple[int, object]:
        eng = self.engines.get(dataset)
        if eng is None:
            return 404, _err(f"dataset {dataset!r} not found")
        if rest == ["write"] and method == "POST":
            return self._remote_write_ingest(dataset, body, headers or {})
        planner_params = _planner_params(params, self._qconfig)
        if rest == ["query_range"]:
            q = params.get("query", "")
            start = _num_param(params, "start")
            end = _num_param(params, "end")
            step = _step_param(params.get("step", "15"))
            if params.get("explain") in ("true", "1"):
                return self._explain(eng, q, start, step, end)
            res = self.frontends[dataset].query_range(
                q, start, step, end, planner_params)
            payload = QueryEngine.to_prom_matrix(res)
            if res.trace_id:
                payload["traceID"] = res.trace_id
            if _want_stats(params):
                payload["stats"] = res.stats.to_dict()
            status = 200 if payload["status"] == "success" else 400
            return (_throttled_status(res, payload) or status), payload
        if rest == ["explain"]:
            q = params.get("query", "")
            start = _num_param(params, "start")
            end = _num_param(params, "end")
            step = _step_param(params.get("step", "15"))
            if params.get("analyze") in ("true", "1"):
                return self._explain_analyze(dataset, q, start, step, end,
                                             planner_params)
            return self._explain(eng, q, start, step, end)
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
            if params.get("explain") in ("true", "1"):
                return self._explain(eng, q, t, 1, t)
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
        if rest == ["metering", "cardinality"]:
            return self._cardinality(dataset, params)
        if rest == ["read"] and method == "POST":
            return self._remote_read(eng, body, planner_params)
        if rest == ["rules"]:
            return self._rules(params)
        if rest == ["alerts"]:
            return self._alerts()
        if rest == ["status", "buildinfo"]:
            return self._buildinfo()
        if rest == ["status", "runtimeinfo"]:
            return self._runtimeinfo()
        if rest == ["status", "health"]:
            return 200, {"status": "success",
                         "data": self.health.evaluate()}
        if rest == ["status", "tsdb"]:
            return self._status_tsdb(dataset, params)
        return 404, _err(f"unknown api/v1 endpoint {'/'.join(rest)}")

    def _explain(self, eng: QueryEngine, q: str, start: int, step: int,
                 end: int) -> Tuple[int, object]:
        """Exec-plan tree instead of results (the reference's
        `explainOnly` verb): the plan is materialized, never run, so
        nothing reaches the device."""
        from filodb_tpu_torch.promql.parser import (TimeStepParams,
                                              query_range_to_logical_plan)
        from filodb_tpu_torch.query.rangevector import QueryContext
        plan = query_range_to_logical_plan(q, TimeStepParams(start, step, end))
        ep = eng.planner.materialize(plan, QueryContext())
        return 200, {"status": "success",
                     "data": {"resultType": "execPlan",
                              "result": ep.print_tree().splitlines()}}

    def _explain_analyze(self, dataset: str, q: str, start: int, step: int,
                         end: int, planner_params) -> Tuple[int, object]:
        """EXPLAIN ANALYZE: the plan is EXECUTED and every locally-run
        node's line carries its exclusive time / device / transfer /
        samples attribution plus the root QueryStats.  Goes through the
        dataset's frontend so the tenant limits, scheduler bound, and
        usage/slowlog accounting apply exactly as for query_range — an
        unaccounted analyze verb would be a free pass around them."""
        res, rec, ep = self.frontends[dataset].analyze_range(
            q, start, step, end, planner_params)
        if rec is None:                  # tenant admission rejected/shed it
            # same errorType taxonomy as query_range (a shed analyze is
            # "too_many_requests", not "bad_data" — clients route on it)
            payload = _prom_error_payload(res) or _err("rejected")
            return (_throttled_status(res, payload) or 400), payload
        if res.error:
            # same contract as query_range: execution failure is a 400
            # with status error, not a success-shaped payload
            return 400, _err(res.error)
        lines = ep.print_tree(annot=rec.annotation).splitlines()
        data = {"resultType": "execPlanAnalysis",
                "result": lines,
                "stats": res.stats.to_dict(),
                "nodes": rec.order,
                "traceID": res.trace_id}
        return 200, {"status": "success", "data": data}

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

    # ------------------------------------------------------------- cluster

    def _cluster_status(self, dataset: str) -> Tuple[int, object]:
        """ref: ClusterApiRoute shard status (doc/http_api.md)."""
        mapper = self.shard_mappers.get(dataset)
        if mapper is None:
            return 404, _err(f"dataset {dataset!r} not found")
        statuses = [{"shard": i, "status": st, "address": addr}
                    for i, (addr, st) in sorted(mapper.status_snapshot().items())]
        return 200, {"status": "success", "data": statuses}

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

    def _ingestlog(self, action, params: Dict[str, str],
                   method: str) -> Tuple[int, object]:
        """Ingest-batch flight recorder (utils/slowlog.IngestSlowLog):
        GET /admin/ingestlog returns the write-path ring newest-last —
        batches over `ingest.slow_batch_threshold_s` door-to-ack with
        tenant, byte/sample counts, per-stage breakdown and trace id;
        ?limit=N tails it, POST /admin/ingestlog/clear empties it."""
        from filodb_tpu_torch.utils.slowlog import ingestlog
        if action is None and method == "GET":
            limit = _num_param(params, "limit", "0")
            entries = ingestlog.entries(limit)
            return 200, {"status": "success",
                         "data": {"count": len(entries),
                                  "thresholdSeconds":
                                      self._config.ingest
                                      .slow_batch_threshold_s,
                                  "entries": entries}}
        if action == "clear" and method == "POST":
            return 200, {"status": "success",
                         "data": {"cleared": ingestlog.clear()}}
        return 404, _err(f"unknown ingestlog action {action!r} ({method})")

    def _ready(self) -> Tuple[int, object]:
        """Readiness probe (Prometheus /-/ready semantics): 503 during
        boot WAL replay / shard recovery and while a critical subsystem
        is failed — the signal a load balancer or rolling restart waits
        on before routing traffic here (doc/operations.md)."""
        ok, reason = self.health.ready()
        if ok:
            return 200, {"status": "ready"}
        return 503, {"status": "unready", "reason": reason}

    def _devices(self, params: Dict[str, str]) -> Tuple[int, object]:
        """GET /admin/devices — the per-card device telemetry table
        (utils/devicetelem): utilization EWMA, booked HBM by region,
        cumulative kernel/compile counters, and the newest kernel-ledger
        entries.  ?recent=N sizes the ledger tail (default 10, max the
        ring capacity); ?device= / ?kind= filter it."""
        from filodb_tpu_torch.utils.devicetelem import telem
        try:
            recent = int(params.get("recent", "10"))
        except ValueError:
            raise _BadRequest("recent must be an integer") from None
        snap = telem.snapshot(recent=max(0, recent))
        dev_f, kind_f = params.get("device", ""), params.get("kind", "")
        if dev_f or kind_f:
            snap["recent"] = telem.recent(limit=max(0, recent) or 10,
                                          device=dev_f, kind=kind_f)
        return 200, {"status": "success", "data": snap}

    def _tenants(self) -> Tuple[int, object]:
        """GET /admin/tenants — the per-tenant QoS control panel in one
        payload: usage-accountant rows (cumulative + rolling-window
        burn) joined with the live scheduler state (share, running,
        queued, lifetime sheds) merged across this node's frontends."""
        from filodb_tpu_torch.utils.usage import usage
        rows: Dict[str, dict] = {}

        def row_for(ws: str) -> dict:
            row = rows.get(ws)
            if row is None:
                row = rows[ws] = {
                    "ws": ws,
                    "share": self._qconfig.tenant_default_share,
                    "running": 0, "queued": 0, "shed": 0,
                    "queries": 0, "querySeconds": 0.0,
                    "samplesScanned": 0, "ingestSamples": 0,
                    "rejected": 0, "windowSamplesScanned": 0}
            return row

        # usage rows are per (ws, ns); the QoS unit is the workspace —
        # fold namespaces together (the /api/v1/usage endpoint keeps
        # the fine-grained split)
        for r in usage.snapshot():
            row = row_for(r["ws"])
            row["queries"] += r["queries"]
            row["querySeconds"] = round(
                row["querySeconds"] + r["querySeconds"], 6)
            row["samplesScanned"] += r["samplesScanned"]
            row["ingestSamples"] += r["ingestSamples"]
            row["rejected"] += r["rejected"]
            row["windowSamplesScanned"] += r["windowSamplesScanned"]
        for fe in self.frontends.values():
            if fe.scheduler is None:
                continue
            for s in fe.scheduler.snapshot():
                row = row_for(s["ws"])
                row["share"] = s["share"]
                row["running"] += s["running"]
                row["queued"] += s["queued"]
                row["shed"] += s["shed"]
        out = sorted(rows.values(),
                     key=lambda r: (-(r["queued"] + r["running"]),
                                    -r["querySeconds"], r["ws"]))
        return 200, {"status": "success",
                     "data": {"count": len(out), "tenants": out}}

    def _shards(self, params: Dict[str, str]) -> Tuple[int, object]:
        """GET /admin/shards — the ShardMapper assignment table as JSON:
        per shard the primary, its status, the ordered replica list with
        per-replica status, live-owner count, and (when a replication
        manager is attached) the per-peer fan-out lag table.  ?dataset=
        narrows to one dataset (default: all registered)."""
        want = params.get("dataset", "")
        datasets = {}
        for ds, mapper in self.shard_mappers.items():
            if want and ds != want:
                continue
            ent = {"numShards": mapper.num_shards,
                   "replicationFactor": getattr(mapper,
                                                "replication_factor", 1),
                   "shards": (mapper.assignment_table()
                              if hasattr(mapper, "assignment_table")
                              else [])}
            repl = self.replicators.get(ds)
            if repl is not None:
                ent["replicaLag"] = repl.snapshot()
            datasets[ds] = ent
        if want and not datasets:
            return 404, _err(f"dataset {want!r} not found")
        return 200, {"status": "success", "data": {"datasets": datasets}}

    def _shard_handoff(self, shard_s: str, params: Dict[str, str],
                       body: bytes) -> Tuple[int, object]:
        """POST /admin/shards/{s}/handoff — trigger a live handoff of
        one shard to `to=<node>` (param or JSON body {"to": ...});
        ?dataset= picks the dataset (default: the server's first).
        `drain=true` additionally flips this node's /ready to 503 once
        the move completes (the rolling-restart drain step,
        doc/operations.md)."""
        try:
            shard = int(shard_s)
        except ValueError:
            raise _BadRequest(f"bad shard number {shard_s!r}")
        req = {}
        if body:
            try:
                req = json.loads(body.decode() or "{}")
            except ValueError as e:
                raise _BadRequest(f"bad handoff body: {e}")
        to_node = params.get("to") or req.get("to")
        if not to_node:
            raise _BadRequest("handoff needs a target node "
                              "(?to=<node> or body {\"to\": ...})")
        dataset = params.get("dataset") or req.get("dataset") \
            or self.default_dataset
        coord = self.handoffs.get(dataset)
        if coord is None:
            return 400, _err(
                f"no handoff coordinator for dataset {dataset!r} "
                "(replication.enabled=false, or not wired)")
        drain = str(params.get("drain", req.get("drain", ""))
                    ).lower() in ("1", "true")
        from filodb_tpu_torch.replication.handoff import HandoffError
        try:
            summary = coord.handoff(shard, to_node)
        except HandoffError as e:
            return 409, _err(str(e))
        if drain:
            self.health.draining = (f"shard {shard} handed off to "
                                    f"{to_node}")
        return 200, {"status": "success", "data": summary}

    def _jobs(self) -> Tuple[int, object]:
        """Unified background-job registry (utils/jobs.py): every
        recurring worker's last start/end, duration, lag vs schedule,
        consecutive-error streak, and progress string in one place."""
        from filodb_tpu_torch.utils.jobs import jobs
        snaps = jobs.snapshot()
        return 200, {"status": "success",
                     "data": {"count": len(snaps), "jobs": snaps}}

    def _events(self, params: Dict[str, str]) -> Tuple[int, object]:
        """Structured event journal (utils/events.py): typed lifecycle
        events with monotonic sequence numbers — GET
        /admin/events?since_seq=N&limit=K resumes from a sequence (the
        CLI's `events --follow` tail), ?kind= filters one event type."""
        from filodb_tpu_torch.utils.events import journal
        since = _num_param(params, "since_seq", "0")
        limit = _num_param(params, "limit", "0")
        evs = journal.since(since, limit, kind=params.get("kind", ""))
        return 200, {"status": "success",
                     "data": {"nextSeq": journal.next_seq,
                              "count": len(evs), "events": evs}}

    def _federation(self) -> Tuple[int, object]:
        """GET /admin/federation — every configured remote cluster's
        ownership declaration (endpoint, label matchers, time window)
        and live probe state (healthy, last probe/error, transition
        count) from the FederationRegistry; the first stop of the
        "a remote cluster is down" runbook (doc/federation.md).  A
        server without federation answers an empty cluster list."""
        reg = self.federation
        if reg is None:
            return 200, {"status": "success",
                         "data": {"cluster": "", "clusters": []}}
        return 200, {"status": "success",
                     "data": {"cluster": reg.local_name,
                              "clusters": reg.snapshot()}}

    def _breakers(self) -> Tuple[int, object]:
        """Per-peer circuit-breaker states (parallel/breaker.py): which
        remote nodes the query transport is currently failing fast on,
        with consecutive-failure counts and backoff windows — the view an
        operator checks when a chaos/partial-results event is suspected."""
        from filodb_tpu_torch.parallel.breaker import breakers
        return 200, {"status": "success",
                     "data": {"breakers": breakers.snapshot()}}

    # --------------------------------------------------------------- ruler

    def _rules(self, params: Dict[str, str]) -> Tuple[int, object]:
        """Prometheus RuleDiscovery payload (doc/recording_rules.md).
        `?type=record|alert` filters like upstream; a deployment with no
        ruler answers an empty group list (Grafana's alerting UI probes
        this on every datasource)."""
        data = (self.ruler.rules_payload() if self.ruler is not None
                else {"groups": []})
        want = params.get("type")
        if want in ("record", "alert"):
            kind = "recording" if want == "record" else "alerting"
            data = {"groups": [
                {**g, "rules": [r for r in g["rules"]
                                if r["type"] == kind]}
                for g in data["groups"]]}
        return 200, {"status": "success", "data": data}

    def _alerts(self) -> Tuple[int, object]:
        data = (self.ruler.alerts_payload() if self.ruler is not None
                else {"alerts": []})
        return 200, {"status": "success", "data": data}

    def _rules_reload(self) -> Tuple[int, object]:
        """POST /admin/rules/reload: re-read the conf-tree groups + the
        standalone rules file.  Invalid config is a 400 and the RUNNING
        rules keep evaluating (Prometheus reload semantics)."""
        import time as _time
        if self.ruler is None:
            return 400, _err("no ruler configured (rules.enabled=false)")
        from filodb_tpu_torch.rules.config import RulesConfigError
        try:
            summary = self.ruler.reload()
        except RulesConfigError as e:
            # runtimeinfo's reloadConfigSuccess mirrors the Prometheus
            # field: the last reload ATTEMPT failed (running rules keep
            # evaluating on the previous config)
            self._last_reload_ok = False
            return 400, _err(f"rules reload rejected: {e}")
        self._last_reload_ok = True
        self._last_reload_unix = _time.time()
        return 200, {"status": "success", "data": summary}

    def _buildinfo(self) -> Tuple[int, object]:
        """Grafana probes /api/v1/status/buildinfo on datasource setup to
        pick API features by version — answer the Prometheus shape."""
        import platform as _platform

        from filodb_tpu_torch import __version__
        return 200, {"status": "success", "data": {
            "version": __version__,
            "revision": "",
            "branch": "",
            "buildUser": "",
            "buildDate": "",
            "goVersion": f"python-{_platform.python_version()}",
        }}

    def _runtimeinfo(self) -> Tuple[int, object]:
        import os as _os
        import threading as _threading
        import time as _time

        from filodb_tpu_torch.utils import iso_utc as iso

        n_series = 0
        for dataset, eng in self.engines.items():
            source = getattr(eng, "source", None)
            mapper = self.shard_mappers.get(dataset)
            if source is None or mapper is None:
                continue
            for s in mapper.all_shards():
                shard = source.get_shard(dataset, s)
                if shard is not None:
                    n_series += shard.num_partitions
        retention_s = self._config.store.disk_time_to_live_s
        # WAL posture for runbooks: enabled datasets + whether the boot
        # replay completed (a restarted node mid-replay shows false —
        # the same signal /ready turns into a 503)
        wal = self.health.wal_summary()
        wal_enabled = any(e["enabled"] for e in wal.values())
        replay_done = all(e["replayDone"] for e in wal.values()
                          if e["enabled"]) if wal_enabled else True
        return 200, {"status": "success", "data": {
            "startTime": iso(self._start_unix),
            "CWD": _os.getcwd(),
            "reloadConfigSuccess": self._last_reload_ok,
            "lastConfigTime": iso(self._last_reload_unix),
            "corruptionCount": 0,
            "goroutineCount": _threading.active_count(),
            "GOMAXPROCS": _os.cpu_count() or 1,
            "storageRetention": f"{retention_s}s",
            "timeSeriesCount": n_series,
            "serverTime": iso(_time.time()),
            "walEnabled": wal_enabled,
            "walReplayDone": replay_done,
            "serverPhase": self.health.phase,
        }}

    def _traces(self, trace_id,
                params: Optional[Dict[str, str]] = None
                ) -> Tuple[int, object]:
        """Stitched cross-node span tree for one request (the
        Zipkin-query analogue; spans from remote nodes arrive via the
        dispatch/ack replies and carry their node name).  GET
        /admin/traces lists known ids — `?limit=N` (default 50) keeps
        the newest N, `?origin=query|rule_eval|remote_write` filters to
        one door's traces; /admin/traces/<id> returns the events sorted
        by end time, answering 410 for an id the bounded ring has
        EVICTED (it existed; the buffer recycled it) vs 404 for one it
        never saw."""
        from filodb_tpu_torch.utils.metrics import collector
        params = params or {}
        if trace_id is None:
            origin = params.get("origin", "")
            if origin and origin not in ("query", "rule_eval",
                                         "remote_write"):
                raise _BadRequest(
                    f"unknown trace origin {origin!r} "
                    "(query | rule_eval | remote_write)")
            limit = _num_param(params, "limit", "50")
            if limit < 0:
                raise _BadRequest("limit must be >= 0")
            return 200, {"status": "success",
                         "data": collector.trace_ids(origin=origin,
                                                     limit=limit)}
        evs = sorted(collector.trace(trace_id),
                     key=lambda e: e.get("end_unix_s", 0))
        if not evs:
            if collector.was_evicted(trace_id):
                return 410, {"status": "error", "errorType": "gone",
                             "error": f"trace {trace_id!r} was evicted "
                                      "from the bounded trace ring "
                                      "(raise max_traces or export "
                                      "spans via trace_export_url)"}
            return 404, _err(f"no trace {trace_id!r}")
        data = {"traceID": trace_id, "queryID": trace_id, "spans": evs}
        # cross-links: the final verdict (completed/killed/
        # deadline) and, when this query also left a slowlog record, its
        # ring seq — so trace <-> slowlog correlation works BOTH ways
        # instead of being a manual join
        verdict = collector.verdict(trace_id)
        if verdict:
            data["verdict"] = verdict
        from filodb_tpu_torch.utils.slowlog import slowlog
        seq = slowlog.seq_for_trace(trace_id)
        if seq is not None:
            data["slowlogSeq"] = seq
        return 200, {"status": "success", "data": data}

    def _traced_filters(self, body: bytes) -> Tuple[int, object]:
        """Set per-series debug-follow filters on every local shard (ref:
        README.md:871-875 tracedPartFilters; TimeSeriesShard.scala:265) —
        POST a JSON list of label->value maps; [] clears."""
        import json as _json
        try:
            filters = _json.loads(body.decode() or "[]")
            if not isinstance(filters, list) or any(
                    not isinstance(g, dict) for g in filters):
                raise ValueError("expected a list of label maps")
        except (ValueError, UnicodeDecodeError) as e:
            raise _BadRequest(f"bad traced-filter body: {e}")
        n = 0
        for name, eng in self.engines.items():
            source = getattr(eng, "source", None)
            if source is None or not hasattr(source, "shards_for"):
                continue
            for shard in source.shards_for(name):
                shard.set_traced_filters(filters)
                n += 1
        return 200, {"status": "success",
                     "data": {"shards": n, "filters": filters}}

    def _loglevel(self, logger_name: str, level: str) -> Tuple[int, object]:
        """Dynamic per-logger level (ref: doc/http_api.md:38-46)."""
        lvl = getattr(logging, level.upper(), None)
        if not isinstance(lvl, int):
            return 400, _err(f"bad level {level!r}")
        logging.getLogger(logger_name if logger_name != "root" else None
                          ).setLevel(lvl)
        return 200, {"status": "success",
                     "data": f"{logger_name} set to {level.upper()}"}

    # ------------------------------------------------------------ profiler

    def _profiler(self, action: str, params: Dict[str, str],
                  method: str) -> Tuple[int, object]:
        """Sampling-profiler admin (ref: SimpleProfiler.java in the
        reference's standalone server)."""
        from filodb_tpu_torch.utils.profiler import profiler
        expected = {"start": "POST", "stop": "POST", "report": "GET"}
        if action not in expected:
            return 404, _err(f"unknown profiler action {action!r}")
        if method != expected[action]:
            return 405, _err(f"profiler {action} requires "
                             f"{expected[action]}, got {method}")
        if action == "start":
            try:
                hz = float(params.get("hz", "100"))
                if not profiler.start(hz):
                    raise _BadRequest("profiler already running")
            except ValueError as e:
                raise _BadRequest(f"bad hz: {e}")
            return 200, {"status": "started", "hz": profiler.hz}
        if action == "stop":
            if not profiler.stop():
                raise _BadRequest("profiler not running")
            return 200, {"status": "stopped", "samples": profiler.samples}
        fmt = params.get("format", "flat")
        if fmt == "collapsed":
            # semicolon-joined stacks, speedscope/flamegraph.pl-compatible
            return 200, profiler.report_collapsed()
        if fmt != "flat":
            raise _BadRequest(f"unknown report format {fmt!r} "
                              "(flat | collapsed)")
        return 200, profiler.report(_num_param(params, "top", "30"))

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

    # -------------------------------------------------------- remote write

    def _remote_write_ingest(self, dataset: str, body: bytes,
                             headers: Dict[str, str]) -> Tuple[int, object]:
        """POST /api/v1/write — the Prometheus remote_write front door
        (snappy-compressed protobuf WriteRequest; the Cortex /
        Thanos-receive ingest contract).  Pipeline: snappy block
        decompress → shared prompb codec decode → per-tenant admission →
        WAL group commit (when configured) → rectangular columnar slabs
        into `ingest_columns` (gateway/remotewrite.RemoteWriteSink).
        Responses: 204 on success (the Prometheus client contract is any
        2xx), 400 on malformed payloads, 429 + Retry-After when the
        tenant's rolling ingest window is over its limit (backpressure —
        the client re-sends, nothing is silently dropped), 503 when the
        WAL cannot claim durability (ack withheld, client must retry).

        Write-path tracing (doc/observability.md): a W3C `traceparent`
        request header's trace id is ACCEPTED (the client's trace
        continues through decode → WAL → memstore), else
        one is minted; every response — errors included — carries
        `X-Trace-Id` plus a `traceparent` echo, the per-stage breakdown
        lands in an IngestStats fed to the freshness histograms, and
        batches over `ingest.slow_batch_threshold_s` land in
        /admin/ingestlog."""
        from filodb_tpu_torch.utils.freshness import DoorTrace
        from filodb_tpu_torch.utils.metrics import registry, span
        registry.counter("remote_write_requests",
                         dataset=dataset).increment()
        door = DoorTrace(
            "remote_write", dataset, headers, len(body),
            threshold_s=self._config.ingest.slow_batch_threshold_s)
        try:
            with door, span("remote_write", dataset=dataset):
                status, payload = self._remote_write_traced(
                    dataset, body, door.headers, door.stats)
        except _BadRequest as e:
            # a rejected payload still answers with its trace headers
            # (the documented contract: EVERY response correlates)
            return 400, {**_err(str(e)),
                         "_headers": door.trace_headers()}
        if isinstance(payload, dict):
            payload.setdefault("_headers", {}).update(
                door.finish(status))
        return status, payload

    def _remote_write_traced(self, dataset: str, body: bytes,
                             hdr: Dict[str, str], stats
                             ) -> Tuple[int, object]:
        """The remote_write pipeline body, running under the request's
        trace context (split out so _remote_write_ingest owns the trace
        bookkeeping and this owns the protocol)."""
        import time as _time

        from filodb_tpu_torch.http import remotepb
        from filodb_tpu_torch.utils import snappy
        from filodb_tpu_torch.utils.metrics import registry, span
        from filodb_tpu_torch.utils.usage import usage
        from filodb_tpu_torch.gateway.remotewrite import (admit_series,
                                                    count_samples)
        t0 = _time.perf_counter()
        try:
            with span("rw_decode", dataset=dataset):
                series = remotepb.decode_write_request(
                    snappy.decompress(body))
        except (ValueError, IndexError, struct.error) as e:
            # truncated/garbled snappy or protobuf bytes: the client's
            # fault, counted and answered 400 like any bad payload
            registry.counter("remote_write_bad_payloads",
                             dataset=dataset).increment()
            raise _BadRequest(f"bad remote-write payload: {e}")
        stats.decode_s = _time.perf_counter() - t0
        stats.series = len(series)
        stats.samples = count_samples(series)
        if stats.samples == 0:
            return 204, {}
        org = hdr.get("x-scope-orgid")
        if org:
            ws, _, ns = org.partition("/")
            stats.tenant_ws, stats.tenant_ns = ws, ns
        elif series:
            labels = dict(series[0].labels)
            stats.tenant_ws = labels.get("_ws_", "")
            stats.tenant_ns = labels.get("_ns_", "")
        # PER-TENANT admission over every series in the request (header
        # org = one tenant for the whole request): an over-limit tenant
        # must not ride in behind another tenant's series
        t_adm = _time.perf_counter()
        with span("rw_admission", dataset=dataset):
            admitted, retry_after, rejected = admit_series(
                series, org, self._qconfig.tenant_ingest_samples_limit)
        stats.admission_s = _time.perf_counter() - t_adm
        if admitted:
            sink = self._remote_write_sink(dataset)
            from filodb_tpu_torch.replication.replicator import \
                ReplicationSendError
            from filodb_tpu_torch.wal import WalWriteError
            try:
                sink.ingest_series(admitted, stats=stats)
            except WalWriteError as e:
                # durability could not be claimed: withhold the ack — a
                # compliant remote_write client retries 5xx with backoff
                return 503, {"status": "error",
                             "errorType": "unavailable",
                             "error":
                                 f"write-ahead log commit failed: {e}"}
            except ReplicationSendError as e:
                # distributor mode: a remotely-owned shard's slab landed
                # on NO owner — same un-acked contract as a failed WAL
                # commit (the client re-sends; dedup absorbs overlap)
                return 503, {"status": "error",
                             "errorType": "unavailable",
                             "error": f"replication failed: {e}"}
        if rejected:
            # anything rejected makes the WHOLE response a 429 so the
            # client re-sends (never a silent drop): the re-send's
            # already-admitted samples are same-timestamp duplicates the
            # store drops, the rejected tenant's land after Retry-After
            registry.counter("remote_write_rejected",
                             dataset=dataset).increment()
            return 429, {
                "status": "error", "errorType": "too_many_requests",
                "error": (f"{rejected} samples over a tenant ingest "
                          f"limit "
                          f"({self._qconfig.tenant_ingest_samples_limit}"
                          f" samples per {usage.window_s:g}s window) — "
                          f"retry after the window rolls"),
                "_headers": {"Retry-After":
                             str(max(1, int(-(-retry_after // 1))))}}
        return 204, {}

    def _remote_write_sink(self, dataset: str):
        """Lazily-built RemoteWriteSink per dataset, assembled from the
        dataset's gateway pipeline (memstore/mapper/spread/schemas + the
        WAL manager attached to it)."""
        sink = self._rw_sinks.get(dataset)
        if sink is None:
            gw = self.gateways.get(dataset)
            if gw is None:
                raise _BadRequest(
                    f"no ingestion pipeline for dataset {dataset!r}")
            from filodb_tpu_torch.gateway.remotewrite import RemoteWriteSink
            sink = RemoteWriteSink(
                gw.memstore, dataset, mapper=gw.mapper,
                spread_provider=gw.spread, schemas=gw.schemas,
                wal=getattr(gw, "wal", None),
                replicator=self.replicators.get(dataset))
            self._rw_sinks[dataset] = sink
        return sink

    # --------------------------------------------------------- remote read

    def _remote_read(self, eng: QueryEngine, body: bytes,
                     planner_params: Optional[PlannerParams] = None
                     ) -> Tuple[int, object]:
        """Prometheus remote-read: snappy-compressed protobuf ReadRequest in,
        snappy-compressed ReadResponse of raw samples out (ref:
        PrometheusApiRoute.scala:37-62, remote/RemoteStorage.java).  A bytes
        payload tells the server shell to send application/x-protobuf with
        Content-Encoding: snappy.  Blocks read from the card come back
        with on_host() before the f64 re-add of vbase."""
        import dataclasses as _dc

        import numpy as np

        from filodb_tpu_torch.core.index import (Equals, EqualsRegex, NotEquals,
                                           NotEqualsRegex)
        from filodb_tpu_torch.http import remotepb
        from filodb_tpu_torch.query import logical as lp
        from filodb_tpu_torch.utils import snappy

        try:
            queries = remotepb.decode_read_request(snappy.decompress(body))
        except (ValueError, IndexError, struct.error) as e:
            # IndexError/struct.error: truncated snappy or protobuf bytes —
            # still the client's fault, so a 400 like any other bad payload
            raise _BadRequest(f"bad remote-read payload: {e}")
        # the remote-read protobuf has NO channel for a partial flag or
        # warnings, so degradation here would be exactly the silent
        # partial the contract forbids: always fail hard on dead shards
        # (timeout=/limit overrides still apply)
        pp = planner_params if planner_params is not None else PlannerParams()
        if pp.allow_partial_results:
            pp = _dc.replace(pp, allow_partial_results=False)
        matcher_map = {remotepb.EQ: Equals, remotepb.NEQ: NotEquals,
                       remotepb.RE: EqualsRegex, remotepb.NRE: NotEqualsRegex}
        results = []
        for q in queries:
            filters = []
            for m in q.matchers:
                cls = matcher_map.get(m.type)
                if cls is None:
                    raise _BadRequest(f"unsupported matcher type {m.type}")
                name = "_metric_" if m.name == "__name__" else m.name
                filters.append(cls(name, m.value))
            plan = lp.RawSeries(
                lp.IntervalSelector(q.start_timestamp_ms, q.end_timestamp_ms),
                tuple(filters))
            res = eng.exec_logical_plan(plan, pp)
            if res.error:
                raise _BadRequest(res.error)
            series_out = []
            for block in res.blocks:
                block = block.on_host()
                vals = np.asarray(block.values, dtype=np.float64)
                if vals.ndim != 2:
                    continue            # histogram schemas: not remote-readable
                ts_abs = np.asarray(block.ts_off, dtype=np.int64) + block.base_ms
                if block.vbase is not None:
                    vals = vals + np.asarray(block.vbase, np.float64)[:, None]
                for i, key in enumerate(block.keys):
                    valid = (np.isfinite(vals[i])
                             & (ts_abs[i] >= q.start_timestamp_ms)
                             & (ts_abs[i] <= q.end_timestamp_ms))
                    labels = [("__name__" if k == "_metric_" else k, v)
                              for k, v in key.labels]
                    samples = [(float(v), int(t)) for v, t in
                               zip(vals[i][valid], ts_abs[i][valid])]
                    series_out.append(remotepb.PromTimeSeries(labels, samples))
            results.append(series_out)
        payload = snappy.compress(remotepb.encode_read_response(results))
        return 200, payload

    def _cardinality(self, dataset: str,
                     params: Dict[str, str]) -> Tuple[int, object]:
        """Top-k child prefixes by series count, merged across shards
        (ref: TsCardinalities logical plan / ClusterApiRoute cardinality)."""
        eng = self.engines[dataset]
        prefix = tuple(p for p in params.get("prefix", "").split(",") if p)
        k = _num_param(params, "k", "10")
        merged: Dict[Tuple[str, ...], Dict[str, int]] = {}
        source = getattr(eng, "source", None)
        mapper = self.shard_mappers.get(dataset)
        shard_ids = mapper.all_shards() if mapper is not None else [0]
        for s in shard_ids:
            shard = source.get_shard(dataset, s) if source else None
            tracker = getattr(shard, "cardinality_tracker", None)
            if tracker is None:
                continue
            # merge FULL child lists — per-shard top-k truncation would
            # undercount prefixes that rank differently across shards
            for rec in tracker.children(prefix):
                agg = merged.setdefault(rec.prefix, {"ts": 0, "active": 0,
                                                     "children": 0})
                agg["ts"] += rec.ts_count
                agg["active"] += rec.active_ts_count
                agg["children"] += rec.children_count
        rows = [{"prefix": list(p), "tsCount": v["ts"],
                 "activeTsCount": v["active"], "childrenCount": v["children"]}
                for p, v in merged.items()]
        rows.sort(key=lambda r: -r["tsCount"])
        return 200, {"status": "success", "data": rows[:k]}

    def _status_tsdb(self, dataset: str,
                     params: Dict[str, str]) -> Tuple[int, object]:
        """GET /api/v1/status/tsdb — the Prometheus-compatible
        cardinality explorer, built on the tag index's alive
        label_value_counts and merged across shards: top-k metrics,
        label-value pairs and value counts per label name, plus
        per-tenant (_ws_) series totals and the per-ws budget rejection
        count (the "which tenant is exploding cardinality" runbook view,
        doc/index.md)."""
        eng = self.engines[dataset]
        k = _num_param(params, "limit", "10")
        source = getattr(eng, "source", None)
        mapper = self.shard_mappers.get(dataset)
        shard_ids = mapper.all_shards() if mapper is not None else [0]
        num_series = 0
        rejected = 0
        by_metric: Dict[str, int] = {}
        values_by_label: Dict[str, int] = {}
        mem_by_label: Dict[str, int] = {}
        by_pair: Dict[str, int] = {}
        by_tenant: Dict[str, int] = {}
        for s in shard_ids:
            shard = source.get_shard(dataset, s) if source else None
            idx = getattr(shard, "index", None)
            if idx is None:
                continue
            num_series += idx.num_docs
            rejected += shard.stats.tenant_rejected
            for label in idx.label_names():
                counts = idx.label_value_counts(label)
                values_by_label[label] = (values_by_label.get(label, 0)
                                          + len(counts))
                mem_by_label[label] = (mem_by_label.get(label, 0)
                                       + idx.label_memory_bytes(label))
                for v, c in counts:
                    if c <= 0:
                        continue
                    if label == "__name__":
                        by_metric[v] = by_metric.get(v, 0) + c
                    elif label == "_ws_":
                        by_tenant[v] = by_tenant.get(v, 0) + c
                    pair = f"{label}={v}"
                    by_pair[pair] = by_pair.get(pair, 0) + c

        def topk(d: Dict[str, int]) -> list:
            rows = sorted(d.items(), key=lambda kv: (-kv[1], kv[0]))
            return [{"name": n, "value": v} for n, v in rows[:k]]

        data = {
            "headStats": {
                "numSeries": num_series,
                "numLabelPairs": len(by_pair),
                "tenantSeriesRejected": rejected,
                "tenantSeriesLimit":
                    self._config.index.tenant_series_limit,
            },
            "seriesCountByMetricName": topk(by_metric),
            "labelValueCountByLabelName": topk(values_by_label),
            "memoryInBytesByLabelName": topk(mem_by_label),
            "seriesCountByLabelValuePair": topk(by_pair),
            "seriesCountByTenant": topk(by_tenant),
        }
        return 200, {"status": "success", "data": data}

    # -------------------------------------------------------------- influx

    def _influx_write_traced(self, params, body, headers=None):
        """Gateway-side trace context: the write path's spans collect
        under one trace id — ACCEPTED from a W3C `traceparent` request
        header when present, minted otherwise — returned in the
        X-Trace-Id / traceparent response headers (Influx writes answer
        204 with no body; ref: the ingest half of the Kamon span
        pipeline, KamonLogger.scala:16-40).  Batches over
        `ingest.slow_batch_threshold_s` land in /admin/ingestlog with
        the same freshness accounting as the remote_write door."""
        from filodb_tpu_torch.utils.freshness import DoorTrace
        from filodb_tpu_torch.utils.metrics import span
        door = DoorTrace(
            "influx", params.get("db") or self.default_dataset or "",
            headers, len(body),
            threshold_s=self._config.ingest.slow_batch_threshold_s)
        with door, span("influx_write"):
            status, payload = self._influx_write(params, body,
                                                 door.stats)
        if isinstance(payload, dict):
            payload.setdefault("_headers", {}).update(
                door.finish(status))
        return status, payload

    def _influx_write(self, params: Dict[str, str],
                      body: bytes, stats=None) -> Tuple[int, object]:
        dataset = params.get("db") or self.default_dataset
        gateway = self.gateways.get(dataset)
        if gateway is None:
            return 404, _err(f"no gateway for dataset {dataset!r}")
        lines = body.decode("utf-8", errors="replace").splitlines()
        n = gateway.ingest_lines(lines)
        if stats is not None:
            stats.series = len(lines)
            stats.samples = n
            stats.ingested = n
        retry_after = gateway.last_retry_after
        if n == 0 and retry_after is not None:
            # every record bounced off the per-tenant ingest limit: this
            # door HAS a reply channel, so backpressure like the
            # remote_write front door instead of a silent drop
            return 429, {
                "status": "error", "errorType": "too_many_requests",
                "error": "tenant ingest limit exceeded — retry after "
                         "the window rolls",
                "_headers": {"Retry-After":
                             str(max(1, int(-(-retry_after // 1))))}}
        return 204, {}


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
