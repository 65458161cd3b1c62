"""Query-serving frontend: turns a fast single-query engine into fast
concurrent TRAFFIC (port of filodb_tpu/query/frontend.py, with
analyze_range, the EXPLAIN ANALYZE execution behind /api/v1/explain).

Three layers wrap one QueryEngine, outermost first (ref: the Cortex/
Thanos query-frontend split — dedup, result caching and scheduling live
in front of the querier, not inside it):

  1. singleflight — byte-identical in-flight `query_range` requests
     share ONE execution (N dashboard clients polling the same panel
     cost one query; `query_singleflight_hits` counts the shares).
  2. incremental result cache (query/resultcache.py) — a re-poll
     computes only the windows past the append horizon and merges them
     with the cached prefix.
  3. scheduler — a WEIGHTED-FAIR scheduler (query/qos.py) bounds
     concurrently EXECUTING queries (query.max_concurrent_queries) with
     per-tenant queues, configurable concurrency shares and deficit-
     round-robin dispatch (an idle tenant's share redistributes), plus
     adaptive load shedding: queries whose predicted queue wait would
     blow their deadline budget — or whose tenant queue is already at
     query.tenant_max_queue_depth — are rejected at admission with the
     structured `tenant_overloaded` error (HTTP 429 + Retry-After,
     write-side parity with the ingest limits).  The window-grid
     coalescer (query/coalesce.py) still merges same-grid peers into
     one engine.query_range_batch when query.batch_window_ms > 0.

Cache hits and dedup'd followers never touch the scheduler, so the
bound applies exactly to the expensive device-dispatching work.
"""
from __future__ import annotations

import threading
import time as _time
from typing import Dict, Optional, Tuple

from filodb_tpu_torch.core.shard import NO_HORIZON_MS
from filodb_tpu_torch.query.coalesce import QueryCoalescer
from filodb_tpu_torch.query.qos import (SHED_ERROR_CODE, WeightedFairScheduler,
                                  account_wait)
from filodb_tpu_torch.query.rangevector import (PlannerParams, QueryResult,
                                          remaining_budget)
from filodb_tpu_torch.query.resultcache import ResultCache, _plan_cacheable


class _Flight:
    __slots__ = ("done", "result")

    def __init__(self):
        self.done = threading.Event()
        self.result = None


def _canceled_result(tok, where: str) -> QueryResult:
    """The structured query_canceled result for a kill that landed while
    the request was BLOCKED in the serving stack (queue / dedup wait) —
    before any exec node existed to raise it."""
    return QueryResult([], error=("query_canceled: query killed "
                                  f"{where} (reason={tok.reason or 'admin'})"
                                  + (f": {tok.detail}" if tok.detail
                                     else "")))


class QueryFrontend:
    """Per-dataset serving frontend around one QueryEngine."""

    def __init__(self, engine, window_s: float = 0.0, config=None):
        if config is None:
            from filodb_tpu_torch.config import settings
            config = settings()
        q = config.query
        self.engine = engine
        self.coalescer = QueryCoalescer(engine, window_s)
        self.cache: Optional[ResultCache] = (
            ResultCache(q.result_cache_max_entries,
                        q.result_cache_max_entry_bytes,
                        tenant_quota_bytes=q
                        .result_cache_tenant_quota_bytes)
            if q.result_cache_enabled else None)
        self._sf_enabled = q.singleflight_enabled
        self._sf_lock = threading.Lock()
        self._inflight: Dict[Tuple, _Flight] = {}
        n = q.max_concurrent_queries
        # weighted-fair admission over the execution capacity: the
        # scheduler dispatches per-tenant queues by
        # deficit round robin and sheds doomed queries at admission
        self._sched = WeightedFairScheduler(
            n, shares=q.tenant_shares,
            default_share=q.tenant_default_share,
            max_queue_depth=q.tenant_max_queue_depth,
            shed_enabled=q.shed_enabled) if n > 0 else None
        self._ask_timeout_s = q.ask_timeout_s
        # promql -> cacheability memo (parse once per distinct string)
        self._cacheable: Dict[str, bool] = {}
        # --- observability: slowlog + per-tenant usage/limits ---
        self._slow_s = q.slow_query_threshold_s
        self._usage_enabled = q.tenant_usage_enabled
        self._warn_limit = q.tenant_samples_warn_limit
        self._fail_limit = q.tenant_samples_fail_limit
        # --- failure-domain hardening: end-to-end deadlines ---
        self._default_timeout_s = q.default_timeout_s
        self._allow_partial_default = q.allow_partial_results
        # shed slowlog records are rate-limited PER TENANT (one per
        # second): a flood producing hundreds of sheds/s must not turn
        # the flight recorder into the overload's biggest CPU consumer —
        # the counter counts every shed; the slowlog keeps representative
        # records
        self._last_shed_log: Dict[str, float] = {}

    # ------------------------------------------------------------ public

    @property
    def scheduler(self):
        """The weighted-fair admission scheduler (query/qos.py), or
        None when max_concurrent_queries == 0 (unbounded)."""
        return self._sched

    def query_range(self, promql: str, start_s: int, step_s: int,
                    end_s: int, planner_params=None):
        """The serving entry point: tenant admission, then the
        singleflight/cache/scheduler stack, then usage accounting + the
        slow-query flight recorder on the way out.  The recorded
        duration is the CLIENT-OBSERVED wall (queue wait and dedup wait
        included) — that's the latency an operator is paged for."""
        # the deadline clock starts at ADMISSION: scheduler queue wait
        # and singleflight dedup wait spend from the same budget the
        # exec tree enforces (doc/robustness.md deadline semantics)
        pp = self._admit_params(planner_params)
        key = (promql, start_s, step_s, end_s, repr(pp))
        return self._serve(
            key, lambda: self._cached_query(promql, start_s, step_s,
                                            end_s, pp),
            promql, (start_s, step_s, end_s), pp, None, "query_range")

    def query_instant(self, promql: str, time_s: int, planner_params=None,
                      tenant=None, origin: str = "query"):
        """Instant queries through the SAME serving stack as query_range
        — tenant admission/limits, deadline stamped at admission,
        singleflight dedup, the concurrency semaphore, usage accounting
        and the slowlog — minus the step-aligned result cache (a
        one-step grid has no reusable prefix).  Before this the
        /api/v1/query route called eng.query_instant directly, a free
        pass around every one of those; the ruler evaluates every rule
        through here (`tenant` override -> the `_rules_` accounting
        bucket, `origin` tags its slowlog records)."""
        pp = self._admit_params(planner_params)
        # an instant query at t IS the range query (t, 1, t): sharing
        # the range key-space lets a dashboard's instant poll dedup
        # against an identical in-flight one
        key = (promql, time_s, 1, time_s, repr(pp))
        return self._serve(
            key, lambda: self._run(promql, time_s, 1, time_s, pp),
            promql, (time_s, 1, time_s), pp, tenant, origin)

    def _serve(self, key, run, promql, grid, pp, tenant, origin):
        """Admission -> singleflight -> accounting: the shared serving
        wrapper for both query shapes."""
        from filodb_tpu_torch.query.activequeries import set_pending, verdict_of
        from filodb_tpu_torch.utils.slowlog import slowlog
        from filodb_tpu_torch.utils.usage import tenant_of, usage
        if self._usage_enabled:
            if tenant is None:
                tenant = tenant_of(promql)
            err = usage.admit(tenant[0], tenant[1], self._warn_limit,
                              self._fail_limit)
            if err is not None:
                res = QueryResult([], error=err)
                # scan-limit 429s answer with the same Retry-After
                # contract as the ingest limits and the overload sheds:
                # seconds until the tenant's rolling window resets
                res.retry_after_s = usage.scan_retry_after(tenant[0],
                                                           tenant[1])
                return res
        if tenant is None:
            tenant = ("", "")
        # live introspection (query/activequeries.py): mark the request
        # so the SCHEDULER layer registers it the moment real work
        # begins (before the semaphore wait).  Cache hits and dedup'd
        # followers finish inside the serving layers holding nothing —
        # they pay these two thread-local writes and never register.
        set_pending((tenant, origin))
        t0 = _time.perf_counter()
        res = None
        try:
            res, shared = self._singleflight(key, run, pp)
        finally:
            set_pending(None)
        dur = _time.perf_counter() - t0
        # singleflight followers received the LEADER's result: the work
        # (and its samples_scanned) happened once — re-recording it per
        # follower would bill a tenant N× for one execution and write N
        # identical slowlog records, throttling tenants fastest exactly
        # when dedup makes their traffic cheapest
        if not shared:
            if self._usage_enabled and res is not None:
                usage.record_query(tenant[0], tenant[1], dur,
                                   res.stats.samples_scanned,
                                   res.stats.result_bytes)
            # shed queries are force-recorded (verdict `shed`): an
            # operator triaging "why is this tenant getting 429s" reads
            # the actual shed requests, not just a counter — they never
            # cross the slow threshold on their own (shedding is fast;
            # that is the point).  Rate-limited to one record per tenant
            # per second so a shed storm can't make the recorder itself
            # a load source.
            shed = (res is not None and res.error is not None
                    and res.error.startswith(SHED_ERROR_CODE))
            if shed:
                now = _time.monotonic()
                shed = now - self._last_shed_log.get(tenant[0],
                                                     -1e9) >= 1.0
                if shed:
                    if len(self._last_shed_log) > 1024:
                        self._last_shed_log.clear()  # hostile ws churn
                    self._last_shed_log[tenant[0]] = now
            slowlog.maybe_record(promql, grid[0], grid[1], grid[2], dur,
                                 res, tenant=tenant, origin=origin,
                                 threshold_s=self._slow_s, force=shed)
            # serving-latency histogram with the trace id as its
            # OpenMetrics exemplar (p99 spike -> the exact trace in one
            # hop), and the trace tagged with its door for the
            # /admin/traces?origin= filter
            from filodb_tpu_torch.utils.metrics import collector, registry
            tid = getattr(res, "trace_id", "") if res is not None else ""
            registry.histogram("query_latency_seconds",
                               origin=origin).record(dur,
                                                     exemplar=tid or None)
            if tid:
                collector.note_origin(
                    tid, "rule_eval" if origin.startswith("rule_")
                    else "query")
                # final verdict on the trace (completed/killed/deadline)
                # so /admin/traces/<id> answers "how did it end" —
                # the slowlog cross-link's other half
                collector.note_verdict(tid, verdict_of(res))
        return res

    def _singleflight(self, key, run, planner_params=None):
        """Returns (result, shared): shared=True iff this caller rode a
        singleflight leader's execution instead of running its own.
        A killed LEADER's result is never inherited — followers
        re-execute under their own (freshly-registered) token."""
        if not self._sf_enabled:
            return run(), False
        with self._sf_lock:
            flight = self._inflight.get(key)
            leader = flight is None
            if leader:
                flight = self._inflight[key] = _Flight()
        if not leader:
            from filodb_tpu_torch.utils.metrics import registry
            registry.counter("query_singleflight_hits").increment()
            # generous bound mirroring the coalescer's: a wedged leader
            # must not strand followers — they fall back to running solo.
            # The follower's DEADLINE bounds the wait too (dedup wait
            # spends the same budget as execution); an expired budget
            # then surfaces as the structured query_timeout via the solo
            # path's scheduler/exec-boundary checks.
            bound = remaining_budget(planner_params,
                                     max(300.0, 3 * self._ask_timeout_s))
            dl = getattr(planner_params, "deadline_unix_s", 0.0) \
                if planner_params is not None else 0.0
            completed = flight.done.wait(timeout=bound)
            if flight.result is not None:
                shared = flight.result
                # never inherit the LEADER's deadline expiry OR its
                # kill: budgets and kills are per-request (repr-excluded
                # from the dedup key), so a short-timeout or killed
                # leader must not fail its followers — they run solo
                # under their own deadline/token
                if not (shared.error is not None
                        and (shared.error.startswith("query_timeout")
                             or shared.error.startswith("query_canceled"))):
                    return shared, True
            res = run()
            if not completed and not (dl and _time.time() >= dl):
                # the leader wedged past the full bound (NOT our own
                # deadline expiring): the fallback must be visible to
                # operators, not a silent doubled execution
                registry.counter("singleflight_leader_timeouts").increment()
                if res is not None:
                    res.stats.warnings.append(
                        "singleflight leader timed out; follower fell "
                        "back to solo execution")
            return res, False
        try:
            res = run()
            flight.result = res
            return res, False
        finally:
            with self._sf_lock:
                if self._inflight.get(key) is flight:
                    del self._inflight[key]
            flight.done.set()

    def analyze_range(self, promql: str, start_s: int, step_s: int,
                      end_s: int, planner_params=None):
        """EXPLAIN ANALYZE execution (/api/v1/explain?analyze=true): the
        SAME tenant admission, scheduler bound, and usage/slowlog
        accounting as query_range, but runs a recorder-attached plan and
        bypasses the result caches (annotations must reflect a real
        execution).  Returns (result, recorder, exec_tree); recorder and
        tree are None when admission rejected the query.  Parse and
        planning errors propagate (the HTTP edge turns them into 400s,
        as on the plain explain path)."""
        import dataclasses as _dc
        import uuid as _uuid

        from filodb_tpu_torch.promql.parser import (
            TimeStepParams, query_range_to_logical_plan)
        from filodb_tpu_torch.query.activequeries import (active_queries,
                                                          verdict_of)
        from filodb_tpu_torch.query.execbase import AnalyzeRecorder
        from filodb_tpu_torch.query.rangevector import QueryContext
        from filodb_tpu_torch.utils.slowlog import slowlog
        from filodb_tpu_torch.utils.usage import tenant_of, usage
        tenant = ("", "")
        if self._usage_enabled:
            tenant = tenant_of(promql)
            err = usage.admit(tenant[0], tenant[1], self._warn_limit,
                              self._fail_limit)
            if err is not None:
                return QueryResult([], error=err), None, None
        t0 = _time.perf_counter()
        plan = query_range_to_logical_plan(
            promql, TimeStepParams(start_s, step_s, end_s))
        eng = self.engine
        ctx = QueryContext(query_id=_uuid.uuid4().hex[:16],
                           device=eng.device,
                           mirror_background_rebuild=(
                               eng.mirror_background_rebuild))
        # analyze executions are live-listable and killable like any
        # other query
        ent = active_queries.register(ctx.query_id, promql=promql,
                                      tenant=tenant,
                                      origin="explain_analyze")
        if ent is not None:
            ctx.cancel = ent.token
            ctx.active = ent
            ent.set_phase("planning")
        # the deadline starts at admission, as for query_range; analyze
        # has no re-plan layer, so the partial-results gate engages the
        # scatter-gather drop directly
        planner_params = self._admit_params(planner_params)
        if planner_params.allow_partial_results:
            planner_params = _dc.replace(planner_params, partial_now=True)
        ctx.planner_params = planner_params
        ctx.deadline_unix_s = planner_params.deadline_unix_s
        ep = eng.planner.materialize(plan, ctx)
        rec = AnalyzeRecorder()
        # a plain attribute, not a dataclass field
        ctx.analyze = rec
        sched = self._sched
        adm = None
        res = None
        if sched is not None:
            adm = sched.admit(
                tenant[0],
                remaining_budget(planner_params, self._ask_timeout_s),
                ent.token if ent is not None else None,
                deadline_unix_s=planner_params.deadline_unix_s)
            if adm.status == "shed":
                res = self._shed_result(tenant[0], adm)
                active_queries.deregister(ent, verdict_of(res))
                return res, None, None
        try:
            if ent is not None:
                ent.set_phase("executing")
            res = ep.execute(eng.source)
        finally:
            if adm is not None and adm.acquired:
                sched.release(tenant[0])
            active_queries.deregister(ent, verdict_of(res))
        res.trace_id = ctx.query_id
        account_wait(res, adm)
        dur = _time.perf_counter() - t0
        if self._usage_enabled:
            usage.record_query(tenant[0], tenant[1], dur,
                               res.stats.samples_scanned,
                               res.stats.result_bytes)
        slowlog.maybe_record(promql, start_s, step_s, end_s, dur, res,
                             tenant=tenant, origin="explain_analyze",
                             threshold_s=self._slow_s)
        return res, rec, ep

    # ----------------------------------------------------------- layers

    def _cached_query(self, promql, start_s, step_s, end_s, pp):
        cache = self.cache
        if cache is None or not self._promql_cacheable(promql):
            return self._run(promql, start_s, step_s, end_s, pp)

        def run(s0, e0):
            return self._run(promql, s0, step_s, e0, pp)

        return cache.query_range(run, promql, start_s, step_s, end_s,
                                 repr(pp), self._state())

    def _admit_params(self, pp):
        """Copy of the caller's PlannerParams with the end-to-end
        deadline stamped (None → server defaults).  The request's
        timeout_s is CAPPED by query.default_timeout_s; the returned
        copy keys identically to the input (deadline is repr-excluded),
        so singleflight/coalescer/result-cache keys are unaffected."""
        import dataclasses as _dc

        from filodb_tpu_torch.query.rangevector import compute_deadline
        if pp is None:
            pp = PlannerParams(
                allow_partial_results=self._allow_partial_default)
        deadline = compute_deadline(pp, self._default_timeout_s)
        if deadline == pp.deadline_unix_s:
            return pp
        return _dc.replace(pp, deadline_unix_s=deadline)

    def _run(self, promql, start_s, step_s, end_s, pp):
        """The registration boundary (query/activequeries.py): the
        pending marker set at admission becomes a live ActiveQuery HERE
        — the moment the request is about to consume real resources
        (scheduler slot, engine, device).  The entry's id becomes
        ctx.query_id (= the trace id) via the thread-local handoff the
        engine adopts in _ctx; deregistration (with the final verdict)
        happens when execution returns, canceled-in-queue included."""
        from filodb_tpu_torch.query.activequeries import (active_queries,
                                                    set_admission,
                                                    take_admission,
                                                    take_pending,
                                                    verdict_of)
        info = take_pending()
        ws = info[0][0] if info is not None else ""
        ent = None
        if info is not None:
            from filodb_tpu_torch.utils.metrics import mint_trace_id
            ent = active_queries.register(mint_trace_id(), promql=promql,
                                          tenant=info[0], origin=info[1])
        if ent is None:
            return self._run_scheduled(promql, start_s, step_s, end_s,
                                       pp, None, ws)
        set_admission(ent)
        res = None
        try:
            res = self._run_scheduled(promql, start_s, step_s, end_s,
                                      pp, ent, ws)
            return res
        finally:
            take_admission()         # clear if the engine never adopted
            active_queries.deregister(ent, verdict_of(res))

    def _shed_result(self, ws: str, adm) -> QueryResult:
        """One home for the shed surface: the structured
        tenant_overloaded result (Retry-After riding along for the HTTP
        edge), the queries_shed{ws,reason} counter, and the queue-wait
        attribution every outcome gets.  The counter tags the
        scheduler's FOLDED ws (adm.ws), never the raw client-controlled
        one — hostile ws churn must not grow metric cardinality."""
        from filodb_tpu_torch.utils.metrics import registry
        registry.counter("queries_shed", ws=adm.ws or ws,
                         reason=adm.reason).increment()
        res = QueryResult([], error=adm.shed_error())
        res.retry_after_s = adm.retry_after_s
        account_wait(res, adm)
        return res

    def _run_scheduled(self, promql, start_s, step_s, end_s, pp, ent,
                       ws=""):
        sched = self._sched
        tok = ent.token if ent is not None else None
        if sched is None:
            return self.coalescer.query_range(promql, start_s, step_s,
                                              end_s, pp)
        # weighted-fair admission: the tenant's queue, the tenant's
        # share.  Shedding happens HERE, before any wait — a query whose
        # predicted queue wait would blow its deadline (or whose tenant
        # queue is full) 429s immediately instead of burning a slot
        # until query_timeout.  Past that gate the pre-QoS stances hold:
        # never fail a query on queue pressure alone (a scheduler-wait
        # timeout runs unthrottled, observable via the counter), but the
        # DEADLINE does bound the wait — time queued spends from the
        # same end-to-end budget as execution.
        dl = getattr(pp, "deadline_unix_s", 0.0) if pp is not None else 0.0
        timeout = remaining_budget(pp, self._ask_timeout_s)
        adm = sched.admit(ws, timeout, tok, deadline_unix_s=dl)
        if adm.status == "shed":
            return self._shed_result(ws, adm)
        try:
            if adm.status == "cancelled" or (tok is not None
                                             and tok.cancelled):
                # killed while queued: the structured error, with the
                # slot either never held (kill interrupted the wait) or
                # released by the finally below before anyone noticed
                res = _canceled_result(tok, "in the scheduler queue")
                account_wait(res, adm)
                return res
            if dl and _time.time() >= dl:
                from filodb_tpu_torch.utils.metrics import registry
                registry.counter("query_timeouts_in_queue").increment()
                res = QueryResult(
                    [], error=("query_timeout: deadline exceeded after "
                               f"{adm.waited_s:.3f}s in the scheduler "
                               "queue"))
                account_wait(res, adm)
                return res
            if not adm.acquired:
                from filodb_tpu_torch.utils.metrics import registry
                registry.counter("query_scheduler_timeouts").increment()
            res = self.coalescer.query_range(promql, start_s, step_s,
                                             end_s, pp)
            # queue attribution: scheduler wait is part of the query's
            # serving cost but not of any exec node's cpu time
            account_wait(res, adm)
            return res
        finally:
            if adm.acquired:
                sched.release(ws)

    def _promql_cacheable(self, promql: str) -> bool:
        ok = self._cacheable.get(promql)
        if ok is None:
            ok = _plan_cacheable(promql)
            if len(self._cacheable) > 1024:
                self._cacheable.clear()
            self._cacheable[promql] = ok
        return ok

    # ------------------------------------------------------ store state

    def _state(self) -> Optional[Tuple[Tuple, int]]:
        """(series-set token, append horizon ms) across the engine's local
        shards, or None when the source can't vouch for them (remote /
        unknown sources bypass the cache).  A federated planner folds its
        registry's state — the participating clusters, their health
        transitions and their doors' data tokens — into the token, so a
        remote cluster dying, recovering or ingesting invalidates cached
        federated answers exactly like local ingest does."""
        source = getattr(self.engine, "source", None)
        shards_for = getattr(source, "shards_for", None)
        if shards_for is None:
            return None
        try:
            shards = shards_for(self.engine.dataset)
        except Exception:  # noqa: BLE001 — exotic sources: just bypass
            return None
        if not shards:
            return None
        token = []
        horizon = None
        for sh in shards:
            token.append((sh.keys_serial, sh.keys_epoch,
                          sh.index.mutations))
            h = sh.append_horizon_ms()
            horizon = h if horizon is None else min(horizon, h)
        if horizon is None or horizon <= NO_HORIZON_MS:
            return None
        fed_fn = getattr(self.engine.planner, "federation_state", None)
        if fed_fn is not None:
            try:
                return (tuple(token), ("federation",) + fed_fn()), horizon
            except Exception:  # noqa: BLE001 — registry trouble: bypass
                return None
        return tuple(token), horizon
