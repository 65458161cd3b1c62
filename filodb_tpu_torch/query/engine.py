"""QueryEngine — parse -> plan -> execute facade (port of
filodb_tpu/query/engine.py: query_range, query_instant, query_range_batch,
exec_logical_plan with the metadata plans and whole-expression
compilation (query/exprfuse.py), and the Prometheus matrix and vector
models).  Each query's context carries the frontend's admission entry
(its id and cancellation token) and the end-to-end deadline.

With remote dispatchers (parallel/transport), a query whose shard owner
died (`shard_unavailable`) re-plans through `replan_hook` up to
`query.dispatch_retries` times, and past the retries degrades to a
flagged partial result when the caller allows partial results.

Takes ``device=`` (default ``"cuda"``) and raises without a card unless
given ``device="cpu"``; the source memstore must live on the same device.
"""
from __future__ import annotations

import math
import time as _time
import uuid
from typing import Dict, List, Optional

import numpy as np

from filodb_tpu_torch.parallel.shardmapper import (ShardEvent, ShardMapper,
                                                   SpreadProvider)
from filodb_tpu_torch.promql.parser import (TimeStepParams,
                                            query_range_to_logical_plan)
from filodb_tpu_torch.query import logical as lp
from filodb_tpu_torch.query.execbase import QueryError
from filodb_tpu_torch.query.planner import SingleClusterPlanner
from filodb_tpu_torch.query.rangevector import (PlannerParams, QueryContext,
                                                QueryResult, compute_deadline,
                                                host_values)
from filodb_tpu_torch.utils.device import resolve_device


class QueryEngine:

    def __init__(self, dataset: str, source,
                 shard_mapper: Optional[ShardMapper] = None,
                 spread_provider: Optional[SpreadProvider] = None,
                 planner: Optional[SingleClusterPlanner] = None,
                 device="cuda", mirror_background_rebuild: bool = True,
                 config=None, replan_hook=None):
        """mirror_background_rebuild: after an eviction or a page-in
        rearranged a store's cells, rebuild its device mirror on a
        background thread and serve meanwhile from the host gather (the
        reference's default), or, with False, re-upload it inline.
        config: a FilodbSettings (None reads the settings() singleton at
        each query, so a bare engine tracks changes to it).
        replan_hook: () -> a planner over a FRESH shard-map snapshot.
        When a scatter-gather fails shard_unavailable (an owner died
        mid-query), the engine re-plans through it up to
        query.dispatch_retries times, so after failover the new plan
        dispatches to the reassigned owner."""
        self.device = resolve_device(device)
        self.config = config
        from filodb_tpu_torch.config import apply_torch_runtime, settings
        apply_torch_runtime(config or settings())
        self.mirror_background_rebuild = mirror_background_rebuild
        src_dev = getattr(source, "device", None)
        if src_dev is not None and src_dev != self.device:
            raise ValueError(f"engine device {self.device} differs from its "
                             f"source's device {src_dev}")
        self.dataset = dataset
        self.source = source
        self.shard_mapper = shard_mapper or _single_shard_mapper()
        self.planner = planner or SingleClusterPlanner(
            dataset, self.shard_mapper, spread_provider)
        self.replan_hook = replan_hook

    def _ctx(self, planner_params: Optional[PlannerParams]) -> QueryContext:
        from filodb_tpu_torch.query.activequeries import take_admission
        q = self._qconfig()
        if planner_params is None:
            # bare-engine callers inherit the server's partial-results
            # stance; explicit PlannerParams always win
            planner_params = PlannerParams(
                allow_partial_results=q.allow_partial_results)
        # a frontend-admitted query carries its ActiveQuery entry across
        # the layer gap on a thread-local: the context adopts its id (the
        # registry key, the trace id and ctx.query_id are one identifier)
        # and its CancellationToken
        ent = take_admission()
        qid = ent.query_id if ent is not None else str(uuid.uuid4())
        # the end-to-end deadline: the frontend stamps deadline_unix_s at
        # admission (queue wait counts); otherwise the budget starts now
        ctx = QueryContext(query_id=qid,
                           submit_time_ms=int(_time.time() * 1000),
                           planner_params=planner_params,
                           deadline_unix_s=compute_deadline(
                               planner_params, q.default_timeout_s),
                           device=self.device,
                           mirror_background_rebuild=(
                               self.mirror_background_rebuild))
        if ent is not None:
            # plain attributes, not dataclass fields
            ctx.cancel = ent.token
            ctx.active = ent
            ctx.tenant_ws = ent.tenant_ws
        return ctx

    def _qconfig(self):
        if self.config is not None:
            return self.config.query
        from filodb_tpu_torch.config import settings
        return settings().query

    def query_range(self, promql: str, start_s: int, step_s: int, end_s: int,
                    planner_params: Optional[PlannerParams] = None
                    ) -> QueryResult:
        """Range query.  Errors come back in the result."""
        from filodb_tpu_torch.query.activequeries import peek_admission
        from filodb_tpu_torch.utils.metrics import span
        ent = peek_admission()
        if ent is not None:
            ent.set_phase("parsing")
        t_parse0 = _time.perf_counter()
        try:
            with span("query_parse"):
                plan = query_range_to_logical_plan(
                    promql, TimeStepParams(start_s, step_s, end_s))
        except Exception as e:  # noqa: BLE001 — parse errors surface in result
            return QueryResult([], error=f"parse error: {e}")
        parse_t = _time.perf_counter() - t_parse0
        res = self.exec_logical_plan(plan, planner_params)
        res.stats.parse_s += parse_t
        return res

    def query_instant(self, promql: str, time_s: int,
                      planner_params: Optional[PlannerParams] = None
                      ) -> QueryResult:
        """Instant query: a range query of one step at time_s (what rule
        evaluation runs)."""
        return self.query_range(promql, time_s, 1, time_s, planner_params)

    def query_range_batch(self, promqls: List[str], start_s: int,
                          step_s: int, end_s: int,
                          planner_params: Optional[PlannerParams] = None
                          ) -> List[QueryResult]:
        """Evaluate a dashboard's worth of queries over one time grid,
        merging compatible fused leaves into single kernel launches.

        Three phases: (1) every MultiSchemaPartitionsExec leaf of every
        tree runs its gather and fused preflight (prepare_fused) under
        one gather memo scope, parking what it gathered; (2) the
        compatible FusedCalls merge in fusedbatch.finish_fused_calls (one
        group-mode launch per working set, window grid and function,
        killed queries filtered out first); (3) each tree executes, its
        leaves reusing the parked data and the injected partials.  A
        query that does not fit (a parse error, a metadata plan, a leaf
        the fused path does not take) takes its normal path.
        """
        from filodb_tpu_torch.ops import hostleaf
        from filodb_tpu_torch.query import exprfuse
        from filodb_tpu_torch.query.activequeries import (set_admission,
                                                          take_admission)
        # the coalesce leader's admission entry binds to ITS query, not
        # to whichever batch member mints a context first (a kill of the
        # leader's id must not cancel another client's query)
        adm = take_admission()
        results: List[Optional[QueryResult]] = [None] * len(promqls)
        entries = []
        for i, q in enumerate(promqls):
            mine = adm is not None and q == adm.promql
            if mine:
                set_admission(adm)
                adm = None
            t0 = _time.perf_counter()
            try:
                plan = query_range_to_logical_plan(
                    q, TimeStepParams(start_s, step_s, end_s))
            except Exception as e:  # noqa: BLE001
                results[i] = QueryResult([], error=f"parse error: {e}")
                if mine:
                    take_admission()     # never leak to the next query
                continue
            parse_t = _time.perf_counter() - t0
            if isinstance(plan, lp.MetadataQueryPlan):
                results[i] = self.exec_logical_plan(plan, planner_params)
                results[i].stats.parse_s += parse_t
                continue
            ctx = self._ctx(planner_params)
            t0 = _time.perf_counter()
            try:
                ep = self.planner.materialize(plan, ctx)
            except QueryError:
                raise
            except Exception as e:  # noqa: BLE001
                results[i] = QueryResult([], error=f"planning error: {e}")
                continue
            entries.append((i, ep, ctx, plan, parse_t,
                            _time.perf_counter() - t0))
        calls = []
        comps = {}
        if self._qconfig().exprfuse_enabled:
            with hostleaf.batch_gather_memo():
                for i, ep, _, _, _, _ in entries:
                    comp = exprfuse.compile_tree(ep, self.source)
                    if comp is not None:
                        comps[i] = comp
                        calls.extend(comp.calls)
            exprfuse.finish_prepared(calls)
        for i, ep, ctx, plan, parse_t, plan_t in entries:
            res = ep.execute(self.source)
            res.trace_id = ctx.query_id
            if res.error and res.error.startswith("shard_unavailable") \
                    and (self.replan_hook is not None
                         or ctx.planner_params.allow_partial_results):
                # failover retry (and, past the retries, the partial-
                # result degrade) for the batch path too: the retried
                # query re-plans through exec_logical_plan (it loses this
                # batch's fusion, which is moot — its shard owner died)
                res = self.exec_logical_plan(plan, planner_params)
            res.stats.parse_s += parse_t
            res.stats.plan_s += plan_t
            comp = comps.get(i)
            if comp is not None:
                res.stats.exprfuse_fused += comp.fused
                res.stats.exprfuse_degraded += comp.degraded
            results[i] = res
        return results

    def exec_logical_plan(self, plan: lp.LogicalPlan,
                          planner_params: Optional[PlannerParams] = None
                          ) -> QueryResult:
        """Plan and run a logical plan.  A metadata plan's answer comes
        back in the result's `data`: a list of label names, a dict of
        label -> values, or a list of series label dicts.  A tree of two
        or more leaves batches their fused preflights into one merged
        launch (exprfuse, min_leaves=2); a single leaf keeps its
        standalone path."""
        from filodb_tpu_torch.utils.metrics import span
        ctx = self._ctx(planner_params)
        ent = getattr(ctx, "active", None)
        if ent is not None:
            ent.set_phase("planning")
        t_plan0 = _time.perf_counter()
        try:
            with span("query_plan"):
                ep = self.planner.materialize(plan, ctx)
        except QueryError:
            raise
        except Exception as e:  # noqa: BLE001
            return QueryResult([], error=f"planning error: {e}")
        plan_t = _time.perf_counter() - t_plan0
        if ent is not None:
            ent.set_phase("executing")
        if isinstance(plan, lp.MetadataQueryPlan):
            try:
                try:
                    data, stats = ep.execute_internal(self.source)
                except QueryError as e:
                    if e.code != "shard_unavailable" or \
                            not ctx.planner_params.allow_partial_results:
                        raise
                    # metadata scatters degrade like data queries: a
                    # shard that stays down is dropped and the merged
                    # result flagged partial
                    try:
                        ep = self._engage_partial_replan(plan, ctx)
                    except QueryError:
                        raise
                    except Exception as e2:  # noqa: BLE001
                        return QueryResult([], error=f"replan error: {e2}")
                    data, stats = ep.execute_internal(self.source)
            except QueryError as e:
                return QueryResult([], error=str(e))
            stats.plan_s += plan_t
            if isinstance(data, QueryResult):
                if data.partial:
                    from filodb_tpu_torch.utils.metrics import registry
                    registry.counter("query_partial_results").increment()
                return data
            return QueryResult([], stats)
        comp = None
        if self._qconfig().exprfuse_enabled:
            from filodb_tpu_torch.query import exprfuse
            comp = exprfuse.compile_tree(ep, self.source, min_leaves=2)
            if comp is not None:
                exprfuse.finish_prepared(comp.calls)
        res = ep.execute(self.source)
        if comp is not None:
            res.stats.exprfuse_fused += comp.fused
            res.stats.exprfuse_degraded += comp.degraded
        res.stats.plan_s += plan_t
        res.trace_id = ctx.query_id
        if res.error and res.error.startswith("shard_unavailable") \
                and self.replan_hook is not None:
            from filodb_tpu_torch.utils.metrics import registry
            for _ in range(max(self._qconfig().dispatch_retries, 0)):
                # a shard owner died mid-query: re-plan against a fresh
                # shard-map snapshot and retry on the reassigned owner
                # (only shard_unavailable — dispatch_timeout is never
                # retried, the remote may still be executing)
                registry.counter("query_replan_retries").increment()
                try:
                    self.planner = self.replan_hook()
                    ep = self.planner.materialize(plan, ctx)
                except Exception as e:  # noqa: BLE001
                    return QueryResult([], error=f"replan error: {e}")
                res = ep.execute(self.source)
                res.trace_id = ctx.query_id
                if not (res.error
                        and res.error.startswith("shard_unavailable")):
                    break
        if res.error and res.error.startswith("shard_unavailable") \
                and ctx.planner_params.allow_partial_results:
            try:
                ep = self._engage_partial_replan(plan, ctx)
            except Exception as e:  # noqa: BLE001
                return QueryResult([], error=f"replan error: {e}")
            res = ep.execute(self.source)
            res.trace_id = ctx.query_id
        return res

    def _engage_partial_replan(self, plan: lp.LogicalPlan, ctx):
        """The shard STAYED unavailable after the re-plan retries and
        partials are allowed: degrade instead of fail — engage the
        scatter-gather drop (partial_now) and re-materialize; with the
        peer's breaker now open the next pass fails fast per dropped
        child and the survivors merge into a FLAGGED partial result.
        The dataclasses copy keeps the caller's PlannerParams
        unmutated."""
        import dataclasses as _dc

        from filodb_tpu_torch.utils.metrics import registry
        registry.counter("query_partial_engaged").increment()
        ctx.planner_params = _dc.replace(ctx.planner_params,
                                         partial_now=True)
        return self.planner.materialize(plan, ctx)

    @staticmethod
    def to_prom_matrix(result: QueryResult) -> Dict:
        """Prometheus matrix envelope for a range-query result."""
        err = _prom_error_payload(result)
        if err is not None:
            return err
        out = []
        for b in result.blocks:
            vals = host_values(b.values)
            if vals.ndim != 2:
                continue
            secs = (np.asarray(b.wends, np.int64) / 1000.0).tolist()
            present = ~np.isnan(vals)
            for i, key in enumerate(b.keys):
                idx = np.flatnonzero(present[i]).tolist()
                if not idx:
                    continue
                row = vals[i]
                out.append({"metric": _prom_labels(key.labels_dict),
                            "values": [[secs[j], _fmt(row[j])]
                                       for j in idx]})
        payload = {"status": "success",
                   "data": {"resultType": "matrix", "result": out}}
        return _attach_partial_fields(payload, result.partial,
                                      result.stats.warnings)

    @staticmethod
    def to_prom_vector(result: QueryResult) -> Dict:
        """Prometheus vector envelope: the last step of each series."""
        err = _prom_error_payload(result)
        if err is not None:
            return err
        out = []
        for key, wends, vals in result.series():
            if vals.ndim == 2 or len(vals) == 0:
                continue
            v = vals[-1]
            if not math.isnan(v):
                out.append({"metric": _prom_labels(key.labels_dict),
                            "value": [int(wends[-1]) / 1000.0, _fmt(v)]})
        payload = {"status": "success",
                   "data": {"resultType": "vector", "result": out}}
        return _attach_partial_fields(payload, result.partial,
                                      result.stats.warnings)


def _walk_plan(ep):
    """Yield every node of an exec tree (pre-order)."""
    yield ep
    for c in ep.children:
        yield from _walk_plan(c)


def _prom_error_payload(result: QueryResult) -> Optional[Dict]:
    """Error half of the Prometheus envelope, or None for success: one
    home for the errorType taxonomy (a deadline expiry is "timeout", a
    kill "canceled", a throttle "too_many_requests"), shared by the
    matrix and vector serializers and the metadata routes."""
    if not result.error:
        return None
    if result.error.startswith("query_timeout"):
        etype = "timeout"
    elif result.error.startswith("query_canceled"):
        etype = "canceled"
    elif result.error.startswith(("tenant_overloaded",
                                  "tenant_limit_exceeded")):
        etype = "too_many_requests"
    else:
        etype = "query_error"
    return {"status": "error", "errorType": etype, "error": result.error}


def _attach_partial_fields(payload: Dict, partial: bool,
                           warnings: List[str]) -> Dict:
    """Degradation fields of the envelope: the warnings list, and
    "partial": true for a partial result (never silent)."""
    if partial or warnings:
        payload["warnings"] = (
            list(warnings)
            or ["partial results: one or more shards were unreachable"])
    if partial:
        payload["partial"] = True
    return payload


def _prom_labels(labels: Dict[str, str]) -> Dict[str, str]:
    out = dict(labels)
    metric = out.pop("_metric_", None)
    if metric:
        out["__name__"] = metric
    return out


def _fmt(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return f"{v:.17g}" if v == v else "NaN"


def _single_shard_mapper() -> ShardMapper:
    m = ShardMapper(1)
    m.update_from_event(ShardEvent("IngestionStarted", "", 0, "local"))
    return m
