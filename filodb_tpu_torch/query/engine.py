"""QueryEngine — parse -> plan -> execute facade (port of
filodb_tpu/query/engine.py: query_range, query_instant,
exec_logical_plan with the metadata plans, and the Prometheus matrix and
vector models).  Not ported yet: query_range_batch and the
whole-expression compiler.

Takes ``device=`` (default ``"cuda"``) and raises without a card unless
given ``device="cpu"``; the source memstore must live on the same device.
"""
from __future__ import annotations

import math
import time as _time
import uuid
from typing import Dict, Optional

import numpy as np

from filodb_tpu_torch.parallel.shardmapper import (ShardEvent, ShardMapper,
                                                   SpreadProvider)
from filodb_tpu_torch.promql.parser import (TimeStepParams,
                                            query_range_to_logical_plan)
from filodb_tpu_torch.query import logical as lp
from filodb_tpu_torch.query.execbase import QueryError
from filodb_tpu_torch.query.planner import SingleClusterPlanner
from filodb_tpu_torch.query.rangevector import (PlannerParams, QueryContext,
                                                QueryResult, host_values)
from filodb_tpu_torch.utils.device import resolve_device


class QueryEngine:

    def __init__(self, dataset: str, source,
                 shard_mapper: Optional[ShardMapper] = None,
                 spread_provider: Optional[SpreadProvider] = None,
                 planner: Optional[SingleClusterPlanner] = None,
                 device="cuda", mirror_background_rebuild: bool = True):
        """mirror_background_rebuild: after an eviction or a page-in
        rearranged a store's cells, rebuild its device mirror on a
        background thread and serve meanwhile from the host gather (the
        reference's default), or, with False, re-upload it inline."""
        self.device = resolve_device(device)
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

    def _ctx(self, planner_params: Optional[PlannerParams]) -> QueryContext:
        return QueryContext(query_id=str(uuid.uuid4()),
                            submit_time_ms=int(_time.time() * 1000),
                            planner_params=planner_params or PlannerParams(),
                            device=self.device,
                            mirror_background_rebuild=(
                                self.mirror_background_rebuild))

    def query_range(self, promql: str, start_s: int, step_s: int, end_s: int,
                    planner_params: Optional[PlannerParams] = None
                    ) -> QueryResult:
        """Range query.  Errors come back in the result, except a query
        outside the port's slice, which raises QueryError("not_ported")."""
        t_parse0 = _time.perf_counter()
        try:
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

    def exec_logical_plan(self, plan: lp.LogicalPlan,
                          planner_params: Optional[PlannerParams] = None
                          ) -> QueryResult:
        """Plan and run a logical plan.  A metadata plan's answer comes
        back in the result's `data`: a list of label names, a dict of
        label -> values, or a list of series label dicts."""
        ctx = self._ctx(planner_params)
        t_plan0 = _time.perf_counter()
        try:
            ep = self.planner.materialize(plan, ctx)
        except QueryError:
            raise
        except Exception as e:  # noqa: BLE001
            return QueryResult([], error=f"planning error: {e}")
        plan_t = _time.perf_counter() - t_plan0
        if isinstance(plan, lp.MetadataQueryPlan):
            try:
                data, stats = ep.execute_internal(self.source)
            except QueryError as e:
                if e.code == "not_ported":
                    raise
                return QueryResult([], error=str(e))
            stats.plan_s += plan_t
            if isinstance(data, QueryResult):
                return data
            return QueryResult([], stats)
        res = ep.execute(self.source)
        res.stats.plan_s += plan_t
        res.trace_id = ctx.query_id
        return res

    @staticmethod
    def to_prom_matrix(result: QueryResult) -> Dict:
        """Prometheus matrix envelope for a range-query result."""
        if result.error:
            return {"status": "error", "errorType": "query_error",
                    "error": result.error}
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
        return {"status": "success",
                "data": {"resultType": "matrix", "result": out}}

    @staticmethod
    def to_prom_vector(result: QueryResult) -> Dict:
        """Prometheus vector envelope: the last step of each series."""
        if result.error:
            return {"status": "error", "errorType": "query_error",
                    "error": result.error}
        out = []
        for key, wends, vals in result.series():
            if vals.ndim == 2 or len(vals) == 0:
                continue
            v = vals[-1]
            if not math.isnan(v):
                out.append({"metric": _prom_labels(key.labels_dict),
                            "value": [int(wends[-1]) / 1000.0, _fmt(v)]})
        return {"status": "success",
                "data": {"resultType": "vector", "result": out}}


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
