"""Explain and explain-analyze in the port (ExecPlan.print_tree and
args_str on every node and transformer, AnalyzeRecorder,
QueryFrontend.analyze_range, the explain routes of http/routes.py)
against the JAX package over the same two-shard store.

The store: counters `http_requests` (job, instance, group), gauges `m`
(i) and `x` (job, g), and a classic histogram `req_bucket` (job, le), 121
samples at 30 s from t=0, values from numpy seed 11, series i on shard
i % 2.  For every eval of the PromQL corpus (tests/promql_corpus, read
as tests/test_torch_corpus.py reads it), at the eval's own time:

- the port's plan tree, line for line, is the reference's;
- `explain=true` on query_range and query and GET /api/v1/explain answer
  the reference's payload to the string;
- `analyze=true` executes the plan: the same nodes in the same order,
  with the same samples and series counts (times are not compared).

Explain materializes the plan only: no kernel, no mirror.
"""
import json
import os

import numpy as np
import pytest

from filodb_tpu.core.memstore import TimeSeriesMemStore as JaxMemStore
from filodb_tpu.core.partkey import PartKey as JaxPartKey
from filodb_tpu.http.routes import PromHttpApi as JaxApi
from filodb_tpu.parallel.shardmapper import ShardEvent as JaxShardEvent
from filodb_tpu.parallel.shardmapper import ShardMapper as JaxShardMapper
from filodb_tpu.promql.parser import TimeStepParams as JaxTimeStepParams
from filodb_tpu.promql.parser import \
    query_range_to_logical_plan as jax_logical_plan
from filodb_tpu.query.engine import QueryEngine as JaxEngine
from filodb_tpu.query.rangevector import QueryContext as JaxQueryContext
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.http.routes import PromHttpApi
from filodb_tpu_torch.parallel.shardmapper import ShardEvent, ShardMapper
from filodb_tpu_torch.promql.parser import (TimeStepParams,
                                            query_range_to_logical_plan)
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.query.rangevector import QueryContext
from filodb_tpu_torch.utils.counters import counters

from test_promql_corpus import CORPUS_DIR, _corpus_files, parse_corpus

SEED = 11
STEP_MS = 30_000
T = 121
SHARDS = 2
LES = ["0.1", "0.5", "1", "+Inf"]


@pytest.fixture(autouse=True, scope="module")
def _clear_compile_journal():
    """The JAX engine's queries journal jit compiles under their trace
    ids, which the reference's health model reads as a compile storm in
    the next test file this process runs; clear the journal after."""
    yield
    from filodb_tpu.utils.events import journal
    journal.clear()


def _series(seed=SEED):
    """[(schema, column, metric, labels, values [T])]: the store's
    series, values from one numpy generator."""
    rng = np.random.default_rng(seed)
    out = []
    for job in ("api-server", "app-server"):
        for inst in range(4):
            for group in ("production", "canary"):
                v = np.cumsum(rng.uniform(0, 10, T))
                v[T // 2:] -= v[T // 2]           # one counter reset
                out.append(("prom-counter", "count", "http_requests",
                            {"job": job, "instance": str(inst),
                             "group": group}, v))
    for i in range(6):
        out.append(("gauge", "value", "m", {"i": str(i)},
                    rng.normal(100.0, 20.0, T)))
    for job in ("a", "b"):
        for g in ("p", "c"):
            out.append(("gauge", "value", "x", {"job": job, "g": g},
                        rng.uniform(-5, 5, T)))
    for job in ("a", "b"):
        slopes = np.sort(rng.uniform(0.5, 3.0, len(LES)))
        for le, slope in zip(LES, slopes):
            out.append(("prom-counter", "count", "req_bucket",
                        {"job": job, "le": le},
                        slope * np.arange(T, dtype=np.float64)))
    return out


def build_stores(seed=SEED, shards=SHARDS):
    """(JAX engine, port engine on the CPU) over the same series."""
    jms = JaxMemStore()
    pms = TimeSeriesMemStore(device="cpu")
    jmap, pmap = JaxShardMapper(shards), ShardMapper(shards)
    for s in range(shards):
        jms.setup("prometheus", s)
        pms.setup("prometheus", s)
        jmap.update_from_event(
            JaxShardEvent("IngestionStarted", "prometheus", s, "local"))
        pmap.update_from_event(
            ShardEvent("IngestionStarted", "prometheus", s, "local"))
    ts = np.arange(T, dtype=np.int64) * STEP_MS
    groups = {}
    for i, (schema, col, metric, labels, vals) in enumerate(_series(seed)):
        groups.setdefault((i % shards, schema, col), []).append(
            (metric, labels, vals))
    for (s, schema, col), rows in sorted(groups.items()):
        vals = np.stack([r[2] for r in rows])
        tss = np.broadcast_to(ts, vals.shape).copy()
        jms.get_shard("prometheus", s).ingest_columns(
            schema, [JaxPartKey.make(m, lb) for m, lb, _ in rows], tss,
            {col: vals})
        pms.get_shard("prometheus", s).ingest_columns(
            schema, [PartKey.make(m, lb) for m, lb, _ in rows], tss,
            {col: vals})
    return (JaxEngine("prometheus", jms, jmap),
            QueryEngine("prometheus", pms, pmap, device="cpu"))


@pytest.fixture(scope="module")
def engines():
    return build_stores()


@pytest.fixture(scope="module")
def apis(engines):
    jeng, eng = engines
    return JaxApi({"prometheus": jeng}), PromHttpApi({"prometheus": eng})


def _cases(fname):
    _, _, cases = parse_corpus(os.path.join(CORPUS_DIR, fname))
    return cases


def _grid(case):
    at = int(case.at_s)
    return at, 60, at


@pytest.mark.parametrize("fname", _corpus_files())
def test_plan_tree_matches_reference(engines, fname):
    jeng, eng = engines
    for case in _cases(fname):
        s, step, e = _grid(case)
        want = jeng.planner.materialize(
            jax_logical_plan(case.expr, JaxTimeStepParams(s, step, e)),
            JaxQueryContext()).print_tree().splitlines()
        got = eng.planner.materialize(
            query_range_to_logical_plan(case.expr,
                                        TimeStepParams(s, step, e)),
            QueryContext()).print_tree().splitlines()
        assert got == want, (case.line_no, case.expr)


def _both(apis, path, params):
    (jst, jp), (st, p) = [api.handle("GET", path, dict(params))
                          for api in apis]
    return (st, p), (jst, jp)


@pytest.mark.parametrize("fname", _corpus_files())
def test_explain_routes_match_reference(apis, engines, fname):
    """explain=true on query_range and query, and /api/v1/explain: the
    reference's status and payload to the string; nothing executes."""
    kernel0 = counters.get("leaf_fused_kernel")
    mirrors0 = _mirrors(engines[1])
    for case in _cases(fname):
        s, step, e = _grid(case)
        for path, params in (
                ("/api/v1/query_range", {"query": case.expr, "start": s,
                                         "end": e, "step": step,
                                         "explain": "true"}),
                ("/api/v1/query", {"query": case.expr, "time": e,
                                   "explain": "true"}),
                ("/api/v1/explain", {"query": case.expr, "start": s,
                                     "end": e, "step": step})):
            params = {k: str(v) for k, v in params.items()}
            (st, p), (jst, jp) = _both(apis, path, params)
            assert st == jst == 200, (case.line_no, path, p)
            assert json.dumps(p, sort_keys=True) == \
                json.dumps(jp, sort_keys=True), (case.line_no, path)
            assert p["data"]["resultType"] == "execPlan"
    # explain ran nothing: no kernel, no mirror built or refreshed
    assert counters.get("leaf_fused_kernel") == kernel0
    assert _mirrors(engines[1]) == mirrors0


def _mirrors(eng):
    """(mirror serial, snapshot generation) of every store's mirror."""
    out = []
    for sh in eng.source.shards_for("prometheus"):
        for st in sh.stores.values():
            m = getattr(st, "device_mirror", None)
            snap = m.snapshot() if m is not None else None
            out.append(None if m is None else
                       (m.serial, snap.gen if snap is not None else -1))
    return out


def _strip(line: str):
    """A tree line without its times and bytes: (text, samples,
    series)."""
    text, _, annot = line.partition("  [")
    if not annot:
        return text, None, None
    fields = dict(kv.split("=") for kv in annot.split("]")[0].split())
    return text, int(fields["samples"]), int(fields["series"])


@pytest.mark.parametrize("fname", _corpus_files())
def test_analyze_matches_reference(apis, fname):
    """analyze=true: the reference's status; on success the same tree,
    the same nodes in the same order with the same samples and series
    counts, and the root's stats counts."""
    for case in _cases(fname):
        s, step, e = _grid(case)
        params = {"query": case.expr, "start": str(s), "end": str(e),
                  "step": str(step), "analyze": "true"}
        (st, p), (jst, jp) = _both(apis, "/api/v1/explain", params)
        assert st == jst, (case.line_no, case.expr, p, jp)
        if st != 200:
            continue
        d, jd = p["data"], jp["data"]
        assert d["resultType"] == jd["resultType"] == "execPlanAnalysis"
        assert [_strip(x) for x in d["result"]] == \
            [_strip(x) for x in jd["result"]], (case.line_no, case.expr)
        key = ("plan", "samples_scanned", "series_scanned",
               "shards_queried")
        assert [tuple(n[k] for k in key) for n in d["nodes"]] == \
            [tuple(n[k] for k in key) for n in jd["nodes"]], case.expr
        for k in ("samplesScanned", "seriesScanned", "shardsQueried",
                  "resultSamples"):
            assert d["stats"][k] == jd["stats"][k], (case.expr, k)


def test_explain_of_a_bad_query_is_the_reference_400(apis):
    for path, params in (
            ("/api/v1/query_range", {"query": "sum(", "start": "0",
                                     "end": "60", "explain": "true"}),
            ("/api/v1/explain", {"query": "sum(", "start": "0",
                                 "end": "60"})):
        (st, p), (jst, jp) = _both(apis, path, params)
        assert st == jst == 400 and p["errorType"] == jp["errorType"]


def test_explain_tree_names_the_reference_multi_shard_concat(engines):
    """A selector over both shards: the port's root is the reference's
    LocalPartitionDistConcatExec, one MultiSchemaPartitionsExec a shard
    with the PeriodicSamplesMapper pushed down."""
    _, eng = engines
    ep = eng.planner.materialize(
        query_range_to_logical_plan('http_requests{job="api-server"}',
                                    TimeStepParams(600, 60, 1200)),
        QueryContext())
    lines = ep.print_tree().splitlines()
    assert lines[0] == "-E~LocalPartitionDistConcatExec()"
    assert [ln.split("(")[0] for ln in lines[1:]] == [
        "--T~PeriodicSamplesMapper", "---E~MultiSchemaPartitionsExec"] * 2
    assert "shard=0" in lines[2] and "shard=1" in lines[4]
