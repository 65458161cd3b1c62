"""The PromQL conformance corpus (tests/promql_corpus/*.test) through the
port's QueryEngine(device="cpu"), with tests/test_promql_corpus.py's
loader and checks: each file is loaded into the JAX memstore, its series
are carried into the port's (load_reference_arrays, as
tests/test_torch_engine.py does), and every `eval` must give the
expected values: the port answers every eval of the corpus.
histograms.test is also replayed through the native histogram schema.
"""
import os

import numpy as np
import pytest

from test_promql_corpus import (CORPUS_DIR, _corpus_files, build_engine,
                                parse_corpus, run_case)
from test_torch_engine import _port_engine
from test_torch_ingest import _clear_compile_journal  # noqa: F401

@pytest.mark.parametrize("fname", _corpus_files())
def test_corpus_file_through_the_port(fname):
    step_s, series, cases = parse_corpus(os.path.join(CORPUS_DIR, fname))
    engine = _port_engine(build_engine(step_s, series), 1, "gauge", "value")
    for case in cases:
        run_case(engine, case)


def test_classic_buckets_match_native_histogram_schema_through_the_port():
    """The port's counterpart of tests/test_promql_corpus.py::
    test_classic_buckets_match_native_histogram_schema: histograms.test's
    job="a" ladder as one native column (bucket matrix + bucket_les) must
    answer histogram_quantile over rate as the classic `le`-labelled
    form does, through the port's general path and its fused leaf.  The
    instant form over the native column, a non-counter read of the
    counter column `h`, takes the windowed host gather (the reference's
    host route) and must agree with the reference and the classic form."""
    from filodb_tpu.core.memstore import TimeSeriesMemStore
    from filodb_tpu.core.partkey import PartKey
    from filodb_tpu.core.records import RecordBatch
    from filodb_tpu.core.schemas import DEFAULT_SCHEMAS
    from filodb_tpu.parallel.shardmapper import ShardEvent, ShardMapper
    from filodb_tpu.query.engine import QueryEngine

    from test_torch_hist_native import _port_engine as _native_port

    step_s, series, _ = parse_corpus(
        os.path.join(CORPUS_DIR, "histograms.test"))
    classic = _port_engine(build_engine(step_s, series), 1, "gauge",
                           "value")
    les = np.array([0.1, 0.5, 1.0, np.inf])
    slopes = np.array([1.0, 3.0, 5.0, 6.0])
    T = 21
    ts = np.arange(T, dtype=np.int64) * int(step_s * 1000)
    hist = slopes[None, :] * np.arange(T, dtype=np.float64)[:, None]
    pk = PartKey.make("req", {"job": "a"})
    ms = TimeSeriesMemStore()
    ms.setup("prometheus", 0).ingest(RecordBatch(
        DEFAULT_SCHEMAS["prom-histogram"], [pk], np.zeros(T, np.int32), ts,
        {"sum": hist[:, -1] * 2.0, "count": hist[:, -1].copy(),
         "h": hist}, bucket_les=les))
    mapper = ShardMapper(1)
    mapper.update_from_event(
        ShardEvent("IngestionStarted", "prometheus", 0, "b"))
    reference = QueryEngine("prometheus", ms, mapper)
    native = _native_port(reference, 1)

    def one(engine, promql):
        res = engine.query_range(promql, 600, 60, 600)
        assert res.error is None, res.error
        vals = [float(np.asarray(v)[0]) for _, _, v in res.series()]
        assert len(vals) == 1, (promql, vals)
        return vals[0]

    for q in (0.25, 0.5, 0.75, 0.9, 1.0):
        want = one(classic, f'histogram_quantile({q}, rate('
                   f'req_bucket{{job="a"}}[5m]))')
        assert one(native, f'histogram_quantile({q}, rate('
                   f'req{{job="a"}}[5m]))') == pytest.approx(want, rel=1e-6)
        # the fused leaf: sum over (group, bucket) slots
        assert one(native, f'histogram_quantile({q}, sum(rate('
                   f'req{{job="a"}}[5m])))') == pytest.approx(want, rel=1e-6)
    q_instant = 'histogram_quantile(0.5, req{job="a"})'
    want = one(classic, 'histogram_quantile(0.5, req_bucket{job="a"})')
    assert one(reference, q_instant) == pytest.approx(want)
    assert one(native, q_instant) == pytest.approx(want, rel=1e-6)
