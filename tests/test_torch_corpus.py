"""The PromQL conformance corpus (tests/promql_corpus/*.test) through the
port's QueryEngine(device="cpu"), with tests/test_promql_corpus.py's
loader and checks: each file is loaded into the JAX memstore, its series
are carried into the port's (load_reference_arrays, as
tests/test_torch_engine.py does), and every `eval` must give the
expected values.  An eval that needs what the port leaves out (the sort,
limit, absent, label, scalar() and vector() functions, subqueries, `@`,
native histogram columns, a bare range vector) must raise not_ported;
each file's count of those is pinned in NOT_PORTED, so a regression
cannot hide among them.
"""
import os

import pytest

from filodb_tpu_torch.query.execbase import QueryError

from test_promql_corpus import (CORPUS_DIR, _corpus_files, build_engine,
                                parse_corpus, run_case)
from test_torch_engine import _port_engine

# file -> evals that raise not_ported (see PERF.md for the groups)
NOT_PORTED = {
    "advanced.test": 4,             # `@` (1), subqueries (3)
    "at_offset_subquery.test": 18,  # `@` (9), subqueries (9)
    "functions.test": 3,            # label_replace (1), absent (2)
    "functions2.test": 7,           # vector, scalar, absent (2),
                                    # label_replace/label_join (2), sort
    "functions3.test": 5,           # absent_over_time (an absent plan)
    "operators2.test": 1,           # scalar()
    "operators3.test": 3,           # vector()
    "scalars.test": 6,              # vector() (3), scalar() (3)
}


@pytest.mark.parametrize("fname", _corpus_files())
def test_corpus_file_through_the_port(fname):
    step_s, series, cases = parse_corpus(os.path.join(CORPUS_DIR, fname))
    engine = _port_engine(build_engine(step_s, series), 1, "gauge", "value")
    skipped = []
    for case in cases:
        try:
            run_case(engine, case)
        except QueryError as e:
            if e.code != "not_ported":
                raise
            skipped.append((case.line_no, case.expr))
    assert len(skipped) == NOT_PORTED.get(fname, 0), skipped
