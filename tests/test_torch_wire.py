"""The port's wire (filodb_tpu_torch/parallel/serialize.py, streams.py and
the transport's stream frames) against the JAX package's.

The same plan or result, built in each package (the port's with torch
tensors where it holds them), must encode to the same frame, byte for
byte: ResultBlock, RawBlock, AggPartial in its component, candidate and
sketch forms, every leaf plan, RemoteAggregateExec.  A port frame must
decode in the reference and the reverse.  Random values of every wire
type round-trip (tests/test_wire_fuzz.py's fuzz); streams split and
assemble; torn, corrupt, short and reordered streams fail as typed
errors.
"""
import random

import numpy as np
import pytest
import torch

from filodb_tpu.parallel import serialize as jser
from filodb_tpu.parallel import streams as jstreams
from filodb_tpu.parallel import transport as jtr

from filodb_tpu_torch.parallel import serialize as tser
from filodb_tpu_torch.parallel import streams as tstreams
from filodb_tpu_torch.parallel import transport as ttr

from test_unparse_fuzz import TSP, _vector
from test_torch_ingest import _clear_compile_journal  # noqa: F401

START = 1_600_000_020_000


def _pkg(name):
    """The exec facade, rangevector and index modules of one package."""
    if name == "jax":
        from filodb_tpu.core import index
        from filodb_tpu.query import exec as ex
        from filodb_tpu.query import rangevector as rv
    else:
        from filodb_tpu_torch.core import index
        from filodb_tpu_torch.query import exec as ex
        from filodb_tpu_torch.query import rangevector as rv
    return ex, rv, index


def _arr(name, a):
    """The port holds values as tensors; the reference as numpy."""
    return a if name == "jax" else torch.from_numpy(a)


def _keys(rv, n, shard=0):
    return [rv.RangeVectorKey.make({"_ns_": f"App-{i % 3}",
                                    "instance": f"i{shard}-{i}"})
            for i in range(n)]


def _results(name):
    ex, rv, _ = _pkg(name)
    rng = np.random.default_rng(7)
    wends = START + np.arange(5, dtype=np.int64) * 60_000
    vals = rng.normal(0, 1, (4, 5)).astype(np.float32)
    comp = rng.normal(0, 1, (3, 5, 2))
    sk = rng.normal(0, 1, (2, 5, 64, 2))
    ts = (np.arange(6, dtype=np.int32)[None, :] * 10_000).repeat(4, 0)
    raw_v = rng.normal(0, 1, (4, 6)).astype(np.float32)
    vbase = rng.normal(1e6, 1, 4)
    gk = [rv.RangeVectorKey.make({"_ns_": f"App-{g}"}) for g in range(3)]
    return {
        "result_block": rv.ResultBlock(_keys(rv, 4), wends,
                                       _arr(name, vals)),
        "raw_block": ex.RawBlock(_keys(rv, 4), _arr(name, ts),
                                 _arr(name, raw_v), START, None,
                                 samples=24, vbase=_arr(name, vbase),
                                 precorrected=True, dense=True),
        "partial_component": ex.AggPartial("avg", gk, wends, comp=comp,
                                           params=()),
        "partial_candidate": ex.AggPartial(
            "topk", gk, wends, cand_keys=_keys(rv, 4),
            cand_vals=_arr(name, vals), cand_groups=np.array([0, 1, 2, 0]),
            params=(2,)),
        "partial_sketch": ex.AggPartial("quantile", gk[:2], wends,
                                        sketch=sk, params=(0.9,)),
        "reply": {"ok": True, "data": rv.ResultBlock(
            _keys(rv, 4), wends, _arr(name, vals)),
            "stats": rv.QueryStats(samples_scanned=7, device_calls={
                "cuda:0|fused_rate": [0.5, 2]}), "spans": []},
    }


@pytest.mark.parametrize("what", sorted(_results("jax")))
def test_result_frames_equal_reference(what):
    frame = tser.dumps(_results("torch")[what])
    assert frame == jser.dumps(_results("jax")[what])
    # and each package decodes the other's frame
    back = jser.loads(frame)
    assert jser.dumps(back) == frame
    assert tser.dumps(tser.loads(frame)) == frame


def test_revive_puts_port_arrays_back_as_tensors():
    res = _results("torch")
    frame = tser.dumps(res["partial_candidate"])
    p = tser.revive(tser.loads(frame), torch.device("cpu"))
    assert isinstance(p.cand_vals, torch.Tensor)
    np.testing.assert_array_equal(p.cand_vals.numpy(),
                                  res["partial_candidate"].cand_vals.numpy())
    raw = tser.revive(tser.loads(tser.dumps(res["raw_block"])),
                      torch.device("cpu"))
    assert isinstance(raw.values, torch.Tensor)
    assert raw.ts_off.dtype == torch.int32 and raw.vbase.dtype == \
        torch.float64


def _leaves(name):
    ex, rv, index = _pkg(name)
    ctx = rv.QueryContext(query_id="q1", deadline_unix_s=123.5,
                          planner_params=rv.PlannerParams(
                              allow_partial_results=True))
    f = [index.Equals("_metric_", "heap_usage"),
         index.EqualsRegex("_ns_", "App-.*")]
    leaf = ex.MultiSchemaPartitionsExec(ctx, "prometheus", 1, f, START,
                                        START + 3_600_000)
    leaf.add_transformer(ex.PeriodicSamplesMapper(
        START + 600_000, 60_000, START + 3_600_000, 300_000, "rate", ()))
    leaf.add_transformer(ex.AggregateMapReduce("sum", (), ("_ns_",), ()))
    leaf2 = ex.MultiSchemaPartitionsExec(ctx, "prometheus", 2, f, START,
                                         START + 3_600_000)
    leaf2.add_transformer(ex.PeriodicSamplesMapper(
        START + 600_000, 60_000, START + 3_600_000, 300_000, "rate", ()))
    leaf2.add_transformer(ex.AggregateMapReduce("sum", (), ("_ns_",), ()))
    if name == "jax":
        from filodb_tpu.persist.segments import PersistedTier
    else:
        from filodb_tpu_torch.persist.segments import PersistedTier
    tier = PersistedTier.__new__(PersistedTier)
    tier.dataset = "prometheus"
    return {
        "multi_schema": leaf,
        "persisted_segments": ex.SelectPersistedSegmentsExec(
            ctx, "prometheus", 0, f, START, START + 3_600_000, tier),
        "label_values": ex.LabelValuesExec(ctx, "prometheus", 0, f,
                                           ["_ns_"], START, START + 1000),
        "part_keys": ex.PartKeysExec(ctx, "prometheus", 0, f, START,
                                     START + 1000),
        "time_scalar": ex.TimeScalarGeneratorExec(ctx, START, 60_000,
                                                  START + 600_000),
        "fixed_double": ex.ScalarFixedDoubleExec(ctx, START, 60_000,
                                                 START + 600_000, 2.5),
        "remote_aggregate": ex.RemoteAggregateExec(ctx, [leaf, leaf2],
                                                   "quantile", (0.9,)),
        "presenter": ex.AggregatePresenter("sum", ()),
    }


@pytest.mark.parametrize("what", sorted(_leaves("jax")))
def test_plan_frames_equal_reference(what):
    frame = tser.dumps(_leaves("torch")[what])
    assert frame == jser.dumps(_leaves("jax")[what])
    if what == "persisted_segments":
        return              # decoding rebinds to a node's registered tier
    back = tser.loads(frame)
    jback = jser.loads(frame)
    if what != "presenter":
        assert back.print_tree() == jback.print_tree()
    assert tser.dumps(back) == frame


def test_nonleaf_plans_refuse_the_wire():
    ex, rv, _ = _pkg("torch")
    leaves = _leaves("torch")
    plan = ex.DistConcatExec(rv.QueryContext(), [leaves["multi_schema"]])
    with pytest.raises(tser.NotSerializable):
        tser.dumps(plan)


def test_planner_leaf_frames_fuzz():
    """Random PromQL through both packages' planners: every serializable
    leaf subtree encodes to the reference's frame and round-trips."""
    from filodb_tpu.parallel.shardmapper import ShardEvent as JEv
    from filodb_tpu.parallel.shardmapper import ShardMapper as JMapper
    from filodb_tpu.promql.parser import query_range_to_logical_plan as jparse
    from filodb_tpu.query.engine import _walk_plan as jwalk
    from filodb_tpu.query.planner import SingleClusterPlanner as JPlanner
    from filodb_tpu.query.rangevector import QueryContext as JCtx

    from filodb_tpu_torch.parallel.shardmapper import ShardEvent, ShardMapper
    from filodb_tpu_torch.promql.parser import query_range_to_logical_plan
    from filodb_tpu_torch.query.engine import _walk_plan
    from filodb_tpu_torch.query.planner import SingleClusterPlanner
    from filodb_tpu_torch.query.rangevector import QueryContext

    jm, tm = JMapper(2), ShardMapper(2)
    for s in range(2):
        jm.update_from_event(JEv("IngestionStarted", "prometheus", s, "n"))
        tm.update_from_event(ShardEvent("IngestionStarted", "prometheus", s,
                                        "n"))
    jp, tp = JPlanner("prometheus", jm), SingleClusterPlanner("prometheus",
                                                              tm)
    rng = random.Random(42)
    checked = 0
    for _ in range(120):
        expr = _vector(rng, 3)
        try:
            jep = jp.materialize(jparse(expr, TSP), JCtx(query_id="f"))
        except Exception:
            continue
        tep = tp.materialize(query_range_to_logical_plan(expr, TSP),
                             QueryContext(query_id="f"))
        jl = [n for n in jwalk(jep) if not n.children]
        tl = [n for n in _walk_plan(tep) if not n.children]
        assert len(jl) == len(tl), expr
        for a, b in zip(tl, jl):
            try:
                want = jser.dumps(b)
            except jser.NotSerializable:
                continue
            frame = tser.dumps(a)
            assert frame == want, expr
            assert tser.loads(frame).print_tree() == a.print_tree()
            checked += 1
    assert checked >= 40, f"only {checked} leaf plans exercised"


def _rand_obj(rng, depth, key_cls):
    r = rng.random()
    if depth <= 0 or r < 0.35:
        return rng.choice([
            None, True, False, rng.randrange(-10**12, 10**12),
            rng.random() * 1e6, "s" * rng.randrange(0, 8), "uniçøde"])
    if r < 0.55:
        dt = rng.choice([np.float32, np.float64, np.int32, np.int64,
                         np.bool_])
        shape = tuple(rng.randrange(0, 5)
                      for _ in range(rng.randrange(1, 3)))
        a = np.random.default_rng(rng.randrange(1 << 30)).random(shape) * 100
        return (a > 30) if dt == np.bool_ else a.astype(dt)
    if r < 0.7:
        return [_rand_obj(rng, depth - 1, key_cls)
                for _ in range(rng.randrange(0, 4))]
    if r < 0.85:
        return tuple(_rand_obj(rng, depth - 1, key_cls)
                     for _ in range(rng.randrange(0, 4)))
    if r < 0.95:
        return {f"k{i}": _rand_obj(rng, depth - 1, key_cls)
                for i in range(rng.randrange(0, 4))}
    return key_cls.make({f"l{i}": f"v{rng.randrange(100)}"
                         for i in range(rng.randrange(0, 3))})


def _assert_eq(a, b, path="$"):
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_eq(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_eq(a[k], b[k], f"{path}.{k}")
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("seed", range(6))
def test_value_roundtrip_fuzz_equals_reference(seed):
    from filodb_tpu.query.rangevector import RangeVectorKey as JKey

    from filodb_tpu_torch.query.rangevector import RangeVectorKey
    for i in range(60):
        obj = _rand_obj(random.Random(seed * 1000 + i), 4, RangeVectorKey)
        jobj = _rand_obj(random.Random(seed * 1000 + i), 4, JKey)
        frame = tser.dumps(obj)
        assert frame == jser.dumps(jobj)
        _assert_eq(obj, tser.loads(frame))


# ------------------------------------------------------------ streams


@pytest.mark.parametrize("what", ["result_block", "raw_block",
                                  "partial_component", "partial_candidate",
                                  "partial_sketch"])
def test_stream_split_equals_reference_and_assembles(what):
    t, j = _results("torch")[what], _results("jax")[what]
    ts_, js_ = tstreams.split_for_stream(t, 64), \
        jstreams.split_for_stream(j, 64)
    assert (ts_ is None) == (js_ is None)
    if ts_ is None:
        return
    (tb, tp), (jb, jp) = ts_, js_
    assert tser.dumps({"begin": tb}) == jser.dumps({"begin": jb})
    assert len(tp) == len(jp) > 1
    for a, b in zip(tp, jp):
        assert tser.dumps({"piece": a}) == jser.dumps({"piece": b})
    asm = tstreams.StreamAssembler(tser.loads(tser.dumps({"begin": tb}))[
        "begin"])
    for p in tp:
        asm.add(tser.loads(tser.dumps({"piece": p}))["piece"])
    assert tser.dumps(asm.finish()) == tser.dumps(t)


def test_assembler_refuses_short_reordered_and_unknown_streams():
    t = _results("torch")["result_block"]
    begin, pieces = tstreams.split_for_stream(t, 20)
    assert len(pieces) >= 3
    asm = tstreams.StreamAssembler(begin)
    asm.add(pieces[0])
    with pytest.raises(ValueError, match="short stream"):
        asm.finish()
    with pytest.raises(ValueError, match="out-of-order"):
        asm.add(pieces[2])
    with pytest.raises(ValueError, match="unknown stream payload"):
        tstreams.StreamAssembler({"type": "Nope", "rows": 1})


def test_stream_frames_equal_reference_and_crc_rejects():
    body = tser.dumps({"piece": {"r0": 0, "n": 1}})
    raw = ttr._pack_stream_frame(3, body, last=False)
    assert raw == jtr._pack_stream_frame(3, body, last=False)
    assert ttr._unpack_stream_frame(raw) == (False, 3, body)
    with pytest.raises(ValueError, match="CRC"):
        ttr._unpack_stream_frame(raw[:-1] + bytes([raw[-1] ^ 0xFF]))
    with pytest.raises(ValueError, match="shorter"):
        ttr._unpack_stream_frame(raw[:6])
