"""The port's Prometheus remote read (POST /api/v1/read, http/remotepb.py,
utils/snappy.py) against the JAX package's, mirroring
tests/test_remote_read.py: the same counter batch (each package's
ingest/generator.py, equal arrays) goes into a memstore of each package,
and every read request must get the reference's response to the byte.
"""
import numpy as np
import pytest

from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.http import remotepb as jpb
from filodb_tpu.http.routes import PromHttpApi as JApi
from filodb_tpu.ingest.generator import counter_batch as jcounter_batch
from filodb_tpu.query.engine import QueryEngine as JEngine
from filodb_tpu.utils import snappy as jsnappy
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.http import remotepb
from filodb_tpu_torch.http.routes import PromHttpApi
from filodb_tpu_torch.ingest.generator import counter_batch
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.utils import snappy

from test_torch_ingest import _clear_compile_journal  # noqa: F401

START = 1_600_000_000_000


# ------------------------------------------------------------------ snappy

def test_snappy_roundtrip_various_sizes():
    rng = np.random.default_rng(3)
    for n in (0, 1, 59, 60, 61, 1000, 70_000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert snappy.decompress(snappy.compress(data)) == data
        assert snappy.compress(data) == jsnappy.compress(data)


def test_snappy_compresses_repetitive_data():
    data = b"abcdefgh" * 4096
    comp = snappy.compress(data)
    assert snappy.decompress(comp) == data
    assert len(comp) < len(data) // 4


def test_snappy_decodes_foreign_copy_ops():
    blob = bytes([8]) + bytes([(4 - 1) << 2]) + b"abcd" \
        + bytes([(0 << 5) | ((4 - 4) << 2) | 1, 4])
    assert snappy.decompress(blob) == b"abcdabcd"
    blob = bytes([8]) + bytes([(2 - 1) << 2]) + b"ab" \
        + bytes([((6 - 1) << 2) | 2, 2, 0])
    assert snappy.decompress(blob) == b"abababab"
    blob = bytes([8]) + bytes([(4 - 1) << 2]) + b"wxyz" \
        + bytes([((4 - 1) << 2) | 3, 4, 0, 0, 0])
    assert snappy.decompress(blob) == b"wxyzwxyz"


def test_snappy_rejects_malformed():
    for bad in (b"", bytes([4]) + bytes([(4 - 1) << 2 | 1, 1]),
                bytes([99]) + bytes([(4 - 1) << 2]) + b"abcd"):
        with pytest.raises(ValueError):
            snappy.decompress(bad)


# ------------------------------------------------------------------ prompb

def _request(pb):
    return [pb.PromQuery(START, START + 60_000, [
        pb.LabelMatcher(pb.EQ, "__name__", "request_total"),
        pb.LabelMatcher(pb.RE, "_ns_", "App-.*"),
        pb.LabelMatcher(pb.NEQ, "dc", "DC1"),
        pb.LabelMatcher(pb.NRE, "instance", "x|y"),
    ]), pb.PromQuery(-5, -1, [])]


def test_prompb_request_bytes_equal_both_directions():
    ours = remotepb.encode_read_request(_request(remotepb))
    ref = jpb.encode_read_request(_request(jpb))
    assert ours == ref
    assert remotepb.decode_read_request(ref) == _request(remotepb)
    assert jpb.decode_read_request(ours) == _request(jpb)


def _response(pb):
    ts = pb.PromTimeSeries(
        labels=[("__name__", "m"), ("app", "a")],
        samples=[(1.5, START), (float("nan"), START + 1000),
                 (-2.25, START + 2000), (-0.0, -7)])
    return [[ts], [], [ts, ts]]


def test_prompb_response_bytes_equal_both_directions():
    ours = remotepb.encode_read_response(_response(remotepb))
    ref = jpb.encode_read_response(_response(jpb))
    assert ours == ref
    for pb, blob in ((remotepb, ref), (jpb, ours)):
        out = pb.decode_read_response(blob)
        assert [len(r) for r in out] == [1, 0, 2]
        got = out[0][0]
        assert got.labels == [("__name__", "m"), ("app", "a")]
        assert np.array(got.samples).tobytes() == \
            np.array(_response(pb)[0][0].samples).tobytes()


def test_prompb_negative_int64():
    req = [remotepb.PromQuery(-5, -1, [])]
    assert remotepb.decode_read_request(
        remotepb.encode_read_request(req)) == req


# ----------------------------------------------------------------- endpoint

@pytest.fixture(scope="module")
def apis():
    jms = JMemStore()
    jms.setup("prometheus", 0)
    jbatch = jcounter_batch(12, 50, start_ms=START)
    jms.ingest("prometheus", 0, jbatch, offset=1)
    ms = TimeSeriesMemStore(device="cpu")
    ms.setup("prometheus", 0)
    batch = counter_batch(12, 50, start_ms=START)
    ms.ingest("prometheus", 0, batch, offset=1)
    assert [pk.to_bytes() for pk in batch.part_keys] == \
        [pk.to_bytes() for pk in jbatch.part_keys]
    np.testing.assert_array_equal(batch.timestamps, jbatch.timestamps)
    assert batch.columns["count"].tobytes() == \
        jbatch.columns["count"].tobytes()
    return (JApi({"prometheus": JEngine("prometheus", jms)}),
            PromHttpApi({"prometheus": QueryEngine("prometheus", ms,
                                                   device="cpu")}),
            batch)


def _read(apis, queries):
    body = snappy.compress(remotepb.encode_read_request(queries))
    out = []
    for api in apis[:2]:
        status, payload = api.handle("POST", "/api/v1/read", {}, body)
        assert status == 200, payload
        assert isinstance(payload, bytes)
        out.append(payload)
    assert out[1] == out[0]
    return remotepb.decode_read_response(snappy.decompress(out[1]))


def test_remote_read_returns_raw_samples(apis):
    batch = apis[2]
    q = remotepb.PromQuery(START, START + 500_000, [
        remotepb.LabelMatcher(remotepb.EQ, "__name__", "request_total"),
        remotepb.LabelMatcher(remotepb.EQ, "_ns_", "App-3"),
    ])
    series = _read(apis, [q])[0]
    assert series
    for ts in series:
        labels = dict(ts.labels)
        assert labels["_ns_"] == "App-3"
        target = next(i for i, pk in enumerate(batch.part_keys)
                      if all(dict(pk.tags).get(k) == v
                             for k, v in labels.items() if k != "__name__"))
        sel = batch.part_idx == target
        np.testing.assert_array_equal([t for _, t in ts.samples],
                                      batch.timestamps[sel])
        np.testing.assert_allclose([v for v, _ in ts.samples],
                                   batch.columns["count"][sel], rtol=1e-12)


def test_remote_read_time_range_clipping(apis):
    lo, hi = START + 100_000, START + 200_000
    q = remotepb.PromQuery(lo, hi, [
        remotepb.LabelMatcher(remotepb.EQ, "__name__", "request_total")])
    results = _read(apis, [q])
    assert results[0]
    for ts in results[0]:
        assert all(lo <= t <= hi for _, t in ts.samples)


def test_remote_read_regex_and_neq_matchers(apis):
    q = remotepb.PromQuery(START, START + 500_000, [
        remotepb.LabelMatcher(remotepb.EQ, "__name__", "request_total"),
        remotepb.LabelMatcher(remotepb.RE, "_ns_", "App-[12]"),
        remotepb.LabelMatcher(remotepb.NEQ, "_ns_", "App-2"),
    ])
    assert {dict(ts.labels)["_ns_"] for ts in _read(apis, [q])[0]} == \
        {"App-1"}


def test_remote_read_multiple_queries(apis):
    qs = [remotepb.PromQuery(START, START + 500_000, [
              remotepb.LabelMatcher(remotepb.EQ, "__name__",
                                    "request_total"),
              remotepb.LabelMatcher(remotepb.EQ, "_ns_", f"App-{i}")])
          for i in (1, 2)]
    results = _read(apis, qs)
    assert len(results) == 2 and all(results)


@pytest.mark.parametrize("body", [
    b"not snappy",
    snappy.compress(b"\x0a\xff\x01ab"),
    snappy.compress(remotepb.encode_read_request([remotepb.PromQuery(
        START, START + 1000,
        [remotepb.LabelMatcher(7, "__name__", "request_total")])])),
], ids=["not_snappy", "truncated_protobuf", "bad_matcher_type"])
def test_remote_read_bad_payload_is_400(apis, body):
    out = [api.handle("POST", "/api/v1/read", {}, body) for api in apis[:2]]
    assert out[1] == out[0]
    assert out[1][0] == 400
