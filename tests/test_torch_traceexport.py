"""The port's span exporter (filodb_tpu_torch/utils/traceexport.py) and
the collector's sinks it sits on (utils/metrics.TraceCollector.add_sink /
remove_sink and the fan-out in record), modelled on
tests/test_traceexport.py and held to the JAX package's span shape."""
import json
import time

import pytest

from filodb_tpu_torch.utils.metrics import (TraceCollector, collector,
                                            registry, span, trace_context)
from filodb_tpu_torch.utils.traceexport import TraceExporter, _zipkin_span


def _event(i=0):
    return {"span": f"exec.{i}", "dur_s": 0.002,
            "end_unix_s": time.time(), "node": "n1", "shard": str(i)}


def test_zipkin_span_equals_the_reference():
    """Every field but the random span id equals the reference's span of
    the same event: 32-hex traceId, microsecond duration floored at 1,
    the extra fields as tags."""
    from filodb_tpu.utils.traceexport import _zipkin_span as jspan
    for tid, ev in (("11111111-2222-3333-4444-555555555555", _event(3)),
                    ("not-a-uuid!", _event()),
                    ("a" * 32, {"span": "s", "dur_s": 0.0,
                                "end_unix_s": 1_700_000_000.5}),
                    ("b" * 16, {"span": "q", "dur_s": 1.25, "n": 3,
                                "end_unix_s": 1_700_000_001.0})):
        got, want = _zipkin_span(tid, ev), jspan(tid, ev)
        assert len(got["id"]) == 16 and got["id"] != want["id"]
        del got["id"], want["id"]
        assert got == want
    sp = _zipkin_span("11111111-2222-3333-4444-555555555555", _event(3))
    assert sp["traceId"] == "11111111222233334444555555555555"
    assert sp["duration"] == 2000 and sp["tags"] == {"shard": "3"}
    assert sp["localEndpoint"]["serviceName"] == "n1"


def test_flush_ships_in_batch_sized_chunks():
    shipped = []
    exp = TraceExporter("http://unused.invalid/api/v2/spans", batch=16)
    exp._ship = lambda spans: shipped.append(list(spans))
    n0 = registry.counter("trace_export_spans").value
    for i in range(40):
        exp.sink("a" * 32, _event(i))
    exp._flush()
    assert [len(b) for b in shipped] == [16, 16, 8]
    assert [s["name"] for b in shipped for s in b] == \
        [f"exec.{i}" for i in range(40)]
    assert registry.counter("trace_export_spans").value - n0 == 40


def test_stop_drains_remaining_queue():
    shipped = []
    exp = TraceExporter("http://unused.invalid/api/v2/spans",
                        flush_interval_s=60.0, batch=8)
    exp._ship = lambda spans: shipped.append(list(spans))
    exp.start()
    try:
        for i in range(20):
            exp.sink("b" * 32, _event(i))
    finally:
        exp.stop()
    assert sum(len(b) for b in shipped) == 20


def test_file_target_gets_the_collectors_spans(tmp_path):
    """A file:// exporter started over the collector: traced spans land
    in the file one JSON span a line, under the trace's id; nothing is
    dropped; after stop() the sink is detached."""
    path = tmp_path / "out" / "spans.jsonl"
    exp = TraceExporter(f"file://{path}", flush_interval_s=60.0)
    drop0 = registry.counter("trace_export_dropped").value
    exp.start()
    try:
        tid = "c" * 32
        with trace_context(tid):
            for i in range(5):
                with span("exporter_probe", step=str(i)):
                    pass
    finally:
        exp.stop()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    mine = [s for s in lines if s["traceId"] == tid]
    assert [s["tags"]["step"] for s in mine] == [str(i) for i in range(5)]
    assert all(s["name"].endswith("exporter_probe") for s in mine)
    assert registry.counter("trace_export_dropped").value == drop0
    assert exp.sink not in collector._sinks
    with trace_context("d" * 32):
        with span("after_stop"):
            pass
    assert len(path.read_text().splitlines()) == len(lines)


def test_http_target_posts_json_batches():
    import http.server
    import threading
    got = []

    class H(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            got.append(json.loads(self.rfile.read(
                int(self.headers["Content-Length"]))))
            self.send_response(202)
            self.end_headers()

        def log_message(self, *a):
            pass
    srv = http.server.HTTPServer(("127.0.0.1", 0), H)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        exp = TraceExporter(
            f"http://127.0.0.1:{srv.server_port}/api/v2/spans", batch=4)
        for i in range(6):
            exp.sink("e" * 32, _event(i))
        exp._flush()
        assert [len(b) for b in got] == [4, 2]
        assert got[0][0]["traceId"] == "e" * 32
    finally:
        srv.shutdown()
        srv.server_close()


def test_sink_failure_never_blocks_recording_path():
    calls = {"n": 0}
    broken = {"yes": True}

    def flaky_ship(spans):
        calls["n"] += 1
        if broken["yes"]:
            raise ConnectionError("collector down")

    exp = TraceExporter("http://unused.invalid/api/v2/spans",
                        flush_interval_s=0.02, max_queue=32, batch=8)
    exp._ship = flaky_ship
    err0 = registry.counter("trace_export_errors").value
    drop0 = registry.counter("trace_export_dropped").value
    exp.start()
    try:
        t0 = time.perf_counter()
        for i in range(500):
            exp.sink("c" * 32, _event(i))
        assert time.perf_counter() - t0 < 1.0, "sink() blocked"
        deadline = time.time() + 5
        while time.time() < deadline and \
                registry.counter("trace_export_errors").value == err0:
            time.sleep(0.01)
        assert registry.counter("trace_export_errors").value > err0
        assert registry.counter("trace_export_dropped").value > drop0
        from filodb_tpu_torch.utils.jobs import jobs
        h = jobs.get("trace_export")
        assert h is not None and h.consecutive_errors >= 1
        broken["yes"] = False
        exp.sink("d" * 32, _event(0))
        pre = calls["n"]
        deadline = time.time() + 5
        while time.time() < deadline and calls["n"] == pre:
            time.sleep(0.01)
        assert calls["n"] > pre
        assert h.consecutive_errors == 0
    finally:
        exp.stop()


def test_sink_failure_does_not_wedge_query_serving():
    def dead_ship(spans):
        raise ConnectionError("collector down")

    exp = TraceExporter("http://unused.invalid/api/v2/spans",
                        flush_interval_s=0.02, max_queue=8)
    exp._ship = dead_ship
    exp.start()
    try:
        t0 = time.perf_counter()
        for i in range(200):
            with trace_context(f"{i:032x}"):
                with span("serving_probe"):
                    pass
        assert time.perf_counter() - t0 < 1.0
        assert collector.trace(f"{199:032x}")
    finally:
        exp.stop()


def test_collector_sink_that_raises_never_blocks_recording():
    """The collector's fan-out: every sink sees every recorded event, a
    sink that raises is skipped (and counted as a suppressed error)
    without reaching the span's exit or the sinks after it; remove_sink
    detaches; an id-only record reaches no sink."""
    c = TraceCollector(max_traces=8)
    seen = []

    def bad(tid, ev):
        raise RuntimeError("sink down")
    c.add_sink(bad)
    c.add_sink(lambda tid, ev: seen.append((tid, ev["span"])))
    sup = registry.counter("suppressed_errors", site="trace.sink",
                           **{"class": "RuntimeError"})
    n0 = sup.value
    c.record("t1", {"span": "a"})
    c.record("t1", None)
    c.record("t2", {"span": "b"})
    assert seen == [("t1", "a"), ("t2", "b")]
    assert [e["span"] for e in c.trace("t1")] == ["a"]
    assert sup.value - n0 == 2
    c.remove_sink(bad)
    c.remove_sink(bad)                    # absent: a no-op
    c.record("t3", {"span": "c"})
    assert seen[-1] == ("t3", "c") and sup.value - n0 == 2


@pytest.mark.parametrize("url", ["file:///nonexistent-dir-\0/x", "bogus://"])
def test_ship_errors_are_counted_not_raised(url):
    exp = TraceExporter(url)
    e0 = registry.counter("trace_export_errors").value
    exp.sink("f" * 32, _event())
    exp._flush()
    assert registry.counter("trace_export_errors").value == e0 + 1
