"""Span EXPORT: ship stitched traces out of the process (port of
filodb_tpu/utils/traceexport.py).

The reference exports its Kamon spans through configured reporters
(Zipkin / Prometheus; ref: coordinator/.../KamonLogger.scala:16-40,
filodb-defaults.conf kamon block).  /admin/traces/<id> is pull-only;
this module pushes: a background exporter drains span events into Zipkin v2 JSON batches and ships them to

  - ``http(s)://host:port/api/v2/spans`` — POSTed as JSON (Zipkin's
    native collector endpoint), or
  - ``file:///path/to/spans.jsonl`` — appended one span per line (the
    zero-dependency option; tail it or bulk-import later).

Configured via ``FilodbSettings.trace_export_url`` (empty = disabled);
a composition root wires and stops it (the port has none yet: callers
start and stop the exporter themselves).  Export is strictly best-effort and
non-blocking: a full queue drops spans and counts them
(``trace_export_dropped``), never stalling the query path.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
import uuid
from typing import Optional
from urllib.request import Request, urlopen

from filodb_tpu_torch.utils.metrics import collector, registry


def _zipkin_span(trace_id: str, event: dict) -> dict:
    """One collector event -> one Zipkin v2 span dict.

    trace ids are query uuids: stripped of dashes they are exactly the
    32 lower hex chars Zipkin wants; non-uuid ids are hashed into one.
    """
    tid = trace_id.replace("-", "").lower()
    if len(tid) not in (16, 32) or any(c not in "0123456789abcdef"
                                       for c in tid):
        tid = uuid.uuid5(uuid.NAMESPACE_OID, trace_id).hex
    dur_us = max(int(float(event.get("dur_s", 0.0)) * 1e6), 1)
    end_s = float(event.get("end_unix_s", time.time()))
    tags = {k: str(v) for k, v in event.items()
            if k not in ("span", "dur_s", "end_unix_s", "node")}
    return {
        "traceId": tid,
        "id": uuid.uuid4().hex[:16],
        "name": str(event.get("span", "span")),
        "timestamp": int((end_s - dur_us / 1e6) * 1e6),
        "duration": dur_us,
        "localEndpoint": {"serviceName": str(event.get("node") or "filodb")},
        "tags": tags,
    }


class TraceExporter:
    """Background Zipkin-v2 exporter fed by TraceCollector's sink hook."""

    def __init__(self, url: str, flush_interval_s: float = 2.0,
                 max_queue: int = 4096, batch: int = 256):
        self.url = url
        self.flush_interval_s = flush_interval_s
        self.batch = batch
        self._q: "queue.Queue[dict]" = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # unified job registry: export ticks/streaks at /admin/jobs (NOT
        # critical — a dead Zipkin collector must never flip /ready)
        from filodb_tpu_torch.utils.jobs import jobs
        self.job = jobs.register("trace_export",
                                 interval_s=flush_interval_s)

    # -- the collector sink (called under the query path: must not block)

    def sink(self, trace_id: str, event: dict) -> None:
        try:
            self._q.put_nowait(_zipkin_span(trace_id, event))
        except queue.Full:
            registry.counter("trace_export_dropped").increment()

    # -- lifecycle

    def start(self) -> "TraceExporter":
        collector.add_sink(self.sink)
        self._thread = threading.Thread(target=self._run,
                                        name="filodb-trace-export",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        collector.remove_sink(self.sink)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._flush()                      # final drain

    # -- internals

    def _run(self) -> None:
        while not self._stop.wait(self.flush_interval_s):
            self._flush()

    def _drain(self):
        spans = []
        while len(spans) < self.batch:
            try:
                spans.append(self._q.get_nowait())
            except queue.Empty:
                break
        return spans

    def _flush(self) -> None:
        shipped = 0
        while True:
            spans = self._drain()
            if not spans:
                if shipped:
                    self.job.note_ok()
                    self.job.set_progress(f"shipped {shipped} span(s)")
                return
            try:
                self._ship(spans)
                shipped += len(spans)
                registry.counter("trace_export_spans").increment(len(spans))
            except Exception as e:  # noqa: BLE001 — export is best-effort
                registry.counter("trace_export_errors").increment()
                self.job.note_error(e)
                return

    def _ship(self, spans) -> None:
        if self.url.startswith("file://"):
            path = self.url[len("file://"):]
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "a") as f:
                for s in spans:
                    f.write(json.dumps(s, separators=(",", ":")) + "\n")
            return
        req = Request(self.url, data=json.dumps(spans).encode(),
                      headers={"Content-Type": "application/json"})
        with urlopen(req, timeout=5) as resp:
            resp.read()
