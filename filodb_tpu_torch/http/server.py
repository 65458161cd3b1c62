"""Threaded HTTP server shell around PromHttpApi (port of
filodb_tpu/http/server.py).

The stdlib ThreadingHTTPServer is the transport; all route logic lives
in routes.py.  `FiloHttpServer(PromHttpApi({"prometheus": eng}),
port=0)` binds a free port (`.port`); `start()` serves on a daemon
thread, `stop()` shuts it down.
"""
from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from filodb_tpu_torch.http.routes import PromHttpApi


class FiloHttpServer:

    def __init__(self, api: PromHttpApi, host: str = "127.0.0.1",
                 port: int = 8080):
        self.api = api
        api_ref = api

        class _Handler(BaseHTTPRequestHandler):
            def _serve(self, method: str):
                parsed = urllib.parse.urlsplit(self.path)
                multi = urllib.parse.parse_qs(parsed.query)
                params = {k: v[-1] for k, v in multi.items()}
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                # form-decode only for the API routes (/admin and /influx
                # carry text bodies even when clients default the form
                # content-type); the binary api/v1 endpoints (remote read
                # and write: snappy protobuf) are excluded too, since
                # simple clients POST them with the form content-type
                if method == "POST" and body and \
                        parsed.path.startswith(("/promql", "/api")) and \
                        not parsed.path.endswith(("/read", "/write")) and \
                        self.headers.get("Content-Type", "").startswith(
                            "application/x-www-form-urlencoded"):
                    try:
                        form_multi = urllib.parse.parse_qs(body.decode())
                    except UnicodeDecodeError:
                        self.send_response(400)
                        blob = (b'{"status":"error","errorType":"bad_data",'
                                b'"error":"form-encoded body is not utf-8"}')
                        self.send_header("Content-Type", "application/json")
                        self.send_header("Content-Length", str(len(blob)))
                        self.end_headers()
                        self.wfile.write(blob)
                        return
                    form = {k: v[-1] for k, v in form_multi.items()}
                    params = {**form, **params}
                    multi = {**form_multi, **multi}
                    body = b""
                # bind the client socket for the duration of the request
                # so a query registered on this thread carries it: the
                # disconnect watcher (query/activequeries.py) detects the
                # peer closing mid-query and trips the CancellationToken
                # — abandoned dashboard polls stop consuming the
                # concurrency semaphore and device time
                from filodb_tpu_torch.query.activequeries import bind_client_conn
                with bind_client_conn(self.connection):
                    status, payload = api_ref.handle(
                        method, parsed.path, params, body,
                        multi_params=multi, headers=dict(self.headers))
                extra_headers = {}
                if isinstance(payload, bytes):      # binary (remote read)
                    blob = payload
                    ctype = "application/x-protobuf"
                    extra_headers["Content-Encoding"] = "snappy"
                elif isinstance(payload, str):      # text routes (/metrics)
                    blob = payload.encode()
                    # routes may carry a negotiated content type (the
                    # OpenMetrics exposition); plain strings keep the
                    # Prometheus text type
                    ctype = getattr(payload, "content_type",
                                    "text/plain; version=0.0.4")
                else:
                    if isinstance(payload, dict) and "_headers" in payload:
                        extra_headers.update(payload.pop("_headers"))
                    blob = b"" if status == 204 else json.dumps(payload).encode()
                    ctype = "application/json"
                try:
                    self.send_response(status)
                    self.send_header("Content-Type", ctype)
                    for k, v in extra_headers.items():
                        self.send_header(k, v)
                    self.send_header("Content-Length", str(len(blob)))
                    self.end_headers()
                    if blob:
                        self.wfile.write(blob)
                except (BrokenPipeError, ConnectionResetError):
                    # the client hung up mid-request — routine since the
                    # disconnect watcher aborts abandoned queries (their
                    # canceled response has nowhere to go); the stdlib
                    # handler would traceback to stderr on every one
                    self.close_connection = True

            def do_GET(self):       # noqa: N802 — BaseHTTPRequestHandler API
                self._serve("GET")

            def do_POST(self):      # noqa: N802
                self._serve("POST")

            def log_message(self, fmt, *args):
                pass                 # quiet; observability goes via metrics

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        # stdlib shutdown() BLOCKS until serve_forever acknowledges —
        # forever if the serving thread was never started
        if self._thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
