"""Webhook-shaped alert notifier with retry/backoff (port of
filodb_tpu/rules/notifier.py).

Fires the Alertmanager v4 webhook payload shape at `rules.notify_url`;
with no URL configured, deliveries land in the in-process `sent` ring
instead (tests and single-node ops read it at /api/v1/alerts anyway).
Every delivery ATTEMPT passes the `ruler.notify` fault point
(utils/faults.py), so the chaos harness can exercise the retry/backoff
path and the dropped-notification accounting without a real endpoint.

With a URL configured, batches are handed to a single background
dispatch thread (bounded queue) — the retry/backoff/timeout budget
(~(retries+1)×timeout_s at defaults) must never run inside the group
evaluation loop, where it would overrun the interval and skip ticks.
The in-process path stays synchronous (no I/O to block on, and tests
read `sent` right after an evaluation).
"""
from __future__ import annotations

import collections
import json
import queue
import threading
import time
from typing import Dict, List, Optional

from filodb_tpu_torch.utils.faults import faults

_QUEUE_MAX = 64


class WebhookNotifier:

    def __init__(self, url: str = "", retries: int = 3,
                 backoff_s: float = 0.5, timeout_s: float = 5.0,
                 sleep=time.sleep):
        self.url = url
        self.retries = max(int(retries), 0)
        self.backoff_s = backoff_s
        self.timeout_s = timeout_s
        self._sleep = sleep
        self._lock = threading.Lock()
        self._queue: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        # delivered payloads (bounded): the in-memory sink when no URL is
        # configured, and a flight recorder either way
        self.sent: collections.deque = collections.deque(maxlen=256)

    def notify(self, alerts: List[Dict]) -> bool:
        """Accept one batch of alert state changes for delivery.  URL
        mode: enqueue for the dispatch thread and return True (a full
        queue drops the batch, counted — the ruler re-notifies
        still-firing alerts whose batch never advanced their clock, or
        on the resend cadence).  In-process mode: deliver synchronously;
        a batch that exhausts its retries is DROPPED and returns False
        (counted — alert evaluation must never wedge behind a dead
        webhook; the ruler retries it next interval)."""
        if not alerts:
            return True
        payload = {"version": "4", "status": "firing", "alerts": alerts}
        if not self.url:
            return self._deliver(payload)
        with self._lock:
            if self._worker is None or not self._worker.is_alive():
                self._queue = queue.Queue(maxsize=_QUEUE_MAX)
                self._worker = threading.Thread(
                    target=self._drain, args=(self._queue,),
                    name="ruler-notify", daemon=True)
                self._worker.start()
            q = self._queue
        try:
            q.put_nowait(payload)
        except queue.Full:
            from filodb_tpu_torch.utils.metrics import registry
            registry.counter("rule_notifications_dropped").increment()
            return False
        return True

    def _drain(self, q: "queue.Queue") -> None:
        while True:
            self._deliver(q.get())

    def _deliver(self, payload: Dict) -> bool:
        """Retry with exponential backoff; exhausted batches are dropped
        and counted."""
        from filodb_tpu_torch.utils.metrics import registry
        last_err: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            if attempt:
                registry.counter("rule_notification_retries").increment()
                self._sleep(self.backoff_s * (2 ** (attempt - 1)))
            try:
                faults.fire("ruler.notify")
                if self.url:
                    self._post(payload)
                with self._lock:
                    self.sent.append(payload)
                registry.counter("rule_notifications_sent").increment()
                return True
            except Exception as e:  # noqa: BLE001 — webhook/injected faults
                last_err = e
        registry.counter("rule_notifications_dropped").increment()
        from filodb_tpu_torch.utils.metrics import log_error_once
        if last_err is not None:
            log_error_once("ruler.notify", last_err)
        return False

    def _post(self, payload: Dict) -> None:
        import urllib.request
        req = urllib.request.Request(
            self.url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        # urlopen raises HTTPError for any >= 400 status — the retry
        # loop's except catches it like a transport failure
        urllib.request.urlopen(req, timeout=self.timeout_s).close()

    def snapshot(self) -> List[Dict]:
        with self._lock:
            return list(self.sent)
