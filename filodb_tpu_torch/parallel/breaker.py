"""Per-peer circuit breakers for the cross-node query transport (port
of filodb_tpu/parallel/breaker.py, a JAX-free copy; the port has no
transport yet, so its registry stays empty until one uses it).

A SIGKILLed or partitioned peer makes every scatter-gather that touches
its shards serialize a connect attempt (worst case the full connect
timeout, per child, per query).  The breaker converts that into a
microsecond fail-fast: after `failure_threshold` CONSECUTIVE
shard_unavailable/connect failures to one node address the breaker
opens, `RemoteNodeDispatcher` raises the same typed `shard_unavailable`
immediately, and the partial-result / re-plan machinery engages without
ever touching the socket.  Half-open probes with exponential backoff +
jitter detect recovery: one trial dispatch is let through per open
interval; success closes the breaker, failure re-opens it with a doubled
interval (ref: the standard Nygard circuit-breaker state machine — the
reference gets the equivalent for free from akka deathwatch marking the
member down; PAPERS.md Cortex/Thanos both ship per-store-gateway
breakers).

State is observable: `breaker_state` gauges (0 closed / 1 half-open /
2 open) and `breaker_transitions` counters at /metrics, a snapshot at
GET /admin/breakers.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional

CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
_STATE_NUM = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """One peer's breaker.  Thread-safe; all transitions happen under
    the instance lock and are mirrored to the metrics registry."""

    def __init__(self, peer: str, failure_threshold: int = 3,
                 open_base_s: float = 1.0, open_max_s: float = 30.0,
                 jitter: float = 0.2):
        self.peer = peer
        self.failure_threshold = max(int(failure_threshold), 1)
        self.open_base_s = float(open_base_s)
        self.open_max_s = float(open_max_s)
        self.jitter = float(jitter)
        self._lock = threading.Lock()
        self.state = CLOSED
        self.consecutive_failures = 0
        self.open_until = 0.0
        self.opens = 0                   # total open transitions
        self.fail_fast = 0               # dispatches rejected while open
        self._backoff_s = self.open_base_s
        self._probe_inflight = False

    # ------------------------------------------------------------ events

    def allow(self) -> bool:
        """True = the dispatch may try the wire.  While open, exactly one
        caller per elapsed backoff interval is admitted as the half-open
        probe; everyone else fails fast."""
        with self._lock:
            if self.state == CLOSED:
                return True
            now = time.monotonic()
            if self.state == OPEN and now >= self.open_until:
                self._set_state(HALF_OPEN)
            if self.state == HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True
                return True
            self.fail_fast += 1
            from filodb_tpu_torch.utils.metrics import registry
            registry.counter("breaker_fail_fast",
                             peer=self.peer).increment()
            return False

    def on_success(self) -> None:
        with self._lock:
            self.consecutive_failures = 0
            self._probe_inflight = False
            self._backoff_s = self.open_base_s
            if self.state != CLOSED:
                self._set_state(CLOSED)

    def on_failure(self) -> None:
        """A shard_unavailable/connect failure (only those count: a slow
        but alive peer — dispatch_timeout — is not a dead one)."""
        with self._lock:
            self.consecutive_failures += 1
            if self.state == HALF_OPEN:
                # failed probe: re-open with a doubled interval
                self._probe_inflight = False
                self._backoff_s = min(self._backoff_s * 2, self.open_max_s)
                self._open()
            elif self.state == CLOSED and \
                    self.consecutive_failures >= self.failure_threshold:
                self._open()

    def on_abort(self) -> None:
        """The dispatch ended with NO verdict on the peer's liveness (a
        deadline/ask timeout: the peer may be alive but slow).  Closed
        breakers are untouched; an admitted half-open probe must release
        its slot — without this, a probe that times out would leak
        `_probe_inflight` and wedge the breaker half-open FOREVER (found
        by the chaos stage: recovery never healed).  An inconclusive
        probe re-opens with a doubled interval, same as a failed one —
        optimistically closing on a timeout would thunder the herd onto
        a struggling peer."""
        with self._lock:
            if self.state == HALF_OPEN and self._probe_inflight:
                self._probe_inflight = False
                self._backoff_s = min(self._backoff_s * 2, self.open_max_s)
                self._open()

    # ----------------------------------------------------------- helpers

    def _open(self) -> None:
        span = self._backoff_s
        if self.jitter > 0:
            span *= 1.0 + random.uniform(-self.jitter, self.jitter)
        self.open_until = time.monotonic() + max(span, 0.0)
        self.opens += 1
        self._set_state(OPEN)

    def _set_state(self, state: str) -> None:
        from filodb_tpu_torch.utils.metrics import registry
        if state != self.state:
            registry.counter("breaker_transitions", peer=self.peer,
                             to=state).increment()
            # the flight recorder sees every transition: "which peer
            # opened right before the partial-results spike" is one
            # GET /admin/events, correlated with slowlog by timestamp
            from filodb_tpu_torch.utils.events import journal
            journal.emit(f"breaker_{state}", subsystem="peers",
                         peer=self.peer,
                         consecutive_failures=self.consecutive_failures)
        self.state = state
        registry.gauge("breaker_state",
                       peer=self.peer).update(_STATE_NUM[state])

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "peer": self.peer,
                "state": self.state,
                "consecutiveFailures": self.consecutive_failures,
                "opens": self.opens,
                "failFast": self.fail_fast,
                "backoffSeconds": round(self._backoff_s, 3),
                "openRemainingSeconds": round(
                    max(self.open_until - time.monotonic(), 0.0), 3)
                if self.state == OPEN else 0.0,
            }


class BreakerRegistry:
    """Process-wide breakers keyed by peer address; knobs resolve from
    `settings().breaker` at first use, overridable via configure() for
    tests (which also reset() between cases)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._overrides: Optional[dict] = None

    def configure(self, **kw) -> None:
        """Override breaker knobs for subsequently-created breakers
        (failure_threshold / open_base_s / open_max_s / jitter)."""
        with self._lock:
            self._overrides = kw or None

    def reset(self) -> None:
        with self._lock:
            self._breakers.clear()

    def enabled(self) -> bool:
        from filodb_tpu_torch.config import settings
        return settings().breaker.enabled

    def get(self, peer: str) -> CircuitBreaker:
        br = self._breakers.get(peer)
        if br is None:
            with self._lock:
                br = self._breakers.get(peer)
                if br is None:
                    kw = self._overrides
                    if kw is None:
                        from filodb_tpu_torch.config import settings
                        c = settings().breaker
                        kw = dict(failure_threshold=c.failure_threshold,
                                  open_base_s=c.open_base_s,
                                  open_max_s=c.open_max_s,
                                  jitter=c.jitter)
                    br = self._breakers[peer] = CircuitBreaker(peer, **kw)
        return br

    def snapshot(self) -> List[dict]:
        with self._lock:
            brs = list(self._breakers.values())
        return [b.snapshot() for b in brs]


breakers = BreakerRegistry()
