"""Deterministic fault injection — named fault points production code
calls as one-line no-ops (port of filodb_tpu/utils/faults.py, a
JAX-free copy; the port fires ingest.batch, flush.persist and
device.upload, at the reference's call sites).

The reference proves its failure handling with multi-JVM specs that kill
real actor systems (ref: standalone/src/multi-jvm/.../
IngestionAndRecoverySpec.scala); the TPU rebuild adds the complementary
in-process layer: a registry of NAMED fault points that tests (and the
chaos bench) arm with seeded, deterministic fault plans, so "node died
mid-scatter", "flush persist failing", "heartbeats delayed past the
liveness window" are unit-testable without real processes or clocks.

Catalog (the production call sites):

    transport.send    — coordinator-side dispatch, before the plan frame
                        is written (parallel/transport.py)
    transport.recv    — coordinator-side dispatch, the raw reply frame
                        (corrupt plans mutate the bytes)
    flush.persist     — background flush, before chunks are written to
                        the column store (core/shard.py)
    device.upload     — DeviceMirror full refresh (core/devicecache.py)
    ingest.batch      — shard ingest entry (core/shard.py; also covers
                        the ruler's recorded-series write-back)
    cluster.heartbeat — NodeAgent heartbeat RPC (parallel/cluster.py)
    ruler.notify      — alert webhook delivery attempt
                        (rules/notifier.py; retry/backoff chaos)
    wal.append        — WAL record framing/enqueue, before the bytes
                        reach the segment file (wal/writer.py)
    wal.fsync         — group commit, before the fsync that makes the
                        batch durable (wal/writer.py; a failure here
                        must fail every writer waiting on the group)
    wal.replay        — per decoded record during restart replay
                        (wal/replay.py; corrupt-mid-log chaos)
    objectstore.put   — shared cold-tier object upload, before the
                        bytes land (persist/objectstore.py; upload
                        retry/backoff + breaker chaos)
    objectstore.get   — object fetch (corrupt plans mutate the payload:
                        content-hash verification must catch it)
    objectstore.list  — manifest/object listing (a dead store must
                        degrade cold scans to flagged partials)

Plan kinds and how they surface at the call site:

    error   — raise InjectedFault (a ConnectionError: transport sites
              classify it exactly like a peer death)
    delay   — time.sleep(delay_s), then proceed
    drop    — raise socket.timeout: a dropped frame looks to the sender
              like no reply ever arriving, and raising the timeout AT
              the point exercises the identical handling path without
              spending the wall-clock wait
    corrupt — bytes payloads come back with deterministically-flipped
              bytes (frame decode must fail loudly, never mis-parse)

Firing is deterministic: `first_k` fires on exactly the first K calls;
`probability` draws from a Random seeded per plan — the same seed
always yields the same firing sequence.  The disabled fast path is one
falsy-dict check, so production cost is negligible.  Plans may also be
armed from the environment (FILODB_TPU_FAULTS, a JSON list of plan
objects) so a standalone node process can boot pre-faulted for chaos
runs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import random
import socket
import threading
import time
from typing import Dict, List, Optional

POINTS = frozenset({
    "transport.send", "transport.recv", "flush.persist", "device.upload",
    "ingest.batch", "cluster.heartbeat", "ruler.notify",
    "wal.append", "wal.fsync", "wal.replay",
    "objectstore.put", "objectstore.get", "objectstore.list",
})

KINDS = frozenset({"error", "delay", "drop", "corrupt"})


class InjectedFault(ConnectionError):
    """The `error` plan's exception: a ConnectionError so transport call
    sites classify an injected fault exactly like a real peer death."""


@dataclasses.dataclass
class FaultPlan:
    point: str
    kind: str
    first_k: int = 0            # fire on exactly the first K calls...
    probability: float = 0.0    # ...else per-call with this seeded chance
    seed: int = 0
    delay_s: float = 0.01
    message: str = ""
    calls: int = 0
    fired: int = 0

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(f"unknown fault point {self.point!r} "
                             f"(catalog: {sorted(POINTS)})")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(valid: {sorted(KINDS)})")
        self._rng = random.Random(self.seed)

    def should_fire(self) -> bool:
        """Advance the deterministic schedule by one call."""
        self.calls += 1
        if self.first_k > 0:
            fire = self.calls <= self.first_k
        else:
            fire = self._rng.random() < self.probability
        if fire:
            self.fired += 1
        return fire


class FaultRegistry:
    """Process-wide registry; `fire(point)` is the one-line production
    hook.  Thread-safe: the schedule advances under a lock so concurrent
    callers see one global deterministic call order."""

    def __init__(self, env: Optional[Dict[str, str]] = None):
        self._lock = threading.Lock()
        self._plans: Dict[str, FaultPlan] = {}
        spec = (env if env is not None else os.environ).get(
            "FILODB_TPU_FAULTS", "")
        if spec:
            for raw in json.loads(spec):
                self.arm(**raw)

    # ------------------------------------------------------------ arming

    def arm(self, point: str, kind: str, **kw) -> FaultPlan:
        plan = FaultPlan(point, kind, **kw)
        with self._lock:
            self._plans[point] = plan
        return plan

    def disarm(self, point: Optional[str] = None) -> None:
        with self._lock:
            if point is None:
                self._plans.clear()
            else:
                self._plans.pop(point, None)

    @contextlib.contextmanager
    def plan(self, point: str, kind: str, **kw):
        """Scoped arming for tests: the point is disarmed on exit even
        when the body raises (most arming ends in an exception path)."""
        p = self.arm(point, kind, **kw)
        try:
            yield p
        finally:
            self.disarm(point)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [{"point": p.point, "kind": p.kind, "calls": p.calls,
                     "fired": p.fired, "first_k": p.first_k,
                     "probability": p.probability, "seed": p.seed}
                    for p in self._plans.values()]

    # ------------------------------------------------------------ firing

    def fire(self, point: str, payload=None):
        """The production hook.  Disabled: returns `payload` untouched
        (one falsy-dict check).  Armed: advance the point's schedule and
        apply its plan — raise, sleep, or corrupt-and-return."""
        if not self._plans:
            return payload
        with self._lock:
            plan = self._plans.get(point)
            if plan is None or not plan.should_fire():
                return payload
        from filodb_tpu_torch.utils.metrics import registry
        registry.counter("faults_injected", point=point,
                         kind=plan.kind).increment()
        if plan.kind == "delay":
            time.sleep(plan.delay_s)
            return payload
        if plan.kind == "error":
            raise InjectedFault(plan.message
                                or f"injected fault at {point}")
        if plan.kind == "drop":
            raise socket.timeout(plan.message
                                 or f"injected drop at {point}")
        # corrupt: only meaningful for bytes payloads; flip a few bytes
        # at deterministic (seeded) positions so decode fails loudly
        if isinstance(payload, (bytes, bytearray)) and len(payload):
            buf = bytearray(payload)
            with self._lock:
                idxs = [plan._rng.randrange(len(buf))
                        for _ in range(min(4, len(buf)))]
            for i in idxs:
                buf[i] ^= 0xFF
            return bytes(buf)
        raise InjectedFault(plan.message
                            or f"injected corruption at {point} "
                               f"(non-bytes payload)")


faults = FaultRegistry()
