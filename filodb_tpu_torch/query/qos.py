"""Multi-tenant QoS: the weighted-fair query scheduler + read-side
load shedding + the shuffle-shard placement helper.

The frontend's original admission control was ONE global
BoundedSemaphore (query.max_concurrent_queries): fair only while every
tenant is polite.  A single abusive tenant — a dashboard storm, a
runaway notebook — fills all slots and every other tenant queues behind
it until their deadlines die (the noisy-neighbor brown-out the
reference's coordinator per-query limits exist to prevent, PAPER.md §1;
the Cortex/Thanos query-frontend fairness problem).  This module is the
fairness layer that replaces it:

  * WeightedFairScheduler — per-tenant (workspace) FIFO queues with
    configurable concurrency shares (`query.tenant_shares`, default
    equal) dispatched by deficit round robin: each round a tenant's
    deficit grows by its share and it may start floor(deficit) queries.
    Only tenants with QUEUED work participate in a round, so an idle
    tenant's share redistributes to the busy ones automatically — and a
    tenant that goes idle forfeits its banked deficit (no credit
    hoarding: returning after an idle spell earns fair share, not a
    burst).  Capacity is the same global bound as before; what changes
    is WHO gets the next free slot.
  * Adaptive read-side load shedding (the write side's
    `admit_ingest` → 429 + Retry-After stance): at
    admission the scheduler estimates this tenant's queue wait from its
    LIVE state — queued queries ahead, an EWMA of recent slot-hold
    times, the tenant's effective share of capacity — and rejects early
    with the structured `tenant_overloaded` error (HTTP 429 +
    Retry-After) when the predicted wait would blow the query's
    deadline budget, or when the tenant's queue is already at
    `query.tenant_max_queue_depth`.  A doomed query burning a queue
    slot until `query_timeout` helps nobody; a 429 with an honest
    Retry-After lets a compliant client back off.
  * `shuffle_shard_nodes` — the Cortex/Amazon shuffle-sharding
    primitive: a deterministic k-of-N node subset per tenant, so the
    replica-failover dispatcher can prefer each tenant's subset and a
    hot tenant's load lands on a bounded blast radius instead of every
    data node (replication/failover.py applies it to the owner
    lists).

Internal workspaces (`_rules_`, `_self_`) are scheduled like any tenant
but NEVER shed — the ruler and the self-monitoring loop must not be
starved out of their own standing queries precisely under the overload
they exist to observe (same exemption as the scan-limit gate).
"""
from __future__ import annotations

import collections
import hashlib
import threading
import time
from typing import Deque, Dict, List, Optional, Sequence, Tuple


# shed verdicts are structured errors (the QueryError-taxonomy shape:
# clients route on the code before the colon); http/routes maps the
# code to 429 + Retry-After exactly like the write-side ingest limits
SHED_ERROR_CODE = "tenant_overloaded"


class Admission:
    """Outcome of one WeightedFairScheduler.admit() call.

    status:
      "acquired"  — the caller holds a slot; it MUST release(ws).
      "shed"      — rejected at admission (queue full / predicted wait
                    past the deadline); `reason` + `retry_after_s` say
                    why and when to come back.  No slot held.
      "cancelled" — the request's CancellationToken flipped while it
                    waited in its tenant queue.  No slot held.
      "timeout"   — the wait bound expired without a grant (and without
                    a stamped deadline to shed against).  No slot held;
                    the frontend preserves the pre-QoS stance of running
                    such queries unthrottled rather than failing them on
                    queue pressure alone.
    `waited_s` is the time spent queued — the queue_wait_s attribution
    every outcome carries (see account()).
    """

    __slots__ = ("status", "waited_s", "retry_after_s", "reason", "ws")

    def __init__(self, status: str, waited_s: float = 0.0,
                 retry_after_s: float = 0.0, reason: str = "",
                 ws: str = ""):
        self.status = status
        self.waited_s = waited_s
        self.retry_after_s = retry_after_s
        self.reason = reason
        # the (possibly overflow-folded) workspace this admission was
        # scheduled under — callers MUST tag metrics with this, not the
        # raw client-controlled ws (cardinality defense)
        self.ws = ws

    @property
    def acquired(self) -> bool:
        return self.status == "acquired"

    def shed_error(self) -> str:
        """The structured rejection string for a shed admission."""
        why = ("tenant scheduler queue is full"
               if self.reason == "queue_full" else
               "predicted queue wait would exceed the deadline budget")
        return (f"{SHED_ERROR_CODE}: {why} (predicted wait "
                f"{self.retry_after_s:.2f}s) — retry after "
                f"{self.retry_after_s:.2f}s")


class _Waiter:
    __slots__ = ("event", "granted", "ws")

    def __init__(self, ws: str):
        self.event = threading.Event()
        self.granted = False
        self.ws = ws


class WeightedFairScheduler:
    """Deficit-round-robin admission over per-tenant queues.

    One instance guards one frontend's execution capacity (the old
    semaphore's bound).  All state lives behind one lock; grants are
    handed to waiters by flipping their per-waiter Event, so a grant
    never requires the granted thread to win a lock race (no thundering
    herd on release).
    """

    # kill reaction bound while queued: a killed request stops waiting
    # within ~50 ms and never holds the slot
    _SLICE_S = 0.05

    # ws comes from client-controlled query text: distinct workspaces
    # past this cap fold into the overflow sentinel so hostile ws churn
    # cannot grow the scheduler's tables or the tenant_queue_depth /
    # queries_shed metric cardinality without bound (the same defense —
    # and the same cap — as usage.UsageAccountant.resolve)
    MAX_TENANTS = 512

    def __init__(self, capacity: int,
                 shares: Optional[Dict[str, float]] = None,
                 default_share: float = 1.0,
                 max_queue_depth: int = 0,
                 shed_enabled: bool = True):
        self.capacity = max(int(capacity), 1)
        self.shares = {str(k): max(float(v), 1e-6)
                       for k, v in (shares or {}).items()}
        self.default_share = max(float(default_share), 1e-6)
        self.max_queue_depth = max(int(max_queue_depth), 0)
        self.shed_enabled = bool(shed_enabled)
        self._lock = threading.Lock()
        self._queues: Dict[str, Deque[_Waiter]] = {}
        self._deficit: Dict[str, float] = {}
        # round-robin visit order over tenants with queued work, the
        # visit pointer, and the tenant currently mid-visit (topped up
        # this round; stays selected while its deficit lasts — THAT is
        # what makes a share of 3 worth 3 grants per round, not 1)
        self._order: List[str] = []
        self._rr = 0
        self._visit_ws: Optional[str] = None
        self._active: Dict[str, int] = {}
        self._total_active = 0
        # every distinct ws ever scheduled (bounded by MAX_TENANTS —
        # later strangers fold into the overflow sentinel)
        self._seen: set = set()
        # EWMA of slot-hold seconds (the service-time half of the wait
        # prediction); seeded pessimistically low so a cold scheduler
        # never sheds the first burst on a guess
        self._hold_ewma_s = 0.05
        self._hold_start: Dict[int, float] = {}
        # lifetime counters for snapshot()/CLI (metrics are incremented
        # by the frontend per shed with the reason tag)
        self.shed_total: Dict[str, int] = {}
        self.granted_total = 0

    # ------------------------------------------------------------ config

    def share_of(self, ws: str) -> float:
        return self.shares.get(ws, self.default_share)

    def _fold_locked(self, ws: str) -> str:
        """The workspace a request is scheduled under: itself while the
        tenant table has room, the overflow sentinel once MAX_TENANTS
        distinct workspaces have been seen."""
        if ws in self._seen or len(self._seen) < self.MAX_TENANTS:
            self._seen.add(ws)
            return ws
        from filodb_tpu_torch.utils.usage import OVERFLOW_TENANT
        return OVERFLOW_TENANT[0]

    # --------------------------------------------------------- admission

    def admit(self, ws: str, timeout_s: float, tok=None,
              deadline_unix_s: float = 0.0) -> Admission:
        """Wait for a slot under weighted-fair dispatch, or shed.

        `tok` is the request's CancellationToken (None = unkillable);
        `deadline_unix_s` the end-to-end budget stamped at admission
        (0 = none) — the adaptive shed compares the PREDICTED queue wait
        against it before queueing at all.
        """
        from filodb_tpu_torch.utils.usage import INTERNAL_WORKSPACES
        sheddable = self.shed_enabled and ws not in INTERNAL_WORKSPACES
        with self._lock:
            ws = self._fold_locked(ws)
            q = self._queues.get(ws)
            depth = len(q) if q is not None else 0
            if sheddable and self.max_queue_depth \
                    and depth >= self.max_queue_depth:
                self.shed_total[ws] = self.shed_total.get(ws, 0) + 1
                return Admission("shed",
                                 retry_after_s=self._predict_locked(
                                     ws, depth),
                                 reason="queue_full", ws=ws)
            if sheddable and deadline_unix_s:
                predicted = self._predict_locked(ws, depth)
                if time.time() + predicted >= deadline_unix_s:
                    self.shed_total[ws] = self.shed_total.get(ws, 0) + 1
                    return Admission("shed", retry_after_s=predicted,
                                     reason="deadline", ws=ws)
            w = _Waiter(ws)
            if q is None:
                q = self._queues[ws] = collections.deque()
            if not q and ws not in self._order:
                self._order.append(ws)
            q.append(w)
            self._dispatch_locked()
        t0 = time.perf_counter()
        deadline = t0 + max(timeout_s, 0.0)
        while True:
            if w.event.wait(timeout=min(
                    self._SLICE_S, max(deadline - time.perf_counter(),
                                       0.0))):
                waited = time.perf_counter() - t0
                with self._lock:
                    self._hold_start[id(w)] = time.perf_counter()
                return Admission("acquired", waited_s=waited, ws=ws)
            cancelled = tok is not None and tok.cancelled
            expired = time.perf_counter() >= deadline
            if cancelled or expired:
                waited = time.perf_counter() - t0
                with self._lock:
                    if w.granted:
                        # grant raced the cancel/timeout: the slot was
                        # handed to us — give it straight back and let
                        # the dispatcher pass it on
                        self._release_locked(ws, id(w))
                    else:
                        self._remove_locked(ws, w)
                return Admission("cancelled" if cancelled else "timeout",
                                 waited_s=waited, ws=ws)

    def release(self, ws: str, _wid: Optional[int] = None) -> None:
        """Release one slot of `ws` — pass the Admission's `ws` (the
        folded name), which `_fold_locked` reproduces stably anyway."""
        with self._lock:
            self._release_locked(self._fold_locked(ws), _wid)

    # --------------------------------------------- internal (lock held)

    def _release_locked(self, ws: str, wid: Optional[int] = None) -> None:
        left = max(self._active.get(ws, 1) - 1, 0)
        if left:
            self._active[ws] = left
        else:
            # drop zeroed rows: _active must not accumulate one entry
            # per workspace ever seen (cardinality hygiene, like the
            # empty-queue cleanup in _forget_idle_locked)
            self._active.pop(ws, None)
        self._total_active = max(self._total_active - 1, 0)
        if wid is not None:
            t0 = self._hold_start.pop(wid, None)
        elif self._hold_start:
            # released via the public release(ws): retire the OLDEST
            # open hold (FIFO is the common case; the EWMA only needs a
            # representative sample, not exact per-query pairing)
            t0 = self._hold_start.pop(next(iter(self._hold_start)))
        else:
            t0 = None
        if t0 is not None:
            held = time.perf_counter() - t0
            self._hold_ewma_s += 0.2 * (held - self._hold_ewma_s)
        self._dispatch_locked()

    def _remove_locked(self, ws: str, w: _Waiter) -> None:
        q = self._queues.get(ws)
        if q is not None:
            try:
                q.remove(w)
            except ValueError:
                pass
            if not q:
                self._forget_idle_locked(ws)

    def _forget_idle_locked(self, ws: str) -> None:
        """A tenant whose queue drained leaves the DRR rotation AND
        forfeits its banked deficit — the share-redistribution property:
        the remaining tenants' rounds no longer visit it, and it cannot
        hoard credit while idle to burst past its share later."""
        q = self._queues.get(ws)
        if q is not None and not q:
            del self._queues[ws]
        self._deficit.pop(ws, None)
        if self._visit_ws == ws:
            self._visit_ws = None
        if ws in self._order:
            i = self._order.index(ws)
            self._order.remove(ws)
            if i < self._rr:
                self._rr -= 1
            if self._order:
                self._rr %= len(self._order)
            else:
                self._rr = 0

    def _dispatch_locked(self) -> None:
        """Grant free slots to queued waiters by deficit round robin."""
        while self._total_active < self.capacity:
            ws = self._next_locked()
            if ws is None:
                return
            w = self._queues[ws].popleft()
            if not self._queues[ws]:
                self._forget_idle_locked(ws)
            w.granted = True
            self._active[ws] = self._active.get(ws, 0) + 1
            self._total_active += 1
            self.granted_total += 1
            w.event.set()

    def _next_locked(self) -> Optional[str]:
        """Next tenant owed a grant, or None when nothing is queued.
        Classic DRR over the tenants with queued work: VISITING a
        tenant tops its deficit up by its share once; while the deficit
        covers a query (unit cost) the visit pointer STAYS on it — a
        share of 3 is worth 3 back-to-back grants per round — and only
        an exhausted deficit advances the rotation."""
        if not self._order:
            return None
        # bound the scan: every tenant's deficit grows by >= its share
        # per full round, so within ceil(1/min_share) rounds SOME
        # deficit crosses 1.0 — the 64 cap is a safety net, after which
        # we grant the largest-deficit tenant outright
        for _ in range(64 * len(self._order)):
            ws = self._order[self._rr % len(self._order)]
            if self._visit_ws != ws:
                # first touch this round: top up the quantum
                self._visit_ws = ws
                self._deficit[ws] = self._deficit.get(ws, 0.0) \
                    + self.share_of(ws)
            d = self._deficit[ws]
            if d >= 1.0:
                self._deficit[ws] = d - 1.0
                return ws
            self._visit_ws = None
            self._rr = (self._rr + 1) % len(self._order)
        ws = max(self._order, key=lambda t: self._deficit.get(t, 0.0))
        self._deficit[ws] = 0.0
        return ws

    def _predict_locked(self, ws: str, depth: int) -> float:
        """Predicted queue wait for a NEW query of `ws` from live state:
        (queries ahead + 1) service times, at the tenant's effective
        slice of capacity.  Effective share counts only tenants with
        live demand — the same redistribution the dispatcher does."""
        demand = set(self._order)
        demand.update(t for t, n in self._active.items() if n > 0)
        demand.add(ws)
        total_share = sum(self.share_of(t) for t in demand)
        eff = self.capacity * self.share_of(ws) / max(total_share, 1e-9)
        ahead = depth + self._active.get(ws, 0)
        return (ahead + 1) * self._hold_ewma_s / max(eff, 1e-3)

    # ----------------------------------------------------- observability

    def predict_wait_s(self, ws: str) -> float:
        with self._lock:
            q = self._queues.get(ws)
            return self._predict_locked(ws, len(q) if q else 0)

    def queue_depths(self) -> Dict[str, int]:
        with self._lock:
            return {ws: len(q) for ws, q in self._queues.items() if q}

    def snapshot(self) -> List[dict]:
        """Per-tenant live rows for /admin/tenants and `filo-cli
        tenants`: share, running, queued, lifetime sheds."""
        with self._lock:
            ws_set = set(self._queues) | set(self._active) \
                | set(self.shed_total) | set(self.shares)
            out = []
            for ws in sorted(ws_set):
                q = self._queues.get(ws)
                out.append({
                    "ws": ws,
                    "share": self.share_of(ws),
                    "running": self._active.get(ws, 0),
                    "queued": len(q) if q else 0,
                    "shed": self.shed_total.get(ws, 0),
                })
            return out

    def refresh_gauges(self) -> None:
        """Publish per-tenant scheduler queue depth as
        `tenant_queue_depth{ws}` — refreshed at SCRAPE time like the
        shard and active-query gauges, so the admission hot path never
        touches the metric registry."""
        from filodb_tpu_torch.utils.metrics import registry
        with self._lock:
            seen = set(self._queues) | set(self._active)
            depths = {ws: len(self._queues.get(ws) or ()) for ws in seen}
        for ws, d in depths.items():
            registry.gauge("tenant_queue_depth", ws=ws).update(d)


def account_wait(res, adm: Optional[Admission]) -> None:
    """THE admission-accounting helper: every serving outcome — ran,
    shed, killed-in-queue, timed-out-in-queue — attributes its scheduler
    wait through this one function, so the shed/killed/timeout paths can
    never drift from the happy path on queue_wait_s attribution (the
    four copy-pasted `+= waited` sites this replaced had exactly that
    failure mode)."""
    if res is not None and adm is not None:
        res.stats.queue_wait_s += adm.waited_s


# --------------------------------------------------- shuffle sharding


def shuffle_shard_nodes(tenant_ws: str, nodes: Sequence[str],
                        k: int) -> Tuple[str, ...]:
    """Deterministic k-of-N node subset for a tenant (the Cortex /
    Amazon shuffle-sharding primitive): rank every node by a stable
    hash of (tenant, node) and keep the first k.  Independent of list
    order, stable across processes (hashlib, not PYTHONHASHSEED), and
    overlapping subsets between two tenants shrink combinatorially as
    N grows — the bounded-blast-radius property."""
    uniq = sorted(set(nodes))
    if k <= 0 or k >= len(uniq):
        return tuple(uniq)
    ranked = sorted(
        uniq,
        key=lambda n: hashlib.blake2b(
            f"{tenant_ws}\x00{n}".encode(), digest_size=8).digest())
    return tuple(sorted(ranked[:k]))
