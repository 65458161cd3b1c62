"""Per-tenant (_ws_/_ns_) usage accounting + config-gated limits.

The Monarch-style operating contract for a multi-tenant TSDB: every
query and every ingest batch is attributed to the workspace/namespace
shard-key pair, accumulated both as registry counters (scraped at
/metrics, so existing dashboards see per-tenant burn) and in an
in-process table served by GET /api/v1/usage.  Limits are enforced at
the serving frontend on samples SCANNED over a rolling window:

  * warn limit — the query runs; a rate-limited log line + the
    `tenant_limit_warnings` counter fire once per window.
  * fail limit — the query is rejected with a structured
    "tenant_limit_exceeded: ..." error (the QueryError-taxonomy shape:
    clients route on the code before the colon) BEFORE any exec work.

The reference's cardinality quotas guard series CREATION
(core/ratelimit.py); this guards query-side resource burn — the two
halves of tenant isolation.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

log = logging.getLogger("filodb.usage")

TenantKey = Tuple[str, str]                 # (_ws_, _ns_)


class _Tenant:
    __slots__ = ("queries", "query_seconds", "samples_scanned",
                 "result_bytes", "ingest_samples", "rejected",
                 "win_start", "win_samples", "win_warned",
                 "ingest_rejected", "ingest_win_start", "win_ingest")

    def __init__(self):
        self.queries = 0
        self.query_seconds = 0.0
        self.samples_scanned = 0
        self.result_bytes = 0
        self.ingest_samples = 0
        self.rejected = 0
        self.win_start = time.monotonic()
        self.win_samples = 0
        self.win_warned = False
        # write-side rolling window (admit_ingest): samples OFFERED this
        # window + rejections, independent of the scan-limit window
        self.ingest_rejected = 0
        self.ingest_win_start = time.monotonic()
        self.win_ingest = 0


# tenants past the cap fold into this sentinel row: query text is
# client-controlled, so distinct (_ws_, _ns_) pairs must not grow the
# registry/accountant without bound (each pair pins counters forever)
OVERFLOW_TENANT: TenantKey = ("_overflow_", "")

# synthetic workspaces of INTERNAL subsystems (the ruler bills as
# `_rules_`, the self-scrape loop as `_self_`): accounted like any
# tenant, but exempt from the scan-limit gate — aggregation rules
# legitimately scan the whole store every interval, and self-monitoring
# must never starve itself out of its own answers; a fail limit sized
# for external tenants would break both precisely under load
INTERNAL_WORKSPACES = frozenset({"_rules_", "_self_"})


class UsageAccountant:

    MAX_TENANTS = 512

    def __init__(self, window_s: float = 60.0):
        self.window_s = window_s
        self._lock = threading.Lock()
        self._tenants: Dict[TenantKey, _Tenant] = {}

    def clear(self) -> None:
        with self._lock:
            self._tenants.clear()

    def resolve(self, ws: str, ns: str) -> TenantKey:
        """The key a (ws, ns) pair is accounted under: itself while the
        table has room, the overflow sentinel once MAX_TENANTS distinct
        pairs exist — bounding both this table and the registry's
        tenant-tagged counter cardinality against hostile query text."""
        key = (ws, ns)
        if key in self._tenants or len(self._tenants) < self.MAX_TENANTS:
            return key
        return OVERFLOW_TENANT

    def _get(self, key: TenantKey) -> _Tenant:
        t = self._tenants.get(key)
        if t is None:
            t = self._tenants.setdefault(key, _Tenant())
        return t

    def _roll(self, t: _Tenant, now: float) -> None:
        """Roll BOTH rolling windows (scan + ingest) when expired — the
        one place window state resets."""
        if now - t.win_start >= self.window_s:
            t.win_start = now
            t.win_samples = 0
            t.win_warned = False
        if now - t.ingest_win_start >= self.window_s:
            t.ingest_win_start = now
            t.win_ingest = 0

    def _retry_after(self, win_start: float, now: float) -> float:
        """Seconds until a rolling window (scan OR ingest) resets — the
        Retry-After value every 429 this accountant produces shares, so
        scan-limit rejections, ingest rejections and the scheduler's
        overload sheds all answer a compliant client identically."""
        return max(self.window_s - (now - win_start), 0.001)

    def scan_retry_after(self, ws: str, ns: str) -> float:
        """Retry-After for a scan-limit (admit) rejection: how long
        until this tenant's scan window rolls and queries admit again.
        The read-side twin of admit_ingest's return value."""
        now = time.monotonic()
        with self._lock:
            t = self._tenants.get(self.resolve(ws, ns))
            if t is None:
                return 0.001
            self._roll(t, now)
            return self._retry_after(t.win_start, now)

    # ----------------------------------------------------------- account

    def record_query(self, ws: str, ns: str, seconds: float,
                     samples_scanned: int, result_bytes: int) -> None:
        from filodb_tpu_torch.utils.metrics import registry
        now = time.monotonic()
        with self._lock:
            key = self.resolve(ws, ns)
            t = self._get(key)
            self._roll(t, now)
            t.queries += 1
            t.query_seconds += seconds
            t.samples_scanned += samples_scanned
            t.result_bytes += result_bytes
            t.win_samples += samples_scanned
        tags = {"ws": key[0], "ns": key[1]}
        registry.counter("tenant_queries", **tags).increment()
        registry.counter("tenant_query_seconds", **tags).increment(seconds)
        registry.counter("tenant_query_samples_scanned",
                         **tags).increment(samples_scanned)
        registry.counter("tenant_query_result_bytes",
                         **tags).increment(result_bytes)

    def record_ingest(self, ws: str, ns: str, samples: int,
                      dataset: str = "") -> None:
        from filodb_tpu_torch.utils.metrics import registry
        with self._lock:
            key = self.resolve(ws, ns)
            self._get(key).ingest_samples += samples
        registry.counter("tenant_ingest_samples", ws=key[0], ns=key[1],
                         dataset=dataset).increment(samples)

    # ------------------------------------------------------------ limits

    def admit(self, ws: str, ns: str, warn_limit: int,
              fail_limit: int) -> Optional[str]:
        """None to admit, else the structured rejection error.  Checked
        BEFORE execution against the tenant's rolling-window scan total;
        the query that crosses the line still runs (limits bound the
        window's cumulative burn, not predict a query's cost)."""
        if not (warn_limit or fail_limit):
            return None
        if ws in INTERNAL_WORKSPACES:
            return None
        from filodb_tpu_torch.utils.metrics import registry
        now = time.monotonic()
        with self._lock:
            ws, ns = self.resolve(ws, ns)
            t = self._get((ws, ns))
            self._roll(t, now)
            win = t.win_samples
            warn = (warn_limit and win > warn_limit and not t.win_warned)
            if warn:
                t.win_warned = True
            reject = bool(fail_limit and win > fail_limit)
            if reject:
                t.rejected += 1
        if warn and not reject:
            registry.counter("tenant_limit_warnings", ws=ws,
                             ns=ns).increment()
            log.warning(
                "tenant ws=%r ns=%r over warn limit: %d samples scanned "
                "in the current %gs window (limit %d)", ws, ns, win,
                self.window_s, warn_limit)
        if reject:
            registry.counter("tenant_limit_rejections", ws=ws,
                             ns=ns).increment()
            return (f"tenant_limit_exceeded: ws={ws!r} ns={ns!r} scanned "
                    f"{win} samples in the last {self.window_s:g}s, over "
                    f"the limit {fail_limit} — retry after the window "
                    f"rolls")
        return None

    def admit_ingest(self, ws: str, ns: str, samples: int,
                     fail_limit: int) -> Optional[float]:
        """Write-side admission at every ingest door (remote_write, the
        Influx TCP gateway, /influx): None admits `samples` and books
        them against the tenant's rolling ingest window; a float rejects
        and is the seconds until the window rolls — remote_write turns
        it into `429` + `Retry-After` (backpressure: the client re-sends,
        nothing is silently dropped).  Like the scan limits, the batch
        that CROSSES the line still lands (limits bound the window's
        cumulative offer, not predict a batch's size); everything after
        it bounces until the window resets."""
        if not fail_limit:
            return None
        if ws in INTERNAL_WORKSPACES:
            return None
        from filodb_tpu_torch.utils.metrics import registry
        now = time.monotonic()
        with self._lock:
            ws, ns = self.resolve(ws, ns)
            t = self._get((ws, ns))
            self._roll(t, now)
            if t.win_ingest > fail_limit:
                t.ingest_rejected += 1
                retry_after = self._retry_after(t.ingest_win_start, now)
            else:
                t.win_ingest += samples
                retry_after = None
        if retry_after is not None:
            registry.counter("tenant_ingest_rejections", ws=ws,
                             ns=ns).increment()
            return retry_after
        return None

    def window_samples(self, ws: str, ns: str) -> int:
        now = time.monotonic()
        with self._lock:
            t = self._tenants.get(self.resolve(ws, ns))
            if t is None:
                return 0
            self._roll(t, now)
            return t.win_samples

    # ---------------------------------------------------------- snapshot

    def snapshot(self) -> List[dict]:
        """The /api/v1/usage payload: one row per tenant, cumulative
        since process start plus the current window's scan total."""
        now = time.monotonic()
        with self._lock:
            out = []
            for (ws, ns), t in self._tenants.items():
                self._roll(t, now)
                out.append({
                    "ws": ws, "ns": ns,
                    "queries": t.queries,
                    "querySeconds": round(t.query_seconds, 6),
                    "samplesScanned": t.samples_scanned,
                    "resultBytes": t.result_bytes,
                    "ingestSamples": t.ingest_samples,
                    "rejected": t.rejected,
                    "ingestRejected": t.ingest_rejected,
                    "windowSamplesScanned": t.win_samples,
                    "windowSamplesOffered": t.win_ingest,
                })
        out.sort(key=lambda r: (-r["querySeconds"], r["ws"], r["ns"]))
        return out


# process-wide instance (frontend + shards + routes share it)
usage = UsageAccountant()


# ------------------------------------------------- tenant identification

_tenant_memo: Dict[str, TenantKey] = {}
_TENANT_MEMO_MAX = 2048


def tenant_of(promql: str) -> TenantKey:
    """(_ws_, _ns_) from the query's first vector selector's equality
    matchers ("" where absent) — the same shard-key pair the planner
    routes by.  Memoized per distinct promql string; parse failures
    attribute to the anonymous tenant (the engine surfaces the error)."""
    got = _tenant_memo.get(promql)
    if got is not None:
        return got
    ws = ns = ""
    try:
        from filodb_tpu_torch.promql import ast as A
        from filodb_tpu_torch.promql.parser import parse_query_cached
        expr = parse_query_cached(promql)
        sel = _first_selector(expr)
        if sel is not None:
            for m in sel.matchers:
                if m.op == "=" and m.name == "_ws_":
                    ws = m.value
                elif m.op == "=" and m.name == "_ns_":
                    ns = m.value
    except Exception:  # noqa: BLE001 — unparsable: anonymous tenant
        pass
    if len(_tenant_memo) > _TENANT_MEMO_MAX:
        _tenant_memo.clear()
    _tenant_memo[promql] = (ws, ns)
    return ws, ns


def _first_selector(node):
    import dataclasses as _dc

    from filodb_tpu_torch.promql import ast as A
    if isinstance(node, A.VectorSelector):
        return node
    if _dc.is_dataclass(node) and not isinstance(node, type):
        for f in _dc.fields(node):
            got = _first_selector(getattr(node, f.name))
            if got is not None:
                return got
    elif isinstance(node, (list, tuple)):
        for x in node:
            got = _first_selector(x)
            if got is not None:
                return got
    return None
