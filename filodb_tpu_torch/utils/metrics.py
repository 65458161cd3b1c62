"""Metrics + span tracing (port of filodb_tpu/utils/metrics.py).

A process-wide registry of tagged counters/gauges/histograms with the
Prometheus and OpenMetrics text expositions (served at /metrics by the
HTTP layer), a bounded trace collector the query frontend tags with each
query's origin and verdict, and a `span()` context manager that records
durations into histograms.  Everything is thread-safe; metric lookups are
dict hits on interned (name, tags) keys.

The per-thread exec tally attributes device kernel time (by device and
kernel, fed by utils/devicetelem.record_dispatch), host->device
transfers and mirror refreshes to the exec node that triggered them, so
QueryStats.device_seconds and its per-device split reconcile with the
kernel ledger by construction.

Spans stamp the node's name on every collected event, feed the span
reporters, and stop under the `set_spans_enabled(False)` kill switch;
`FiloSchedulers` holds the thread-name assertions of the hot entry
points.
"""
from __future__ import annotations

import bisect
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

TagTuple = Tuple[Tuple[str, str], ...]


def _tags_key(tags: Dict[str, str]) -> TagTuple:
    return tuple(sorted(tags.items()))


class Counter:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def increment(self, by: float = 1.0) -> None:
        with self._lock:
            self.value += by


class Gauge:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def update(self, v: float) -> None:
        with self._lock:
            self.value = v


# log2-ish bucket boundaries, milliseconds-friendly
_DEFAULT_BOUNDS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 50, 100,
                   500, 1000, 5000, 10000, 60000)

# process-wide exemplar kill switch (config `exemplars_enabled`): when
# off, Histogram.record drops the exemplar argument on the floor so the
# per-record cost is identical to the pre-exemplar code path
EXEMPLARS_ENABLED = True


def set_exemplars_enabled(flag: bool) -> None:
    global EXEMPLARS_ENABLED
    EXEMPLARS_ENABLED = bool(flag)


class Histogram:
    __slots__ = ("bounds", "counts", "sum", "count", "max", "exemplars",
                 "_lock")

    def __init__(self, bounds: Sequence[float] = _DEFAULT_BOUNDS):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0
        # largest value ever recorded: bounds the overflow-bucket
        # percentile estimate (a 752 s p99 and a 5.1 s p99 both land in
        # the +Inf bucket; without the max they'd report identically)
        self.max = 0.0
        # bucket index -> (trace_id, value, unix_ts): the most recent
        # exemplar per bucket (the OpenMetrics bridge from a latency
        # histogram to the exact trace that caused it).  Lazily created —
        # histograms that never see an exemplar pay nothing.
        self.exemplars: Optional[Dict[int, Tuple[str, float, float]]] = None
        self._lock = threading.Lock()

    def record(self, v: float, exemplar: Optional[str] = None) -> None:
        """Record one observation.  `exemplar` is an optional trace id
        attached to the containing bucket (latest wins), emitted by the
        OpenMetrics exposition as `# {trace_id="..."} value ts` so an
        operator can jump from a latency spike straight to the trace."""
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1
            if v > self.max:
                self.max = v
            if exemplar and EXEMPLARS_ENABLED:
                if self.exemplars is None:
                    self.exemplars = {}
                self.exemplars[i] = (str(exemplar), float(v), time.time())

    # Prometheus-client parity name for the same operation
    observe = record

    def percentile(self, q: float) -> float:
        """Approximate percentile, linearly interpolated within the
        containing bucket (Prometheus histogram_quantile semantics)
        instead of reporting the bucket's upper bound.  The overflow
        (+Inf) bucket interpolates between the last finite bound and the
        maximum value observed — an explicit estimate rather than the
        old behavior of capping at the top bound."""
        with self._lock:
            if self.count == 0:
                return 0.0
            target = q * self.count
            acc = 0
            for i, c in enumerate(self.counts):
                if c == 0:
                    continue
                if acc + c >= target:
                    lo = self.bounds[i - 1] if i > 0 else 0.0
                    hi = self.bounds[i] if i < len(self.bounds) \
                        else max(self.max, self.bounds[-1])
                    frac = (target - acc) / c
                    return lo + frac * (hi - lo)
                acc += c
            return max(self.max, self.bounds[-1])


def _esc_label(v: str) -> str:
    # the exposition-format label escapes: backslash, quote, newline
    # (shared by both exposition grammars — one home, no drift)
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _fmt_tags(tags: TagTuple, extra: str = "") -> str:
    items = [f'{k}="{_esc_label(v)}"' for k, v in tags]
    if extra:
        items.append(extra)
    return "{" + ",".join(items) + "}" if items else ""


class MetricsRegistry:
    """Process-wide named+tagged metrics (ref: Kamon.counter/gauge/histogram)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, TagTuple], Counter] = {}
        self._gauges: Dict[Tuple[str, TagTuple], Gauge] = {}
        self._hists: Dict[Tuple[str, TagTuple], Histogram] = {}

    def counter(self, name: str, **tags) -> Counter:
        key = (name, _tags_key(tags))
        c = self._counters.get(key)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(key, Counter())
        return c

    def gauge(self, name: str, **tags) -> Gauge:
        key = (name, _tags_key(tags))
        g = self._gauges.get(key)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(key, Gauge())
        return g

    def histogram(self, name: str, bounds: Optional[Sequence[float]] = None,
                  **tags) -> Histogram:
        """`bounds` applies on FIRST creation of a (name, tags) series
        only (later callers get the existing histogram unchanged) — the
        default log2-ish bounds suit millisecond latencies; seconds-scale
        series (e.g. the ruler's group-eval durations) pass their own."""
        key = (name, _tags_key(tags))
        h = self._hists.get(key)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(
                    key, Histogram(bounds) if bounds else Histogram())
        return h

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    # ----------------------------------------------------- sample snapshot

    def snapshot_samples(self):
        """Every metric as (series_name, tag_tuple, value) with the
        Prometheus exposition naming — counters as `name_total`,
        histograms as cumulative `name_bucket{le=...}` + `name_sum` +
        `name_count`.  The self-scrape loop (utils/selfmon.py) ingests
        exactly this set, so PromQL written against a real /metrics
        scrape works unchanged against the self-scraped series."""
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            hists = list(self._hists.items())
        out = []
        for (name, tags), c in counters:
            out.append((f"{name}_total", tags, c.value))
        for (name, tags), g in gauges:
            out.append((name, tags, g.value))
        for (name, tags), h in hists:
            with h._lock:                  # torn-read guard, as exposition
                counts = list(h.counts)
                h_sum, h_count = h.sum, h.count
            acc = 0
            for i, b in enumerate(h.bounds):
                acc += counts[i]
                out.append((f"{name}_bucket",
                            tags + (("le", "%g" % b),), acc))
            out.append((f"{name}_bucket", tags + (("le", "+Inf"),),
                        h_count))
            out.append((f"{name}_sum", tags, h_sum))
            out.append((f"{name}_count", tags, h_count))
        return out

    # -------------------------------------------------- prometheus format

    def expose_prometheus(self) -> str:
        """Prometheus text exposition of the framework's own metrics
        (ref: Kamon prometheus reporter, README:812-819)."""
        out: List[str] = []
        fmt_tags = _fmt_tags

        # snapshot under the lock: concurrent first-seen metric creation must
        # not blow up a scrape mid-iteration
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            hists = list(self._hists.items())
        for (name, tags), c in sorted(counters):
            out.append(f"{name}_total{fmt_tags(tags)} {c.value:g}")
        for (name, tags), g in sorted(gauges):
            out.append(f"{name}{fmt_tags(tags)} {g.value:g}")
        for (name, tags), h in sorted(hists):
            # per-histogram snapshot under ITS lock: counts/sum/count
            # mutate together in record(), and reading them lock-free
            # while formatting could emit a bucket total above _count
            # (sum updated, count not yet) — a torn exposition
            with h._lock:
                counts = list(h.counts)
                h_sum, h_count = h.sum, h.count
            acc = 0
            for i, b in enumerate(h.bounds):
                acc += counts[i]
                le_tag = 'le="%g"' % b
                out.append(f"{name}_bucket{fmt_tags(tags, le_tag)} "
                           f"{acc}")
            inf_tag = 'le="+Inf"'
            out.append(f"{name}_bucket{fmt_tags(tags, inf_tag)} "
                       f"{h_count}")
            out.append(f"{name}_sum{fmt_tags(tags)} {h_sum:g}")
            out.append(f"{name}_count{fmt_tags(tags)} {h_count}")
        return "\n".join(out) + "\n"

    # -------------------------------------------------- openmetrics format

    def expose_openmetrics(self) -> str:
        """OpenMetrics 1.0 text exposition (`/metrics?format=openmetrics`):
        `# TYPE` metadata per family, canonical-float `le` values,
        counter samples under their `_total` name, per-bucket exemplars
        (`# {trace_id="..."} value ts` — the standard bridge from a
        latency histogram to the exact trace that caused it), and the
        mandatory `# EOF` terminator.  The plain Prometheus format
        (expose_prometheus) is untouched — scrapers negotiate via the
        query param, and the legacy output stays byte-identical."""
        out: List[str] = []
        fmt_tags = _fmt_tags

        def om_float(b: float) -> str:
            # canonical float form: OpenMetrics `le` values are floats,
            # never bare ints ("1.0", not "1")
            s = "%g" % b
            return s if ("." in s or "e" in s or "inf" in s) else s + ".0"

        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            hists = list(self._hists.items())

        def grouped(items):
            fams: Dict[str, list] = {}
            for (name, tags), m in sorted(items):
                fams.setdefault(name, []).append((tags, m))
            return fams

        for name, series in grouped(counters).items():
            out.append(f"# TYPE {name} counter")
            for tags, c in series:
                out.append(f"{name}_total{fmt_tags(tags)} {c.value:g}")
        for name, series in grouped(gauges).items():
            out.append(f"# TYPE {name} gauge")
            for tags, g in series:
                out.append(f"{name}{fmt_tags(tags)} {g.value:g}")
        for name, series in grouped(hists).items():
            out.append(f"# TYPE {name} histogram")
            for tags, h in series:
                with h._lock:
                    counts = list(h.counts)
                    h_sum, h_count = h.sum, h.count
                    ex = dict(h.exemplars) if h.exemplars else {}
                acc = 0
                for i, b in enumerate(h.bounds):
                    acc += counts[i]
                    le_tag = 'le="%s"' % om_float(b)
                    line = (f"{name}_bucket{fmt_tags(tags, le_tag)} "
                            f"{acc}")
                    out.append(line + _om_exemplar(ex.get(i)))
                inf_tag = 'le="+Inf"'
                line = (f"{name}_bucket{fmt_tags(tags, inf_tag)} "
                        f"{h_count}")
                out.append(line + _om_exemplar(ex.get(len(h.bounds))))
                out.append(f"{name}_sum{fmt_tags(tags)} {h_sum:g}")
                out.append(f"{name}_count{fmt_tags(tags)} {h_count}")
        out.append("# EOF")
        return "\n".join(out) + "\n"


def _om_exemplar(ex) -> str:
    """One bucket's exemplar suffix, or "" (OpenMetrics exemplar syntax:
    ` # {trace_id="..."} value timestamp`)."""
    if not ex:
        return ""
    tid, v, ts = ex
    tid = str(tid).replace("\\", "").replace('"', "").replace("\n", "")
    return f' # {{trace_id="{tid}"}} {v:g} {ts:.3f}'


registry = MetricsRegistry()


# ----------------------------------------------------- exec resource tally

class _ExecTally(threading.local):
    """Per-thread accumulators attributing device time, host→device
    transfer, and mirror-refresh events to the exec node that triggered
    them (the Kamon-context analogue for QueryStats attribution).

    Protocol: ExecPlan.execute_internal snapshots + zeroes the fields on
    entry, folds whatever its own work accumulated into its QueryStats on
    exit, then restores the outer values — so a parent node never
    re-claims what a child already attributed (child contributions arrive
    via QueryStats.merge instead).  `child_wall` carries nested nodes'
    wall seconds up, letting each node compute its EXCLUSIVE cpu time."""

    def __init__(self):
        self.child_wall = 0.0
        self.device_s = 0.0
        self.transfer_s = 0.0
        self.transfer_bytes = 0
        self.mirror_full = 0
        self.mirror_incremental = 0
        # (device, kernel) -> [seconds, count]: the per-device, per-kernel
        # split of device_s (device telemetry) — same snapshot /
        # restore protocol, folded into QueryStats.device_calls
        self.device_calls: Dict[Tuple[str, str], List[float]] = {}

    def snapshot(self):
        s = (self.child_wall, self.device_s, self.transfer_s,
             self.transfer_bytes, self.mirror_full, self.mirror_incremental,
             self.device_calls)
        self.child_wall = 0.0
        self.device_s = 0.0
        self.transfer_s = 0.0
        self.transfer_bytes = 0
        self.mirror_full = 0
        self.mirror_incremental = 0
        self.device_calls = {}
        return s

    def restore(self, snap, total_wall: float) -> None:
        (self.child_wall, self.device_s, self.transfer_s,
         self.transfer_bytes, self.mirror_full,
         self.mirror_incremental, self.device_calls) = snap
        self.child_wall += total_wall


exec_tally = _ExecTally()


def note_device_time(seconds: float) -> None:
    """Attribute device dispatch/kernel wall time to the current node."""
    exec_tally.device_s += seconds


def note_device_call(device: str, kernel: str, seconds: float) -> None:
    """Attribute one device kernel dispatch to the current node, split by
    (device, kernel) — the sum over entries equals what note_device_time
    alone would have accumulated, so QueryStats.device_seconds and the
    per-device breakdown reconcile by construction."""
    exec_tally.device_s += seconds
    cell = exec_tally.device_calls.get((device, kernel))
    if cell is None:
        exec_tally.device_calls[(device, kernel)] = [seconds, 1]
    else:
        cell[0] += seconds
        cell[1] += 1


def note_transfer(nbytes: int, seconds: float) -> None:
    """Attribute a host→device (or wire) transfer to the current node."""
    exec_tally.transfer_bytes += int(nbytes)
    exec_tally.transfer_s += seconds


def note_mirror_refresh(kind: str) -> None:
    """kind: 'full' | 'incremental' — query-path mirror uploads, so
    QueryStats can say WHICH query paid for a rebuild."""
    if kind == "full":
        exec_tally.mirror_full += 1
    else:
        exec_tally.mirror_incremental += 1


# ------------------------------------------------------------------ spans

SpanReporter = Callable[[str, float, Dict[str, str]], None]
_reporters: List[SpanReporter] = []
_active = threading.local()

# process-wide span kill switch (measures the span pipeline's own cost by
# turning it off); the exec tallies are not affected, only the
# histogram, trace and reporter work is skipped
SPANS_ENABLED = True


def set_spans_enabled(flag: bool) -> None:
    global SPANS_ENABLED
    SPANS_ENABLED = bool(flag)

# node identity stamped on every collected span event (a composition
# root sets it at startup) so a stitched cross-node trace shows placement
NODE_NAME = ""


class TraceCollector:
    """Bounded per-trace span-event buffer — the Zipkin-reporter analogue
    of the reference's Kamon span pipeline (ref: ExecPlan.scala:102-131
    Kamon spans around doExecute; KamonLogger.scala:16-40).  Remote nodes
    ship their events back with the query reply (parallel/transport), so
    `trace(tid)` returns ONE stitched cross-node trace."""

    def __init__(self, max_traces: int = 256, max_events: int = 512):
        import collections as _collections
        self.max_traces = max_traces
        self.max_events = max_events
        self._traces: Dict[str, List[dict]] = {}
        self._order: List[str] = []
        # trace -> origin tag (query | rule_eval | remote_write), set by
        # the doors; /admin/traces?origin= filters on it
        self._origins: Dict[str, str] = {}
        # trace -> final verdict (completed | killed | deadline | error),
        # set by the query frontend at completion; /admin/traces/<id>
        # carries it so "how did this query end" needs no slowlog join
        self._verdicts: Dict[str, str] = {}
        # ids evicted from the bounded ring: /traces/{id} answers "410
        # gone" (the trace existed, the ring recycled it) instead of a
        # 404 indistinguishable from a typo.  Bounded itself so hostile
        # churn cannot grow it without bound.
        self._evicted = _collections.deque(maxlen=max(4 * max_traces, 64))
        self._evicted_set: set = set()
        self._lock = threading.Lock()
        # push-export hooks (utils/traceexport.TraceExporter): called
        # outside the lock with every recorded event; must not block
        self._sinks: List = []

    def add_sink(self, sink) -> None:
        self._sinks.append(sink)

    def remove_sink(self, sink) -> None:
        if sink in self._sinks:
            self._sinks.remove(sink)

    def record(self, trace_id: str, event: Optional[dict]) -> None:
        """Record one span event (event=None registers the trace id in
        the ring without an event — the doors tag origins before their
        first span exits)."""
        evicted = 0
        with self._lock:
            evs = self._traces.get(trace_id)
            if evs is None:
                evs = self._traces[trace_id] = []
                self._order.append(trace_id)
                while len(self._order) > self.max_traces:
                    old = self._order.pop(0)
                    self._traces.pop(old, None)
                    self._origins.pop(old, None)
                    self._verdicts.pop(old, None)
                    if old in self._evicted_set:
                        # a re-registered-then-re-evicted id: refresh
                        # its position instead of duplicating it (a
                        # duplicate would let the rotation discard the
                        # set entry while a deque copy remains, turning
                        # a promised 410 into a 404).  O(n) on a small
                        # bounded deque, and only on this rare path.
                        try:
                            self._evicted.remove(old)
                        except ValueError:
                            pass
                    elif len(self._evicted) == self._evicted.maxlen:
                        self._evicted_set.discard(self._evicted[0])
                    self._evicted.append(old)
                    self._evicted_set.add(old)
                    evicted += 1
            if event is not None and len(evs) < self.max_events:
                evs.append(event)
        if evicted:
            registry.counter("trace_evictions").increment(evicted)
        if event is not None:
            for sink in list(self._sinks):
                # a sink that raises never blocks the recording path (the
                # reference lets it propagate into the span's exit)
                try:
                    sink(trace_id, event)
                except Exception as e:  # noqa: BLE001 — export is best-effort
                    log_error_once("trace.sink", e)

    def note_origin(self, trace_id: str, origin: str) -> None:
        """Tag a trace with its door (query | rule_eval | remote_write).
        The doors tag BEFORE their first span exits, so an unknown id is
        registered in the ring (empty event list) rather than dropped —
        the origins map shares the ring's bound either way."""
        if not trace_id or not origin:
            return
        with self._lock:
            if trace_id in self._traces:
                self._origins[trace_id] = origin
                return
        # register through record()'s eviction bookkeeping, then tag
        self.record(trace_id, None)
        with self._lock:
            if trace_id in self._traces:
                self._origins[trace_id] = origin

    def note_verdict(self, trace_id: str, verdict: str) -> None:
        """Tag a trace with its query's final verdict (completed |
        killed | deadline | error).  Only known ids are tagged — a
        verdict for an evicted trace would re-register it for nothing."""
        if not trace_id or not verdict:
            return
        with self._lock:
            if trace_id in self._traces:
                self._verdicts[trace_id] = verdict

    def verdict(self, trace_id: str) -> str:
        with self._lock:
            return self._verdicts.get(trace_id, "")

    def was_evicted(self, trace_id: str) -> bool:
        with self._lock:
            return trace_id in self._evicted_set \
                and trace_id not in self._traces

    def trace(self, trace_id: str) -> List[dict]:
        with self._lock:
            return list(self._traces.get(trace_id, ()))

    def take(self, trace_id: str) -> List[dict]:
        """Drain the trace's events (used by the node query server: each
        dispatch reply carries exactly the events recorded since the last
        one, so the coordinator's merge never duplicates)."""
        with self._lock:
            evs = self._traces.get(trace_id)
            if not evs:
                return []
            out = list(evs)
            evs.clear()
            return out

    def trace_ids(self, origin: str = "", limit: int = 0) -> List[str]:
        """Known ids, oldest first.  `origin` filters to one door's
        traces; `limit` keeps the newest N."""
        with self._lock:
            if origin:
                ids = [t for t in self._order
                       if self._origins.get(t) == origin]
            else:
                ids = list(self._order)
        return ids[-limit:] if limit > 0 else ids


collector = TraceCollector()


# ------------------------------------------------------- W3C traceparent

# the W3C Trace Context header: 00-<32 hex trace id>-<16 hex span id>-<flags>
_TRACEPARENT_RE = None


def parse_traceparent(header: Optional[str]) -> Optional[str]:
    """Extract the 32-hex trace id from a `traceparent` request header
    (W3C Trace Context).  Returns None for missing/malformed headers and
    for the all-zero (invalid) trace id — the caller mints its own."""
    global _TRACEPARENT_RE
    if not header:
        return None
    if _TRACEPARENT_RE is None:
        import re as _re
        _TRACEPARENT_RE = _re.compile(
            r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if not m or m.group(1) == "ff":
        return None
    tid = m.group(2)
    if tid == "0" * 32 or m.group(3) == "0" * 16:
        return None
    return tid


def make_traceparent(trace_id: str) -> str:
    """Format a trace id as an outgoing `traceparent` header (a fresh
    16-hex span id per call; non-32-hex internal ids are hashed into
    shape, matching the trace-export normalization)."""
    import uuid as _uuid
    tid = str(trace_id).replace("-", "").lower()
    if len(tid) != 32 or any(c not in "0123456789abcdef" for c in tid):
        tid = _uuid.uuid5(_uuid.NAMESPACE_OID, str(trace_id)).hex
    return f"00-{tid}-{_uuid.uuid4().hex[:16]}-01"


def mint_trace_id() -> str:
    """A fresh W3C-shaped (32 lower hex) trace id for a request that
    arrived without one."""
    import uuid as _uuid
    return _uuid.uuid4().hex


class trace_context:
    """Bind a trace id to this thread for the duration; spans entered
    inside feed TraceCollector under it.  Re-entrant (restores the outer
    id), so a node executing a dispatched subtree nests cleanly."""

    def __init__(self, trace_id: str):
        self.trace_id = trace_id

    def __enter__(self):
        self._prev = getattr(_active, "trace_id", None)
        _active.trace_id = self.trace_id
        return self

    def __exit__(self, exc_type, exc, tb):
        _active.trace_id = self._prev
        return False


def current_trace_id():
    return getattr(_active, "trace_id", None)


def add_span_reporter(rep: SpanReporter) -> None:
    """Call `rep(dotted_name, seconds, tags)` at the end of every span
    (ref: KamonSpanLogReporter, KamonLogger.scala:16-40)."""
    _reporters.append(rep)


def remove_span_reporter(rep: SpanReporter) -> None:
    if rep in _reporters:
        _reporters.remove(rep)


class span:
    """Duration-recording span (ref: Kamon.spanBuilder threaded through
    ExecPlan.execute / startODPSpan).  Nesting is tracked per thread so
    reporters see parent names dotted in."""

    def __init__(self, name: str, **tags: str):
        self.name = name
        self.tags = tags

    def __enter__(self):
        if not SPANS_ENABLED:
            self._t0 = None
            return self
        stack = getattr(_active, "stack", None)
        if stack is None:
            stack = _active.stack = []
        stack.append(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._t0 is None:
            return False
        elapsed = time.perf_counter() - self._t0
        stack = _active.stack
        full = ".".join(stack)
        stack.pop()
        tid = current_trace_id()
        # the active trace id doubles as the span histogram's exemplar,
        # so every span_*_seconds family carries OpenMetrics exemplars
        # for free (histogram spike -> /admin/traces/<id> in one hop)
        registry.histogram(f"span_{self.name}_seconds",
                           **self.tags).record(elapsed, exemplar=tid)
        if tid:
            collector.record(tid, {
                "span": full, "dur_s": round(elapsed, 6),
                "end_unix_s": round(time.time(), 3),
                "node": NODE_NAME, **self.tags})
        for rep in _reporters:
            rep(full, elapsed, self.tags)
        return False


# ----------------------------------------------------- scheduler asserts


class FiloSchedulers:
    """Thread-name assertions on hot entry points (ref:
    core/.../memstore/FiloSchedulers.scala:14-20, gated by
    filodb.scheduler.enable-assertions)."""

    enabled = False
    INGEST = "ingest"
    QUERY = "query"
    FLUSH = "flush"

    @staticmethod
    def assert_thread_name(fragment: str) -> None:
        if not FiloSchedulers.enabled:
            return
        name = threading.current_thread().name
        assert fragment in name, \
            f"expected thread name containing {fragment!r}, got {name!r}"


_error_last: Dict[str, float] = {}


def log_error_once(where: str, exc: BaseException,
                   min_interval_s: float = 300.0,
                   logger_name: str = "filodb") -> None:
    """Log a swallowed optimization-path exception once per (site, error
    class), rate-limited — the general form of log_fused_degradation for
    paths whose failures otherwise vanish into a bare counter (e.g. the
    device mirror's incremental-refresh fallback).  A new error CLASS at
    the same site always logs immediately, so a regression that changes
    failure mode is visible even inside the rate window.

    Every call — logged or rate-suppressed — also increments
    `suppressed_errors_total{site,class}`, so swallowed
    optimization-path errors are visible at /metrics and alertable via
    the self-scrape loop, not only greppable in logs."""
    registry.counter("suppressed_errors",
                     **{"site": where,
                        "class": type(exc).__name__}).increment()
    key = f"{where}:{type(exc).__name__}"
    now = time.monotonic()
    if now - _error_last.get(key, -1e9) >= min_interval_s:
        _error_last[key] = now
        logging.getLogger(logger_name).warning(
            "%s suppressed (optimization path fell back): %s: %s",
            where, type(exc).__name__, exc)
