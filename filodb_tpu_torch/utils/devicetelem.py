"""Process-wide device telemetry: the per-card kernel ledger, the HBM
occupancy model and kernel-library build observability (port of
filodb_tpu/utils/devicetelem.py for torch devices).

  - **kernel dispatch ledger** — every fused or gathered device call
    records a bounded ring entry {kernel, shape signature, device, wall
    seconds, bytes in/out, origin trace id} plus per-device cumulative
    counters.  Call sites (query/fusedbatch.py, query/leafexec.py,
    core/devicecache.py) report through `record_dispatch`, which also
    feeds the per-thread exec tally, so QueryStats.device_seconds and
    the ledger's per-query sum reconcile by construction.  A CUDA launch
    returns before the kernel runs: a call site's seconds run from its
    launch through the synchronizing readback where it has one (the
    fused calls), and are enqueue time where it has none (the mirror
    gather), as in the reference.
  - **HBM occupancy model** — the device mirrors book their device bytes
    through `hbm_book(device, region, ±n)` (region `hot`; the cold
    segment region, core/devicecache.ColdSegmentCache, `cold`), exposed as
    `device_hbm_booked_bytes{device,region}` gauges with a journaled
    `device_hbm_high_water` timeline.  The model books what the port
    holds; the caching allocator reserves more.
  - **compile events** — where the reference counts jit trace-cache
    misses, the port counts kernel-library builds: ops/kernels.py
    journals each nvcc build of a csrc/ source (`record_compile`,
    journal kind `jit_compile`, the reference's, so the health model's
    compile-storm verdict reads it unchanged), and `watched_call` around
    `kernels.library` counts every other call as a cache `hit`.

Device labels are `str(torch.device)`: `cuda:0`, `cpu` (the reference's
are JAX device names such as `TPU_0`).

Surfaces: `GET /admin/devices` and the `device` subsystem of
utils/health.HealthEvaluator; everything lands in the plain metrics
registry as well.  The `set_enabled(False)` kill switch skips
ledger/metrics/span work but never the exec-tally feed: stats
correctness is not optional.
"""
from __future__ import annotations

import collections
import math
import threading
import time
from typing import Dict, List, Optional

from filodb_tpu_torch.utils import metrics as _metrics
from filodb_tpu_torch.utils.metrics import (collector, current_trace_id,
                                            log_error_once,
                                            note_device_call, registry)

# process-wide kill switch (a benchmark measures the ledger's own
# overhead by toggling this off).  The exec-tally feed in
# record_dispatch is NOT affected — only ring/metrics/span work.
TELEM_ENABLED = True


def set_enabled(flag: bool) -> None:
    global TELEM_ENABLED
    TELEM_ENABLED = bool(flag)


# utilization EWMA time constant: busy-seconds folded against a 30 s
# horizon, so a chip pegged for 30 s reads ~1.0 and an idle chip decays
# visibly within a dashboard refresh or two
EWMA_TAU_S = 30.0

# ring default — ~512 entries x ~200 B each keeps the ledger under
# ~100 KiB regardless of query rate
DEFAULT_MAX_ENTRIES = 512

# journal a device_hbm_high_water event only when the per-device total
# grows by at least this much (or 5% of the previous high water) — an
# occupancy TIMELINE, not a per-booking firehose
_HIGH_WATER_MIN_STEP = 1 << 20


def _dev_key(device) -> str:
    """Stable label value for a device: a torch.device stringifies to
    e.g. 'cuda:0' / 'cpu', None means 'the default device'."""
    if device is None:
        return "default"
    return str(device)


class _DeviceState:
    """Per-device cumulative counters behind the telemetry lock."""

    __slots__ = ("dispatches", "busy_s", "bytes_in", "bytes_out",
                 "compiles", "compile_s", "util_ewma", "last_unix_s",
                 "kernels", "handles")

    def __init__(self):
        self.dispatches = 0
        self.busy_s = 0.0
        self.bytes_in = 0
        self.bytes_out = 0
        self.compiles = 0
        self.compile_s = 0.0
        self.util_ewma = 0.0
        self.last_unix_s = 0.0
        self.kernels: Dict[str, List[float]] = {}   # kernel -> [count, s]
        # kernel -> cached registry handles: re-resolving a tagged metric
        # per dispatch (kwargs dict + sorted tag tuple + registry lookup,
        # x5 metrics) dominated the ledger's tax on the hot dispatch path
        self.handles: Dict[str, tuple] = {}

    def fold_busy(self, seconds: float, now: float) -> None:
        """Utilization EWMA: decay by the gap since the last dispatch,
        then fold this dispatch's busy fraction in.  Approximates
        busy-seconds-per-wall-second over an EWMA_TAU_S horizon, clamped
        to 1.0 (overlapping dispatches can momentarily exceed it)."""
        if self.last_unix_s > 0.0:
            dt = max(now - self.last_unix_s, 0.0)
            self.util_ewma *= math.exp(-dt / EWMA_TAU_S)
        self.util_ewma = min(self.util_ewma + seconds / EWMA_TAU_S, 1.0)
        self.last_unix_s = now


class DeviceTelemetry:
    """The process-wide device telemetry hub (module global `telem`).

    Never raises toward a dispatch path: any internal failure is
    swallowed through metrics.log_error_once, because a broken ledger
    must not break queries."""

    def __init__(self, max_entries: int = DEFAULT_MAX_ENTRIES):
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=max_entries)
        self._seq = 0
        self._devices: Dict[str, _DeviceState] = {}
        # device -> region -> bytes (the HBM occupancy model) + the
        # journaled per-device high-water mark
        self._hbm: Dict[str, Dict[str, int]] = {}
        self._high_water: Dict[str, int] = {}
        # (kernel, event) -> Counter, resolved once (hot: warm 'hit's)
        self._cache_event_counters: Dict[tuple, object] = {}

    # ------------------------------------------------------------ ledger

    def record_dispatch(self, kernel: str, device=None, shape: str = "",
                        seconds: float = 0.0, bytes_in: int = 0,
                        bytes_out: int = 0, kind: str = "kernel",
                        origin: Optional[str] = None,
                        note: bool = True) -> None:
        """One device call.  kind: 'kernel' (fused/general dispatches,
        feeds QueryStats.device_seconds parity when note=True) |
        'transfer' (mirror uploads / cold page-ins; stats attribution
        already handled by note_transfer, so note=False there) |
        'compile' (via record_compile).  `origin` defaults to the
        current trace id, tying every entry to the query that paid."""
        dev = _dev_key(device)
        if note and kind == "kernel":
            # the stats feed is unconditional — QueryStats.device_seconds
            # must not change when the ledger is toggled off
            note_device_call(dev, kernel, seconds)
        if not TELEM_ENABLED:
            return
        try:
            if origin is None:
                origin = current_trace_id() or ""
            now = time.time()
            st = self._devices.get(dev)
            if st is None:
                with self._lock:
                    st = self._devices.setdefault(dev, _DeviceState())
            h = st.handles.get(kernel)
            if h is None:
                # resolved once per (device, kernel), outside the telem
                # lock (registry has its own); a rare duplicate resolve
                # under a race lands on the same underlying metrics
                h = (registry.counter("device_kernel_dispatches",
                                      device=dev, kernel=kernel),
                     registry.counter("device_busy_seconds", device=dev),
                     registry.gauge("device_util_ewma", device=dev),
                     registry.counter("device_kernel_bytes", device=dev,
                                      dir="in"),
                     registry.counter("device_kernel_bytes", device=dev,
                                      dir="out"),
                     registry.histogram("span_kernel_dispatch_seconds",
                                        kernel=kernel))
                st.handles[kernel] = h
            with self._lock:
                self._seq += 1
                self._ring.append({
                    "seq": self._seq, "kind": kind, "kernel": kernel,
                    "device": dev, "shape": shape,
                    "seconds": round(seconds, 6),
                    "bytes_in": int(bytes_in),
                    "bytes_out": int(bytes_out),
                    "origin": origin, "unix_s": round(now, 3),
                })
                st.dispatches += 1
                st.bytes_in += int(bytes_in)
                st.bytes_out += int(bytes_out)
                if kind == "kernel":
                    st.busy_s += seconds
                    st.fold_busy(seconds, now)
                    cell = st.kernels.get(kernel)
                    if cell is None:
                        st.kernels[kernel] = [1, seconds]
                    else:
                        cell[0] += 1
                        cell[1] += seconds
                elif kind == "compile":
                    st.compiles += 1
                    st.compile_s += seconds
                util = st.util_ewma
            h[0].increment()
            if bytes_in:
                h[3].increment(bytes_in)
            if bytes_out:
                h[4].increment(bytes_out)
            if kind == "kernel":
                h[1].increment(seconds)
                h[2].update(util)
                # span event on the live trace: the kernel shows
                # up inside the query's timeline with device tags, and
                # span_kernel_dispatch_seconds carries the exemplar
                h[5].record(seconds, exemplar=origin or None)
                if origin:
                    collector.record(origin, {
                        "span": "kernel_dispatch",
                        "dur_s": round(seconds, 6),
                        "end_unix_s": round(now, 3),
                        "node": _metrics.NODE_NAME, "device": dev,
                        "kernel": kernel, "shape": shape})
        except Exception as exc:  # noqa: BLE001 — never break a dispatch
            log_error_once("devicetelem.record_dispatch", exc)

    # ---------------------------------------------------------- compiles

    def record_compile(self, kernel: str, shape: str = "",
                       seconds: float = 0.0, device=None,
                       cache_size: int = -1,
                       origin: Optional[str] = None) -> None:
        """A compile observed when it happens: in the port one nvcc
        build of a kernel library (ops/kernels.finish_builds), with its
        wall seconds.  Attributable to the query that paid it (origin,
        the current trace id) and to the source it built."""
        try:
            registry.counter("jit_compile_events", fn=kernel).increment()
            # compiles run seconds-scale, not ms — explicit bounds
            registry.histogram(
                "jit_compile_seconds",
                bounds=(0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10,
                        25, 60, 120),
                kernel=kernel).record(seconds, exemplar=origin
                                      or current_trace_id())
            if cache_size >= 0:
                registry.gauge("jit_cache_entries",
                               fn=kernel).update(cache_size)
            from filodb_tpu_torch.utils.events import journal
            journal.emit("jit_compile", subsystem="device", kernel=kernel,
                         shape=shape, seconds=round(seconds, 3),
                         origin=origin or current_trace_id() or "")
        except Exception as exc:  # noqa: BLE001
            log_error_once("devicetelem.record_compile", exc)
        self.record_dispatch(kernel, device=device, shape=shape,
                             seconds=seconds, kind="compile",
                             origin=origin, note=False)

    def record_cache_event(self, kernel: str, event: str) -> None:
        """Library-cache traffic: event = 'hit' | 'miss' | 'evict'.
        Handle-cached: 'hit' fires once per warm library call."""
        if not TELEM_ENABLED:
            return
        try:
            key = (kernel, event)
            c = self._cache_event_counters.get(key)
            if c is None:
                c = self._cache_event_counters.setdefault(
                    key, registry.counter("jit_cache_events",
                                          kernel=kernel, event=event))
            c.increment()
        except Exception as exc:  # noqa: BLE001
            log_error_once("devicetelem.record_cache_event", exc)

    # ----------------------------------------------------- HBM occupancy

    def hbm_book(self, device, region: str, delta: int) -> None:
        """Fold a booking delta into the per-device, per-region occupancy
        model.  Regions: 'hot' (live shard mirrors) and 'cold'
        (ColdSegmentCache pages); the reference's 'planmats' has no
        booking in the port.  Gauges clamp at zero — release races round
        down, never negative."""
        if not delta:
            return
        try:
            dev = _dev_key(device)
            with self._lock:
                regions = self._hbm.setdefault(dev, {})
                regions[region] = max(regions.get(region, 0) + int(delta),
                                      0)
                booked = regions[region]
                total = sum(regions.values())
                high = self._high_water.get(dev, 0)
                new_high = total > high + max(
                    _HIGH_WATER_MIN_STEP, int(high * 0.05))
                if new_high:
                    self._high_water[dev] = total
            registry.gauge("device_hbm_booked_bytes", device=dev,
                           region=region).update(booked)
            if new_high:
                registry.gauge("device_hbm_high_water_bytes",
                               device=dev).update(total)
                from filodb_tpu_torch.utils.events import journal
                journal.emit("device_hbm_high_water", subsystem="device",
                             device=dev, bytes=total, region=region)
        except Exception as exc:  # noqa: BLE001
            log_error_once("devicetelem.hbm_book", exc)

    def hbm_set(self, device, region: str, nbytes: int) -> None:
        """Absolute variant of hbm_book for callers that track their own
        totals (set-to-current instead of delta arithmetic)."""
        try:
            dev = _dev_key(device)
            with self._lock:
                cur = self._hbm.get(dev, {}).get(region, 0)
            self.hbm_book(device, region, int(nbytes) - cur)
        except Exception as exc:  # noqa: BLE001
            log_error_once("devicetelem.hbm_set", exc)

    def hbm_booked(self, device, region: Optional[str] = None) -> int:
        dev = _dev_key(device)
        with self._lock:
            regions = self._hbm.get(dev, {})
            if region is not None:
                return regions.get(region, 0)
            return sum(regions.values())

    # ----------------------------------------------------------- queries

    def register_devices(self, devices=None) -> None:
        """Pre-register the local cards so /admin/devices lists every
        device (zeroed) before the first dispatch lands.  None: every
        CUDA device torch sees (`torch.cuda.device_count()`, each checked
        with `get_device_properties`)."""
        try:
            if devices is None:
                import torch
                devices = []
                if torch.cuda.is_available():
                    for i in range(torch.cuda.device_count()):
                        torch.cuda.get_device_properties(i)
                        devices.append(torch.device("cuda", i))
            with self._lock:
                for d in devices:
                    self._devices.setdefault(_dev_key(d), _DeviceState())
        except Exception as exc:  # noqa: BLE001
            log_error_once("devicetelem.register_devices", exc)

    def recent(self, limit: int = 50, device: str = "",
               kind: str = "") -> List[dict]:
        """Newest-first ledger entries, optionally filtered."""
        with self._lock:
            entries = list(self._ring)
        out = []
        for e in reversed(entries):
            if device and e["device"] != device:
                continue
            if kind and e["kind"] != kind:
                continue
            out.append(dict(e))
            if len(out) >= limit:
                break
        return out

    def snapshot(self, recent: int = 10) -> dict:
        """The /admin/devices payload: per-chip table + recent ledger."""
        with self._lock:
            now = time.time()
            devices = {}
            for dev, st in sorted(self._devices.items()):
                ewma = st.util_ewma
                if st.last_unix_s > 0.0:
                    # decay to NOW, not to the last dispatch — an idle
                    # chip must read idle without waiting for traffic
                    ewma *= math.exp(
                        -max(now - st.last_unix_s, 0.0) / EWMA_TAU_S)
                kern = sorted(st.kernels.items(),
                              key=lambda kv: -kv[1][1])
                devices[dev] = {
                    "dispatches": st.dispatches,
                    "busySeconds": round(st.busy_s, 6),
                    "utilEwma": round(ewma, 4),
                    "bytesIn": st.bytes_in,
                    "bytesOut": st.bytes_out,
                    "compiles": st.compiles,
                    "compileSeconds": round(st.compile_s, 3),
                    "lastDispatchUnixSeconds": round(st.last_unix_s, 3),
                    "hbm": dict(self._hbm.get(dev, {})),
                    "hbmHighWaterBytes": self._high_water.get(dev, 0),
                    "kernels": {k: {"count": int(c), "seconds":
                                    round(s, 6)} for k, (c, s) in kern},
                }
            # HBM-only devices (booked but never dispatched to) still
            # belong in the table — occupancy without traffic is exactly
            # the case an operator needs to see
            for dev, regions in sorted(self._hbm.items()):
                if dev not in devices and any(regions.values()):
                    devices[dev] = {
                        "dispatches": 0, "busySeconds": 0.0,
                        "utilEwma": 0.0, "bytesIn": 0, "bytesOut": 0,
                        "compiles": 0, "compileSeconds": 0.0,
                        "lastDispatchUnixSeconds": 0.0,
                        "hbm": dict(regions),
                        "hbmHighWaterBytes": self._high_water.get(dev, 0),
                        "kernels": {},
                    }
            ring = [dict(e) for e in
                    list(self._ring)[-max(recent, 0):]][::-1]
        return {"devices": devices, "recent": ring,
                "ledgerSeq": self._seq,
                "ledgerCapacity": self._ring.maxlen,
                "enabled": TELEM_ENABLED}

    def clear(self) -> None:
        """Test isolation: reset every table (NOT the metrics registry)."""
        with self._lock:
            self._ring.clear()
            self._seq = 0
            self._devices.clear()
            self._hbm.clear()
            self._high_water.clear()


telem = DeviceTelemetry()


def watched_call(kernel: str, call, shape: str = "", device=None):
    """Run `call()` — ops/kernels.py's library load, which returns
    (library, built) — and count a call that found its library already
    built as a cache `hit`.  A call that had to build it was journaled as
    a compile by the build itself (ops/kernels.finish_builds, with the
    nvcc wall seconds), the port's counterpart of the reference's jit
    trace-cache growth.  Returns the library."""
    res, built = call()
    if TELEM_ENABLED and not built:
        telem.record_cache_event(kernel, "hit")
    return res
