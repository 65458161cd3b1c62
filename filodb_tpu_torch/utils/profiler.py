"""Sampling profiler — the SimpleProfiler.java analogue (port of
filodb_tpu/utils/profiler.py, a JAX-free copy).

The reference ships a thread-stack sampling profiler in its standalone
server (ref: standalone/src/main/java/filodb.standalone/SimpleProfiler.java
— periodic stack sampling, aggregated hot-method report).  This is the
Python equivalent: a daemon thread samples every live thread's stack via
sys._current_frames at a fixed rate and aggregates (function, file, line)
hit counts, attributing each sample to the innermost frame and to every
frame on the stack (self vs cumulative), so both hot leaves and hot call
paths show up.

Zero overhead when stopped; sampling cost is O(threads * stack depth) per
tick.  Exposed over HTTP via /admin/profiler/{start,stop,report}.
"""
from __future__ import annotations

import collections
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

FrameKey = Tuple[str, str, int]       # (function, file, first line)


class SamplingProfiler:

    MAX_HZ = 1000.0
    # bound on distinct collapsed stacks kept (each full stack tuple is
    # one Counter key); overflow hits aggregate under a sentinel frame so
    # the report says truncation happened instead of silently dropping
    MAX_STACKS = 10_000

    def __init__(self):
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        # one Event PER RUN, created by start() and captured by stop()
        # under the lock — a shared event would let a concurrent start()
        # race stop() into killing the new run or orphaning the old thread
        self._stop: Optional[threading.Event] = None
        self.samples = 0
        self._self_hits: Dict[FrameKey, int] = collections.Counter()
        self._cum_hits: Dict[FrameKey, int] = collections.Counter()
        # root-first stack tuples -> hit counts (the collapsed-stack /
        # flamegraph source; /admin/profiler/report?format=collapsed)
        self._stack_hits: Dict[Tuple[FrameKey, ...], int] = \
            collections.Counter()
        self.started_at: Optional[float] = None
        self.hz = 0.0

    # ----------------------------------------------------------- lifecycle

    def start(self, hz: float = 100.0) -> bool:
        """Begin sampling at `hz` (clamped to [1, MAX_HZ]; non-finite
        rejected — an inf rate would busy-loop the sampler).  Returns
        False if already running."""
        hz = float(hz)
        if not (0 < hz < float("inf")):      # also rejects NaN
            raise ValueError(f"hz must be a positive finite number, "
                             f"got {hz!r}")
        with self._lock:
            if self._thread is not None:
                return False
            self.hz = min(max(hz, 1.0), self.MAX_HZ)
            self.samples = 0
            self._self_hits = collections.Counter()
            self._cum_hits = collections.Counter()
            self._stack_hits = collections.Counter()
            self.started_at = time.time()
            stop_evt = threading.Event()
            self._stop = stop_evt
            self._thread = threading.Thread(
                target=self._run, args=(stop_evt,), daemon=True,
                name="sampling-profiler")
            self._thread.start()
            return True

    def stop(self) -> bool:
        with self._lock:
            t, evt = self._thread, self._stop
            self._thread, self._stop = None, None
        if t is None:
            return False
        evt.set()
        t.join(timeout=5)
        return True

    @property
    def running(self) -> bool:
        return self._thread is not None

    # ------------------------------------------------------------ sampling

    def _run(self, stop_evt: threading.Event) -> None:
        me = threading.get_ident()
        interval = 1.0 / self.hz
        while not stop_evt.wait(interval):
            frames = sys._current_frames()
            with self._lock:
                self.samples += 1
                for tid, frame in frames.items():
                    if tid == me:
                        continue
                    seen = set()
                    top = True
                    f = frame
                    stack = []                  # leaf-first while walking
                    while f is not None:
                        code = f.f_code
                        key = (code.co_name, code.co_filename,
                               code.co_firstlineno)
                        stack.append(key)
                        if top:
                            self._self_hits[key] += 1
                            top = False
                        if key not in seen:     # recursion counts once
                            self._cum_hits[key] += 1
                            seen.add(key)
                        f = f.f_back
                    # collapsed form is root-first; cap distinct stacks
                    skey = tuple(reversed(stack))
                    if skey in self._stack_hits or \
                            len(self._stack_hits) < self.MAX_STACKS:
                        self._stack_hits[skey] += 1
                    else:
                        self._stack_hits[_TRUNCATED] += 1

    # ------------------------------------------------------------- report

    def report(self, top_n: int = 30) -> str:
        """Flat text report, hottest self-time frames first (the shape of
        SimpleProfiler's aggregated output).  Percentages are per sample
        TICK: every live thread contributes at each tick, so a frame hot
        in N threads simultaneously can exceed 100%."""
        with self._lock:
            samples = self.samples
            self_hits = dict(self._self_hits)
            cum_hits = dict(self._cum_hits)
        lines: List[str] = [
            f"# sampling profiler: {samples} samples @ {self.hz:g} Hz"
            + (" (running)" if self.running else " (stopped)"),
            f"# {'self%':>6} {'cum%':>6}  location",
        ]
        if samples == 0:
            return "\n".join(lines + ["# no samples collected"])
        ranked = sorted(self_hits.items(), key=lambda kv: -kv[1])[:top_n]
        for key, hits in ranked:
            name, fname, line = key
            cum = cum_hits.get(key, hits)
            lines.append(f"  {100.0 * hits / samples:6.2f} "
                         f"{100.0 * cum / samples:6.2f}  "
                         f"{name} ({fname}:{line})")
        return "\n".join(lines)


    def report_collapsed(self) -> str:
        """Collapsed-stack output: one line per distinct stack,
        root-first frames `;`-joined, trailing hit count — directly
        loadable by speedscope / Brendan Gregg's flamegraph.pl (served
        at /admin/profiler/report?format=collapsed)."""
        with self._lock:
            stacks = dict(self._stack_hits)
        lines = []
        for skey, hits in sorted(stacks.items(),
                                 key=lambda kv: -kv[1]):
            frames = ";".join(
                f"{name} ({fname}:{line})" for name, fname, line in skey)
            lines.append(f"{frames} {hits}")
        return "\n".join(lines) + ("\n" if lines else "")


# sentinel stack for hits past the MAX_STACKS distinct-stack cap
_TRUNCATED: Tuple[FrameKey, ...] = (("[stacks-truncated]", "", 0),)


# process-wide instance the HTTP admin routes drive
profiler = SamplingProfiler()
