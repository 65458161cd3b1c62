"""Structured event journal — the node's flight recorder.

Counters say HOW MUCH; the journal says WHAT HAPPENED and WHEN, in
order.  Typed lifecycle events from every background subsystem — WAL
segment rotation/prune/commit-failure, boot replay, compaction and
retention runs, breaker open/half-open/close, mirror rebuilds and
over-cap degrades, eviction sweeps, rules/config reloads, node
join/dead from the cluster registry, server phase transitions — land in
one bounded ring with monotonic sequence numbers, served at

    GET /admin/events?since_seq=N&limit=K

so "what changed right before the p99 spike?" is one request, resumable
by sequence number (the CLI's `events --follow` tails it), and
correlatable with /admin/slowlog entries and trace ids by timestamp.
An optional JSONL sink mirrors every event to disk for post-mortem
import; the ring stays bounded either way (the Prometheus stance:
meta-monitoring must never be the thing that OOMs the monitor).

Emission is cheap (one lock, one dict) and NEVER raises: a broken sink
or a hostile field must not take down the subsystem reporting it.
"""
from __future__ import annotations

import collections
import json
import threading
import time
from typing import List, Optional


class EventJournal:

    DEFAULT_MAX = 2048

    def __init__(self, max_entries: int = DEFAULT_MAX, path: str = ""):
        self._lock = threading.Lock()
        self._seq = 0
        self._ring: "collections.deque[dict]" = collections.deque(
            maxlen=max_entries)
        self._path = path
        self._file = None

    # ----------------------------------------------------------- config

    def configure(self, max_entries: Optional[int] = None,
                  path: Optional[str] = None) -> None:
        """Re-point the ring size / JSONL sink (FiloServer calls this
        with its settings, like slowlog.configure).  Existing entries
        carry over up to the new bound."""
        with self._lock:
            if max_entries is not None and \
                    max_entries != self._ring.maxlen:
                self._ring = collections.deque(self._ring,
                                               maxlen=max(max_entries, 1))
            if path is not None and path != self._path:
                if self._file is not None:
                    try:
                        self._file.close()
                    except OSError:
                        pass
                self._path = path
                self._file = None

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            # seq keeps climbing: a follower's since_seq must stay valid
            # across an operator clear

    # ------------------------------------------------------------- emit

    def emit(self, kind: str, subsystem: str = "", **fields) -> int:
        """Record one event; returns its sequence number.  Never raises
        — the journal is observability, not control flow."""
        try:
            now = time.time()
            ev = {"kind": str(kind), "subsystem": str(subsystem),
                  "unixSeconds": round(now, 3)}
            for k, v in fields.items():
                if v is None:
                    continue
                ev[k] = v if isinstance(v, (int, float, bool)) \
                    else str(v)[:300]
            with self._lock:
                self._seq += 1
                ev["seq"] = self._seq
                self._ring.append(ev)
                seq = self._seq
                path, f = self._path, self._file
            from filodb_tpu_torch.utils.metrics import registry
            registry.counter("events_emitted", kind=str(kind)).increment()
            if path:
                self._write_jsonl(ev)
            return seq
        except Exception:  # noqa: BLE001 — never sink the reporting caller
            return -1

    def _write_jsonl(self, ev: dict) -> None:
        try:
            with self._lock:
                if self._file is None:
                    self._file = open(self._path, "a")
                self._file.write(json.dumps(ev, separators=(",", ":"))
                                 + "\n")
                self._file.flush()
        except OSError:
            from filodb_tpu_torch.utils.metrics import registry
            registry.counter("events_sink_errors").increment()

    # ------------------------------------------------------------- read

    @property
    def next_seq(self) -> int:
        with self._lock:
            return self._seq + 1

    def since(self, since_seq: int = 0, limit: int = 0,
              kind: str = "") -> List[dict]:
        """Events with seq > since_seq, oldest first; `limit` > 0 keeps
        the NEWEST that many (a follower catching up after a gap wants
        the recent tail, not a replay of everything it missed)."""
        with self._lock:
            out = [dict(ev) for ev in self._ring
                   if ev["seq"] > since_seq
                   and (not kind or ev["kind"] == kind)]
        if limit and len(out) > limit:
            out = out[-limit:]
        return out

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [dict(ev) for ev in self._ring]


# process-wide instance (subsystems emit into it; the /admin/events
# route and the health evaluator read it)
journal = EventJournal()
