"""Live query introspection: the active-query registry and cooperative
cancellation (port of filodb_tpu/query/activequeries.py).

  * ActiveQueryRegistry — every query from frontend admission to
    completion: a stable query id (= the trace id), tenant, promql,
    origin, live phase (queued, parsing, planning, executing), and scan
    counters updated in place by the exec nodes (execbase's tally hook
    reads each node's QueryStats).
  * CancellationToken — stamped on the QueryContext as a plain
    attribute, checked at every exec-node boundary, between the host
    gather's row blocks and before fused kernel launches; `kill()` flips
    it.  Killed queries surface as the structured `query_canceled` error,
    release their scheduler slot, are never cached, and singleflight and
    coalescer followers re-execute instead of inheriting the kill.
  * Client-disconnect watcher: the HTTP shell binds each request's socket
    (`bind_client_conn`); a background poller trips the same token when
    the peer closes mid-query (`queries_killed_total{reason=
    "disconnect"}`).
  * Crash-durable active-query file (the Prometheus pattern): entries
    appended at admission, tombstoned at completion; on boot, leftover
    entries are journaled as `query_active_at_crash` events.  The
    standalone server configures it (next to its WAL by default).

A kill also goes, as a kill frame (parallel/transport.send_kill), to
every remote child node the query dispatched to (`note_remote`).
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional, Tuple

# the live-phase vocabulary (doc/observability.md): last-write-wins,
# set by the frontend (queued), engine (parsing/planning/executing) and
# scatter-gather roots (gathering)
PHASES = ("queued", "parsing", "planning", "executing", "gathering")


# one lock for ALL token flips: cancel() is the cold path (a kill, a
# disconnect), and sharing the lock keeps CancellationToken allocation
#— which happens once per query on the serving hot path — free of a
# per-instance Lock object
_CANCEL_LOCK = threading.Lock()


class CancellationToken:
    """Cooperative cancellation flag shared by every exec node of one
    query on one node.  `cancel()` is idempotent — the FIRST caller's
    reason wins (double-kill keeps reason=admin; a later disconnect of
    an already-killed query changes nothing)."""

    __slots__ = ("_cancelled", "reason", "detail")

    def __init__(self):
        self._cancelled = False
        self.reason = ""
        self.detail = ""

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def cancel(self, reason: str, detail: str = "") -> bool:
        """Returns True iff THIS call flipped the token."""
        with _CANCEL_LOCK:
            if self._cancelled:
                return False
            self.reason = reason
            self.detail = detail
            self._cancelled = True
            return True

    def raise_if_cancelled(self, where: str = "") -> None:
        if self._cancelled:
            from filodb_tpu_torch.query.execbase import QueryError
            raise QueryError(
                "query_canceled",
                f"query killed (reason={self.reason or 'admin'})"
                + (f" {where}" if where else "")
                + (f": {self.detail}" if self.detail else ""))


class ActiveQuery:
    """One live execution on THIS node.  Counters mutate in place (plain
    int/float writes under the GIL — readers tolerate slightly-stale
    values; a torn multi-field read only skews a live display row)."""

    __slots__ = ("query_id", "promql", "tenant_ws", "tenant_ns", "origin",
                 "role", "phase", "start_unix", "token", "verdict",
                 "samples_scanned", "samples_paged", "bytes_paged",
                 "device_dispatches", "device_seconds", "remote_nodes",
                 "client_conn", "_registry")

    def __init__(self, query_id: str, promql: str, tenant: Tuple[str, str],
                 origin: str, role: str, registry: "ActiveQueryRegistry",
                 client_conn=None):
        self.query_id = query_id
        self.promql = promql
        self.tenant_ws, self.tenant_ns = tenant
        self.origin = origin
        self.role = role                      # "frontend" | "remote"
        self.phase = "queued"
        self.start_unix = time.time()
        self.token = CancellationToken()
        self.verdict = ""                     # set at deregister
        self.samples_scanned = 0
        self.samples_paged = 0
        self.bytes_paged = 0
        self.device_dispatches = 0
        self.device_seconds = 0.0
        self.remote_nodes: List[str] = []     # "host:port" children
        self.client_conn = client_conn
        self._registry = registry

    # ------------------------------------------------------ live updates

    def set_phase(self, phase: str) -> None:
        if phase != self.phase:
            self._registry._phase_moved(self, self.phase, phase)
            self.phase = phase

    def note_remote(self, where: str) -> None:
        """Record a remote child node at dispatch time — the kill fan-out
        list (and the /admin/queries `remoteNodes` column)."""
        if where not in self.remote_nodes:
            self.remote_nodes.append(where)

    def add(self, samples: int = 0, paged_samples: int = 0,
            paged_bytes: int = 0, dispatches: int = 0,
            device_s: float = 0.0) -> None:
        self.samples_scanned += int(samples)
        self.samples_paged += int(paged_samples)
        self.bytes_paged += int(paged_bytes)
        self.device_dispatches += int(dispatches)
        self.device_seconds += float(device_s)

    def tally(self, node, stats, exec_tally) -> None:
        """execute_internal's per-node hook: leaves own their scan
        counters (parents only merge children's — adding those again
        would double-count); device work is EXCLUSIVE per node, so every
        node may add its own."""
        if not node.children:
            self.add(samples=stats.samples_scanned,
                     paged_samples=stats.samples_paged,
                     paged_bytes=stats.bytes_paged)
        if exec_tally.device_s > 0:
            self.add(dispatches=1, device_s=exec_tally.device_s)

    def to_dict(self) -> dict:
        return {
            "queryID": self.query_id,
            "promql": self.promql,
            "tenant": {"ws": self.tenant_ws, "ns": self.tenant_ns},
            "origin": self.origin,
            "role": self.role,
            "phase": self.phase,
            "ageSeconds": round(time.time() - self.start_unix, 3),
            "startUnixSeconds": round(self.start_unix, 3),
            "canceled": self.token.cancelled,
            "cancelReason": self.token.reason,
            "counters": {
                "samplesScanned": self.samples_scanned,
                "samplesPaged": self.samples_paged,
                "bytesPaged": self.bytes_paged,
                "deviceDispatches": self.device_dispatches,
                "deviceSeconds": round(self.device_seconds, 6),
            },
            "remoteNodes": list(self.remote_nodes),
        }


def verdict_of(result) -> str:
    """Final verdict for a finished query — the value slowlog entries,
    trace payloads, and deregistration share (one home, no drift)."""
    err = getattr(result, "error", None) if result is not None else None
    if not err:
        return "completed"
    if err.startswith("query_canceled"):
        return "killed"
    if err.startswith("query_timeout"):
        return "deadline"
    if err.startswith("tenant_overloaded"):
        return "shed"
    return "error"


class ActiveQueryRegistry:
    """Process-wide table of in-flight queries.  Entries are grouped by
    query id: a coordinator entry and this node's remote-leaf executions
    of OTHER coordinators' queries live side by side (one process can be
    both), and `kill()` flips every token registered under the id."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_id: Dict[str, List[ActiveQuery]] = {}
        self.enabled = True
        # crash-durable active-query file (JSONL: {"op": "+"/"-"} pairs;
        # unmatched "+" at boot = running at crash time)
        self._path = ""
        self._file = None
        # per-ws inflight/queued counts backing the live gauges, plus a
        # per-ws cache of the Gauge objects themselves: the serving hot
        # path updates both on every register/deregister, and re-keying
        # through the metrics registry each time (tag-tuple sort + dict
        # hit) under 8-thread contention was measurable
        self._inflight: Dict[str, int] = {}
        self._queued: Dict[str, int] = {}
        self._gauge_cache: Dict[str, Tuple] = {}
        # disconnect watcher (lazily started on the first entry that
        # carries a client socket)
        self._watcher: Optional[threading.Thread] = None
        self.watch_interval_s = 0.1

    # ----------------------------------------------------------- config

    def configure(self, enabled: Optional[bool] = None,
                  path: Optional[str] = None) -> "ActiveQueryRegistry":
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if path is not None and path != self._path:
                if self._file is not None:
                    try:
                        self._file.close()
                    except OSError:
                        pass
                self._path = path
                self._file = None
        return self

    @property
    def path(self) -> str:
        """The crash log's path ("" when none is configured)."""
        return self._path

    def replay_crash_log(self) -> int:
        """Boot step: journal every entry the previous process left
        unmatched in the active-query file as `query_active_at_crash`,
        then truncate.  Returns how many were found."""
        with self._lock:
            path = self._path
        if not path:
            return 0
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError:
            return 0
        open_entries: Dict[str, dict] = {}
        for line in lines:
            try:
                rec = json.loads(line)
            except ValueError:
                continue                     # torn tail from the crash
            if rec.get("op") == "+":
                open_entries[rec.get("id", "")] = rec
            else:
                open_entries.pop(rec.get("id", ""), None)
        from filodb_tpu_torch.utils.events import journal
        for qid, rec in open_entries.items():
            journal.emit("query_active_at_crash", subsystem="query",
                         query_id=qid, promql=rec.get("promql", ""),
                         ws=rec.get("ws", ""), origin=rec.get("origin", ""),
                         started_unix=rec.get("unix"))
        try:
            with open(path, "w"):
                pass
        except OSError:
            pass
        return len(open_entries)

    def _log(self, op: str, ent: ActiveQuery) -> None:
        """Append one crash-log line (best-effort: the registry is the
        record; the file is the crash forensics)."""
        if not self._path:
            return
        rec = {"op": op, "id": ent.query_id}
        if op == "+":
            rec.update(promql=ent.promql[:300], ws=ent.tenant_ws,
                       origin=ent.origin, role=ent.role,
                       unix=round(ent.start_unix, 3))
        try:
            with self._lock:
                if self._file is None:
                    self._file = open(self._path, "a")
                self._file.write(json.dumps(rec, separators=(",", ":"))
                                 + "\n")
                self._file.flush()
        except OSError:
            from filodb_tpu_torch.utils.metrics import registry
            registry.counter("active_query_log_errors").increment()

    # -------------------------------------------------------- lifecycle

    def register(self, query_id: str, promql: str = "",
                 tenant: Tuple[str, str] = ("", ""), origin: str = "query",
                 role: str = "frontend") -> Optional[ActiveQuery]:
        """New live entry (None when the registry is disabled — callers
        treat a None entry as 'no introspection', not an error).  The
        HTTP shell's client socket, when bound on this thread, rides
        along for the disconnect watcher."""
        if not self.enabled:
            return None
        conn = getattr(_conn_local, "sock", None)
        ent = ActiveQuery(query_id, promql, tenant, origin, role, self,
                          client_conn=conn)
        ws = ent.tenant_ws
        with self._lock:
            self._by_id.setdefault(query_id, []).append(ent)
            self._inflight[ws] = self._inflight.get(ws, 0) + 1
            self._queued[ws] = self._queued.get(ws, 0) + 1
        if self._path:
            self._log("+", ent)
        if conn is not None:
            self._ensure_watcher()
        return ent

    def deregister(self, ent: Optional[ActiveQuery],
                   verdict: str = "completed") -> None:
        if ent is None:
            return
        ent.verdict = verdict
        ws = ent.tenant_ws
        with self._lock:
            ents = self._by_id.get(ent.query_id)
            if ents is None:
                return                       # double-deregister: no-op
            try:
                ents.remove(ent)
            except ValueError:
                return                       # double-deregister: no-op
            if not ents:
                del self._by_id[ent.query_id]
            self._inflight[ws] = max(self._inflight.get(ws, 1) - 1, 0)
            if ent.phase == "queued":
                self._queued[ws] = max(self._queued.get(ws, 1) - 1, 0)
        if self._path:
            self._log("-", ent)
        if verdict == "deadline":
            # the deadline reaper is a kill too (the metric's third
            # reason): token-flipped kills count in kill() instead
            from filodb_tpu_torch.utils.metrics import registry
            registry.counter("queries_killed", reason="deadline").increment()

    def _phase_moved(self, ent: ActiveQuery, old: str, new: str) -> None:
        if (old == "queued") == (new == "queued"):
            return
        ws = ent.tenant_ws
        with self._lock:
            if new == "queued":
                self._queued[ws] = self._queued.get(ws, 0) + 1
            else:
                self._queued[ws] = max(self._queued.get(ws, 1) - 1, 0)

    def refresh_gauges(self) -> None:
        """Publish the per-tenant inflight/queue-depth counts as gauges
        — called at SCRAPE time (routes._own_metrics), the same refresh-
        on-scrape pattern the shard gauges use, so the serving hot path
        pays dict arithmetic only, never metric-registry traffic."""
        from filodb_tpu_torch.utils.metrics import registry
        with self._lock:
            snap_in = dict(self._inflight)
            snap_q = dict(self._queued)
        for ws, v in snap_in.items():
            g = self._gauge_cache.get(ws)
            if g is None:
                g = self._gauge_cache[ws] = (
                    registry.gauge("queries_inflight", ws=ws),
                    registry.gauge("query_queue_depth", ws=ws))
            g[0].update(v)
            g[1].update(snap_q.get(ws, 0))

    # ------------------------------------------------------------- read

    def entries(self) -> List[ActiveQuery]:
        with self._lock:
            return [e for ents in self._by_id.values() for e in ents]

    def get(self, query_id: str) -> List[ActiveQuery]:
        with self._lock:
            return list(self._by_id.get(query_id, ()))

    def snapshot(self) -> List[dict]:
        """The /admin/queries payload, oldest-first."""
        ents = sorted(self.entries(), key=lambda e: e.start_unix)
        return [e.to_dict() for e in ents]

    # ------------------------------------------------------------- kill

    def kill(self, query_id: str, reason: str = "admin", detail: str = "",
             propagate: bool = True) -> dict:
        """Flip every token registered under the id; `propagate` also
        sends kill frames to the remote child nodes the entries recorded
        at dispatch time (so remote leaves stop scanning instead of
        computing a result nobody will read).  Idempotent: killing an
        unknown or already-killed id reports killed=False and changes
        nothing."""
        ents = self.get(query_id)
        killed = 0
        remotes: List[str] = []
        for ent in ents:
            if ent.token.cancel(reason, detail):
                killed += 1
            for where in ent.remote_nodes:
                if where not in remotes:
                    remotes.append(where)
        if killed:
            from filodb_tpu_torch.utils.metrics import registry
            registry.counter("queries_killed", reason=reason).increment()
            from filodb_tpu_torch.utils.events import journal
            journal.emit("query_killed", subsystem="query",
                         query_id=query_id, reason=reason,
                         remote_nodes=",".join(remotes))
        prop_errors = 0
        if propagate and killed and remotes:
            from filodb_tpu_torch.parallel.transport import send_kill
            for where in remotes:
                host, _, port = where.rpartition(":")
                try:
                    send_kill(host, int(port), query_id, reason=reason)
                except Exception:  # noqa: BLE001 — a dead child needs no kill
                    prop_errors += 1
                    from filodb_tpu_torch.utils.metrics import registry
                    registry.counter("queries_kill_propagation_errors"
                                     ).increment()
        return {"killed": killed > 0, "entries": len(ents),
                "remoteNodes": remotes, "propagationErrors": prop_errors}

    # ------------------------------------------- client-disconnect watch

    def _ensure_watcher(self) -> None:
        with self._lock:
            if self._watcher is not None:
                return
            self._watcher = threading.Thread(target=self._watch_loop,
                                             name="query-disconnect-watch",
                                             daemon=True)
            self._watcher.start()

    def _kill_async(self, query_id: str) -> None:
        """Disconnect kills run OFF the watcher thread: the remote
        kill-frame fan-out can block seconds per unreachable child, and
        one wedged propagation must not stall disconnect detection for
        every OTHER abandoned query on the node."""
        threading.Thread(
            target=self.kill, args=(query_id,),
            kwargs={"reason": "disconnect",
                    "detail": "client closed the connection"},
            name="query-disconnect-kill", daemon=True).start()

    def _watch_loop(self) -> None:
        import select
        import socket as _socket
        while True:
            time.sleep(self.watch_interval_s)
            for ent in self.entries():
                sock = ent.client_conn
                if sock is None or ent.token.cancelled:
                    continue
                try:
                    readable, _, _ = select.select([sock], [], [], 0)
                    if not readable:
                        continue
                    # EOF (empty peek) = the client hung up mid-query;
                    # pending pipelined bytes are NOT a disconnect
                    if sock.recv(1, _socket.MSG_PEEK) == b"":
                        self._kill_async(ent.query_id)
                except (OSError, ValueError):
                    # closed/invalid fd: same verdict as an EOF
                    self._kill_async(ent.query_id)


active_queries = ActiveQueryRegistry()


# ------------------------------------------------- admission handoff

# The frontend hands the registration DOWN the serving stack on a
# thread-local, in two stages:
#
#   * `set_pending((tenant, origin))` at _serve admission — two plain
#     attribute writes, the ONLY cost a cache hit or singleflight
#     follower ever pays.  Queries that finish inside the serving
#     layers (sub-millisecond, holding no slot and no device) never
#     register at all — the Prometheus active-query-tracker stance of
#     wrapping engine execution, not the cache.
#   * the scheduler layer (_run) consumes the pending marker and
#     registers the ActiveQuery the moment REAL work begins — before
#     the semaphore wait, so a queued query is listable and killable
#     with the slot never held.
#
# `set_admission(ent)` then carries the entry to the engine, whose _ctx
# adopts its id — so ctx.query_id == the registered id == the trace id.
_admission = threading.local()


def set_pending(info: Optional[Tuple]) -> None:
    _admission.pending = info


def take_pending() -> Optional[Tuple]:
    info = getattr(_admission, "pending", None)
    _admission.pending = None
    return info


def set_admission(ent: Optional[ActiveQuery]) -> None:
    _admission.entry = ent


def peek_admission() -> Optional[ActiveQuery]:
    return getattr(_admission, "entry", None)


def take_admission() -> Optional[ActiveQuery]:
    ent = getattr(_admission, "entry", None)
    _admission.entry = None
    return ent


# -------------------------------------------- HTTP connection binding

_conn_local = threading.local()


class bind_client_conn:
    """Bind the serving thread's client socket for the duration of a
    request so `register()` can attach it to the entry (the disconnect
    watcher's handle).  The HTTP shell wraps `api.handle` in this."""

    def __init__(self, sock):
        self.sock = sock

    def __enter__(self):
        self._prev = getattr(_conn_local, "sock", None)
        _conn_local.sock = self.sock
        return self

    def __exit__(self, exc_type, exc, tb):
        _conn_local.sock = self._prev
        return False
