"""Replication transport: the node-side door peers replicate through
(port of filodb_tpu/replication/service.py: the same frames and the same
WalRecord bodies byte for byte, so a port node and a JAX node replicate
to each other).  The door ingests into its memstore, on that memstore's
device; the snapshot stream reads the shard's host store, never the
card's mirror.

One framed-TCP server per node (next to transport.NodeQueryServer — the
query data plane stays untouched) speaking a small typed-frame protocol
built on the shared frame codec (parallel/transport._send_frame): every
message is a JSON control frame, optionally followed by binary frames
whose sizes the control frame declares.  Verbs:

  append       one columnar slab, WalRecord-encoded (the WAL's own wire
               format — replication and durability share one
               serializer, so they cannot drift): appended to the local
               WAL (durable before the ack when one is attached) and
               ingested through the ordinary `ingest_columns` path.
  fetch_wal    stream WAL segments whose records reach past `since_seq`
               — the catch-up medium (ship segments, don't re-scrape).
  snapshot     stream one shard's working set as WalRecord-encoded
               grids (the live-handoff bulk phase).
  begin_restore / end_restore / abort_restore
               the restore window: while open, LIVE appends for the
               shard are acked but BUFFERED (not ingested), while
               restore-flagged appends (snapshot / WAL-tail records)
               apply immediately; end_restore drains the buffer in
               arrival order.  Without this window a live sample
               landing before its series' older snapshot grid would
               make the store's OOO handling silently DROP the whole
               history — the double-buffering every live shard
               migration needs.
  horizon      per-shard replica horizons (highest PRIMARY seq applied)
               — catch-up resume points.
  drop_shard   tombstone a local shard copy (handoff completion).
  ping         liveness + owned-shard report.

The server never trusts the peer: record bodies go through the same
CRC/decode guards replay uses, and a failed verb answers a structured
error instead of killing the connection.
"""
from __future__ import annotations

import logging
import os
import socket
import socketserver
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from filodb_tpu_torch.parallel.transport import (_recv_frame, _send_frame,
                                                 recv_json_frame,
                                                 send_json_frame)
from filodb_tpu_torch.utils.metrics import registry as metrics_registry
from filodb_tpu_torch.wal.segment import WalRecord

_log = logging.getLogger("filodb.replication")

# series per streamed snapshot grid: bounds per-record memory while
# keeping the per-record Python overhead amortized
SNAPSHOT_BATCH_SERIES = 1024

# restore-window buffer cap (records): past it the restore has fallen
# hopelessly behind live ingest — fail the restore loudly rather than
# silently dropping buffered acked slabs
RESTORE_BUFFER_MAX = 65_536

# decoded key tables a connection keeps (WalRecord.decode's key_memo): a
# distributor streams slab after slab over the same series through one
# connection, so each table's keys decode once, and the list's identity
# lets the shard and the WAL reuse their own per-table caches
KEY_MEMO_TABLES = 4


class ReplicationError(RuntimeError):
    """A replication verb failed on the peer (its detail rides along)."""


def iter_shard_grids(shard, batch_series: int = SNAPSHOT_BATCH_SERIES,
                     page: bool = True) -> Iterator[WalRecord]:
    """Yield one shard's working set as WalRecord grids — the snapshot
    stream's producer.  Series are grouped by sample count into the same
    rectangular [S, k] slabs `ingest_columns` consumes (ragged series
    split across groups, like gateway/remotewrite._build_slabs).  With
    `page` the flushed-but-evicted tail is demand-paged back first so
    the stream covers everything the shard can serve from memory."""
    lookup = shard.lookup_partitions([], 0, 1 << 62)
    for schema_name, pids in lookup.pids_by_schema.items():
        if page:
            try:
                shard.ensure_paged_pids(schema_name, pids, 0, 1 << 62)
            except Exception:  # noqa: BLE001 — page what we can; the
                # dense tier still streams (the new owner recovers the
                # rest from the shared column store)
                _log.exception("handoff snapshot: paging failed for %s",
                               schema_name)
        store = shard.stores[schema_name]
        for lo in range(0, len(pids), batch_series):
            chunk = pids[lo:lo + batch_series]
            rows = shard.rows_for(chunk)
            ts, cols, counts = shard.snapshot_read(
                store, lambda: store.gather_rows(rows))
            by_count: Dict[int, List[int]] = {}
            for i in range(len(chunk)):
                n = int(counts[i])
                if n > 0:
                    by_count.setdefault(n, []).append(i)
            for n, idxs in by_count.items():
                keys = [shard.partitions[int(chunk[i])].part_key
                        for i in idxs]
                sel = np.asarray(idxs)
                grid_ts = np.ascontiguousarray(ts[sel, :n]).astype(np.int64)
                grid_cols = {
                    c: np.ascontiguousarray(np.asarray(v)[sel, :n])
                    for c, v in cols.items() if v is not None}
                yield WalRecord(0, shard.shard_num, schema_name, keys,
                                grid_ts, grid_cols, store.bucket_les)


class ReplicationServer:
    """Per-node replication door.  `wals` maps dataset -> WalManager
    (may be empty: appends then skip local durability and rely on the
    primary's WAL until flush).  Tracks per-(dataset, shard) replica
    horizons — the highest PRIMARY-space seq applied here — which are
    the catch-up resume points."""

    def __init__(self, memstore, node: str = "local",
                 wals: Optional[Dict[str, object]] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.memstore = memstore
        self.node = node
        self.wals = wals if wals is not None else {}
        self._horizons: Dict[Tuple[str, int], int] = {}
        self._hlock = threading.Lock()
        # (dataset, shard) -> buffered live records while a restore
        # window is open; None value = window overflowed (restore must
        # fail, buffered slabs were dropped past the cap)
        self._staging: Dict[Tuple[str, int], Optional[list]] = {}
        # live handler connections: stop() severs them so a stopped
        # in-proc node looks EXACTLY like a SIGKILLed one to peers with
        # pooled sockets (same stance as transport.NodeQueryServer)
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def setup(self):
                with outer._conns_lock:
                    outer._conns.add(self.request)

            def finish(self):
                with outer._conns_lock:
                    outer._conns.discard(self.request)

            def handle(self):
                key_memo: Dict[bytes, tuple] = {}
                try:
                    while True:
                        req = recv_json_frame(self.request)
                        try:
                            outer._handle(self.request, req, key_memo)
                        except (ConnectionError, OSError):
                            raise
                        except Exception as e:  # noqa: BLE001 — verb errors ride the wire
                            send_json_frame(self.request, {
                                "ok": False,
                                "error": f"{type(e).__name__}: {e}"})
                except (ConnectionError, OSError, ValueError):
                    return

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _Handler)
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- lifecycle

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.server_address

    def start(self) -> "ReplicationServer":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        # stdlib shutdown() BLOCKS until serve_forever acknowledges —
        # forever if the serving thread was never started (an embedder
        # that built the door but never start()ed it must still be able
        # to tear down; same guard as http.FiloHttpServer.stop)
        if self._thread is not None:
            self._server.shutdown()
        self._server.server_close()
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        if self._thread:
            self._thread.join(timeout=5)

    def horizon(self, dataset: str, shard: int) -> int:
        with self._hlock:
            return self._horizons.get((dataset, shard), -1)

    # --------------------------------------------------------------- verbs

    def _handle(self, sock, req: Dict,
                key_memo: Optional[Dict[bytes, tuple]] = None) -> None:
        cmd = req.get("cmd")
        if cmd == "append":
            self._append(sock, req, key_memo)
        elif cmd == "fetch_wal":
            self._fetch_wal(sock, req)
        elif cmd == "snapshot":
            self._snapshot(sock, req)
        elif cmd == "horizon":
            ds = req["dataset"]
            with self._hlock:
                hs = {str(s): seq for (d, s), seq in self._horizons.items()
                      if d == ds}
            send_json_frame(sock, {"ok": True, "horizons": hs})
        elif cmd == "begin_restore":
            key = (req["dataset"], int(req["shard"]))
            with self._hlock:
                self._staging.setdefault(key, [])
            send_json_frame(sock, {"ok": True})
        elif cmd == "end_restore":
            self._end_restore(sock, req)
        elif cmd == "abort_restore":
            key = (req["dataset"], int(req["shard"]))
            with self._hlock:
                dropped = self._staging.pop(key, None)
            send_json_frame(sock, {"ok": True,
                                   "dropped": len(dropped or [])})
        elif cmd == "drop_shard":
            self._drop_shard(sock, req)
        elif cmd == "ping":
            send_json_frame(sock, {"ok": True, "node": self.node,
                                   "owned": self.memstore.shard_map()})
        else:
            send_json_frame(sock, {"ok": False,
                                   "error": f"unknown cmd {cmd!r}"})

    def _append(self, sock, req: Dict,
                key_memo: Optional[Dict[bytes, tuple]] = None) -> None:
        """One replicated slab: body frame is a self-contained
        WalRecord.  Local WAL (when attached) commits BEFORE the ack —
        the replica's durability claim is real; the primary-space seq
        advances this shard's replica horizon.  While a restore window
        is open for the shard, LIVE slabs are acked-and-buffered
        (applied in order at end_restore) so a fresh sample can never
        land before its series' older snapshot history and trigger the
        store's OOO drop of that history; restore-flagged slabs (the
        snapshot / WAL-tail stream itself) apply immediately.

        A `trace` field in the header is the distributor's write-path
        trace id: the local WAL append + ingest run under it and the
        span events recorded here ride back in the ack (`spans`), so
        the distributor's collector holds ONE stitched cross-node trace
        — the same drain-per-reply protocol the query transport uses."""
        body = _recv_frame(sock)
        rec = WalRecord.decode(body, key_memo=key_memo)
        if key_memo is not None:
            while len(key_memo) > KEY_MEMO_TABLES:
                key_memo.pop(next(iter(key_memo)))
        dataset = req["dataset"]
        seq = int(req.get("seq", -1))
        trace = req.get("trace") or ""
        # the buffering decision comes FIRST: a buffered live slab is
        # WAL'd at end_restore drain time, not on arrival — otherwise a
        # crash mid-window replays the live tick BEFORE the relayed
        # history still in flight and the store's OOO handling drops
        # that history all over again.  (The narrow cost: a buffered
        # slab's durability on THIS replica starts at drain; the
        # primary's own WAL already holds it, and a crashed mid-restore
        # target is rolled back and redone either way.)
        buffered = False
        if not req.get("restore"):
            key = (dataset, rec.shard)
            with self._hlock:
                buf = self._staging.get(key)
                if buf is not None:
                    if len(buf) >= RESTORE_BUFFER_MAX:
                        # past the cap: poison the window (end_restore
                        # fails loudly) instead of silently dropping
                        self._staging[key] = None
                    else:
                        buf.append((rec, seq))
                        buffered = True
                elif key in self._staging:
                    buffered = True      # poisoned: ack, restore fails
        got = 0
        spans = []
        if not buffered:
            if trace:
                from filodb_tpu_torch.utils.metrics import (collector,
                                                            trace_context)
                with trace_context(trace):
                    offset = self._wal_append(dataset, rec)
                    got = self._apply(dataset, rec, offset, seq)
                # drain exactly the events recorded since the last reply
                # (take — never trace — so a reused connection can't
                # double-ship) and stitch them into the distributor's
                # collector via the ack
                spans = collector.take(trace)
            else:
                offset = self._wal_append(dataset, rec)
                got = self._apply(dataset, rec, offset, seq)
        metrics_registry.counter("replication_appends_received",
                                 dataset=dataset).increment()
        reply = {"ok": True, "seq": seq, "ingested": int(got),
                 "buffered": buffered}
        if spans:
            reply["spans"] = spans
        send_json_frame(sock, reply)

    def _wal_append(self, dataset: str, rec: WalRecord) -> int:
        wal = self.wals.get(dataset)
        if wal is None:
            return -1
        return wal.append_grid(rec.shard, rec.schema, rec.part_keys,
                               rec.ts, rec.columns,
                               bucket_les=rec.bucket_les)

    def _apply(self, dataset: str, rec: WalRecord, offset: int,
               seq: int) -> int:
        shard = self.memstore.get_shard(dataset, rec.shard) \
            or self.memstore.setup(dataset, rec.shard)
        got = shard.ingest_columns(rec.schema, rec.part_keys, rec.ts,
                                   rec.columns, offset=offset,
                                   bucket_les=rec.bucket_les)
        # primary-space seq travels in the HEADER (the record's own u64
        # seq field cannot carry "unknown"): it advances this shard's
        # replica horizon — the catch-up resume point
        if seq >= 0:
            with self._hlock:
                key = (dataset, rec.shard)
                if seq > self._horizons.get(key, -1):
                    self._horizons[key] = seq
        return int(got)

    def _end_restore(self, sock, req: Dict) -> None:
        dataset = req["dataset"]
        shard_num = int(req["shard"])
        key = (dataset, shard_num)
        applied = 0
        # swap-drain loop: the window stays OPEN (concurrent live
        # appends keep landing in a fresh buffer, never applying ahead
        # of older drained records) and only closes atomically once a
        # swap finds it empty — popping then applying outside the lock
        # would let a racing append OOO-drop the still-undrained tail
        while True:
            with self._hlock:
                buf = self._staging.get(key)
                if buf is None:
                    if key in self._staging:
                        self._staging.pop(key)
                        send_json_frame(sock, {
                            "ok": False,
                            "error": f"restore window for shard "
                                     f"{shard_num} overflowed "
                                     f"({RESTORE_BUFFER_MAX} records) — "
                                     "buffered live slabs were dropped; "
                                     "redo the restore"})
                        return
                    buf = []             # window never opened: no-op
                if not buf:
                    self._staging.pop(key, None)
                    break
                self._staging[key] = []
            for rec, seq in buf:
                # WAL'd here, in drain order, so a later replay
                # re-applies history and buffered live slabs in the
                # same safe order
                offset = self._wal_append(dataset, rec)
                self._apply(dataset, rec, offset, seq)
                applied += 1
        send_json_frame(sock, {"ok": True, "applied": applied})

    def _fetch_wal(self, sock, req: Dict) -> None:
        """Stream WAL segments holding records past `since_seq`: one
        {"segment": first_seq, "bytes": n} control frame + one binary
        frame per segment, then {"done": true}.  Whole files ship — the
        receiver replays with its shard filter + resume point, and
        segment self-containment (key tables intern per segment) makes
        any byte range before `safe_bytes` decodable."""
        dataset = req["dataset"]
        since = int(req.get("since_seq", -1))
        wal = self.wals.get(dataset)
        if wal is None:
            send_json_frame(sock, {"ok": False,
                                   "error": f"no WAL for {dataset!r}"})
            return
        segments, committed = wal.writer.snapshot_segments()
        sent = 0
        for first, last, path, safe_bytes in segments:
            if last < since:
                continue
            try:
                with open(path, "rb") as f:
                    data = f.read(safe_bytes)
            except OSError:
                continue                 # pruned underneath the snapshot
            send_json_frame(sock, {"ok": True, "segment": first,
                                   "last_seq": last, "bytes": len(data)})
            _send_frame(sock, data)
            sent += 1
        send_json_frame(sock, {"ok": True, "done": True,
                               "segments": sent, "committed_seq": committed})

    def _snapshot(self, sock, req: Dict) -> None:
        """Stream one shard's working set as WalRecord grids (the
        handoff bulk phase): {"record": true, "bytes": n} + binary frame
        per grid, then {"done": true, "records": k, "samples": n}."""
        dataset = req["dataset"]
        shard_num = int(req["shard"])
        shard = self.memstore.get_shard(dataset, shard_num)
        if shard is None:
            send_json_frame(sock, {"ok": False,
                                   "error": f"shard {shard_num} of "
                                            f"{dataset!r} not owned here"})
            return
        records = samples = 0
        for rec in iter_shard_grids(shard):
            body = rec.encode()
            send_json_frame(sock, {"ok": True, "record": True,
                                   "bytes": len(body)})
            _send_frame(sock, body)
            records += 1
            samples += rec.num_samples
        send_json_frame(sock, {"ok": True, "done": True,
                               "records": records, "samples": samples})

    def _drop_shard(self, sock, req: Dict) -> None:
        dataset = req["dataset"]
        shard_num = int(req["shard"])
        dropped = self.memstore.drop_shard(dataset, shard_num)
        with self._hlock:
            self._horizons.pop((dataset, shard_num), None)
        metrics_registry.counter("replication_shards_tombstoned",
                                 dataset=dataset).increment()
        send_json_frame(sock, {"ok": True, "dropped": dropped})


class ReplicaClient:
    """Pooled client for one peer's replication door (one socket per
    thread, like transport.RemoteNodeDispatcher)."""

    def __init__(self, host: str, port: int, timeout_s: float = 10.0):
        self.host, self.port = host, port
        self.timeout_s = timeout_s
        self._tls = threading.local()

    @property
    def where(self) -> str:
        return f"{self.host}:{self.port}"

    def _sock(self) -> socket.socket:
        s = getattr(self._tls, "sock", None)
        if s is None:
            s = socket.create_connection((self.host, self.port),
                                         timeout=self.timeout_s)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._tls.sock = s
        else:
            s.settimeout(self.timeout_s)
        return s

    def reset(self) -> None:
        s = getattr(self._tls, "sock", None)
        if s is not None:
            try:
                s.close()
            finally:
                self._tls.sock = None

    def _call(self, header: Dict, frames: Tuple[bytes, ...] = ()) -> Dict:
        """One verb: header + binary frames out, first control frame
        back.  Connection errors reset the pool and re-raise as OSError
        so callers classify peer death uniformly."""
        try:
            sock = self._sock()
            send_json_frame(sock, header)
            for fr in frames:
                _send_frame(sock, fr)
            reply = recv_json_frame(sock)
        except (ConnectionError, OSError, ValueError):
            self.reset()
            raise
        if not reply.get("ok"):
            raise ReplicationError(
                f"peer {self.where}: {reply.get('error', 'unknown error')}")
        return reply

    # --------------------------------------------------------------- verbs

    def ping(self) -> Dict:
        return self._call({"cmd": "ping"})

    def append_record(self, dataset: str, body: bytes,
                      seq: int = -1, restore: bool = False,
                      trace: str = "") -> Dict:
        """Ship one WalRecord-encoded slab (`seq` = the primary's WAL
        seq for replica-horizon bookkeeping; `restore` = part of a
        restore stream, applied even inside an open restore window;
        `trace` = the write-path trace id — the peer's WAL/ingest spans
        ride back in the ack under `spans`); returns the peer's ack."""
        hdr = {"cmd": "append", "dataset": dataset, "seq": seq}
        if restore:
            hdr["restore"] = True
        if trace:
            hdr["trace"] = trace
        return self._call(hdr, (body,))

    def begin_restore(self, dataset: str, shard: int) -> None:
        self._call({"cmd": "begin_restore", "dataset": dataset,
                    "shard": shard})

    def end_restore(self, dataset: str, shard: int) -> int:
        reply = self._call({"cmd": "end_restore", "dataset": dataset,
                            "shard": shard})
        return int(reply.get("applied", 0))

    def abort_restore(self, dataset: str, shard: int) -> None:
        self._call({"cmd": "abort_restore", "dataset": dataset,
                    "shard": shard})

    def horizons(self, dataset: str) -> Dict[int, int]:
        reply = self._call({"cmd": "horizon", "dataset": dataset})
        return {int(s): int(seq) for s, seq in reply["horizons"].items()}

    def drop_shard(self, dataset: str, shard: int) -> bool:
        reply = self._call({"cmd": "drop_shard", "dataset": dataset,
                            "shard": shard})
        return bool(reply.get("dropped"))

    def fetch_segments(self, dataset: str, since_seq: int = -1
                       ) -> Iterator[Tuple[int, bytes]]:
        """Yield (first_seq, segment bytes) from the peer's WAL; the
        final control frame ends iteration."""
        try:
            sock = self._sock()
            send_json_frame(sock, {"cmd": "fetch_wal", "dataset": dataset,
                                   "since_seq": since_seq})
            while True:
                ctl = recv_json_frame(sock)
                if not ctl.get("ok"):
                    raise ReplicationError(
                        f"peer {self.where}: "
                        f"{ctl.get('error', 'unknown error')}")
                if ctl.get("done"):
                    return
                data = _recv_frame(sock)
                yield int(ctl["segment"]), data
        except (ConnectionError, OSError, ValueError):
            self.reset()
            raise

    def snapshot_shard(self, dataset: str, shard: int
                       ) -> Iterator[bytes]:
        """Yield WalRecord-encoded grid bodies of the peer's shard."""
        try:
            sock = self._sock()
            send_json_frame(sock, {"cmd": "snapshot", "dataset": dataset,
                                   "shard": shard})
            while True:
                ctl = recv_json_frame(sock)
                if not ctl.get("ok"):
                    raise ReplicationError(
                        f"peer {self.where}: "
                        f"{ctl.get('error', 'unknown error')}")
                if ctl.get("done"):
                    return
                yield _recv_frame(sock)
        except (ConnectionError, OSError, ValueError):
            self.reset()
            raise
