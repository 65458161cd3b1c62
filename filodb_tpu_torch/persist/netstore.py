"""Network column/meta store: a TCP chunk service + remote store clients
(port of filodb_tpu/persist/netstore.py: the same frames).

ref: cassandra/src/main/scala/filodb.cassandra/columnstore/
CassandraColumnStore.scala:53-80 — the reference's store is a REMOTE
service shared by every node; that is what makes ODP, index bootstrap and
failover recovery work across machines (a dead node's part keys, chunks
and checkpoints are all readable by its successor).  This is the
TCP analogue: `ChunkServiceServer` wraps any ColumnStore + MetaStore
(the local-disk pair in deployment) behind a framed protocol, and
`RemoteColumnStore` / `RemoteMetaStore` implement the full store traits
over it — so a cluster node runs with NO shared filesystem.

Wire format: every message is one length-prefixed frame
(parallel/transport framing).  A request is a JSON header frame
{"op": ..., args...}; chunk/part-key payloads follow as N binary frames
reusing the localstore's on-disk encodings (one codec for disk and
wire).  Replies mirror the shape: JSON header then N payload frames.

Standalone service:  python -m filodb_tpu_torch.persist.netstore --root DIR
prints {"ready": true, "port": N} once serving.
"""
from __future__ import annotations

import argparse
import json
import socket
import socketserver
import struct
import threading
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.store import ColumnStore, MetaStore, PartKeyRecord
from filodb_tpu_torch.memory.chunks import ChunkSet
from filodb_tpu_torch.parallel.transport import (_recv_frame, _send_frame,
                                                 recv_json_frame as
                                                 _recv_json_frame,
                                                 send_json_frame as
                                                 _send_json_frame)
from filodb_tpu_torch.persist.localstore import (_decode_chunkset_frame,
                                                 _decode_pk_frame,
                                                 _encode_chunkset_frame,
                                                 _encode_pk_frame)


class ChunkServiceServer:
    """Serves a delegate ColumnStore (+ optional MetaStore) over TCP."""

    def __init__(self, column_store: ColumnStore,
                 meta_store: Optional[MetaStore] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.column_store = column_store
        self.meta_store = meta_store
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        req = _recv_json_frame(self.request)
                        try:
                            outer._dispatch(self.request, req)
                        except (ConnectionError, OSError):
                            raise
                        except Exception as e:  # noqa: BLE001 — per-op error
                            _send_json_frame(self.request, {
                                "ok": False,
                                "error": f"{type(e).__name__}: {e}"})
                except (ConnectionError, OSError, json.JSONDecodeError,
                        struct.error):
                    return

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = _Server((host, port), _Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._srv.server_address

    def start(self) -> "ChunkServiceServer":
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    # -- op dispatch (server side)

    def _dispatch(self, sock, req) -> None:
        op = req["op"]
        cs = self.column_store
        if op == "initialize":
            cs.initialize(req["dataset"], req["num_shards"])
            _send_json_frame(sock, {"ok": True})
        elif op == "write_chunks":
            frames = [_recv_frame(sock) for _ in range(req["n"])]
            for fr in frames:
                pk_bytes, schema_name, chunk = _decode_chunkset_frame(fr)
                cs.write_chunks(req["dataset"], req["shard"],
                                PartKey.from_bytes(pk_bytes), [chunk],
                                schema_name)
            _send_json_frame(sock, {"ok": True})
        elif op == "write_part_keys":
            frames = [_recv_frame(sock) for _ in range(req["n"])]
            cs.write_part_keys(req["dataset"], req["shard"],
                               [_decode_pk_frame(fr) for fr in frames])
            _send_json_frame(sock, {"ok": True})
        elif op == "read_part_keys":
            recs = cs.read_part_keys(req["dataset"], req["shard"])
            _send_json_frame(sock, {"ok": True, "n": len(recs)})
            for r in recs:
                _send_frame(sock, _encode_pk_frame(r))
        elif op == "read_chunks":
            pk = PartKey.from_bytes(bytes.fromhex(req["pk"]))
            chunks = cs.read_chunks(req["dataset"], req["shard"], pk,
                                    req["t0"], req["t1"])
            _send_json_frame(sock, {"ok": True, "n": len(chunks)})
            for c in chunks:
                _send_frame(sock, _encode_chunkset_frame(pk, "", c))
        elif op == "read_chunks_multi":
            # batched partition reads: the server iterates locally and
            # streams ONE reply (header carries per-request counts) —
            # replay/compaction paths stop paying a round trip per
            # partition
            reqs = [(PartKey.from_bytes(bytes.fromhex(pk)), t0, t1)
                    for pk, t0, t1 in req["reqs"]]
            per_part = cs.read_chunks_multi(req["dataset"], req["shard"],
                                            reqs)
            counts = [len(chunks) for chunks in per_part]
            _send_json_frame(sock, {"ok": True, "n": sum(counts),
                                    "counts": counts})
            for (pk, _, _), chunks in zip(reqs, per_part):
                for c in chunks:
                    _send_frame(sock, _encode_chunkset_frame(pk, "", c))
        elif op == "scan_ingestion":
            hits = list(cs.scan_chunks_by_ingestion_time(
                req["dataset"], req["shard"], req["lo"], req["hi"]))
            _send_json_frame(sock, {"ok": True, "n": len(hits)})
            for pk, schema_name, c in hits:
                _send_frame(sock, _encode_chunkset_frame(pk, schema_name, c))
        elif op == "delete_part_keys":
            n = cs.delete_part_keys(
                req["dataset"], req["shard"],
                [PartKey.from_bytes(bytes.fromhex(h)) for h in req["pks"]])
            _send_json_frame(sock, {"ok": True, "n": n})
        elif op == "num_chunksets":
            n = cs.num_chunksets(req["dataset"], req["shard"])
            _send_json_frame(sock, {"ok": True, "n": n})
        elif op == "write_checkpoint":
            self.meta_store.write_checkpoint(req["dataset"], req["shard"],
                                             req["group"], req["offset"])
            _send_json_frame(sock, {"ok": True})
        elif op == "read_checkpoints":
            cps = self.meta_store.read_checkpoints(req["dataset"],
                                                   req["shard"])
            _send_json_frame(sock, {"ok": True,
                                    "cps": {str(k): v
                                            for k, v in cps.items()}})
        else:
            _send_json_frame(sock, {"ok": False,
                                    "error": f"unknown op {op!r}"})


class _RemoteBase:
    """One pooled connection, serialized by a lock; reconnects once on a
    connection error (the service is stateless per request)."""

    def __init__(self, host: str, port: int, timeout_s: float = 30.0):
        self._addr = (host, int(port))
        self._timeout = timeout_s
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None

    def _connect(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection(self._addr, timeout=self._timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
        return self._sock

    def _reset(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _call(self, req: dict, out_frames: Iterable[bytes] = (),
              recv_frames: bool = False):
        """One request/response exchange; retries once on a broken pool
        connection."""
        out_frames = list(out_frames)           # re-sendable across retries
        with self._lock:
            for attempt in (0, 1):
                try:
                    s = self._connect()
                    _send_json_frame(s, req)
                    for fr in out_frames:
                        _send_frame(s, fr)
                    reply = _recv_json_frame(s)
                    if not reply.get("ok"):
                        raise RuntimeError(
                            f"chunk service: {reply.get('error')}")
                    if recv_frames:
                        return reply, [_recv_frame(s)
                                       for _ in range(reply["n"])]
                    return reply, []
                except (ConnectionError, OSError, socket.timeout):
                    self._reset()
                    if attempt:
                        raise

    def close(self) -> None:
        with self._lock:
            self._reset()


class RemoteColumnStore(_RemoteBase, ColumnStore):
    """The full ColumnStore trait over the chunk service — ODP, index
    bootstrap, flush, ingestion-time scans and the cardinality buster all
    work across a network boundary, like the reference's Cassandra store."""

    def initialize(self, dataset: str, num_shards: int) -> None:
        self._call({"op": "initialize", "dataset": dataset,
                    "num_shards": num_shards})

    def write_chunks(self, dataset, shard, part_key, chunksets,
                     schema_name) -> None:
        frames = [_encode_chunkset_frame(part_key, schema_name, cs)
                  for cs in chunksets]
        self._call({"op": "write_chunks", "dataset": dataset,
                    "shard": shard, "n": len(frames)}, out_frames=frames)

    def write_part_keys(self, dataset, shard, records) -> None:
        frames = [_encode_pk_frame(r) for r in records]
        self._call({"op": "write_part_keys", "dataset": dataset,
                    "shard": shard, "n": len(frames)}, out_frames=frames)

    def read_part_keys(self, dataset, shard) -> List[PartKeyRecord]:
        _, frames = self._call({"op": "read_part_keys", "dataset": dataset,
                                "shard": shard}, recv_frames=True)
        return [_decode_pk_frame(fr) for fr in frames]

    def read_chunks(self, dataset, shard, part_key, start_time_ms,
                    end_time_ms) -> List[ChunkSet]:
        _, frames = self._call({"op": "read_chunks", "dataset": dataset,
                                "shard": shard,
                                "pk": part_key.to_bytes().hex(),
                                "t0": int(start_time_ms),
                                "t1": int(end_time_ms)}, recv_frames=True)
        return [_decode_chunkset_frame(fr)[2] for fr in frames]

    def read_chunks_multi(self, dataset, shard, requests
                          ) -> List[List[ChunkSet]]:
        """One round trip for N partition reads (vs N for the loop
        default) — the ensure_paged prefetch / compactor read path."""
        requests = [(pk, int(t0), int(t1)) for pk, t0, t1 in requests]
        reply, frames = self._call(
            {"op": "read_chunks_multi", "dataset": dataset, "shard": shard,
             "reqs": [[pk.to_bytes().hex(), t0, t1]
                      for pk, t0, t1 in requests]}, recv_frames=True)
        out: List[List[ChunkSet]] = []
        i = 0
        for n in reply["counts"]:
            out.append([_decode_chunkset_frame(fr)[2]
                        for fr in frames[i: i + n]])
            i += n
        return out

    def scan_chunks_by_ingestion_time(
            self, dataset, shard, ingestion_start_ms, ingestion_end_ms
    ) -> Iterator[Tuple[PartKey, str, ChunkSet]]:
        _, frames = self._call({"op": "scan_ingestion", "dataset": dataset,
                                "shard": shard,
                                "lo": int(ingestion_start_ms),
                                "hi": int(ingestion_end_ms)},
                               recv_frames=True)
        for fr in frames:
            pk_bytes, schema_name, cs = _decode_chunkset_frame(fr)
            yield PartKey.from_bytes(pk_bytes), schema_name, cs

    def delete_part_keys(self, dataset, shard, part_keys) -> int:
        reply, _ = self._call({
            "op": "delete_part_keys", "dataset": dataset, "shard": shard,
            "pks": [pk.to_bytes().hex() for pk in part_keys]})
        return reply["n"]

    def num_chunksets(self, dataset, shard) -> int:
        reply, _ = self._call({"op": "num_chunksets", "dataset": dataset,
                               "shard": shard})
        return reply["n"]


class RemoteMetaStore(_RemoteBase, MetaStore):
    """Checkpoint watermarks over the chunk service (the reference's
    Cassandra CheckpointTable analogue, ref: metastore/CheckpointTable)."""

    def write_checkpoint(self, dataset, shard, group, offset) -> None:
        self._call({"op": "write_checkpoint", "dataset": dataset,
                    "shard": shard, "group": group, "offset": offset})

    def read_checkpoints(self, dataset, shard) -> Dict[int, int]:
        reply, _ = self._call({"op": "read_checkpoints", "dataset": dataset,
                               "shard": shard})
        return {int(k): v for k, v in reply["cps"].items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args(argv)
    from filodb_tpu_torch.persist.localstore import (LocalDiskColumnStore,
                                                     LocalDiskMetaStore)
    srv = ChunkServiceServer(LocalDiskColumnStore(args.root),
                             LocalDiskMetaStore(args.root),
                             host=args.host, port=args.port).start()
    print(json.dumps({"ready": True, "port": srv.address[1]}), flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
