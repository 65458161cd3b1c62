"""Cluster control plane: node registry, heartbeat liveness, assignment
distribution (port of filodb_tpu/parallel/cluster.py).

The reference runs a NodeClusterActor singleton whose ShardManager reacts to
akka-cluster membership (gossip) and deathwatch terminations (ref:
coordinator/.../ShardManager.scala:621 removeMember on Terminated,
doc/sharding.md:158-189).  The TPU rebuild keeps the same roles with explicit
wire machinery:

- ClusterCoordinator: one process owns the ShardManager; a framed-JSON TCP
  server accepts node registration, heartbeats (which double as the
  assignment feed), and state queries.  A liveness thread plays deathwatch:
  nodes that miss heartbeats past the timeout are removed and their shards
  reassigned to surviving capacity.
- NodeAgent: runs inside each node process; registers, heartbeats, applies
  assignment diffs via a callback (setup + recovery happen node-side), and
  reports which shards are actively ingesting so the coordinator can flip
  them Active in the shard map.
- ClusterClient: anyone (e.g. a query frontend) can fetch the current shard
  map + node addresses to build per-owner dispatchers.

The query data plane stays on transport.NodeQueryServer — this module is
control only.
"""
from __future__ import annotations

import json
import logging
import queue
import socket
import socketserver
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from filodb_tpu_torch.parallel.shardmanager import (DatasetResourceSpec,
                                                    ShardEvent, ShardManager)
from filodb_tpu_torch.parallel.shardmapper import ShardMapper, ShardStatus
from filodb_tpu_torch.parallel.transport import (recv_json_frame,
                                                 send_json_frame)

_log = logging.getLogger("filodb.cluster")


# shared frame codec (one copy next to the framing it wraps)
_send_json = send_json_frame
_recv_json = recv_json_frame


def _rpc(addr: Tuple[str, int], obj, timeout_s: float = 10.0):
    with socket.create_connection(tuple(addr), timeout=timeout_s) as s:
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        _send_json(s, obj)
        return _recv_json(s)


class ClusterCoordinator:
    """The NodeClusterActor-singleton analogue (control-plane server)."""

    def __init__(self, shard_manager: Optional[ShardManager] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 liveness_timeout_s: float = 5.0,
                 check_interval_s: float = 0.5,
                 replication_factor: int = 1):
        self.sm = shard_manager or ShardManager(
            replication_factor=replication_factor)
        self.liveness_timeout_s = liveness_timeout_s
        self.check_interval_s = check_interval_s
        self._lock = threading.RLock()
        # node -> {"query_addr": (h, p), "last_seen": t}
        self._nodes: Dict[str, Dict] = {}
        self._stop = threading.Event()
        self._liveness_thread: Optional[threading.Thread] = None
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        req = _recv_json(self.request)
                        try:
                            reply = outer._handle(req)
                        except Exception as e:  # noqa: BLE001
                            reply = {"ok": False,
                                     "error": f"{type(e).__name__}: {e}"}
                        _send_json(self.request, reply)
                except (ConnectionError, OSError, json.JSONDecodeError):
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

    def start(self) -> "ClusterCoordinator":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        self._liveness_thread = threading.Thread(target=self._liveness_loop,
                                                 daemon=True)
        self._liveness_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        if self._liveness_thread:
            self._liveness_thread.join(timeout=5)

    def setup_dataset(self, dataset: str, num_shards: int,
                      min_num_nodes: int) -> None:
        with self._lock:
            self.sm.setup_dataset(
                dataset, DatasetResourceSpec(num_shards, min_num_nodes))

    # ------------------------------------------------------------- handlers

    def _assignments_for(self, node: str) -> Dict[str, List[int]]:
        """Shards `node` should hold a copy of: primaries AND replicas
        (the node-side contract is identical — set up the shard, ingest
        its stream; the coordinator's mapper keeps the roles)."""
        out = {}
        for ds in self.sm.datasets():
            m = self.sm.mapper(ds)
            shards = sorted(set(m.shards_for_node(node))
                            | set(m.replica_shards_for_node(node)))
            if shards:
                out[ds] = shards
        return out

    def _handle(self, req: Dict) -> Dict:
        cmd = req.get("cmd")
        with self._lock:
            if cmd == "register":
                node = req["node"]
                self._nodes[node] = {"query_addr": tuple(req["query_addr"]),
                                     "last_seen": time.time()}
                self.sm.add_member(node)
                from filodb_tpu_torch.utils.events import journal
                journal.emit("node_joined", subsystem="cluster",
                             node=node, members=len(self.sm.members))
                _log.info("node %s registered (%d members)", node,
                          len(self.sm.members))
                return {"ok": True,
                        "assignments": self._assignments_for(node)}
            if cmd == "heartbeat":
                node = req["node"]
                info = self._nodes.get(node)
                if info is None:
                    # coordinator restarted or node was declared dead:
                    # tell it to re-register (reference: restart handshake)
                    return {"ok": False, "rejoin": True}
                info["last_seen"] = time.time()
                for ds, shards in (req.get("active") or {}).items():
                    mapper = self.sm.mapper(ds)
                    for s in shards:
                        if mapper.node_for_shard(s) == node and \
                                mapper.statuses[s] != ShardStatus.ACTIVE:
                            self.sm.on_shard_event(
                                ShardEvent("IngestionStarted", ds, s, node))
                        elif node in mapper.replicas[s] and \
                                mapper.owner_status(s, node) != \
                                ShardStatus.ACTIVE:
                            # a replica copy went live: it becomes a
                            # query-time failover target
                            self.sm.on_shard_event(
                                ShardEvent("ReplicaActive", ds, s, node))
                return {"ok": True,
                        "assignments": self._assignments_for(node)}
            if cmd == "state":
                return {"ok": True, "state": self._state()}
            return {"ok": False, "error": f"unknown cmd {cmd!r}"}

    def _state(self) -> Dict:
        nodes = {n: list(i["query_addr"]) for n, i in self._nodes.items()}
        datasets = {}
        for ds in self.sm.datasets():
            snap = self.sm.snapshot(ds)
            m = self.sm.mapper(ds)
            datasets[ds] = {
                "nodes": snap.nodes, "statuses": snap.statuses,
                # ordered replica owners + per-replica statuses, so a
                # ClusterClient can rebuild failover dispatchers
                "replicas": [list(r) for r in m.replicas],
                "replica_statuses": {
                    f"{s}:{n}": st.value
                    for (s, n), st in m.replica_statuses.items()}}
        return {"members": self.sm.members, "nodes": nodes,
                "datasets": datasets}

    # ------------------------------------------------------------- liveness

    def _liveness_loop(self) -> None:
        while not self._stop.wait(self.check_interval_s):
            now = time.time()
            with self._lock:
                dead = [n for n, i in self._nodes.items()
                        if now - i["last_seen"] > self.liveness_timeout_s]
                for node in dead:
                    _log.warning("node %s missed heartbeats for %.1fs — "
                                 "removing and reassigning its shards",
                                 node, now - self._nodes[node]["last_seen"])
                    from filodb_tpu_torch.utils.events import journal
                    journal.emit(
                        "node_dead", subsystem="cluster", node=node,
                        last_seen_ago_s=round(
                            now - self._nodes[node]["last_seen"], 2))
                    del self._nodes[node]
                    self.sm.remove_member(node)


class ClusterClient:
    """Control-plane client: state fetch + mapper/dispatcher construction."""

    def __init__(self, coordinator_addr: Tuple[str, int],
                 timeout_s: float = 10.0):
        self.addr = tuple(coordinator_addr)
        self.timeout_s = timeout_s

    def state(self) -> Dict:
        reply = _rpc(self.addr, {"cmd": "state"}, self.timeout_s)
        if not reply.get("ok"):
            raise RuntimeError(reply.get("error", "state failed"))
        return reply["state"]

    def mapper(self, dataset: str) -> Tuple[ShardMapper, Dict[str, Tuple[str, int]]]:
        """(ShardMapper, node -> query address) reflecting current state,
        including the replica tails of each shard's assignment list."""
        st = self.state()
        ds = st["datasets"][dataset]
        mapper = ShardMapper(len(ds["nodes"]))
        for shard, (node, status) in enumerate(zip(ds["nodes"],
                                                   ds["statuses"])):
            if node is None:
                continue
            mapper.register_node([shard], node)
            if status == ShardStatus.ACTIVE.value:
                mapper.update_from_event(
                    ShardEvent("IngestionStarted", dataset, shard, node))
        rstatus = ds.get("replica_statuses") or {}
        for shard, repls in enumerate(ds.get("replicas") or []):
            for node in repls:
                mapper.register_replica(
                    shard, node,
                    status=ShardStatus(rstatus.get(f"{shard}:{node}",
                                                   "Assigned")))
        addrs = {n: tuple(a) for n, a in st["nodes"].items()}
        return mapper, addrs


class NodeAgent:
    """Node-side membership: register, heartbeat, apply assignment diffs.

    `on_assign(dataset, shard)` runs once per newly-assigned shard (setup +
    recovery); when it returns the shard is reported active on subsequent
    heartbeats.  `on_unassign` is invoked for shards taken away."""

    def __init__(self, node_name: str, coordinator_addr: Tuple[str, int],
                 query_addr: Tuple[str, int],
                 on_assign: Callable[[str, int], None],
                 on_unassign: Optional[Callable[[str, int], None]] = None,
                 heartbeat_interval_s: float = 1.0):
        self.node = node_name
        self.coordinator_addr = tuple(coordinator_addr)
        self.query_addr = tuple(query_addr)
        self.on_assign = on_assign
        self.on_unassign = on_unassign
        self.heartbeat_interval_s = heartbeat_interval_s
        self._lock = threading.Lock()
        self._owned: Dict[str, set] = {}       # dataset -> recovered shards
        # (ds, shard) -> epoch of the CURRENT assignment attempt.  Epochs
        # defeat the revoke-then-reassign ABA: a recovery started under an
        # older epoch must neither claim ownership nor cancel the newer
        # attempt when it finally completes.
        self._scheduled: Dict[Tuple[str, int], int] = {}
        self._epoch = 0
        self._assign_q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._applier: Optional[threading.Thread] = None
        self.errors = 0

    def register(self) -> None:
        reply = _rpc(self.coordinator_addr,
                     {"cmd": "register", "node": self.node,
                      "query_addr": list(self.query_addr)})
        if not reply.get("ok"):
            raise RuntimeError(reply.get("error", "register failed"))
        self._apply(reply.get("assignments") or {})

    def _apply(self, assignments: Dict[str, List[int]]) -> None:
        """Diff assignments; recovery work (on_assign) runs on the applier
        thread so a long index recovery never starves heartbeats — the
        coordinator's deathwatch must not declare a RECOVERING node dead."""
        with self._lock:
            for ds, shards in assignments.items():
                for s in shards:
                    key = (ds, int(s))
                    if int(s) not in self._owned.get(ds, set()) \
                            and key not in self._scheduled:
                        self._epoch += 1
                        self._scheduled[key] = self._epoch
                        self._assign_q.put((key, self._epoch))
            # revocations: drop owned shards AND cancel ones still queued
            # or mid-recovery so the applier doesn't resurrect them
            for ds, owned in self._owned.items():
                now = set(assignments.get(ds, []))
                for s in sorted(owned - now):
                    if self.on_unassign is not None:
                        self.on_unassign(ds, int(s))
                    owned.discard(s)
            for key in list(self._scheduled):
                if key[1] not in set(assignments.get(key[0], [])):
                    del self._scheduled[key]

    def _applier_loop(self) -> None:
        while not self._stop.is_set():
            try:
                (ds, s), epoch = self._assign_q.get(timeout=0.2)
            except queue.Empty:
                continue
            with self._lock:
                if self._scheduled.get((ds, s)) != epoch:
                    continue            # revoked/superseded while queued
            try:
                self.on_assign(ds, s)
                with self._lock:
                    # only claim ownership if THIS attempt is still the
                    # current one — a revocation (or a newer reassignment)
                    # mid-recovery means this work must be torn down
                    survived = self._scheduled.get((ds, s)) == epoch
                    if survived:
                        self._owned.setdefault(ds, set()).add(s)
                        del self._scheduled[(ds, s)]
                if not survived and self.on_unassign is not None:
                    self.on_unassign(ds, s)
            except Exception:  # noqa: BLE001
                self.errors += 1
                _log.exception("shard assignment failed: %s/%d", ds, s)
                with self._lock:
                    if self._scheduled.get((ds, s)) == epoch:
                        del self._scheduled[(ds, s)]

    def start(self) -> "NodeAgent":
        self._applier = threading.Thread(target=self._applier_loop,
                                         daemon=True)
        self._applier.start()
        self.register()
        self._thread = threading.Thread(target=self._heartbeat_loop,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in (self._thread, self._applier):
            if t:
                t.join(timeout=5)

    @property
    def owned(self) -> Dict[str, List[int]]:
        with self._lock:
            return {ds: sorted(s) for ds, s in self._owned.items()}

    def _heartbeat_loop(self) -> None:
        from filodb_tpu_torch.utils.faults import faults
        while not self._stop.wait(self.heartbeat_interval_s):
            try:
                faults.fire("cluster.heartbeat")
                reply = _rpc(self.coordinator_addr,
                             {"cmd": "heartbeat", "node": self.node,
                              "active": self.owned},  # locked snapshot
                             timeout_s=self.heartbeat_interval_s * 4)
                if reply.get("rejoin"):
                    self.register()
                elif reply.get("ok"):
                    self._apply(reply.get("assignments") or {})
            except (OSError, RuntimeError, json.JSONDecodeError):
                self.errors += 1
