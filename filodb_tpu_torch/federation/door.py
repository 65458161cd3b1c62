"""The federation door: the socket a remote coordinator's federated
leaves arrive at, and the source they resolve datasets against (port of
filodb_tpu/federation/door.py).  The source carries its cluster's
device: the door stamps it on every decoded leaf, so the re-planned
subtree runs where that cluster's memstore lives.

One door per cluster.  It is a plain NodeQueryServer (parallel/
transport.py) — CRC-framed plan dispatches, streamed replies, FKILL
kill frames, FPING health probes all behave exactly as between nodes —
whose `source` is a FederationSource: instead of shard memory it maps a
dataset name to (this cluster's planner stack, this cluster's store
source), which is what a decoded FederatedLeafExec executes against.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

from filodb_tpu_torch.parallel.transport import NodeQueryServer


class FederationSource:
    """dataset name -> (planner, store source) for remote federated
    leaves.  "" resolves to the default dataset (a coordinator whose
    cluster config omits `dataset:` queries the same-named one)."""

    def __init__(self, cluster_name: str = "", device=None):
        self.cluster_name = cluster_name
        # where decoded leaves execute (the first registered source's
        # device unless given)
        self.device = device
        self._entries: Dict[str, Tuple[object, object, Optional[Callable]]] \
            = {}
        self._default: str = ""
        self._lock = threading.Lock()

    def register(self, dataset: str, planner, source,
                 token_fn: Optional[Callable] = None,
                 default: bool = False) -> None:
        """`planner` is this cluster's OWN stack for the dataset — when
        it is itself a FederationPlanner the inner planner is used, so a
        mutually-federated pair can never bounce a subtree back and
        forth.  `token_fn() -> token` is the dataset's data-validity
        token (rides FPING replies into the remote coordinator's
        result-cache key)."""
        inner = getattr(planner, "inner", None)
        from filodb_tpu_torch.federation.planner import FederationPlanner
        if isinstance(planner, FederationPlanner) and inner is not None:
            planner = inner
        with self._lock:
            if self.device is None:
                self.device = getattr(source, "device", None)
            self._entries[dataset] = (planner, source, token_fn)
            if default or not self._default:
                self._default = dataset

    def resolve(self, dataset: str) -> Tuple[object, object]:
        with self._lock:
            name = dataset or self._default
            ent = self._entries.get(name)
        if ent is None:
            raise ValueError(
                f"cluster {self.cluster_name or '?'} serves no dataset "
                f"{name!r} at its federation door "
                f"(registered: {sorted(self._entries)})")
        return ent[0], ent[1]

    def ping_info(self) -> dict:
        """FPING reply body: cluster identity + per-dataset data tokens.
        A remote coordinator folds the tokens into its federated
        result-cache validity, so ingest HERE invalidates cached
        federated answers THERE exactly like local ingest does."""
        with self._lock:
            items = list(self._entries.items())
        datasets = {}
        for name, (_, _, token_fn) in items:
            if token_fn is None:
                continue
            try:
                datasets[name] = str(token_fn())
            except Exception:  # noqa: BLE001 — a probe must never fail here
                datasets[name] = "?"
        return {"cluster": self.cluster_name, "datasets": datasets}


class FederationDoor:
    """NodeQueryServer + FederationSource, bound to this cluster's name.

    start() binds the socket (port 0 = ephemeral, read back via .port —
    the test pair wires each cluster's door port into the other's
    config).  stop() severs live connections like a node death, which is
    exactly what a SIGKILLed cluster looks like to its peers."""

    def __init__(self, cluster_name: str, host: str = "127.0.0.1",
                 port: int = 0, device=None):
        self.cluster_name = cluster_name
        self.host = host
        self._want_port = port
        self.source = FederationSource(cluster_name, device=device)
        self._server: Optional[NodeQueryServer] = None

    def register(self, dataset: str, planner, source,
                 token_fn: Optional[Callable] = None,
                 default: bool = False) -> None:
        self.source.register(dataset, planner, source, token_fn=token_fn,
                             default=default)

    def start(self) -> "FederationDoor":
        if self._server is None:
            self._server = NodeQueryServer(
                self.source, host=self.host, port=self._want_port,
                ping_info=self.source.ping_info)
            self._server.start()
        return self

    @property
    def port(self) -> int:
        if self._server is None:
            return self._want_port
        return self._server.address[1]

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop()
            self._server = None
