"""Cluster seed discovery — the akka-bootstrapper analogue (port of
filodb_tpu/parallel/bootstrap.py).

ref: akka-bootstrapper/.../AkkaBootstrapper.scala:31-50 +
ClusterSeedDiscovery.scala:84 — a joining node discovers existing cluster
seeds via (a) an explicit seed list, (b) DNS SRV records, or (c) an HTTP
`/__members` endpoint served by live members; if nobody answers, it forms a
new cluster with itself as the first seed.

The TPU-native control plane uses the same shapes: `discover()` returns
live (host, port) coordinator addresses to hand to the ShardManager's
add_member, and `members_payload()` is what the HTTP layer serves at
/__members so later joiners find the cluster.
"""
from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import List, Optional, Sequence, Tuple

Address = Tuple[str, int]


class ClusterSeedDiscovery:
    """ref: ClusterSeedDiscovery trait."""

    def discover(self) -> List[Address]:
        raise NotImplementedError


class ExplicitListSeedDiscovery(ClusterSeedDiscovery):
    """Static seed list (ref: ExplicitListClusterSeedDiscovery)."""

    def __init__(self, seeds: Sequence[Address]):
        self.seeds = list(seeds)

    def discover(self) -> List[Address]:
        return list(self.seeds)


class DnsSrvSeedDiscovery(ClusterSeedDiscovery):
    """DNS SRV lookup (ref: DnsSrvClusterSeedDiscovery.scala:122).  Uses a
    pluggable resolver because stdlib has no SRV client; deployments pass
    one backed by their resolver library."""

    def __init__(self, srv_name: str,
                 resolver=None):
        self.srv_name = srv_name
        self.resolver = resolver

    def discover(self) -> List[Address]:
        if self.resolver is None:
            raise RuntimeError("DNS SRV discovery needs a resolver callable "
                               "(srv_name -> [(host, port)])")
        return list(self.resolver(self.srv_name))


class HttpMembersSeedDiscovery(ClusterSeedDiscovery):
    """Ask candidate endpoints for their member list via /__members
    (ref: the seed HTTP endpoint AkkaBootstrapper exposes)."""

    def __init__(self, candidates: Sequence[Address], timeout_s: float = 5.0):
        self.candidates = list(candidates)
        self.timeout_s = timeout_s

    def discover(self) -> List[Address]:
        for host, port in self.candidates:
            try:
                with urllib.request.urlopen(
                        f"http://{host}:{port}/__members",
                        timeout=self.timeout_s) as r:
                    payload = json.loads(r.read())
                members = [(m["host"], int(m["port"]))
                           for m in payload.get("members", [])]
                if members:
                    return members
            except (OSError, ValueError, KeyError, TypeError,
                    AttributeError):
                # unreachable OR malformed answer: try the next candidate —
                # discovery must degrade to self-seeding, never crash
                continue
        return []


class ConsulSeedDiscovery(ClusterSeedDiscovery):
    """Consul-backed seed discovery (ref: akka-bootstrapper/.../
    ConsulClient.scala:29 + DnsSrvClusterSeedDiscovery.scala:95
    ConsulClusterSeedDiscovery): a joining node REGISTERS itself with the
    local Consul agent and discovers live seeds from Consul's catalog.
    The reference resolves seeds through Consul's DNS-SRV interface; this
    client uses the equivalent HTTP health API
    (GET /v1/health/service/<name>?passing=true) so no SRV resolver
    dependency is needed — same catalog, same liveness filter."""

    def __init__(self, service_name: str,
                 consul_host: str = "127.0.0.1", consul_port: int = 8500,
                 timeout_s: float = 5.0):
        self.service_name = service_name
        self.base = f"http://{consul_host}:{consul_port}"
        self.timeout_s = timeout_s
        self._service_id: Optional[str] = None

    def register(self, host: str, port: int) -> str:
        """PUT /v1/agent/service/register (ref: ConsulClient.register:38).
        Returns the service id used for deregistration."""
        service_id = f"{self.service_name}-{host}-{port}"
        payload = json.dumps({"id": service_id, "name": self.service_name,
                              "address": host, "port": port}).encode()
        req = urllib.request.Request(
            f"{self.base}/v1/agent/service/register", data=payload,
            method="PUT", headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s):
                pass
        except urllib.error.HTTPError as e:
            raise RuntimeError(
                f"consul registration failed: HTTP {e.code} {e.reason}"
            ) from e
        except OSError as e:             # agent unreachable / refused
            raise RuntimeError(f"consul agent unreachable: {e}") from e
        self._service_id = service_id
        return service_id

    def deregister(self) -> None:
        """PUT /v1/agent/service/deregister/<id> (ref:
        ConsulClient.deregister:50) — the reference runs this from a
        shutdown hook."""
        if self._service_id is None:
            return
        req = urllib.request.Request(
            f"{self.base}/v1/agent/service/deregister/{self._service_id}",
            data=b"", method="PUT")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s):
                pass
        except OSError:
            # shutdown-hook context: a down agent must not abort the rest
            # of shutdown; the registration expires with the agent anyway
            pass
        self._service_id = None

    def discover(self) -> List[Address]:
        try:
            with urllib.request.urlopen(
                    f"{self.base}/v1/health/service/{self.service_name}"
                    f"?passing=true", timeout=self.timeout_s) as r:
                entries = json.loads(r.read())
        except (OSError, ValueError):
            return []               # agent down: degrade to self-seeding
        out: List[Address] = []
        for e in entries:
            try:
                svc = e["Service"]
                host = svc.get("Address") or e.get("Node", {}).get("Address")
                if not host:
                    continue             # malformed entry: skip, don't crash
                out.append((host, int(svc["Port"])))
            except (KeyError, TypeError, ValueError):
                continue
        return out


def bootstrap(discovery: ClusterSeedDiscovery, self_addr: Address,
              join_fn, retries: int = 3) -> List[Address]:
    """Join discovered seeds, or seed a new cluster with ourselves when no
    one answers (ref: AkkaBootstrapper.bootstrap: retry then
    joinSeedNodes(self))."""
    for _ in range(retries):
        seeds = [s for s in discovery.discover() if s != self_addr]
        if seeds:
            join_fn(seeds)
            return seeds
    join_fn([self_addr])
    return [self_addr]


def members_payload(members: Sequence[Address]) -> dict:
    """The /__members response body served by live nodes."""
    return {"members": [{"host": h, "port": p} for h, p in members]}
