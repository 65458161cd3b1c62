"""Cluster registry: which clusters exist, what they own, are they up
(port of filodb_tpu/federation/registry.py).

Ownership is declarative (config `federation.clusters`): per cluster a
set of label matchers (anchored regexes — the ShardKeyRegexPlanner
stance applied at cluster granularity) and/or a time ownership window.
The registry answers the planner's one question — "which clusters may
own series matching this selector over this range" — conservatively: a
cluster is excluded only when every filter group PROVABLY excludes its
matchers (an equality filter whose value the matcher regex rejects).
The deployment invariant that makes federated aggregation exact is that
each series lives in exactly one cluster; a conservatively-included
cluster that owns nothing contributes an empty partial, never a
duplicate.

Health: a background thread pings each remote cluster's federation door
(transport FPING frames) on `probe_interval_s`.  Probe results feed the
`federation_cluster_up` gauge, the flight-recorder journal, the
health model (standalone registers a `federation` subsystem probe) and
the result-cache validity token (a remote's per-dataset data tokens
ride the ping reply, so a remote ingesting new data invalidates
federated cache entries exactly like local ingest does).
"""
from __future__ import annotations

import dataclasses
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

from filodb_tpu_torch.core.index import Equals, In
from filodb_tpu_torch.query.planutils import TimeRange


@dataclasses.dataclass
class ClusterDef:
    """One remote cluster's declaration (config federation.clusters)."""
    name: str
    host: str = ""
    port: int = 0
    # remote dataset name; "" = same name as the local dataset
    dataset: str = ""
    # label ownership: {label: anchored-regex}.  A selector routes here
    # unless one of these provably excludes it.  {} = label-unconstrained
    # (owns everything inside the time window).
    match: Dict[str, str] = dataclasses.field(default_factory=dict)
    # time ownership window (ms since epoch); 0 = unbounded on that side
    time_start_ms: int = 0
    time_end_ms: int = 0
    # local=True declares what THIS cluster owns (no host/port): it lets
    # the planner skip the local child when a selector provably routes
    # elsewhere.  Without a local entry the local cluster always
    # participates (conservative default).
    local: bool = False

    def __post_init__(self):
        self._compiled = {k: re.compile(v) for k, v in self.match.items()}

    @property
    def peer(self) -> str:
        """Breaker/metrics identity for this cluster."""
        return f"cluster:{self.name}"

    def time_overlap(self, tr: TimeRange) -> Optional[TimeRange]:
        """The part of `tr` this cluster owns, or None."""
        s = max(tr.start_ms, self.time_start_ms)
        e = min(tr.end_ms, self.time_end_ms) if self.time_end_ms \
            else tr.end_ms
        if s > e:
            return None
        return TimeRange(s, e)

    @property
    def windowed(self) -> bool:
        return bool(self.time_start_ms or self.time_end_ms)

    def may_own(self, filter_groups) -> bool:
        """False only when EVERY filter group provably excludes this
        cluster's matchers (conservative: unconstrained labels, regex
        filters and empty matcher sets all keep the cluster in)."""
        if not self.match and not self.windowed:
            return False                     # inert entry owns nothing
        if not filter_groups:
            return True                      # no selectors to exclude by
        return any(self._group_may_match(g) for g in filter_groups)

    def _group_may_match(self, group) -> bool:
        for label, rx in self._compiled.items():
            for f in group:
                if f.column != label:
                    continue
                if isinstance(f, Equals) and not rx.fullmatch(f.value):
                    return False
                if isinstance(f, In) and \
                        not any(rx.fullmatch(v) for v in f.values):
                    return False
        return True


@dataclasses.dataclass
class ClusterState:
    """Mutable probe-side state for one remote cluster."""
    healthy: bool = True          # optimistic until the first probe
    probed: bool = False
    last_probe_unix: float = 0.0
    last_error: str = ""
    # consecutive probe failures / total up<->down transitions
    failures: int = 0
    transitions: int = 0
    # the remote door's ping reply: {"cluster": name,
    #  "datasets": {name: token-list}} — identity + data tokens
    info: dict = dataclasses.field(default_factory=dict)


class FederationRegistry:
    """All configured clusters + their live health, one per server."""

    def __init__(self, config, local_name: str = ""):
        self.config = config
        self.local_name = local_name or getattr(config, "cluster_name",
                                                "local")
        self.clusters: Dict[str, ClusterDef] = {}
        self.local_def: Optional[ClusterDef] = None
        self._states: Dict[str, ClusterState] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        for name, raw in sorted((config.clusters or {}).items()):
            cd = self._parse(name, raw or {})
            if cd.local:
                self.local_def = cd
            else:
                self.clusters[name] = cd
                self._states[name] = ClusterState()

    @staticmethod
    def _parse(name: str, raw: dict) -> ClusterDef:
        from filodb_tpu_torch.config import ConfigError
        known = {"host", "port", "dataset", "match", "time_start_ms",
                 "time_end_ms", "local"}
        bad = set(raw) - known
        if bad:
            raise ConfigError(
                f"federation.clusters.{name}: unknown keys {sorted(bad)} "
                f"(valid: {sorted(known)})")
        cd = ClusterDef(
            name=name, host=str(raw.get("host", "")),
            port=int(raw.get("port", 0) or 0),
            dataset=str(raw.get("dataset", "")),
            match={str(k): str(v)
                   for k, v in (raw.get("match") or {}).items()},
            time_start_ms=int(raw.get("time_start_ms", 0) or 0),
            time_end_ms=int(raw.get("time_end_ms", 0) or 0),
            local=bool(raw.get("local", False)))
        if not cd.local and (not cd.host or not cd.port):
            raise ConfigError(
                f"federation.clusters.{name}: remote clusters need "
                f"host and port (or local: true)")
        return cd

    # ------------------------------------------------------------ routing

    def owners_for(self, filter_groups, tr: TimeRange
                   ) -> Tuple[bool, List[Tuple[ClusterDef, TimeRange]]]:
        """(local_participates, [(remote cluster, owned time range)]).

        Local participates unless a `local: true` entry's matchers
        provably exclude every filter group (or its window misses the
        query range)."""
        remotes: List[Tuple[ClusterDef, TimeRange]] = []
        for name in sorted(self.clusters):
            cd = self.clusters[name]
            if not cd.may_own(filter_groups):
                continue
            eff = cd.time_overlap(tr)
            if eff is None:
                continue
            remotes.append((cd, eff))
        local = True
        if self.local_def is not None:
            local = self.local_def.may_own(filter_groups) and \
                self.local_def.time_overlap(tr) is not None
        return local, remotes

    def local_range(self, tr: TimeRange) -> TimeRange:
        """The slice of `tr` the local cluster owns (whole range without
        a windowed local declaration)."""
        if self.local_def is not None:
            eff = self.local_def.time_overlap(tr)
            if eff is not None:
                return eff
        return tr

    # ------------------------------------------------------------- health

    def state(self, name: str) -> ClusterState:
        return self._states[name]

    def probe_once(self) -> None:
        """Ping every remote cluster's door once; update states, journal
        transitions, refresh the federation_cluster_up gauges."""
        from filodb_tpu_torch.parallel.transport import send_ping
        from filodb_tpu_torch.utils.events import journal
        from filodb_tpu_torch.utils.metrics import registry
        timeout = getattr(self.config, "probe_timeout_s", 2.0)
        for name, cd in self.clusters.items():
            st = self._states[name]
            try:
                info = send_ping(cd.host, cd.port, timeout_s=timeout)
                up, err = True, ""
            except (OSError, ConnectionError, ValueError) as e:
                info, up = {}, False
                err = f"{type(e).__name__}: {e}"
            with self._lock:
                was = st.healthy
                st.probed = True
                st.last_probe_unix = time.time()
                st.last_error = err
                if up:
                    st.failures = 0
                    st.info = info
                else:
                    st.failures += 1
                st.healthy = up
                if was != up:
                    st.transitions += 1
            registry.gauge("federation_cluster_up",
                           cluster=name).update(1.0 if up else 0.0)
            if was != up:
                journal.emit("federation_cluster_up" if up
                             else "federation_cluster_down",
                             subsystem="federation", cluster=name,
                             error=err)

    def start(self) -> "FederationRegistry":
        interval = max(float(getattr(self.config, "probe_interval_s",
                                     5.0)), 0.1)

        def loop():
            # first probe immediately so health/ownership views are
            # populated as soon as the server is up
            while not self._stop.is_set():
                try:
                    self.probe_once()
                except Exception:  # noqa: BLE001 — probes must not die
                    pass
                self._stop.wait(interval)

        if self.clusters and self._thread is None:
            self._thread = threading.Thread(target=loop, daemon=True,
                                            name="federation-probe")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -------------------------------------------------- observability etc.

    def snapshot(self) -> List[dict]:
        """GET /admin/federation rows."""
        out = []
        for name in sorted(self.clusters):
            cd = self.clusters[name]
            with self._lock:
                st = self._states[name]
                out.append({
                    "cluster": name,
                    "endpoint": f"{cd.host}:{cd.port}",
                    "dataset": cd.dataset or "(same)",
                    "match": dict(cd.match),
                    "timeStartMs": cd.time_start_ms,
                    "timeEndMs": cd.time_end_ms,
                    "healthy": st.healthy,
                    "probed": st.probed,
                    "lastProbeUnix": round(st.last_probe_unix, 3),
                    "lastError": st.last_error,
                    "consecutiveFailures": st.failures,
                    "transitions": st.transitions,
                    "remoteCluster": st.info.get("cluster", ""),
                })
        return out

    def health_probe(self) -> dict:
        """Health-subsystem verdict: ok while every configured
        cluster's last probe succeeded; degraded (never down — the local
        cluster still serves) when any remote is unreachable."""
        down = [n for n, st in self._states.items()
                if st.probed and not st.healthy]
        if down:
            return {"status": "degraded",
                    "reason": f"clusters down: {', '.join(sorted(down))}"}
        return {"status": "ok",
                "reason": f"{len(self.clusters)} cluster(s) healthy"}

    def cache_state(self) -> tuple:
        """Result-cache validity contribution: the participating
        cluster set, each cluster's health and its door's per-dataset
        data tokens.  A cluster dying, recovering (transitions bump) or
        ingesting new data (token change) all invalidate federated
        entries — a degraded answer can never be served as a later full
        one."""
        out = []
        with self._lock:
            for name in sorted(self._states):
                st = self._states[name]
                toks = st.info.get("datasets")
                out.append((name, st.healthy, st.transitions,
                            tuple(sorted(map(str, (toks or {}).items())))))
        return tuple(out)
