"""Health model: fold the fleet's scattered state into one verdict tree
(port of filodb_tpu/utils/health.py, a JAX-free copy; in the port the
`jit_compile` events it reads are kernel-library builds, and the WAL
reports every dataset as not enabled until the WAL is ported).

The reference serves this as HealthRoute.scala / ClusterApiRoute.scala
shard-status admin; Prometheus splits it into /-/healthy (liveness) and
/-/ready (readiness).  Here:

    GET /healthz               liveness — the process and its HTTP loop
                               answer; always 200 while alive
    GET /ready                 readiness — 503 during boot WAL replay /
                               shard recovery and while a critical
                               subsystem is failed; the signal a load
                               balancer or rolling restart waits on
    GET /api/v1/status/health  the full per-subsystem verdict tree

`HealthEvaluator` computes the tree on demand from the live sources —
the job registry (consecutive-error streaks), the breaker registry
(open peers), WAL replay/commit state, shard-mapper statuses, and
recent device-mirror over-cap degrades from the event journal — so the
verdict can never go stale between polls.  Verdicts are ok | degraded |
failed, worst-wins up the tree.

Phase machinery: the server moves booting -> replaying_wal -> booted ->
serving -> stopping; every transition lands in the event journal, and
/ready answers 200 only in `serving` — which is what makes "the node
restarted, replayed its WAL, and took traffic again" one greppable
sequence in /admin/events.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

OK, DEGRADED, FAILED = "ok", "degraded", "failed"
_RANK = {OK: 0, DEGRADED: 1, FAILED: 2}

BOOTING = "booting"
REPLAYING_WAL = "replaying_wal"
BOOTED = "booted"
SERVING = "serving"
STOPPING = "stopping"

# mirror over-cap degrades older than this no longer color the verdict
# (counters are cumulative; one spill a week ago is not a live problem)
RECENT_WINDOW_S = 300.0


def _worst(verdicts) -> str:
    out = OK
    for v in verdicts:
        if _RANK.get(v, 0) > _RANK[out]:
            out = v
    return out


class HealthEvaluator:
    """One server's health state + verdict computation.  Attached to
    PromHttpApi by FiloServer; bare API constructions get a default
    instance already in `serving` so route-level tests behave as
    before."""

    def __init__(self, node_name: str = "local", phase: str = SERVING):
        self.node = node_name
        self.phase = phase
        # non-empty while this node is drained for a rolling restart
        # (replication/handoff.py drain; POST /admin/shards/../handoff
        # with drain=true): /ready answers 503 so the load balancer
        # stops routing here before the process restarts
        self.draining = ""
        self._lock = threading.Lock()
        self.started_unix_s = time.time()
        # dataset -> {"enabled", "replayDone", "replayRecords", ...}
        self._wal: Dict[str, dict] = {}
        # dataset -> ShardMapper (status snapshots on demand)
        self.shard_mappers: Dict[str, object] = {}
        # extra per-subsystem probes: name -> zero-arg callable returning
        # a {"status": ...} dict (lets tests and future subsystems plug
        # in without touching the evaluator)
        self.probes: Dict[str, Callable[[], dict]] = {}
        # disaggregated cold tier (persist/objectstore.py): dataset ->
        # manifest mount completed.  A node with the shared tier
        # configured — data node restoring on boot, or a stateless
        # query-only node — answers /ready 503 until every mount lands:
        # serving cold ranges before the catalog is readable would
        # return silently-short "full" results
        self._manifest_mounts: Dict[str, bool] = {}

    # ------------------------------------------------------------ phases

    def set_phase(self, phase: str, **fields) -> None:
        from filodb_tpu_torch.utils.events import journal
        with self._lock:
            prev, self.phase = self.phase, phase
        if prev != phase:
            journal.emit("phase", subsystem="server", node=self.node,
                         frm=prev, to=phase, **fields)

    # --------------------------------------------------------------- wal

    def note_wal(self, dataset: str, enabled: bool,
                 replay_done: bool = False, stats=None) -> None:
        ent = {"enabled": enabled, "replayDone": replay_done}
        if stats is not None:
            ent.update({"replayRecords": stats.records,
                        "replaySamples": stats.samples,
                        "corruptSegments": stats.corrupt_segments,
                        "replaySeconds": round(stats.elapsed_s, 3)})
        with self._lock:
            self._wal[dataset] = ent

    def wal_summary(self) -> Dict[str, dict]:
        with self._lock:
            return {ds: dict(ent) for ds, ent in self._wal.items()}

    # ------------------------------------------------------- persistence

    def note_manifest_mount(self, dataset: str, mounted: bool) -> None:
        """Cold-tier manifest mount progress (persist/objectstore.py):
        registered False when the shared tier is configured, flipped
        True once the mount/restore lands — /ready gates on it."""
        with self._lock:
            self._manifest_mounts[dataset] = bool(mounted)

    def pending_manifest_mounts(self) -> List[str]:
        with self._lock:
            return sorted(ds for ds, ok in self._manifest_mounts.items()
                          if not ok)

    # --------------------------------------------------------- subsystems

    def _jobs_verdict(self) -> dict:
        from filodb_tpu_torch.utils.jobs import jobs
        per = {}
        worst = OK
        critical_failed: List[str] = []
        for snap in jobs.snapshot():
            streak = snap["consecutiveErrors"]
            # the per-handle threshold — the same one note_error journals
            # the job_failed edge at, so the verdict and the flight
            # recorder can never disagree about where "failed" starts
            if streak >= snap["failedStreak"]:
                v = FAILED
            elif streak > 0:
                v = DEGRADED
            else:
                v = OK
            if v == FAILED and snap["critical"]:
                critical_failed.append(snap["job"])
            key = snap["job"] + (f":{snap['dataset']}"
                                 if snap["dataset"] else "")
            per[key] = {"status": v, "consecutiveErrors": streak,
                        "lastError": snap["lastError"],
                        "progress": snap["progress"]}
            worst = _worst((worst, v))
        return {"status": worst, "jobs": per,
                "criticalFailed": sorted(critical_failed)}

    def _peers_verdict(self) -> dict:
        from filodb_tpu_torch.parallel.breaker import breakers
        open_peers, half_open = [], []
        for b in breakers.snapshot():
            if b["state"] == "open":
                open_peers.append(b["peer"])
            elif b["state"] == "half_open":
                half_open.append(b["peer"])
        status = DEGRADED if (open_peers or half_open) else OK
        return {"status": status, "open": sorted(open_peers),
                "halfOpen": sorted(half_open)}

    def _wal_verdict(self) -> dict:
        with self._lock:
            datasets = {ds: dict(ent) for ds, ent in self._wal.items()}
        worst = OK
        for ent in datasets.values():
            if ent["enabled"] and not ent["replayDone"]:
                worst = _worst((worst, DEGRADED))
            if ent.get("corruptSegments"):
                # acknowledged data was lost in the damaged region —
                # serving works, but the durability claim is degraded
                worst = _worst((worst, DEGRADED))
        return {"status": worst, "datasets": datasets}

    def _shards_verdict(self) -> dict:
        datasets = {}
        worst = OK
        recovering = 0
        for ds, mapper in self.shard_mappers.items():
            snap = mapper.status_snapshot()
            by_status: Dict[str, int] = {}
            for _i, (_addr, st) in snap.items():
                by_status[st] = by_status.get(st, 0) + 1
            active = by_status.get("Active", 0)
            rec = by_status.get("Recovery", 0)
            bad = by_status.get("Error", 0) + by_status.get("Down", 0)
            recovering += rec
            v = OK
            if rec or (bad and active):
                v = DEGRADED
            if len(snap) and active == 0:
                v = FAILED
            ent = {"counts": by_status}
            # replication intent vs reality (doc/replication.md): a
            # shard short of its owner target — in particular a primary
            # serving with ZERO live replicas — is one failure from
            # partials, so the verdict degrades even though serving is
            # currently fine
            rf = getattr(mapper, "replication_factor", 1)
            if rf >= 2 and hasattr(mapper, "live_owners"):
                under = dead = 0
                for s in range(mapper.num_shards):
                    live = len(mapper.live_owners(s))
                    if live == 0:
                        dead += 1
                    elif live < rf:
                        under += 1
                ent["underReplicated"] = under
                ent["noLiveOwners"] = dead
                if dead:
                    v = FAILED
                elif under:
                    v = _worst((v, DEGRADED))
            worst = _worst((worst, v))
            ent["status"] = v
            datasets[ds] = ent
        return {"status": worst, "datasets": datasets,
                "recovering": recovering}

    def _ingest_verdict(self) -> dict:
        """Write-path freshness SLO (utils/freshness.py): sustained
        ingest-to-ack breaches — e.g. a disk whose fsyncs started
        stalling — degrade the verdict until the breach window drains.
        A single slow batch never colors it; the tracker requires
        `ingest.freshness_breach_count` breaches inside the window."""
        from filodb_tpu_torch.utils.freshness import freshness
        return freshness.verdict()

    def _mirror_verdict(self) -> dict:
        from filodb_tpu_torch.utils.events import journal
        cutoff = time.time() - RECENT_WINDOW_S
        recent = [ev for ev in journal.since(0, kind="mirror_over_cap")
                  if ev["unixSeconds"] >= cutoff]
        return {"status": DEGRADED if recent else OK,
                "recentOverCap": len(recent)}

    # compile-storm threshold: this many query-attributed jit compiles
    # of the SAME kernel inside RECENT_WINDOW_S degrade the device
    # subsystem.  A storm is one kernel recompiling over and over (new
    # shapes defeating its trace cache); scattered first-compiles across
    # many kernels are a process warming up, not a storm.  Boot warmup
    # compiles carry no origin and never count.
    compile_storm_count = 10
    # a storm is *rapid* recompilation — 10 same-kernel compiles inside
    # two minutes, not 10 spread over the journal's lifetime.  Tighter
    # than RECENT_WINDOW_S on purpose: organic shape churn (new
    # datasets warming, ad-hoc queries) trickles compiles in slowly.
    compile_storm_window_s = 120.0
    # sustained HBM pressure: this many over-cap degrades in the window
    # (one spill is the mirror subsystem's business; a stream of them
    # means placement is thrashing)
    device_over_cap_count = 3

    def _device_verdict(self) -> dict:
        """Device telemetry verdict (utils/devicetelem): a
        recompile storm (every query paying a compile: in the port a
        kernel-library build) or sustained HBM over-cap degrades ⇒
        degraded, with the counts an operator needs to pick between
        /admin/devices and the slowlog as the next hop."""
        from filodb_tpu_torch.utils.events import journal
        now = time.time()
        compiles = [ev for ev in journal.since(0, kind="jit_compile")
                    if ev["unixSeconds"] >= now - self.compile_storm_window_s
                    and ev.get("origin")]
        over_cap = [ev for ev in journal.since(0, kind="mirror_over_cap")
                    if ev["unixSeconds"] >= now - RECENT_WINDOW_S]
        by_kernel: dict = {}
        for ev in compiles:
            k = ev.get("kernel", "")
            by_kernel[k] = by_kernel.get(k, 0) + 1
        storm_kernel, storm_n = "", 0
        if by_kernel:
            storm_kernel = max(by_kernel, key=by_kernel.get)
            storm_n = by_kernel[storm_kernel]
        status = OK
        reasons = []
        if storm_n >= self.compile_storm_count:
            status = DEGRADED
            reasons.append("compile_storm")
        if len(over_cap) >= self.device_over_cap_count:
            status = DEGRADED
            reasons.append("hbm_over_cap")
        return {"status": status, "reasons": reasons,
                "recentCompiles": len(compiles),
                "stormKernel": storm_kernel if storm_n >= self.compile_storm_count else "",
                "recentOverCap": len(over_cap)}

    # ----------------------------------------------------------- verdicts

    def evaluate(self) -> dict:
        subs = {
            "jobs": self._jobs_verdict(),
            "peers": self._peers_verdict(),
            "wal": self._wal_verdict(),
            "shards": self._shards_verdict(),
            "mirror": self._mirror_verdict(),
            "ingest": self._ingest_verdict(),
            "device": self._device_verdict(),
        }
        for name, probe in self.probes.items():
            try:
                subs[name] = probe()
            except Exception as e:  # noqa: BLE001 — a broken probe is a
                # verdict, not a crashed health endpoint
                subs[name] = {"status": FAILED,
                              "error": f"{type(e).__name__}: {e}"[:200]}
        status = _worst(s["status"] for s in subs.values())
        if self.phase != SERVING:
            status = _worst((status, DEGRADED))
        return {"status": status, "phase": self.phase, "node": self.node,
                "startedUnixSeconds": round(self.started_unix_s, 3),
                "subsystems": subs}

    def ready(self) -> "tuple[bool, str]":
        """(ready, reason).  Not ready during boot WAL replay / shard
        recovery and while a critical subsystem is failed — exactly the
        signal a load balancer or rolling restart needs."""
        if self.phase != SERVING:
            return False, f"phase={self.phase}"
        if self.draining:
            return False, f"draining: {self.draining}"
        jv = self._jobs_verdict()
        if jv["criticalFailed"]:
            return False, ("critical job failed: "
                           + ",".join(jv["criticalFailed"]))
        sv = self._shards_verdict()
        if sv["status"] == FAILED:
            return False, "no active shards"
        if sv["recovering"]:
            return False, f"{sv['recovering']} shard(s) recovering"
        wv = self._wal_verdict()
        for ds, ent in wv["datasets"].items():
            if ent["enabled"] and not ent["replayDone"]:
                return False, f"WAL replay pending for {ds!r}"
        pending = self.pending_manifest_mounts()
        if pending:
            return False, ("cold-tier manifest mount pending for "
                           + ",".join(repr(d) for d in pending))
        return True, "serving"
