"""The Ruler: scheduled evaluation of rule groups, recording write-back,
and the alert state machine (port of filodb_tpu/rules/ruler.py; each
evaluation is an instant query through the port's QueryFrontend, so a
rule over a card store runs the fused kernels there).

Semantics follow Prometheus' rule manager (ref: Cortex's ruler service,
which runs the same manager against a remote store; Monarch's standing
queries, VLDB'20 §5):

  * one evaluation loop per group, ticks aligned to the group interval
    with a DETERMINISTIC per-group stagger (xxhash32 of the group name)
    so N groups sharing an interval don't thundering-herd the frontend
    at :00 boundaries;
  * rules evaluate SEQUENTIALLY within a group — a later rule's instant
    query sees earlier rules' freshly-recorded output at the same
    evaluation timestamp (write-back is synchronous columnar ingest);
  * an iteration that overruns its interval SKIPS the missed ticks
    (`rule_group_iterations_missed`) — standing queries precompute the
    present, they never backfill the past;
  * every rule evaluates as an instant query through the QueryFrontend —
    admission, the concurrency bound, tenant accounting as `_rules_`,
    and a per-group deadline equal to the group interval riding the PR-4
    deadline machinery (an evaluation can never outlive its slot);
  * partial results NEVER record: the iteration fails, is counted, and
    alert state holds (a dead shard must not flap a firing alert or
    write a half-aggregate the dashboards would trust).

Alert state machine: inactive -> pending (`for:`) -> firing ->
`keep_firing_for`.  Synthetic `ALERTS{alertstate=...}` and
`ALERTS_FOR_STATE` (value = activeAt unix seconds) series are written
back each iteration, so alert state survives restart by replaying
`ALERTS_FOR_STATE` from the store — exactly Prometheus' restore path.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.query.rangevector import PlannerParams
from filodb_tpu_torch.rules.config import (Rule, RuleGroup, RulesConfigError,
                                           load_rule_groups)
from filodb_tpu_torch.rules.notifier import WebhookNotifier
from filodb_tpu_torch.utils import iso_utc as _iso
from filodb_tpu_torch.utils.hashing import xxhash32

PENDING = "pending"
FIRING = "firing"

# seconds-scale bounds for the eval-duration / group-lag histograms (the
# registry default is tuned for millisecond latencies)
_SECONDS_BOUNDS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                   2.5, 5.0, 10.0, 30.0, 60.0, 300.0)


class MemstoreSink:
    """Write-back path for recorded/synthetic series: shard-routed
    columnar ingest (`TimeSeriesShard.ingest_columns`), so recorded
    series are immediately queryable, flushable and downsample-eligible
    exactly like gateway-ingested series."""

    SCHEMA = "gauge"

    def __init__(self, memstore, dataset: str, mapper=None,
                 spread_provider=None):
        from filodb_tpu_torch.parallel.shardmapper import SpreadProvider
        self.memstore = memstore
        self.dataset = dataset
        self.mapper = mapper
        self.spread = spread_provider or SpreadProvider(0)

    def write(self, part_keys: Sequence[PartKey], ts_ms: int,
              values: Sequence[float]) -> int:
        """One evaluation's output vector at one timestamp.  Raises on
        any shard failure — the caller fails (and counts) the WHOLE
        iteration; dashboards must never see a half-recorded aggregate
        presented as the real thing."""
        if not part_keys:
            return 0
        vals = np.asarray(values, dtype=np.float64).reshape(-1, 1)
        if self.mapper is None:
            shard_of = np.zeros(len(part_keys), dtype=np.int64)
        else:
            shard_of = np.asarray([
                self.mapper.ingestion_shard(
                    pk.shard_key_hash(), pk.partition_hash(),
                    self.spread.spread_for(pk.shard_key()))
                for pk in part_keys])
        shards = {}
        for s in np.unique(shard_of).tolist():
            shard = self.memstore.get_shard(self.dataset, s)
            if shard is None:
                raise ConnectionError(
                    f"record write: shard {s} of {self.dataset!r} "
                    "is not locally owned")
            shards[s] = shard
        n = 0
        for s, shard in shards.items():
            idx = np.flatnonzero(shard_of == s)
            keys = [part_keys[i] for i in idx.tolist()]
            ts = np.full((len(keys), 1), int(ts_ms), dtype=np.int64)
            n += shard.ingest_columns(self.SCHEMA, keys, ts,
                                      {"value": vals[idx]})
        return n


class _AlertInstance:
    __slots__ = ("labels", "state", "active_at_s", "keep_since_s",
                 "last_notified_s", "value")

    def __init__(self, labels: Dict[str, str], active_at_s: float):
        self.labels = labels
        self.state = PENDING
        self.active_at_s = active_at_s
        # first ABSENT evaluation while firing: the keep_firing_for
        # clock starts here (Prometheus keepFiringSince), not at the
        # last present tick — evaluation gaps must not eat the hold
        self.keep_since_s = 0.0
        self.last_notified_s = 0.0   # 0 = never delivered
        self.value = 0.0

    def clone(self) -> "_AlertInstance":
        """Private mutable copy — published instances are immutable to
        evaluation (HTTP payload readers hold references lock-free)."""
        c = _AlertInstance.__new__(_AlertInstance)
        for f in _AlertInstance.__slots__:
            setattr(c, f, getattr(self, f))
        return c

    def payload(self, rule: Rule) -> Dict:
        """`/api/v1/alerts` shape (the Prometheus API Alert object)."""
        return {"labels": dict(self.labels),
                "annotations": rule.annotations_dict,
                "state": self.state,
                "activeAt": _iso(self.active_at_s),
                "value": repr(float(self.value))}

    def webhook_payload(self, rule: Rule) -> Dict:
        """Alertmanager v4 webhook alert shape — status/startsAt/endsAt,
        NOT the API's state/activeAt (a receiver written against the
        webhook spec reads alert["status"]/["startsAt"])."""
        return {"status": "firing",
                "labels": dict(self.labels),
                "annotations": rule.annotations_dict,
                "startsAt": _iso(self.active_at_s),
                "endsAt": "",
                "generatorURL": ""}


class _RuleRuntime:
    """Mutable evaluation state for one rule (health, timings, alert
    instances keyed by sorted label tuple)."""
    __slots__ = ("rule", "health", "last_error", "last_eval_unix_s",
                 "eval_seconds", "alerts", "restored")

    def __init__(self, rule: Rule):
        self.rule = rule
        self.health = "unknown"          # ok | err | unknown
        self.last_error = ""
        self.last_eval_unix_s = 0.0
        self.eval_seconds = 0.0
        self.alerts: Dict[Tuple, _AlertInstance] = {}
        self.restored = rule.kind != "alerting"


class _GroupState:
    __slots__ = ("group", "runtimes", "runner", "last_eval_unix_s",
                 "eval_seconds", "generation")

    def __init__(self, group: RuleGroup):
        self.group = group
        self.runtimes = [_RuleRuntime(r) for r in group.rules]
        self.runner: Optional[threading.Thread] = None
        self.last_eval_unix_s = 0.0
        self.eval_seconds = 0.0
        self.generation = 0


class Ruler:
    """Standing-query engine over one dataset's QueryFrontend + sink."""

    TENANT_WS = "_rules_"

    def __init__(self, frontend, sink, groups: Optional[List[RuleGroup]]
                 = None, config=None, clock=time.time,
                 notifier: Optional[WebhookNotifier] = None,
                 config_source=None):
        if config is None:
            from filodb_tpu_torch.config import settings
            config = settings().rules
        self.config = config
        # zero-arg callable returning a FRESH RulesConfig for reload();
        # standalone wires one that re-reads the conf file from disk, so
        # /admin/rules/reload picks up edited inline `rules.groups` too
        # (None: the in-memory config is the only source — its `file`
        # is still re-read every reload)
        self.config_source = config_source
        self.frontend = frontend
        self.sink = sink
        self.clock = clock
        # _own_notifier: built from config, so reload() rebuilds it when
        # the notify_* settings change; an INJECTED notifier is the
        # caller's to manage and survives reloads untouched
        self._own_notifier = notifier is None
        self.notifier = notifier or self._build_notifier(config)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._started = False
        self._groups: Dict[str, _GroupState] = {}
        for g in (groups if groups is not None
                  else load_rule_groups(config)):
            self._groups[g.name] = _GroupState(g)

    @staticmethod
    def _build_notifier(config) -> WebhookNotifier:
        return WebhookNotifier(
            url=config.notify_url, retries=config.notify_retries,
            backoff_s=config.notify_backoff_s,
            timeout_s=config.notify_timeout_s)

    @staticmethod
    def _notify_key(config) -> Tuple:
        return (config.notify_url, config.notify_retries,
                config.notify_backoff_s, config.notify_timeout_s)

    # --------------------------------------------------------- lifecycle

    def start(self) -> "Ruler":
        with self._lock:
            self._started = True
            self._stop.clear()
            for gs in self._groups.values():
                self._start_runner(gs)
        return self

    def stop(self) -> None:
        with self._lock:
            self._started = False
            self._stop.set()
            runners = [gs.runner for gs in self._groups.values()
                       if gs.runner is not None]
            for gs in self._groups.values():
                gs.generation += 1
                gs.runner = None
        for t in runners:
            t.join(timeout=5.0)

    def _start_runner(self, gs: _GroupState) -> None:
        """Caller holds the lock.  Each runner is pinned to the group
        state's generation — a reload bumps the generation and the old
        thread exits at its next wakeup instead of racing the new one."""
        gs.generation += 1
        gen = gs.generation
        t = threading.Thread(target=self._run_group, args=(gs, gen),
                             name=f"ruler-{gs.group.name}", daemon=True)
        gs.runner = t
        t.start()

    def _run_group(self, gs: _GroupState, gen: int) -> None:
        from filodb_tpu_torch.utils.metrics import registry
        g = gs.group
        interval = g.interval_s
        # deterministic stagger: same group name -> same phase on every
        # node and every restart, spread uniformly across the interval
        stagger = (xxhash32(g.name.encode()) % max(int(
            interval * 1000.0), 1)) / 1000.0
        while not self._stop.is_set() and gs.generation == gen:
            now = self.clock()
            next_t = (math.floor((now - stagger) / interval) + 1) \
                * interval + stagger
            if self._stop.wait(max(next_t - now, 0.0)):
                return
            if gs.generation != gen:
                return
            lag = max(self.clock() - next_t, 0.0)
            registry.histogram("rule_group_lag_seconds",
                               bounds=_SECONDS_BOUNDS,
                               group=g.name).record(lag)
            # evaluate the CAPTURED state, not a name lookup: a reload
            # that swaps the group between our generation check and here
            # must not hand this retired runner the new runtimes (two
            # threads would mutate them and double-record the tick)
            self._evaluate_state(gs, ts=next_t)
            # skip-not-backfill: ticks that passed while we evaluated
            # are counted missed; the loop recomputes next_t from NOW
            behind = int((self.clock() - next_t) / interval)
            if behind >= 1:
                registry.counter("rule_group_iterations_missed",
                                 group=g.name).increment(behind)

    # -------------------------------------------------------- evaluation

    def evaluate_group(self, name: str, ts: Optional[float] = None) -> bool:
        """One full iteration of a group at evaluation timestamp `ts`
        (the SCHEDULED tick in production; tests drive a fake clock).
        Returns True iff every rule evaluated cleanly."""
        with self._lock:
            gs = self._groups.get(name)
        if gs is None:
            raise KeyError(f"no rules group {name!r}")
        return self._evaluate_state(gs, ts)

    def _evaluate_state(self, gs: _GroupState,
                        ts: Optional[float] = None) -> bool:
        from filodb_tpu_torch.utils.jobs import jobs
        from filodb_tpu_torch.utils.metrics import registry
        g = gs.group
        # whole-second evaluation timestamp: the instant-query API takes
        # int seconds, so a fractional tick (stagger is sub-second) would
        # evaluate at int(ts) but record at int(ts*1000) — a sample up to
        # 999 ms in the FUTURE of the eval time, invisible to the
        # second-order rules in this same group that the sequential
        # semantics promise can see it
        ts = float(int(ts if ts is not None else self.clock()))
        t0 = time.perf_counter()
        ok = True
        # unified job registry: one handle per group (idempotent across
        # reloads — history carries over), so a group whose evaluations
        # keep failing shows its streak at /admin/jobs and in the
        # job_consecutive_errors gauge the shipped self-scrape alert
        # group watches
        job = jobs.register(f"ruler:{g.name}", interval_s=g.interval_s)
        with job.tick():
            for i, rt in enumerate(gs.runtimes):
                job.set_progress(
                    f"rule {i + 1}/{len(gs.runtimes)}: {rt.rule.name}")
                ok = self._eval_rule(g, rt, ts) and ok
            if not ok:
                errs = "; ".join(rt.last_error for rt in gs.runtimes
                                 if rt.last_error)[:300]
                job.note_error(errs or "rule evaluation failed")
        gs.eval_seconds = time.perf_counter() - t0
        gs.last_eval_unix_s = ts
        registry.histogram("rule_group_eval_seconds",
                           bounds=_SECONDS_BOUNDS,
                           group=g.name).record(gs.eval_seconds)
        return ok

    def _planner_params(self, g: RuleGroup) -> PlannerParams:
        # per-group eval deadline == the group interval (PR-4 machinery,
        # enforced at every exec-node boundary).  Stamped as an absolute
        # deadline rather than timeout_s: compute_deadline caps timeout_s
        # at query.default_timeout_s (120 s default), which would silently
        # shrink the slot of any group with interval > 2 min — a stamped
        # deadline wins uncapped, and it is repr-excluded so serving keys
        # are unaffected.  Partials are hard-disabled: a degraded vector
        # must fail the iteration, never record.
        return PlannerParams(allow_partial_results=False,
                             deadline_unix_s=time.time() + g.interval_s)

    def _eval_rule(self, g: RuleGroup, rt: _RuleRuntime,
                   ts: float) -> bool:
        from filodb_tpu_torch.utils.metrics import registry
        rule = rt.rule
        if not rt.restored:
            # restart replay BEFORE the first evaluation: pending/firing
            # clocks must not reset just because the process moved
            self._restore_alert_state(g, rt, ts)
        t0 = time.perf_counter()
        try:
            res = self.frontend.query_instant(
                rule.expr, int(ts), self._planner_params(g),
                tenant=(self.TENANT_WS, g.name), origin="rule_eval")
            if res.error:
                raise RuntimeError(res.error)
            if res.partial:
                raise RuntimeError(
                    "partial result: refusing to record/transition from "
                    "a degraded vector")
            vec = _output_vector(res)
            if rule.kind == "recording":
                self._record(g, rule, vec, ts)
            else:
                self._eval_alert(g, rt, vec, ts)
        except Exception as e:  # noqa: BLE001 — one rule must not sink the group
            registry.counter("rule_evaluation_failures",
                             group=g.name).increment()
            rt.health = "err"
            rt.last_error = f"{e}"[:500]
            rt.last_eval_unix_s = ts
            rt.eval_seconds = time.perf_counter() - t0
            return False
        rt.health = "ok"
        rt.last_error = ""
        rt.last_eval_unix_s = ts
        rt.eval_seconds = time.perf_counter() - t0
        return True

    def _record(self, g: RuleGroup, rule: Rule,
                vec: List[Tuple[Dict[str, str], float]],
                ts: float) -> None:
        from filodb_tpu_torch.utils.metrics import registry
        keys = []
        vals = []
        overrides = rule.labels_dict
        for labels, value in vec:
            tags = dict(labels)
            tags.pop("_metric_", None)
            tags.update(overrides)
            keys.append(PartKey.make(rule.name, tags))
            vals.append(value)
        n = self.sink.write(keys, int(ts * 1000.0), vals)
        registry.counter("rule_recorded_samples",
                         group=g.name).increment(n)

    # ------------------------------------------------------ alert engine

    def _alert_labels(self, rule: Rule,
                      series_labels: Dict[str, str]) -> Dict[str, str]:
        lab = dict(series_labels)
        lab.pop("_metric_", None)
        lab.update(rule.labels_dict)
        lab["alertname"] = rule.name
        return lab

    def _eval_alert(self, g: RuleGroup, rt: _RuleRuntime,
                    vec: List[Tuple[Dict[str, str], float]],
                    ts: float) -> None:
        rule = rt.rule
        present: Dict[Tuple, Tuple[Dict[str, str], float]] = {}
        for labels, value in vec:
            lab = self._alert_labels(rule, labels)
            present[tuple(sorted(lab.items()))] = (lab, value)
        # copy-on-write: rules_payload/alerts_payload iterate rt.alerts
        # lock-free from HTTP threads, so every instance this iteration
        # touches is CLONED before mutation and the whole map published
        # with one atomic ref swap — readers never see a torn instance
        alerts = dict(rt.alerts)
        for key, (lab, value) in present.items():
            prev = alerts.get(key)
            inst = alerts[key] = (_AlertInstance(lab, ts) if prev is None
                                  else prev.clone())
            inst.keep_since_s = 0.0
            inst.value = value
            if inst.state != FIRING and \
                    ts - inst.active_at_s >= rule.for_s:
                inst.state = FIRING
        ended: List[_AlertInstance] = []
        for key, inst in list(alerts.items()):
            if key in present:
                continue
            if inst.state == FIRING and rule.keep_firing_for_s > 0:
                # the hold clock starts at the FIRST absent evaluation
                # (Prometheus keepFiringSince semantics)
                held = alerts[key] = inst.clone()
                if not held.keep_since_s:
                    held.keep_since_s = ts
                if ts - held.keep_since_s < rule.keep_firing_for_s:
                    continue             # held by keep_firing_for
                inst = held
            ended.append(inst)
            del alerts[key]              # pending cleared / resolved
        # notify firing instances that were never delivered (covers new
        # transitions AND batches dropped last interval) plus, when
        # rules.notify_resend_delay_s > 0, periodic re-sends so a real
        # Alertmanager's resolve_timeout never auto-resolves a live alert
        resend_s = float(getattr(self.config, "notify_resend_delay_s",
                                 0.0) or 0.0)
        batch = [i for i in alerts.values()
                 if i.state == FIRING and (
                     i.last_notified_s == 0.0
                     or (resend_s > 0
                         and ts - i.last_notified_s >= resend_s))]
        # synthetic series write-back: ALERTS carries the live state,
        # ALERTS_FOR_STATE the pending clock (activeAt) for restart
        # replay.  One write per rule per iteration, atomic with the
        # iteration's success — a raise here fails the iteration BEFORE
        # the new map is published, so alert state holds (no flap, no
        # transition the store never saw).
        keys = []
        vals = []
        for inst in alerts.values():
            keys.append(PartKey.make(
                "ALERTS", {**inst.labels, "alertstate": inst.state}))
            vals.append(1.0)
            keys.append(PartKey.make("ALERTS_FOR_STATE", inst.labels))
            vals.append(float(inst.active_at_s))
        # NaN staleness markers for episodes that just ENDED: without
        # them the resolved episode's last ALERTS_FOR_STATE sample stays
        # visible for the stale-lookback window, and a restart inside it
        # would resurrect the alert with its old activeAt — skipping the
        # `for:` hold entirely (Prometheus hides these with staleness
        # markers; _output_vector drops NaN, so the restore replay and
        # dashboards both see the episode end at this tick)
        for inst in ended:
            keys.append(PartKey.make(
                "ALERTS", {**inst.labels, "alertstate": inst.state}))
            vals.append(float("nan"))
            keys.append(PartKey.make("ALERTS_FOR_STATE", inst.labels))
            vals.append(float("nan"))
        self.sink.write(keys, int(ts * 1000.0), vals)
        rt.alerts = alerts
        if batch and self.notifier.notify([i.webhook_payload(rule)
                                           for i in batch]):
            # only a delivered (or queued) batch advances the clock — a
            # dropped one leaves last_notified_s at 0 so the NEXT
            # interval re-notifies the still-firing alert.  The clones
            # are already published; last_notified_s is eval-private
            # state no payload reader looks at.
            for inst in batch:
                inst.last_notified_s = ts

    def _restore_alert_state(self, g: RuleGroup, rt: _RuleRuntime,
                             ts: float) -> None:
        """Replay `ALERTS_FOR_STATE{alertname=...}` so pending/firing
        clocks survive restart.  Restored instances re-enter as PENDING
        with the ORIGINAL activeAt; the evaluation that follows promotes
        them straight back to firing when `for:` has already elapsed and
        the expr still yields the series.  Failures are non-fatal — an
        empty store (first boot) just starts clean."""
        rule = rt.rule
        rt.restored = True
        try:
            sel = f'ALERTS_FOR_STATE{{alertname="{rule.name}"}}'
            res = self.frontend.query_instant(
                sel, int(ts), self._planner_params(g),
                tenant=(self.TENANT_WS, g.name), origin="rule_restore")
            if res.error:
                return
            alerts = dict(rt.alerts)     # copy-on-write, as in _eval_alert
            for labels, value in _output_vector(res):
                lab = dict(labels)
                lab.pop("_metric_", None)
                key = tuple(sorted(lab.items()))
                if key not in alerts:
                    alerts[key] = _AlertInstance(lab, float(value))
            rt.alerts = alerts
        except Exception:  # noqa: BLE001 — replay is best-effort
            pass

    # ------------------------------------------------------- hot reload

    def reload(self, groups: Optional[List[RuleGroup]] = None) -> Dict:
        """Swap in a freshly-loaded config (None -> re-read the conf
        tree + rules file).  Groups are diffed by name; alert state and
        health carry over for rules whose identity (name, expr, timing)
        is unchanged — a reload that touches one group must not reset
        every firing alert's clock.  Raises RulesConfigError on invalid
        config, leaving the running state untouched (Prometheus reload
        semantics: a bad file never kills the live rules)."""
        if groups is not None:
            new_groups = groups
        else:
            cfg = self.config
            if self.config_source is None and not (
                    getattr(cfg, "groups", None) or
                    getattr(cfg, "file", "")):
                # programmatic embed (Ruler(groups=[...]) with a bare
                # RulesConfig): an argless reload would load [] and
                # silently retire every running group — refuse instead
                raise RulesConfigError(
                    "no reloadable rules source: this ruler was built "
                    "with programmatic groups and no config_source; "
                    "reload via ruler.reload(groups=[...])")
            if self.config_source is not None:
                try:
                    cfg = self.config_source()
                except RulesConfigError:
                    raise
                except Exception as e:  # noqa: BLE001 — bad conf file/IO
                    raise RulesConfigError(
                        f"re-reading rules config: {e}") from None
                old_cfg, self.config = self.config, cfg
                if self._own_notifier and self._notify_key(cfg) != \
                        self._notify_key(old_cfg):
                    # notify_url/retries/backoff/timeout edits must land
                    # on reload like rule edits do; the old dispatcher
                    # thread finishes draining its queue on the old
                    # settings, new batches go to the new notifier
                    self.notifier = self._build_notifier(cfg)
            new_groups = load_rule_groups(cfg)
        if len({g.name for g in new_groups}) != len(new_groups):
            raise RulesConfigError("duplicate group names in reload")
        added, removed, changed = [], [], []
        with self._lock:
            old = self._groups
            nxt: Dict[str, _GroupState] = {}
            for g in new_groups:
                prev = old.get(g.name)
                if prev is None:
                    added.append(g.name)
                    nxt[g.name] = _GroupState(g)
                elif prev.group == g:
                    nxt[g.name] = prev       # untouched: keep the runner
                else:
                    changed.append(g.name)
                    gs = _GroupState(g)
                    carried = {rt.rule.identity(): rt
                               for rt in prev.runtimes}
                    runtimes = []
                    for r in g.rules:
                        src = carried.pop(r.identity(), None)
                        rt = _RuleRuntime(r)
                        if src is not None:
                            # identity matched: state carries over into a
                            # FRESH runtime (the retired runner may still
                            # be mid-iteration on `src` — sharing the
                            # object would let two threads read-copy-write
                            # the same alerts map and lose transitions)
                            # bound to the NEW Rule — identity() excludes
                            # annotations, so an annotation-only edit
                            # still reaches payloads/notifications.
                            # Instances are clone-before-mutate, so a
                            # shallow map copy is race-free.
                            rt.health = src.health
                            rt.last_error = src.last_error
                            rt.last_eval_unix_s = src.last_eval_unix_s
                            rt.eval_seconds = src.eval_seconds
                            rt.alerts = dict(src.alerts)
                            rt.restored = src.restored
                        runtimes.append(rt)
                    gs.runtimes = runtimes
                    gs.last_eval_unix_s = prev.last_eval_unix_s
                    prev.generation += 1     # retire the old runner
                    nxt[g.name] = gs
            for name, gs in old.items():
                if name not in nxt:
                    removed.append(name)
                    gs.generation += 1       # retire the runner
            self._groups = nxt
            if self._started:
                for name in added + changed:
                    self._start_runner(nxt[name])
        # a removed group's job handle must leave the registry with it:
        # a stale failing-group streak would otherwise hold the health
        # verdict degraded (and keep the self-scraped
        # job_consecutive_errors gauge alerting) until process restart
        from filodb_tpu_torch.utils.jobs import jobs
        for name in removed:
            jobs.unregister(f"ruler:{name}")
        from filodb_tpu_torch.utils.events import journal
        from filodb_tpu_torch.utils.metrics import registry
        registry.counter("rule_config_reloads").increment()
        journal.emit("rules_reloaded", subsystem="rules",
                     groups=len(new_groups), added=len(added),
                     removed=len(removed), changed=len(changed))
        return {"groups": len(new_groups), "added": sorted(added),
                "removed": sorted(removed), "changed": sorted(changed)}

    # ------------------------------------------------------ API payloads

    def rules_payload(self) -> Dict:
        """`/api/v1/rules` data (the Prometheus RuleDiscovery shape)."""
        with self._lock:
            states = list(self._groups.values())
        groups = []
        for gs in states:
            g = gs.group
            rules = []
            for rt in gs.runtimes:
                r = rt.rule
                base = {
                    "name": r.name,
                    "query": r.expr,
                    "labels": r.labels_dict,
                    "health": rt.health,
                    "lastError": rt.last_error,
                    "evaluationTime": round(rt.eval_seconds, 6),
                    "lastEvaluation": _iso(rt.last_eval_unix_s),
                }
                if r.kind == "recording":
                    base["type"] = "recording"
                else:
                    insts = sorted(rt.alerts.values(),
                                   key=lambda i: sorted(i.labels.items()))
                    state = "inactive"
                    if any(i.state == FIRING for i in insts):
                        state = "firing"
                    elif insts:
                        state = "pending"
                    base.update({
                        "type": "alerting",
                        "duration": r.for_s,
                        "keepFiringFor": r.keep_firing_for_s,
                        "annotations": r.annotations_dict,
                        "state": state,
                        "alerts": [i.payload(r) for i in insts],
                    })
                rules.append(base)
            groups.append({
                "name": g.name,
                "file": g.source,
                "interval": g.interval_s,
                "rules": rules,
                "evaluationTime": round(gs.eval_seconds, 6),
                "lastEvaluation": _iso(gs.last_eval_unix_s),
            })
        return {"groups": groups}

    def alerts_payload(self) -> Dict:
        """`/api/v1/alerts` data: every active (pending|firing) alert."""
        out = []
        with self._lock:
            states = list(self._groups.values())
        for gs in states:
            for rt in gs.runtimes:
                if rt.rule.kind != "alerting":
                    continue
                for inst in sorted(rt.alerts.values(),
                                   key=lambda i: sorted(i.labels.items())):
                    out.append(inst.payload(rt.rule))
        return {"alerts": out}

    def group_names(self) -> List[str]:
        with self._lock:
            return sorted(self._groups)


def _output_vector(res) -> List[Tuple[Dict[str, str], float]]:
    """Instant-vector extraction from a QueryResult: (labels, value) per
    series with a non-NaN sample at the evaluation step (the same edge
    QueryEngine.to_prom_vector serializes)."""
    out = []
    for key, _wends, vals in res.series():
        v = np.asarray(vals)
        if v.ndim != 1 or v.size == 0:   # histogram blocks don't record
            continue
        x = float(v[-1])
        if not math.isnan(x):
            out.append((key.labels_dict, x))
    return out
