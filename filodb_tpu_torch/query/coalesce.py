"""Server-side query micro-batching (port of
filodb_tpu/query/coalesce.py).

Dashboard clients (Grafana, the Prometheus UI) issue ONE HTTP request
per panel, all sharing the dashboard's time range and step.  The server
coalesces concurrent `query_range` calls over the same window grid into
one `engine.query_range_batch`, so compatible fused leaves share kernel
launches for clients that know nothing about batching.  The trade is
explicit: a request may wait up to `window_s` for peers to arrive.
Enabled by `query.batch_window_ms` (0 = off, the default).

The port adds one counter the reference lacks: `coalesce_merged_batches`
counts the batches that merged two or more requests.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple


class _Group:
    __slots__ = ("queries", "results", "error", "done")

    def __init__(self):
        self.queries: List[str] = []
        self.results = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()


class QueryCoalescer:
    """Wraps one QueryEngine; `query_range` blocks up to `window_s` while
    concurrent callers with the same (start, step, end, planner params)
    pile into the same batch.  The first arrival leads: it sleeps out the
    window, snapshots the group, runs query_range_batch, and wakes the
    followers.  Failures fall back to per-query execution — coalescing
    must never lose a query that would have succeeded alone."""

    def __init__(self, engine, window_s: float):
        self.engine = engine
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._groups: Dict[Tuple, _Group] = {}

    def query_range(self, promql: str, start_s: int, step_s: int,
                    end_s: int, planner_params=None):
        if self.window_s <= 0:
            return self.engine.query_range(promql, start_s, step_s, end_s,
                                           planner_params)
        key = (start_s, step_s, end_s, repr(planner_params))
        with self._lock:
            grp = self._groups.get(key)
            leader = grp is None
            if leader:
                grp = _Group()
                self._groups[key] = grp
            idx = len(grp.queries)
            grp.queries.append(promql)
        completed = True
        dl = getattr(planner_params, "deadline_unix_s", 0.0) \
            if planner_params is not None else 0.0
        if leader:
            time.sleep(self.window_s)
            with self._lock:
                # close the window: later arrivals start a new group
                if self._groups.get(key) is grp:
                    del self._groups[key]
            if len(grp.queries) > 1:
                from filodb_tpu_torch.utils.metrics import registry
                registry.counter("coalesce_merged_batches").increment()
            try:
                grp.results = self.engine.query_range_batch(
                    grp.queries, start_s, step_s, end_s, planner_params)
            except Exception as e:  # noqa: BLE001 — followers must wake
                grp.error = e
                grp.done.set()
            except BaseException as e:
                # KeyboardInterrupt/SystemExit: wake followers (they fall
                # back to solo execution) but PROPAGATE the exit — the
                # leader thread must not swallow an interpreter shutdown
                grp.error = e
                grp.done.set()
                raise
            else:
                grp.done.set()
        else:
            # generous bound: a wedged leader must not strand followers.
            # The follower's deadline bounds the wait too — the solo
            # fallback then returns the structured query_timeout from
            # the exec-boundary check instead of blocking past budget.
            # The wait is sliced against the follower's OWN cancel token
            # (it is registered and holds a scheduler slot while parked
            # here): a kill/disconnect frees the slot within ~50 ms
            # instead of riding out the leader.
            from filodb_tpu_torch.query.activequeries import peek_admission
            from filodb_tpu_torch.query.rangevector import remaining_budget
            bound = remaining_budget(planner_params,
                                     max(300.0, 10 * self.window_s))
            ent = peek_admission()
            tok = ent.token if ent is not None else None
            if tok is None:
                completed = grp.done.wait(timeout=bound)
            else:
                deadline = time.perf_counter() + bound
                completed = False
                while not completed:
                    if tok.cancelled:
                        from filodb_tpu_torch.query.rangevector import \
                            QueryResult
                        return QueryResult(
                            [], error=("query_canceled: query killed "
                                       "waiting on a coalesce leader "
                                       f"(reason={tok.reason or 'admin'})"))
                    left = deadline - time.perf_counter()
                    if left <= 0:
                        break
                    completed = grp.done.wait(timeout=min(left, 0.05))
        if grp.error is not None or grp.results is None:
            # batch failed (or leader timed out): run alone
            res = self.engine.query_range(promql, start_s, step_s, end_s,
                                          planner_params)
            deadline_expired = (not leader and dl and time.time() >= dl)
            if not completed and not deadline_expired:
                # the wedged-leader fallback must be visible: count it
                # and flag the follower's stats so an operator can see
                # WHY this poll ran solo
                from filodb_tpu_torch.utils.metrics import registry
                registry.counter("coalesce_leader_timeouts").increment()
                if res is not None:
                    res.stats.warnings.append(
                        "coalesce leader timed out; follower fell back "
                        "to solo execution")
            return res
        res = grp.results[idx]
        if not leader and res is not None and res.error is not None \
                and (res.error.startswith("query_timeout")
                     or res.error.startswith("query_canceled")):
            # the LEADER's budget expired or it was killed — not this
            # follower (budgets/kills are per-request, repr-excluded
            # from the group key): re-run solo under our own
            # deadline/token instead of inheriting the expiry
            return self.engine.query_range(promql, start_s, step_s, end_s,
                                           planner_params)
        return res
