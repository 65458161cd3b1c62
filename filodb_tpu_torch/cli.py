"""filo-cli — operator command line (port of filodb_tpu/cli.py), run as
`python -m filodb_tpu_torch.cli <command>`.

ref: cli/.../CliMain.scala:91-116,138-210 — init/create/importcsv/list/
indexnames/indexvalues/labelvalues/validateSchemas/decodeChunkInfo plus
PromQL timeseries queries, and `serve` standing in for the standalone
launcher script.  Commands run in-process against a local data directory
(LocalDiskColumnStore) or — for query/status — against a running server
over HTTP with --host.

One addition to the reference's options: `--device {cuda,cpu}` (default
cuda) on every command that opens a memstore, the port's explicit device
(without a card `cuda` is refused; pass `--device cpu` to run on the
host).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
from typing import Dict, List, Optional


def _open_local(data_dir: str, dataset: str, num_shards: int,
                device="cuda"):
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.persist.localstore import (LocalDiskColumnStore,
                                               LocalDiskMetaStore)
    cs = LocalDiskColumnStore(os.path.join(data_dir, "chunks"))
    meta = LocalDiskMetaStore(os.path.join(data_dir, "meta"))
    ms = TimeSeriesMemStore(column_store=cs, meta_store=meta, device=device)
    for s in range(num_shards):
        ms.setup(dataset, s).recover_index()
    return ms, cs, meta


def _local_engine(ms, dataset: str, num_shards: int):
    from filodb_tpu_torch.parallel.shardmapper import ShardEvent, ShardMapper
    from filodb_tpu_torch.query.engine import QueryEngine
    mapper = ShardMapper(num_shards)
    for s in range(num_shards):
        mapper.update_from_event(
            ShardEvent("IngestionStarted", dataset, s, "cli"))
    return QueryEngine(dataset, ms, mapper, device=ms.device)


def _http_get(host: str, path: str, params: Dict[str, str],
              data: bytes = None, timeout: int = 60) -> dict:
    """GET (or POST when `data` is given) with the shared JSON error
    handling every CLI command goes through."""
    import urllib.error
    import urllib.parse
    import urllib.request
    url = f"http://{host}{path}"
    if params:
        url += f"?{urllib.parse.urlencode(params)}"
    req = urllib.request.Request(
        url, data=data,
        headers=({"Content-Type": "application/json"} if data else {}),
        method="POST" if data is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        try:
            return json.loads(e.read())
        except Exception:  # noqa: BLE001 — non-JSON error body
            return {"status": "error", "error": f"HTTP {e.code}: {e.reason}"}
    except urllib.error.URLError as e:
        return {"status": "error", "error": f"cannot reach {host}: {e.reason}"}


# ------------------------------------------------------------------ commands


def cmd_init(args) -> int:
    """Create the data-directory layout (ref: CliMain `init`/`create`)."""
    for sub in ("chunks", "meta"):
        os.makedirs(os.path.join(args.data_dir, sub), exist_ok=True)
    ms, cs, _ = _open_local(args.data_dir, args.dataset, args.shards,
                            args.device)
    cs.initialize(args.dataset, args.shards)
    print(f"initialized {args.data_dir} for dataset {args.dataset} "
          f"({args.shards} shards)")
    return 0


def cmd_importcsv(args) -> int:
    """CSV ingest routed by the shard-key math so queries find the data
    on multi-shard datasets (ref: CliMain `importcsv` / CsvStream source)."""
    from filodb_tpu_torch.gateway.router import split_batch_by_shard
    from filodb_tpu_torch.ingest.stream import CsvStream
    from filodb_tpu_torch.parallel.shardmapper import ShardMapper, SpreadProvider
    ms, _, _ = _open_local(args.data_dir, args.dataset, args.shards,
                           args.device)
    stream = CsvStream(args.file, schema_name=args.schema)
    mapper = ShardMapper(args.shards)
    spread = SpreadProvider()
    n = 0
    touched = set()
    for batch, off in stream.batches():
        for s, sub in split_batch_by_shard(batch, mapper, spread).items():
            n += ms.get_shard(args.dataset, s).ingest(sub, off)
            touched.add(s)
    for s in touched:
        ms.get_shard(args.dataset, s).flush_all_groups()
    print(f"imported {n} samples from {args.file} into shards "
          f"{sorted(touched)}")
    return 0


def cmd_exportbundle(args) -> int:
    """Export filtered raw series to a columnar NPZ bundle — the batch
    analytics bridge (ref: spark/ legacy connector's DataFrame read)."""
    from filodb_tpu_torch.core.index import Equals
    from filodb_tpu_torch.jobs.batch_io import export_series
    ms, _, _ = _open_local(args.data_dir, args.dataset, args.shards,
                           args.device)
    filters = [Equals("_metric_", args.metric)] if args.metric else []
    for f in args.filter or []:
        if "=" not in f:
            print(f"--filter expects label=value, got {f!r}",
                  file=sys.stderr)
            return 2
        k, v = f.split("=", 1)
        filters.append(Equals(k, v))
    n = export_series(ms, args.dataset, filters,
                      args.start, args.end, args.out)
    print(f"exported {n} series to {args.out}")
    return 0


def cmd_importbundle(args) -> int:
    """Bulk-load an NPZ bundle (ref: spark/ connector's DataFrame write)."""
    from filodb_tpu_torch.jobs.batch_io import import_series
    ms, _, _ = _open_local(args.data_dir, args.dataset, args.shards,
                           args.device)
    n = import_series(ms, args.dataset, args.bundle)
    for s in range(args.shards):
        sh = ms.get_shard(args.dataset, s)
        if sh is not None:
            sh.flush_all_groups()
    print(f"imported {n} samples from {args.bundle}")
    return 0


def cmd_list(args) -> int:
    """Datasets + per-shard series counts in a data dir (ref: `list`)."""
    root = os.path.join(args.data_dir, "chunks")
    if not os.path.isdir(root):
        print("no datasets", file=sys.stderr)
        return 1
    for ds in sorted(os.listdir(root)):
        shards = [d for d in os.listdir(os.path.join(root, ds))
                  if d.startswith("shard-")]
        print(f"{ds}\tshards={len(shards)}")
    return 0


def cmd_indexnames(args) -> int:
    ms, _, _ = _open_local(args.data_dir, args.dataset, args.shards,
                           args.device)
    names = set()
    for sh in ms.shards_for(args.dataset):
        names.update(sh.index.label_names())
    for n in sorted(names):
        print(n)
    return 0


def cmd_indexvalues(args) -> int:
    ms, _, _ = _open_local(args.data_dir, args.dataset, args.shards,
                           args.device)
    counts: Dict[str, int] = {}
    for sh in ms.shards_for(args.dataset):
        for val, cnt in sh.index.label_value_counts(args.label):
            counts[val] = counts.get(val, 0) + cnt
    for val, cnt in sorted(counts.items(), key=lambda kv: -kv[1])[:args.limit]:
        print(f"{cnt:>8}  {val}")
    return 0


def cmd_topkcard(args) -> int:
    """Top-k cardinality prefixes (ref: CliMain `topkcard`).  Over HTTP when
    --host is given; otherwise rebuilt from the recovered local index."""
    if args.host:
        payload = _http_get(
            args.host, f"/promql/{args.dataset}/api/v1/metering/cardinality",
            {"prefix": args.prefix, "k": str(args.k)})
        print(json.dumps(payload, indent=2))
        return 0 if payload.get("status") == "success" else 2
    from filodb_tpu_torch.core.ratelimit import CardinalityTracker
    ms, _, _ = _open_local(args.data_dir, args.dataset, args.shards,
                           args.device)
    tracker = CardinalityTracker()
    for sh in ms.shards_for(args.dataset):
        opts = sh.schemas.part.options
        for info in sh.partitions:
            if info is None:
                continue
            sk = info.part_key.shard_key(sh.schemas.part)
            tracker.series_created(
                tuple(sk.get(c, "") for c in opts.shard_key_columns))
    prefix = tuple(p for p in args.prefix.split(",") if p)
    for rec in tracker.top_k(prefix, args.k):
        print(f"{rec.ts_count:>8}  {'/'.join(rec.prefix) or '(root)'}  "
              f"children={rec.children_count}")
    return 0


def cmd_query(args) -> int:
    """PromQL range query (ref: CliMain `timeseries` query commands)."""
    end = args.end or int(time.time())
    start = args.start or end - 1800
    if args.host:
        payload = _http_get(
            args.host, f"/promql/{args.dataset}/api/v1/query_range",
            {"query": args.promql, "start": str(start), "end": str(end),
             "step": str(args.step)})
    else:
        from filodb_tpu_torch.query.engine import QueryEngine
        ms, _, _ = _open_local(args.data_dir, args.dataset, args.shards,
                               args.device)
        eng = _local_engine(ms, args.dataset, args.shards)
        res = eng.query_range(args.promql, start, args.step, end)
        payload = QueryEngine.to_prom_matrix(res)
    print(json.dumps(payload, indent=None if args.raw else 2))
    return 0 if payload.get("status") == "success" else 2


def cmd_querybatch(args) -> int:
    """Dashboard batch: evaluate several PromQL queries over one window
    grid, merging compatible fused leaves into single kernel dispatches
    (engine.query_range_batch; no reference analogue — device dispatch
    amortization, see doc/kernels.md)."""
    end = args.end or int(time.time())
    start = args.start or end - 1800
    queries = list(args.promql)
    if args.host:
        body = json.dumps({"queries": queries, "start": start, "end": end,
                           "step": args.step}).encode()
        payload = _http_get(
            args.host, f"/promql/{args.dataset}/api/v1/query_range_batch",
            {}, data=body, timeout=120)
    else:
        from filodb_tpu_torch.query.engine import QueryEngine
        ms, _, _ = _open_local(args.data_dir, args.dataset, args.shards,
                               args.device)
        eng = _local_engine(ms, args.dataset, args.shards)
        results = eng.query_range_batch(queries, start, args.step, end)
        payload = {"status": "success",
                   "results": [QueryEngine.to_prom_matrix(r)
                               for r in results]}
    print(json.dumps(payload, indent=None if args.raw else 2))
    ok = payload.get("status") == "success" and all(
        r.get("status") == "success" for r in payload.get("results", []))
    return 0 if ok else 2


def cmd_status(args) -> int:
    payload = _http_get(args.host, f"/cluster/{args.dataset}/status", {})
    print(json.dumps(payload, indent=2))
    return 0


def cmd_rules(args) -> int:
    """Ruler state over HTTP: rule groups with per-rule health/timings
    (`rules`), active alerts (`rules --alerts`), or a hot reload of the
    rules config (`rules --reload`).  ref: promtool's rules subcommands
    against a live server; doc/recording_rules.md."""
    if args.reload:
        payload = _http_get(args.host, "/admin/rules/reload", {}, data=b"")
    elif args.alerts:
        payload = _http_get(args.host, "/api/v1/alerts", {})
    else:
        params = {"type": args.type} if args.type else {}
        payload = _http_get(args.host, "/api/v1/rules", params)
    print(json.dumps(payload, indent=2))
    return 0 if payload.get("status") == "success" else 1


def cmd_health(args) -> int:
    """Node health over HTTP: the full per-subsystem verdict tree
    (GET /api/v1/status/health) or the readiness probe (`--ready`:
    GET /ready, exit 0 ready / 1 unready — scriptable in rolling-restart
    loops).  Exit codes mirror the verdict: 0 ok, 1 degraded, 2 failed
    or unreachable."""
    if args.ready:
        payload = _http_get(args.host, "/ready", {})
        print(json.dumps(payload, indent=2))
        return 0 if payload.get("status") == "ready" else 1
    payload = _http_get(args.host, "/api/v1/status/health", {})
    print(json.dumps(payload, indent=2))
    if payload.get("status") != "success":
        return 2
    verdict = payload["data"].get("status")
    return {"ok": 0, "degraded": 1}.get(verdict, 2)


def cmd_jobs(args) -> int:
    """Background-job registry over HTTP (GET /admin/jobs): one line per
    recurring worker — streak, last duration, progress — the "what is
    this node doing" table."""
    payload = _http_get(args.host, "/admin/jobs", {})
    if payload.get("status") != "success":
        print(json.dumps(payload, indent=2))
        return 1
    if args.raw:
        print(json.dumps(payload, indent=2))
        return 0
    rows = payload["data"]["jobs"]
    print(f"{'JOB':<24} {'DATASET':<12} {'RUNS':>7} {'ERRS':>6} "
          f"{'STREAK':>6} {'LAST_S':>9}  PROGRESS")
    for j in rows:
        print(f"{j['job']:<24} {j['dataset'] or '-':<12} "
              f"{j['runs']:>7} {j['errors']:>6} "
              f"{j['consecutiveErrors']:>6} "
              f"{j['lastDurationSeconds']:>9.4f}  "
              f"{j['progress'] or j['lastError'] or ''}")
    return 0


def cmd_shards(args) -> int:
    """Shard assignment table over HTTP (GET /admin/shards): one line
    per shard — primary owner + status, the ordered replica list with
    per-replica statuses, live-owner count — plus the replication
    fan-out lag table when the server runs one.  The view an operator
    checks before/after a handoff or node kill."""
    params = {"dataset": args.dataset} if args.dataset else {}
    payload = _http_get(args.host, "/admin/shards", params)
    if payload.get("status") != "success":
        print(json.dumps(payload, indent=2))
        return 1
    if args.raw:
        print(json.dumps(payload, indent=2))
        return 0
    for ds, ent in payload["data"]["datasets"].items():
        print(f"dataset {ds!r}: {ent['numShards']} shard(s), "
              f"rf={ent['replicationFactor']}")
        print(f"  {'SHARD':>5} {'PRIMARY':<16} {'STATUS':<12} "
              f"{'LIVE':>4}  REPLICAS")
        for row in ent["shards"]:
            reps = ", ".join(f"{r['node']}({r['status']})"
                             for r in row["replicas"]) or "-"
            print(f"  {row['shard']:>5} {row['primary'] or '-':<16} "
                  f"{row['status']:<12} {row['liveOwners']:>4}  {reps}")
        for lag in ent.get("replicaLag", []):
            flag = " LAGGING" if lag["lagging"] else ""
            print(f"  peer {lag['peer']}: acked={lag['acked']} "
                  f"failed={lag['failed']} "
                  f"pending={lag['pendingRecords']}{flag}")
    return 0


def cmd_federation(args) -> int:
    """Federation topology + health over HTTP (GET /admin/federation):
    one line per configured remote cluster — endpoint, ownership
    matchers / time window, live probe verdict — plus that cluster's
    circuit-breaker row (peer `cluster:<name>` from /admin/breakers).
    The first stop of the "a remote cluster is down" runbook
    (doc/federation.md)."""
    payload = _http_get(args.host, "/admin/federation", {})
    if payload.get("status") != "success":
        print(json.dumps(payload, indent=2))
        return 1
    if args.raw:
        print(json.dumps(payload, indent=2))
        return 0
    data = payload["data"]
    rows = data["clusters"]
    if not rows:
        print("federation not configured on this server")
        return 0
    brk = {}
    bp = _http_get(args.host, "/admin/breakers", {})
    if bp.get("status") == "success":
        brk = {b["peer"]: b for b in bp["data"]["breakers"]}
    print(f"local cluster: {data['cluster']!r}")
    print(f"{'CLUSTER':<14} {'ENDPOINT':<22} {'DATASET':<12} "
          f"{'HEALTH':<9} {'FAILS':>5} {'FLIPS':>5} {'BREAKER':<9}  "
          f"OWNERSHIP")
    degraded = False
    for r in rows:
        own = ", ".join(f"{k}=~{v}" for k, v in
                        sorted(r["match"].items())) or "(all labels)"
        if r["timeStartMs"] or r["timeEndMs"]:
            own += (f" time=[{r['timeStartMs']},"
                    f"{r['timeEndMs'] or 'now'}]")
        health = ("up" if r["healthy"] else "DOWN") \
            if r["probed"] else "unprobed"
        degraded = degraded or (r["probed"] and not r["healthy"])
        b = brk.get(f"cluster:{r['cluster']}", {})
        print(f"{r['cluster']:<14} {r['endpoint']:<22} "
              f"{r['dataset']:<12} {health:<9} "
              f"{r['consecutiveFailures']:>5} {r['transitions']:>5} "
              f"{b.get('state', '-'):<9}  {own}")
        if r["lastError"]:
            print(f"{'':14} last error: {r['lastError']}")
    return 1 if degraded else 0


def cmd_queries(args) -> int:
    """Live query introspection over HTTP: list the in-flight queries
    (GET /admin/queries) once or continuously (`--follow`), or kill one
    (`--kill <id>` -> POST /admin/queries/<id>/kill) — the operator's
    "a query is eating the node" loop (doc/operations.md runbook)."""
    if args.kill:
        payload = _http_get(args.host,
                            f"/admin/queries/{args.kill}/kill",
                            {"reason": args.reason}, data=b"")
        print(json.dumps(payload, indent=2))
        return 0 if payload.get("status") == "success" and \
            payload.get("data", {}).get("killed") else 1
    while True:
        params = {"tenant": args.tenant} if args.tenant else {}
        payload = _http_get(args.host, "/admin/queries", params)
        if payload.get("status") != "success":
            print(json.dumps(payload, indent=2))
            return 1
        if args.raw:
            print(json.dumps(payload, indent=2))
        else:
            rows = payload["data"]["queries"]
            print(f"{'QUERY_ID':<34} {'WS':<10} {'ORIGIN':<10} "
                  f"{'ROLE':<8} {'PHASE':<10} {'AGE_S':>8} "
                  f"{'SAMPLES':>12} {'PAGED_B':>10} {'DISP':>5}  PROMQL")
            for q in rows:
                c = q["counters"]
                print(f"{q['queryID']:<34} "
                      f"{q['tenant']['ws'] or '-':<10} "
                      f"{q['origin']:<10} {q['role']:<8} "
                      f"{q['phase']:<10} {q['ageSeconds']:>8.2f} "
                      f"{c['samplesScanned']:>12} "
                      f"{c['bytesPaged']:>10} "
                      f"{c['deviceDispatches']:>5}  "
                      f"{q['promql'][:60]}")
        if not args.follow:
            return 0
        time.sleep(args.interval)


def cmd_tenants(args) -> int:
    """The per-tenant QoS control panel over HTTP (GET /admin/tenants):
    one row per workspace — configured share, live running/queued
    counts in the weighted-fair scheduler, lifetime sheds, and the
    usage accountant's burn columns — once or continuously
    (`--follow`).  The "a tenant is flooding the frontend" runbook's
    first command (doc/operations.md)."""
    while True:
        payload = _http_get(args.host, "/admin/tenants", {})
        if payload.get("status") != "success":
            print(json.dumps(payload, indent=2))
            return 1
        if args.raw:
            print(json.dumps(payload, indent=2))
        else:
            rows = payload["data"]["tenants"]
            print(f"{'WS':<16} {'SHARE':>6} {'RUN':>4} {'QUEUED':>6} "
                  f"{'SHED':>8} {'QUERIES':>9} {'Q_SECONDS':>10} "
                  f"{'WIN_SCANNED':>12} {'REJECTED':>8}")
            for t in rows:
                print(f"{t['ws'] or '-':<16} {t['share']:>6g} "
                      f"{t['running']:>4} {t['queued']:>6} "
                      f"{t['shed']:>8} {t['queries']:>9} "
                      f"{t['querySeconds']:>10.2f} "
                      f"{t['windowSamplesScanned']:>12} "
                      f"{t['rejected']:>8}")
        if not args.follow:
            return 0
        time.sleep(args.interval)


def cmd_devices(args) -> int:
    """The per-chip device telemetry table over HTTP (GET
    /admin/devices): utilization EWMA, booked HBM by region, cumulative
    dispatch/compile counters, and the newest kernel-ledger entries —
    once or continuously (`--follow`).  The "queries are slow — is it
    the device?" runbook's first command (doc/operations.md)."""
    while True:
        payload = _http_get(args.host, "/admin/devices",
                            {"recent": str(args.recent)})
        if payload.get("status") != "success":
            print(json.dumps(payload, indent=2))
            return 1
        if args.raw:
            print(json.dumps(payload, indent=2))
        else:
            data = payload["data"]
            print(f"{'DEVICE':<18} {'UTIL':>6} {'DISP':>8} "
                  f"{'BUSY_S':>10} {'HBM_HOT':>10} {'HBM_COLD':>10} "
                  f"{'HBM_HW':>10} {'COMPILES':>8} {'TOP_KERNEL':<20}")
            for dev, row in data["devices"].items():
                hbm = row["hbm"]
                top = next(iter(row["kernels"]), "-")
                print(f"{dev:<18} {row['utilEwma']:>6.2f} "
                      f"{row['dispatches']:>8} "
                      f"{row['busySeconds']:>10.3f} "
                      f"{hbm.get('hot', 0):>10} "
                      f"{hbm.get('cold', 0):>10} "
                      f"{row['hbmHighWaterBytes']:>10} "
                      f"{row['compiles']:>8} {top:<20}")
            if data["recent"]:
                print(f"\n{'SEQ':>6} {'KIND':<9} {'KERNEL':<18} "
                      f"{'DEVICE':<18} {'SECONDS':>9} {'SHAPE':<26} "
                      f"ORIGIN")
                for e in data["recent"]:
                    print(f"{e['seq']:>6} {e['kind']:<9} "
                          f"{e['kernel'][:18]:<18} {e['device']:<18} "
                          f"{e['seconds']:>9.4f} {e['shape'][:26]:<26} "
                          f"{e['origin'][:16]}")
        if not args.follow:
            return 0
        time.sleep(args.interval)


def cmd_cardinality(args) -> int:
    """Head-block cardinality over HTTP (GET /api/v1/status/tsdb, the
    Prometheus-compatible TSDB status shape): total alive series, top-k
    metrics / label-value pairs / per-label value counts and index
    memory, and the per-tenant series table with budget rejections.
    The "which tenant blew up the index" runbook's first command
    (doc/index.md)."""
    path = "/api/v1/status/tsdb" if not args.dataset \
        else f"/promql/{args.dataset}/api/v1/status/tsdb"
    payload = _http_get(args.host, path, {"limit": str(args.k)})
    if payload.get("status") != "success":
        print(json.dumps(payload, indent=2))
        return 1
    if args.raw:
        print(json.dumps(payload, indent=2))
        return 0
    data = payload["data"]
    head = data.get("headStats", {})
    tenants = data.get("seriesCountByTenant", [])
    if args.tenant is not None:
        rows = [t for t in tenants if t["name"] == args.tenant]
        print(f"{'TENANT':<24} {'SERIES':>10}")
        for t in rows:
            print(f"{t['name']:<24} {t['value']:>10}")
        if not rows:
            print(f"(tenant {args.tenant!r} holds no alive series)")
        return 0
    print(f"numSeries={head.get('numSeries', 0)} "
          f"numLabelPairs={head.get('numLabelPairs', 0)} "
          f"tenantSeriesLimit={head.get('tenantSeriesLimit', 0)} "
          f"tenantSeriesRejected={head.get('tenantSeriesRejected', 0)}")
    sections = [
        ("TOP METRICS", "seriesCountByMetricName", "SERIES"),
        ("TOP TENANTS", "seriesCountByTenant", "SERIES"),
        ("TOP LABEL=VALUE PAIRS", "seriesCountByLabelValuePair", "SERIES"),
        ("VALUES PER LABEL", "labelValueCountByLabelName", "VALUES"),
        ("INDEX MEMORY PER LABEL", "memoryInBytesByLabelName", "BYTES"),
    ]
    for title, key, unit in sections:
        rows = data.get(key, [])
        if not rows:
            continue
        print(f"\n{title}")
        print(f"{'NAME':<40} {unit:>10}")
        for r in rows:
            print(f"{r['name'][:40]:<40} {r['value']:>10}")
    return 0


def cmd_events(args) -> int:
    """Tail the structured event journal over HTTP (GET /admin/events):
    newest events once, from a sequence number (`--since-seq`), or
    continuously (`--follow`, resuming by sequence so nothing is missed
    between polls) — the "what changed?" flight recorder."""
    since = args.since_seq
    while True:
        params = {"since_seq": str(since), "limit": str(args.limit)}
        if args.kind:
            params["kind"] = args.kind
        payload = _http_get(args.host, "/admin/events", params)
        if payload.get("status") != "success":
            print(json.dumps(payload, indent=2))
            return 1
        for ev in payload["data"]["events"]:
            print(json.dumps(ev, separators=(",", ":")))
            since = max(since, ev["seq"])
        if not args.follow:
            return 0
        time.sleep(args.interval)


def cmd_checkrules(args) -> int:
    """Validate a rules file offline (the promtool `check rules`
    analogue): parse + validate every group/expr without a server."""
    from filodb_tpu_torch.config import RulesConfig
    from filodb_tpu_torch.rules import RulesConfigError, load_rule_groups
    try:
        groups = load_rule_groups(RulesConfig(file=args.file))
    except RulesConfigError as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    n_rules = sum(len(g.rules) for g in groups)
    print(f"OK: {len(groups)} group(s), {n_rules} rule(s)")
    for g in groups:
        kinds = [r.kind for r in g.rules]
        print(f"  {g.name}: interval={g.interval_s}s "
              f"recording={kinds.count('recording')} "
              f"alerting={kinds.count('alerting')}")
    return 0


def cmd_validate_schemas(args) -> int:
    """ref: CliMain `validateSchemas`."""
    from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
    ok = True
    seen: Dict[int, str] = {}
    for name, schema in DEFAULT_SCHEMAS.by_name.items():
        sid = schema.schema_id
        if sid in seen and seen[sid] != name:
            print(f"HASH CONFLICT: {name} vs {seen[sid]} (id={sid})")
            ok = False
        seen[sid] = name
        print(f"{name:16} id={sid:5} columns="
              f"{[c.name + ':' + c.col_type for c in schema.columns]}")
    print("Validation passed" if ok else "Validation FAILED")
    return 0 if ok else 1


def cmd_decodechunks(args) -> int:
    """Chunk metadata dump (ref: CliMain `decodeChunkInfo`)."""
    from filodb_tpu_torch.persist.localstore import LocalDiskColumnStore
    cs = LocalDiskColumnStore(os.path.join(args.data_dir, "chunks"))
    for rec in cs.read_part_keys(args.dataset, args.shard)[:args.limit]:
        chunks = cs.read_chunks(args.dataset, args.shard, rec.part_key,
                                0, 1 << 62)
        for c in chunks:
            print(f"{rec.part_key}  id={c.info.chunk_id} "
                  f"rows={c.info.num_rows} "
                  f"start={c.info.start_time_ms} end={c.info.end_time_ms} "
                  f"bytes={c.nbytes}")
    return 0


def cmd_partkey(args) -> int:
    """PromQL filter -> partition key bytes + routing hashes (ref: CliMain
    `promFilterToPartKeyBR` + `partKeyBrAsString` — the shard-routing
    debugging pair)."""
    from filodb_tpu_torch.core.partkey import PartKey
    from filodb_tpu_torch.promql.parser import query_to_logical_plan
    from filodb_tpu_torch.query.logical import raw_series_filters
    try:
        plan = query_to_logical_plan(args.filter, 0)
        filter_sets = raw_series_filters(plan)
    except Exception as e:  # noqa: BLE001
        print(f"parse error: {e}", file=sys.stderr)
        return 1
    from filodb_tpu_torch.core.index import Equals
    labels = {}
    metric = ""
    for fs in filter_sets[:1]:
        for f in fs:
            if not isinstance(f, Equals):
                continue            # only equality pins a partkey label
            if f.column in ("__name__", "_metric_"):
                metric = f.value
            else:
                labels[f.column] = f.value
    if not metric:
        print("filter must pin a metric name with equality", file=sys.stderr)
        return 1
    pk = PartKey.make(metric, labels)
    raw = pk.to_bytes()
    print(f"partKey       {pk}")
    print(f"bytes ({len(raw)})   {raw.hex()}")
    print(f"partitionHash 0x{pk.partition_hash() & 0xFFFFFFFF:08x}")
    print(f"shardKeyHash  0x{pk.shard_key_hash() & 0xFFFFFFFF:08x}")
    from filodb_tpu_torch.parallel.shardmapper import ShardMapper
    n = args.num_shards
    if n <= 0 or (n & (n - 1)) != 0:
        print(f"--num-shards must be a power of 2, got {n}",
              file=sys.stderr)
        return 1
    mapper = ShardMapper(n)
    shard = mapper.ingestion_shard(pk.shard_key_hash(), pk.partition_hash(),
                                   args.spread)
    print(f"ingestionShard {shard}  (numShards={args.num_shards}, "
          f"spread={args.spread})")
    return 0


def cmd_decodevector(args) -> int:
    """Decoded sample dump for one series' chunks (ref: CliMain
    `decodeVector` — raw vector contents for debugging)."""
    import numpy as np

    from filodb_tpu_torch.memory.chunks import decode_chunkset
    from filodb_tpu_torch.persist.localstore import LocalDiskColumnStore
    cs = LocalDiskColumnStore(os.path.join(args.data_dir, "chunks"))
    shown = 0
    for rec in cs.read_part_keys(args.dataset, args.shard):
        if args.metric and rec.part_key.metric != args.metric:
            continue
        for c in cs.read_chunks(args.dataset, args.shard, rec.part_key,
                                0, 1 << 62):
            cols = decode_chunkset(c)
            ts = cols.pop("timestamp")
            print(f"# {rec.part_key} chunk={c.info.chunk_id} "
                  f"rows={c.info.num_rows}")
            for i in range(min(len(ts), args.rows)):
                vals = " ".join(f"{k}={np.asarray(v)[i]}"
                                for k, v in cols.items())
                print(f"  {int(ts[i])} {vals}")
            shown += 1
            if shown >= args.limit:
                return 0
    return 0


def cmd_decodechunkinfo(args) -> int:
    """Decode a hex chunkset frame's metadata (ref: CliMain
    `decodeChunkInfo --hexchunkinfo` — the chunk-info struct decoder)."""
    import json as _json

    from filodb_tpu_torch.persist.localstore import _decode_chunkset_frame
    raw = bytes.fromhex(args.hexframe.removeprefix("0x"))
    pk_bytes, schema_name, cs = _decode_chunkset_frame(raw)
    from filodb_tpu_torch.core.partkey import PartKey
    pk = PartKey.from_bytes(pk_bytes)
    print(_json.dumps({
        "partKey": {"metric": pk.metric, **pk.tags_dict},
        "schema": schema_name,
        "chunkId": cs.info.chunk_id,
        "ingestionTime": cs.info.ingestion_time_ms,
        "numRows": cs.info.num_rows,
        "startTime": cs.info.start_time_ms,
        "endTime": cs.info.end_time_ms,
        "numBytes": cs.nbytes,
        "encodings": {n: c.kind for n, c in cs.columns.items()},
    }, indent=1))
    return 0


def cmd_chunkinfos(args) -> int:
    """Per-chunk metadata for the series a PromQL filter selects, via the
    SelectChunkInfosExec debug plan over a recovered shard (ref:
    query/.../exec/SelectChunkInfosExec.scala)."""
    import json as _json


    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.persist.localstore import (LocalDiskColumnStore,
                                               LocalDiskMetaStore)
    from filodb_tpu_torch.promql.parser import query_to_logical_plan
    from filodb_tpu_torch.query.logical import raw_series_filters
    from filodb_tpu_torch.query.exec import SelectChunkInfosExec
    from filodb_tpu_torch.query.rangevector import QueryContext
    try:
        filter_sets = raw_series_filters(
            query_to_logical_plan(args.filter, 0))
        filters = list(filter_sets[0]) if filter_sets else []
    except Exception as e:  # noqa: BLE001
        print(f"parse error: {e}", file=sys.stderr)
        return 1
    cs = LocalDiskColumnStore(os.path.join(args.data_dir, "chunks"))
    meta = LocalDiskMetaStore(os.path.join(args.data_dir, "chunks"))
    ms = TimeSeriesMemStore(column_store=cs, meta_store=meta,
                            device=args.device)
    shard = ms.setup(args.dataset, args.shard)
    shard.recover_index()
    plan = SelectChunkInfosExec(QueryContext(), args.dataset, args.shard,
                                filters, 0, 1 << 62)
    res, _stats = plan._do_execute(ms)
    for row in (res.data or [])[:args.limit]:
        print(_json.dumps(row))
    return 0


def cmd_serve(args) -> int:
    """Run the standalone server (ref: FiloServer.scala:39)."""
    from filodb_tpu_torch.persist.localstore import (LocalDiskColumnStore,
                                               LocalDiskMetaStore)
    from filodb_tpu_torch.standalone import DatasetConfig, FiloServer
    kwargs = {}
    if args.data_dir:
        kwargs["column_store"] = LocalDiskColumnStore(
            os.path.join(args.data_dir, "chunks"))
        kwargs["meta_store"] = LocalDiskMetaStore(
            os.path.join(args.data_dir, "meta"))
    res = tuple(int(r) for r in args.downsample.split(",")) \
        if args.downsample else ()
    server = FiloServer(
        [DatasetConfig(args.dataset, args.shards,
                       downsample_resolutions=res)],
        http_host=args.bind, http_port=args.port, device=args.device,
        **kwargs)
    # SIGINT stops the server (its final flush included) even when the
    # process was started with SIGINT ignored (a background job of a
    # non-interactive shell inherits that)
    signal.signal(signal.SIGINT, signal.default_int_handler)
    server.start()
    print(f"serving {args.dataset} on {args.bind}:{server.http.port}",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.shutdown()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="filo-cli",
                                description="FiloDB-TPU operator CLI "
                                "(the PyTorch/CUDA port)")
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp, data_dir=True):
        sp.add_argument("--dataset", default="prometheus")
        sp.add_argument("--shards", type=int, default=1)
        if data_dir:
            sp.add_argument("--data-dir", default="./filodb-data")
        sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="the memstore's device (cpu: run on the host)")

    sp = sub.add_parser("init", help="create data-dir layout")
    common(sp)
    sp.set_defaults(fn=cmd_init)

    sp = sub.add_parser("importcsv", help="ingest a CSV file")
    common(sp)
    sp.add_argument("--file", required=True)
    sp.add_argument("--schema", default="gauge")
    sp.set_defaults(fn=cmd_importcsv)

    sp = sub.add_parser("exportbundle",
                        help="export raw series to a columnar NPZ bundle")
    common(sp)
    sp.add_argument("--metric")
    sp.add_argument("--filter", action="append",
                    help="label=value (repeatable)")
    sp.add_argument("--start", type=int, required=True, help="ms epoch")
    sp.add_argument("--end", type=int, required=True, help="ms epoch")
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_exportbundle)

    sp = sub.add_parser("importbundle", help="bulk-load an NPZ bundle")
    common(sp)
    sp.add_argument("--bundle", required=True)
    sp.set_defaults(fn=cmd_importbundle)

    sp = sub.add_parser("list", help="list datasets in a data dir")
    sp.add_argument("--data-dir", default="./filodb-data")
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("indexnames", help="label names in the tag index")
    common(sp)
    sp.set_defaults(fn=cmd_indexnames)

    sp = sub.add_parser("indexvalues", help="top label values by count")
    common(sp)
    sp.add_argument("--label", required=True)
    sp.add_argument("--limit", type=int, default=20)
    sp.set_defaults(fn=cmd_indexvalues)

    sp = sub.add_parser("topkcard", help="top-k cardinality by prefix")
    common(sp)
    sp.add_argument("--prefix", default="",
                    help="comma-separated shard-key prefix, e.g. demo,App-1")
    sp.add_argument("--k", type=int, default=10)
    sp.add_argument("--host", default="")
    sp.set_defaults(fn=cmd_topkcard)

    sp = sub.add_parser("query", help="PromQL range query")
    common(sp)
    sp.add_argument("--promql", required=True)
    sp.add_argument("--start", type=int, default=0)
    sp.add_argument("--end", type=int, default=0)
    sp.add_argument("--step", type=int, default=60)
    sp.add_argument("--host", default="",
                    help="query a running server (host:port) over HTTP")
    sp.add_argument("--raw", action="store_true")
    sp.set_defaults(fn=cmd_query)

    sp = sub.add_parser("querybatch",
                        help="batched PromQL range queries (one dashboard, "
                             "merged kernel dispatches)")
    common(sp)
    sp.add_argument("--promql", required=True, action="append",
                    help="repeatable: one per panel")
    sp.add_argument("--start", type=int, default=0)
    sp.add_argument("--end", type=int, default=0)
    sp.add_argument("--step", type=int, default=60)
    sp.add_argument("--host", default="",
                    help="query a running server (host:port) over HTTP")
    sp.add_argument("--raw", action="store_true")
    sp.set_defaults(fn=cmd_querybatch)

    sp = sub.add_parser("status", help="cluster shard status over HTTP")
    sp.add_argument("--host", required=True)
    sp.add_argument("--dataset", default="prometheus")
    sp.set_defaults(fn=cmd_status)

    sp = sub.add_parser("rules", help="ruler state over HTTP "
                                      "(groups / alerts / reload)")
    sp.add_argument("--host", required=True)
    sp.add_argument("--alerts", action="store_true",
                    help="show active alerts instead of rule groups")
    sp.add_argument("--reload", action="store_true",
                    help="POST /admin/rules/reload")
    sp.add_argument("--type", choices=["record", "alert"], default="",
                    help="filter rule groups by rule type")
    sp.set_defaults(fn=cmd_rules)

    sp = sub.add_parser("health", help="node health verdict tree over "
                                       "HTTP (exit 0 ok / 1 degraded / "
                                       "2 failed)")
    sp.add_argument("--host", required=True)
    sp.add_argument("--ready", action="store_true",
                    help="probe GET /ready instead (exit 0/1)")
    sp.set_defaults(fn=cmd_health)

    sp = sub.add_parser("jobs", help="background-job registry over HTTP")
    sp.add_argument("--host", required=True)
    sp.add_argument("--raw", action="store_true",
                    help="print the raw JSON payload")
    sp.set_defaults(fn=cmd_jobs)

    sp = sub.add_parser("shards", help="shard assignment/replica table "
                                       "over HTTP (GET /admin/shards)")
    sp.add_argument("--host", required=True)
    sp.add_argument("--dataset", default="",
                    help="narrow to one dataset (default: all)")
    sp.add_argument("--raw", action="store_true",
                    help="print the raw JSON payload")
    sp.set_defaults(fn=cmd_shards)

    sp = sub.add_parser("federation",
                        help="federated-cluster topology + health over "
                             "HTTP (GET /admin/federation; exit 1 when "
                             "any remote cluster is down)")
    sp.add_argument("--host", required=True)
    sp.add_argument("--raw", action="store_true",
                    help="print the raw JSON payload")
    sp.set_defaults(fn=cmd_federation)

    sp = sub.add_parser("queries", help="live in-flight queries over "
                                        "HTTP (list / --follow / --kill)")
    sp.add_argument("--host", required=True)
    sp.add_argument("--kill", default="",
                    help="kill this query id instead of listing")
    sp.add_argument("--reason", default="admin",
                    choices=["admin", "disconnect", "deadline"],
                    help="kill-reason tag for queries_killed_total")
    sp.add_argument("--tenant", default="",
                    help="only queries of this workspace")
    sp.add_argument("--follow", action="store_true",
                    help="poll continuously")
    sp.add_argument("--interval", type=float, default=1.0,
                    help="poll interval with --follow (seconds)")
    sp.add_argument("--raw", action="store_true", help="raw JSON")
    sp.set_defaults(fn=cmd_queries)

    sp = sub.add_parser("tenants", help="per-tenant QoS table over HTTP "
                                        "(usage + shares + live queue "
                                        "depth)")
    sp.add_argument("--host", required=True)
    sp.add_argument("--follow", action="store_true",
                    help="poll continuously")
    sp.add_argument("--interval", type=float, default=2.0,
                    help="poll interval with --follow (seconds)")
    sp.add_argument("--raw", action="store_true", help="raw JSON")
    sp.set_defaults(fn=cmd_tenants)

    sp = sub.add_parser("devices", help="per-chip device telemetry over "
                                        "HTTP (kernel ledger, HBM by "
                                        "region, compile events)")
    sp.add_argument("--host", required=True)
    sp.add_argument("--follow", action="store_true",
                    help="poll continuously")
    sp.add_argument("--interval", type=float, default=2.0,
                    help="poll interval with --follow (seconds)")
    sp.add_argument("--recent", type=int, default=8,
                    help="ledger tail length to show (0 hides it)")
    sp.add_argument("--raw", action="store_true", help="raw JSON")
    sp.set_defaults(fn=cmd_devices)

    sp = sub.add_parser("cardinality",
                        help="head-block cardinality over HTTP "
                             "(top-k metrics/tenants/label pairs from "
                             "/api/v1/status/tsdb)")
    sp.add_argument("--host", required=True)
    sp.add_argument("--dataset", default="",
                    help="dataset (default: the server's default dataset)")
    sp.add_argument("--tenant", default=None,
                    help="show only this workspace's series count")
    sp.add_argument("--k", type=int, default=10, help="top-k per section")
    sp.add_argument("--raw", action="store_true", help="raw JSON")
    sp.set_defaults(fn=cmd_cardinality)

    sp = sub.add_parser("events", help="tail the event journal over HTTP")
    sp.add_argument("--host", required=True)
    sp.add_argument("--since-seq", type=int, default=0,
                    help="resume from this sequence number (exclusive)")
    sp.add_argument("--limit", type=int, default=100,
                    help="newest N events per poll (0 = all available)")
    sp.add_argument("--kind", default="",
                    help="only events of this kind")
    sp.add_argument("--follow", action="store_true",
                    help="poll continuously, resuming by sequence")
    sp.add_argument("--interval", type=float, default=2.0,
                    help="poll interval with --follow (seconds)")
    sp.set_defaults(fn=cmd_events)

    sp = sub.add_parser("checkrules", help="validate a rules file offline")
    sp.add_argument("file", help="rules file (.json or HOCON-lite .conf)")
    sp.set_defaults(fn=cmd_checkrules)

    sp = sub.add_parser("validateSchemas", help="check schema registry")
    sp.set_defaults(fn=cmd_validate_schemas)

    sp = sub.add_parser("decodechunks", help="dump chunk metadata")
    common(sp)
    sp.add_argument("--shard", type=int, default=0)
    sp.add_argument("--limit", type=int, default=10)
    sp.set_defaults(fn=cmd_decodechunks)

    sp = sub.add_parser("decodechunkinfo",
                        help="decode a hex chunkset frame's metadata")
    sp.add_argument("hexframe", help="hex bytes of a chunkset frame")
    sp.set_defaults(fn=cmd_decodechunkinfo)

    sp = sub.add_parser("chunkinfos",
                        help="per-chunk metadata for a PromQL filter "
                             "(SelectChunkInfos debug plan)")
    common(sp)
    sp.add_argument("filter", help='e.g. \'m{_ws_="demo"}\'')
    sp.add_argument("--shard", type=int, default=0)
    sp.add_argument("--limit", type=int, default=50)
    sp.set_defaults(fn=cmd_chunkinfos)

    sp = sub.add_parser("partkey",
                        help="PromQL filter -> partkey bytes + shard routing")
    sp.add_argument("filter", help='e.g. \'m{_ws_="demo",_ns_="App-1"}\'')
    sp.add_argument("--num-shards", type=int, default=32)
    sp.add_argument("--spread", type=int, default=1)
    sp.set_defaults(fn=cmd_partkey)

    sp = sub.add_parser("decodevector",
                        help="dump decoded samples from persisted chunks")
    common(sp)
    sp.add_argument("--shard", type=int, default=0)
    sp.add_argument("--metric", default="")
    sp.add_argument("--rows", type=int, default=10)
    sp.add_argument("--limit", type=int, default=5)
    sp.set_defaults(fn=cmd_decodevector)

    sp = sub.add_parser("serve", help="run the standalone server")
    common(sp, data_dir=False)
    sp.add_argument("--data-dir", default="")
    sp.add_argument("--bind", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8080)
    sp.add_argument("--downsample", default="",
                    help="comma-separated resolutions in ms, e.g. 60000,300000")
    sp.set_defaults(fn=cmd_serve)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
