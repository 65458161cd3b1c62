"""Typed, layered runtime configuration (port of filodb_tpu/config.py).

The same FILODB_* keys and defaults as the reference.  This slice reads
the `query` and `store` sections; the others are carried as data for the
slices that port their subsystems.  compute_dtype() returns a torch
dtype, and apply_jax_runtime becomes apply_torch_runtime (TF32 off).

Mirrors the reference's layered HOCON config (ref:
core/src/main/resources/filodb-defaults.conf + FilodbSettings.scala:127 —
defaults, then the deploy's config file, then system-property overrides,
validated against the reference schema).  Here the layers are:

    dataclass defaults  <-  config file (HOCON-lite .conf or .json,
                            FILODB_TPU_CONFIG)  <-  environment variables
                            (FILODB_QUERY_*, FILODB_STORE_*, FILODB_*)

Every overlay is validated: unknown keys raise ConfigError with the full
path, values are coerced to the field's declared type (HOCON-lite duration
strings like "1h" convert by the field's _ms/_s suffix).  Dataset schemas
may be declared in the file's `schemas` block (Schemas.from_config) exactly
like the reference's `filodb.schemas` section.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional


class ConfigError(ValueError):
    pass


@dataclasses.dataclass
class QueryConfig:
    """ref: filodb-defaults.conf:166-204 `filodb.query`."""
    ask_timeout_s: float = 120.0
    # --- failure-domain hardening (doc/robustness.md) ---
    # end-to-end per-query time budget: stamped on the QueryContext at
    # admission (frontend) or execution start (bare engine), checked at
    # every exec-node boundary, and shrinking each remote hop's socket
    # timeout to the REMAINING budget.  Queue wait in the frontend
    # scheduler counts against it.  The Prometheus `timeout=` HTTP param
    # overrides per request, capped at this value.  <= 0 disables.
    default_timeout_s: float = 120.0
    # server-side default for PlannerParams.allow_partial_results: when a
    # shard stays unreachable after the re-plan retries (or a peer blows
    # its deadline share), scatter-gathers drop it and FLAG the result
    # partial instead of failing the query (the Thanos/Cortex
    # partial-response stance).  Per-request `partial_response=` wins.
    allow_partial_results: bool = False
    # deadline SHARE: when partial results are allowed, one remote hop's
    # socket wait is capped at this fraction of the query's REMAINING
    # budget (never above ask_timeout_s).  Without it a wedged peer —
    # accepting connections but never replying — consumes the entire
    # budget and the whole query times out even though degradation was
    # allowed; with it the hop expires early as a droppable
    # dispatch_timeout and the survivors still have (1 - share) of the
    # budget.  >= 1 disables the cap (a hop may spend the full
    # remainder); only meaningful when a deadline is set.
    peer_deadline_share: float = 0.5
    # shard_unavailable re-plan retries at the engine root (a node died
    # mid-query; after failover the re-planned query lands on the
    # reassigned owner).  dispatch_timeout is NEVER retried — the remote
    # may still be executing.  See query/execbase.QueryError taxonomy.
    dispatch_retries: int = 1
    stale_sample_after_ms: int = 5 * 60 * 1000
    sample_limit: int = 1_000_000
    join_cardinality_limit: int = 25_000
    group_by_cardinality_limit: int = 1_000
    min_step_ms: int = 5_000
    fastreduce_max_windows: int = 50
    faster_rate: bool = True
    # server-side micro-batching: concurrent HTTP query_range requests
    # over the same window grid arriving within this many ms coalesce
    # into ONE engine.query_range_batch (merged kernel dispatches) —
    # the batching win for UNMODIFIED dashboard clients that issue one
    # request per panel.  0 disables (default: opt-in, it trades up to
    # this much added latency for dispatch amortization).
    batch_window_ms: float = 0.0
    # cost-based host/device leaf routing: leaf working sets whose
    # estimated scan is at or below this many samples evaluate in host
    # numpy (ops/hostleaf) instead of paying the device's per-dispatch
    # floor.  0 disables.  Read per query from the shard's config, only
    # where FILODB_TPU_FORCE_HOST_ROUTE is set.
    host_route_max_samples: int = 2_000_000
    # --- query-serving frontend (query/frontend.py) ---
    # step-aligned incremental result cache (the Thanos/Cortex
    # query-frontend pattern): a dashboard re-poll recomputes only the
    # windows past the append horizon and merges them with the cached
    # prefix.  Invalidation: shard keys_epoch / index.mutations changes
    # drop entries; append-only ingest only shrinks the reusable prefix.
    result_cache_enabled: bool = True
    result_cache_max_entries: int = 256
    # per-entry size cap — raw-selector queries over huge working sets
    # must not pin the result set in host RAM (aggregated dashboards do)
    result_cache_max_entry_bytes: int = 32 << 20
    # per-tenant (_ws_) byte quota inside the result cache: inserting
    # past it evicts that tenant's OWN oldest entries, never another
    # tenant's — one tenant's dashboard churn cannot flush everyone
    # else's warm entries (the cache half of noisy-neighbor isolation).
    # 0 disables (global LRU only).
    result_cache_tenant_quota_bytes: int = 64 << 20
    # byte-identical in-flight query_range requests share ONE execution
    # (singleflight dedup; `query_singleflight_hits` counts the shares)
    singleflight_enabled: bool = True
    # bound on concurrently EXECUTING queries (cache hits and dedup'd
    # followers don't count): keeps N dashboard fanouts from stampeding
    # the device dispatch path.  0 = unbounded.
    max_concurrent_queries: int = 8
    # --- multi-tenant QoS (query/qos.py; doc/query_frontend.md) ---
    # weighted-fair scheduling over the max_concurrent_queries capacity:
    # per-workspace concurrency shares dispatched by deficit round robin
    # (an idle tenant's share redistributes to the busy ones).  Keys are
    # workspace (_ws_) names, values relative weights; absent tenants
    # get tenant_default_share.  {} = every tenant equal.
    tenant_shares: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    tenant_default_share: float = 1.0
    # per-tenant scheduler queue bound: a tenant with this many queries
    # already WAITING is shed with the structured `tenant_overloaded`
    # error (HTTP 429 + Retry-After) instead of queueing deeper.
    # 0 = unbounded queues (shedding then only via the deadline check).
    tenant_max_queue_depth: int = 32
    # adaptive read-side load shedding (write-side parity with the
    # ingest 429s): reject at admission when the PREDICTED queue wait —
    # live queue depth x an EWMA of slot-hold times at the tenant's
    # effective share — would blow the query's deadline budget.
    # Internal workspaces (_rules_/_self_) are never shed.
    shed_enabled: bool = True
    # shuffle sharding (query/qos.shuffle_shard_nodes): each tenant's
    # scatter-gather prefers a deterministic k-of-N subset of the data
    # nodes when walking replica owner lists, bounding a hot tenant's
    # blast radius.  0 disables (every tenant may land anywhere);
    # only meaningful with replicated multi-node owner lists.
    shuffle_shard_factor: int = 0
    # --- observability ---
    # slow-query flight recorder (utils/slowlog.py): queries whose total
    # serving wall exceeds this land in the /admin/slowlog ring buffer
    # with their full QueryStats + stitched span tree.  <= 0 disables.
    slow_query_threshold_s: float = 10.0
    slowlog_max_entries: int = 128
    # optional JSONL mirror of every slowlog record (empty disables);
    # the ring buffer stays bounded either way
    slowlog_path: str = ""
    # per-tenant (_ws_/_ns_) usage accounting (utils/usage.py): counters
    # at /metrics + the /api/v1/usage endpoint.  Limits count samples
    # SCANNED per tenant over a rolling window; warn logs + counts,
    # fail rejects the query with a structured tenant_limit_exceeded
    # error (Monarch-style per-tenant fairness floor).  0 = no limit.
    tenant_usage_enabled: bool = True
    tenant_limit_window_s: float = 60.0
    tenant_samples_warn_limit: int = 0
    tenant_samples_fail_limit: int = 0
    # per-tenant INGEST admission (the write-side counterpart of the scan
    # limits, enforced at every ingest door — remote_write, the Influx
    # TCP gateway, the /influx endpoint): samples OFFERED per tenant over
    # the same rolling tenant_limit_window_s window.  Over the limit,
    # remote_write answers 429 + Retry-After (backpressure — a compliant
    # client re-sends, nothing is silently lost); the TCP gateway, which
    # has no reply channel, drops WITH per-reason accounting
    # (`tenant_ingest_rejections` + the gateway drop log).  0 = no limit.
    tenant_ingest_samples_limit: int = 0
    # --- live query introspection (query/activequeries.py) ---
    # the active-query registry: every query listable at
    # GET /admin/queries from admission to completion and killable via
    # POST /admin/queries/<id>/kill (cooperative CancellationToken,
    # propagated to remote leaf nodes as kill frames).  Disabling turns
    # registration into a no-op (kill/introspection unavailable).
    active_queries_enabled: bool = True
    # crash-durable active-query file (the Prometheus
    # --query.active-query-tracker pattern): entries appended at
    # admission, tombstoned at completion; on boot, leftovers are
    # journaled as `query_active_at_crash` events so "what was running
    # when the node died" is answerable.  "" disables; FiloServer
    # defaults it under the WAL dir when one is configured.
    active_query_log_path: str = ""
    # --- distributed execution (query/pushdown.py, parallel/streams.py;
    # doc/query-engine.md "Aggregation pushdown & streaming") ---
    # node-level aggregation pushdown: when an aggregation fans out to
    # remote data nodes, the per-shard map subtrees owned by one node
    # are wrapped in a RemoteAggregateExec and dispatched to that node
    # as ONE unit — the node runs the reduce phase locally and only a
    # tiny [G, W] AggPartial crosses the wire (the FiloDB queryplanner
    # map/reduce split; Thanos/Cortex query-frontend pushdown).  A node
    # that is unreachable falls back to today's per-shard dispatch path
    # (replica failover preserved); non-pushable shapes (joins, topk's
    # per-series output, raw selectors) always take today's path.
    # false restores the per-shard dispatch exactly — every shard still
    # replies with its [G, W] map partial, just one round trip per
    # SHARD instead of per node.  Per-request override:
    # PlannerParams.aggregation_pushdown.
    aggregation_pushdown: bool = True
    # chunked streaming replies on the cross-node query transport: a
    # reply larger than this many bytes is split into CRC-framed row
    # slices so the coordinator assembles it incrementally under a
    # bounded frame buffer instead of buffering the whole reply twice
    # (raw frame + decoded arrays).  The query deadline applies per
    # frame and a kill lands between frames.  0 disables (single-frame
    # replies).
    stream_frame_bytes: int = 2 << 20
    # --- whole-expression compilation (query/exprfuse.py;
    # doc/query-engine.md "Whole-expression compilation") ---
    # compile whole expression trees, not just leaves: a multi-leaf
    # query (joins, multi-shard scatter) and every query_range_batch
    # dashboard batch run their leaves' fused preflights together and
    # merge the kernel work into batched dispatches; binary-join label
    # matching is memoized on the operands' working-set identity.
    # Unsupported shapes degrade leaf-by-leaf to the general engine
    # (query_exprfuse{verdict="degraded"}, stats.exprfuse) with
    # bit-identical results — false disables the compiler entirely and
    # restores per-leaf dispatch.
    exprfuse_enabled: bool = True
    # LRU capacity of the binary-join index-map cache (resolved label
    # match maps keyed on the operand blocks' cache_token; one entry
    # per distinct join x working set — a dashboard holds a few)
    exprfuse_join_cache_entries: int = 64


@dataclasses.dataclass
class RulesConfig:
    """Ruler — recording & alerting rules (filodb_tpu/rules/;
    doc/recording_rules.md).  Standing queries evaluated per group on an
    interval through the QueryFrontend (admission, deadlines, tenant
    `_rules_` accounting) whose outputs write back through the columnar
    ingest path, so recorded series are immediately queryable, flushable
    and downsample-eligible like any ingested series.

    Groups come from two places, merged (group names must be unique
    across both): an inline dict-shaped `groups {}` block here, and a
    standalone rules `file` (.json with the Prometheus list shape, or a
    HOCON-lite .conf mirroring the inline shape).  POST
    /admin/rules/reload re-reads both without a restart."""
    enabled: bool = False
    # standalone rules file; "" = inline groups only.  JSON files use the
    # Prometheus shape ({"groups": [{"name", "interval", "rules": [...]}]}),
    # .conf files the dict shape of the inline block below.
    file: str = ""
    # evaluated dataset; "" = the server's default (first) dataset
    dataset: str = ""
    # group eval interval when a group declares none
    default_interval_s: float = 30.0
    # alert webhook (Alertmanager v4 payload shape); "" keeps
    # notifications in the in-process sink (visible to tests/ops)
    notify_url: str = ""
    notify_retries: int = 3
    notify_backoff_s: float = 0.5
    notify_timeout_s: float = 5.0
    # re-send still-firing alerts every this many seconds (Prometheus
    # rules.alert.resend-delay, same 1m default); 0 = notify on
    # transitions only — only safe without a notify_url, where a batch
    # whose async delivery is dropped after retries would otherwise
    # never be re-sent (and a real Alertmanager's resolve_timeout
    # auto-resolves live alerts between deliveries).
    notify_resend_delay_s: float = 60.0
    # inline conf-tree groups: {group: {interval, limit?, rules: {name:
    # {record|alert, expr, labels{}, annotations{}, for, keep_firing_for}}}}
    # — dict-shaped because HOCON-lite has no object lists; the JSON/YAML
    # file path accepts the Prometheus list shape too
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class BreakerConfig:
    """Per-peer circuit breakers around the remote query dispatcher
    (parallel/breaker.py; doc/robustness.md): after `failure_threshold`
    CONSECUTIVE shard_unavailable/connect failures to one node address
    the breaker opens and dispatches to that peer fail fast in
    microseconds (so the partial-result path engages immediately instead
    of serializing connect timeouts), until a half-open probe succeeds.
    Open intervals back off exponentially from `open_base_s` to
    `open_max_s` with `jitter` fractional randomization (0 disables —
    tests pin it for determinism)."""
    enabled: bool = True
    failure_threshold: int = 3
    open_base_s: float = 1.0
    open_max_s: float = 30.0
    jitter: float = 0.2


@dataclasses.dataclass
class WalConfig:
    """Write-ahead log (filodb_tpu/wal/; doc/ingestion.md WAL section).

    Every acknowledged ingest through a WAL-fronted door (remote_write)
    is appended to a segmented on-disk log and group-committed BEFORE the
    ack returns, so a crash between scrape and flush loses nothing —
    replay on restart re-drives the same columnar ingest path (the
    Gorilla checkpoint+log stance: the in-memory store is the serving
    tier, the WAL makes it a system of record).  Segments rotate by size
    and are tombstoned once the flush scheduler reports every shard's
    checkpoint past the segment's last append."""
    enabled: bool = False
    # one subdirectory per dataset is created under this root
    dir: str = ".filodb_wal"
    # group-commit pacing: 0 commits as soon as there is uncommitted data
    # (ack latency = one fsync; concurrent writers batch for free while
    # the fsync runs).  > 0 additionally spaces fsyncs by this many ms —
    # fewer, bigger commits at the cost of up to this much ack latency —
    # unless commit_bytes of uncommitted appends force an early commit.
    commit_interval_ms: float = 0.0
    commit_bytes: int = 1 << 20
    segment_max_bytes: int = 64 << 20
    # False: group commit flushes to the OS page cache but skips fsync —
    # survives process crash, not host crash (bench/CI on slow disks)
    fsync: bool = True
    # replay the log into the memstore before serving on boot
    replay_on_start: bool = True


@dataclasses.dataclass
class ReplicationConfig:
    """Shard replication (filodb_tpu/replication/; doc/replication.md).

    Every shard gets an ordered owner list — one primary plus
    `factor - 1` replicas, never co-located on one node — and ingest
    fans each columnar slab to all live owners, so a node SIGKILL
    degrades into a query-time failover to the replica instead of a
    flagged partial (the FiloDB ShardMapper/coordinator stance;
    Cortex/Monarch replica sets).  Replicas that fall behind catch up
    by streaming WAL segments from the primary (never by re-scraping)."""
    enabled: bool = False
    # owners per shard (primary + replicas).  1 = replication off.
    factor: int = 2
    # when the ack returns to the ingest client:
    #   "primary" — primary durable; replica appends are async (lag
    #               tracked, catch-up repairs)
    #   "quorum"  — primary durable AND every LIVE replica acked (a
    #               dead replica is marked lagging and skipped so one
    #               corpse cannot wedge ingest; catch-up repairs it)
    ack_mode: str = "quorum"
    # per-replica append RPC timeout
    append_timeout_s: float = 5.0
    # a replica this many unacked records behind is journaled
    # `replica_lagging` (and `replica_caught_up` when it drains)
    lag_records_threshold: int = 256
    # async (ack_mode=primary) per-replica send queue bound; overflow
    # marks the replica lagging and drops (WAL catch-up repairs)
    send_queue_max: int = 1024
    # handoff: seconds the old owner keeps serving after cutover before
    # its copy is tombstoned (lets in-flight queries drain)
    handoff_tombstone_grace_s: float = 0.0


@dataclasses.dataclass
class IngestConfig:
    """Write-path observability (doc/observability.md write-path tracing
    section): the ingest slowlog + the freshness SLO fold.  The write
    path mirrors the query side's flight-recorder knobs — batches whose
    door-to-ack wall crosses `slow_batch_threshold_s` land in the
    /admin/ingestlog ring with their per-stage breakdown and trace id,
    and SUSTAINED breaches (>= freshness_breach_count inside
    freshness_window_s) flip the health evaluator's `ingest` subsystem
    to degraded until they age out."""
    # door-to-ack wall past this = one slowlog record + one freshness
    # breach.  <= 0 disables both the ingest slowlog and the breach fold
    # (the ack/freshness histograms record regardless).
    slow_batch_threshold_s: float = 5.0
    ingestlog_max_entries: int = 128
    # optional JSONL mirror of every ingestlog record ("" disables)
    ingestlog_path: str = ""
    # sustained-breach fold: this many breaches inside the window =>
    # health `ingest` subsystem degraded
    freshness_breach_count: int = 3
    freshness_window_s: float = 60.0


@dataclasses.dataclass
class SelfMonConfig:
    """Self-scrape meta-monitoring (utils/selfmon.py;
    doc/observability.md): an in-process loop snapshots the metrics
    registry every `interval_s` and writes every counter/gauge/histogram
    through the columnar ingest path under the reserved `_self_` tenant
    (gauge schema, `job="filodb"`, `instance` = the node id) — making
    the TSDB's own telemetry PromQL-queryable and ruler-alertable
    through its own engines (the Prometheus meta-monitoring / Monarch
    monitors-itself stance).  `_self_` is exempt from the scan-limit
    gate like `_rules_` but fully accounted."""
    enabled: bool = False
    interval_s: float = 15.0
    # target dataset; "" = the server's default (first) dataset
    dataset: str = ""


@dataclasses.dataclass
class StoreConfig:
    """Per-dataset store tuning (ref: core/.../store/IngestionConfig.scala:211 area,
    conf/timeseries-dev-source.conf `store {}` block)."""
    flush_interval_ms: int = 60 * 60 * 1000      # 1h chunk boundary
    disk_time_to_live_s: int = 3 * 24 * 3600
    max_chunks_size: int = 400                   # max samples per chunk
    # background flushes seal a partition only once this many samples are
    # unsealed (the reference's write-buffer batching: fewer, bigger
    # chunks; per-chunk encode+persist overhead was the ingest throttle
    # at 1M series).  Bounded lag: after 8 skipping rounds a group seals
    # everything, so the checkpoint advances at least every ~8 intervals.
    # Direct flush_group()/flush_all_groups() calls always seal all.
    # 256 targets the reference's ~400-sample chunks (max_chunks_size).
    min_flush_samples: int = 256
    groups_per_shard: int = 60
    shard_mem_size: int = 512 * 1024 * 1024
    max_blob_buffer_size: int = 15 * 1024 * 1024
    demand_paging_enabled: bool = True
    multi_partition_odp: bool = False
    # time-block length (samples) for dense device arrays
    device_block_rows: int = 128
    # keep an HBM-resident mirror of each store, revalidated by generation,
    # so repeat queries skip the host->device transfer (devicecache.py)
    device_mirror_enabled: bool = True
    device_mirror_hbm_limit: int = 8 << 30
    # sharded mirror mode (multi-chip boxes): place each shard's mirror
    # on its own device via core/devicecache.MirrorPlacer (HBM-aware
    # against device_mirror_hbm_limit), so the per-device fused dispatch
    # runs every shard's kernel on the chip that holds its columns.
    # Engages only with >= 2 local devices.
    device_mirror_sharded: bool = True
    # compressed resident tier: sealed chunks kept NibblePack'd in host RAM
    # under this budget so the dense tier holds only the active tail
    # (memory/resident.py; ref: doc/ingestion.md:110 in-memory compression)
    resident_cache_bytes: int = 256 << 20
    # samples per series retained dense after memory enforcement
    active_tail_rows: int = 512
    # run the post-eviction full DeviceMirror re-upload on a background
    # thread instead of the first query's critical path (queries host-
    # gather until the new snapshot publishes).  Incremental (append-only) refreshes and the
    # cold first build stay inline.
    mirror_background_rebuild: bool = True
    # --- historical tier (persist/segments + compactor; doc/operations.md
    # compaction runbook) ---
    # background segment compaction: rewrite flushed chunkset frames of
    # closed time windows into columnar [S, T] segments the query path
    # scans at device speed.  Engages only with a disk-backed column
    # store (LocalDiskColumnStore).
    segment_compaction_enabled: bool = True
    # segment window width: one segment file per (shard, schema, window).
    # Bigger windows = fewer/larger cold uploads; smaller = finer LRU
    # eviction granularity in the cold region.
    segment_window_ms: int = 6 * 3600 * 1000
    # a window compacts once its end is this far in the past (late
    # flushes for it have landed); >= the flush interval
    segment_closed_lag_ms: int = 60 * 60 * 1000
    # how often the compactor sweeps (also runs retention)
    segment_compact_interval_ms: int = 5 * 60 * 1000
    # retention: age raw chunk frames out of the chunk log once a
    # covering segment exists AND the frames are at least this old
    # (0 disables pruning — the log grows forever)
    segment_retain_raw_ms: int = 24 * 3600 * 1000
    # byte budget of the cold DeviceMirror region: persisted-segment
    # blocks uploaded on demand, LRU-evicted at segment granularity.
    # A single query whose working set exceeds the budget degrades to a
    # host-side segment scan (never an error, never an OOM).
    device_mirror_cold_limit_bytes: int = 2 << 30


@dataclasses.dataclass
class ObjectStoreConfig:
    """Disaggregated cold tier (persist/objectstore.py): shared,
    content-addressed segment objects + per-shard manifests, so a node's
    disk is disposable and read capacity scales with stateless
    query-only nodes (doc/operations.md disk-loss runbook)."""
    # shared directory every node mounts (the S3/GCS stand-in); empty
    # disables the tier entirely
    root: str = ""
    # boot-time manifest-driven restore: refetch every manifested
    # segment the local disk is missing BEFORE serving (/ready holds
    # 503 until the mount lands)
    restore_on_boot: bool = True
    # upload retry schedule (exponential backoff + full jitter through
    # the objectstore.put/get/list fault points)
    retry_base_s: float = 0.05
    retry_max_s: float = 2.0
    max_attempts: int = 6
    # query-only nodes: manifest snapshot TTL (staleness feeds the
    # `persistence` health verdict)
    manifest_ttl_s: float = 5.0
    # upload backlog age / manifest staleness past this degrades the
    # `persistence` health subsystem
    backlog_warn_s: float = 600.0


@dataclasses.dataclass
class FederationConfig:
    """Cross-cluster federation (filodb_tpu/federation/;
    doc/federation.md): N independent filodb-tpu clusters answer PromQL
    as one system.  A FederationPlanner above each dataset's planner
    stack routes whole-expression subtrees to the clusters that OWN the
    matching series (label matchers and/or time windows), pushes
    exactly-mergeable aggregations so each remote cluster replies one
    [G, W] AggPartial over the node-query wire, and degrades a dead or
    deadline-blown cluster through the partial-results gate (warning
    names the cluster) behind a `cluster:<name>` circuit breaker."""
    enabled: bool = False
    # this cluster's name: announced in door pings, shown in remote
    # clusters' health/ownership views
    cluster_name: str = "local"
    # federation door — the node-query transport endpoint remote
    # coordinators dispatch FederatedLeafExec plans to.  Starts whenever
    # federation is enabled (port 0 = ephemeral, fine for tests; fixed
    # in production so peers can declare it)
    door_host: str = "127.0.0.1"
    door_port: int = 0
    # health probes: each configured remote cluster's door is pinged on
    # this cadence; failures feed the `cluster:<name>` breaker and the
    # federation health subsystem + journal
    probe_interval_s: float = 5.0
    probe_timeout_s: float = 2.0
    # push exactly-mergeable aggregations as [G, W] AggPartials (the
    # cross-cluster pushdown).  False = ship-everything strawman (whole
    # child series cross the wire) — the wire-ratio baseline bench.py
    # federation measures against; True is the only production stance.
    push_partials: bool = True
    # remote clusters, dict-shaped because HOCON-lite has no object
    # lists: {name: {host, port, dataset?, match: {label: regex-or-
    # literal}, time_start_ms?, time_end_ms?}}.  `match` declares label
    # ownership (a query's selector must match to route there);
    # time_*_ms bound the cluster's time ownership window (0/absent =
    # unbounded).  A cluster with neither owns nothing.
    clusters: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class IndexConfig:
    """Tag-index engine knobs (core/index.py bitmap postings)."""
    # per-tenant (_ws_) alive-series budget per shard, enforced at
    # partition creation: an over-budget tenant's new series get a
    # structured drop + the tenant_series_rejected counter (existing
    # series keep ingesting).  0 disables.  Internal workspaces
    # (_rules_, _self_) and series without _ws_ are exempt, like the
    # usage scan limits.
    tenant_series_limit: int = 0
    # index_compaction background job cadence (standalone server):
    # every interval each shard's index prunes tombstoned postings once
    # its backlog crosses the threshold below.  <= 0 disables the job.
    compaction_interval_s: float = 30.0
    # tombstone backlog that triggers a compaction pass per shard; the
    # churn-soak memory-flatness gate assumes this stays bounded
    compaction_tombstone_threshold: int = 8192


@dataclasses.dataclass
class SpreadAssignment:
    """Per-shard-key spread override (ref: filodb-defaults.conf:157-161)."""
    shard_key: Dict[str, str]
    spread: int


@dataclasses.dataclass
class FilodbSettings:
    """Top-level settings (ref: coordinator/.../FilodbSettings.scala:127)."""
    spread_default: int = 1
    # the reference's persistent compile cache directory; the port
    # compiles nothing at query time and keeps it as data only
    jax_compile_cache_dir: str = ".filodb_jax_cache"
    # boot-time warmup: "SxTxWxG[;SxTxWxG...]" fused-kernel shapes to
    # compile before serving (cache-hit deserialization on restart, full
    # compile on first boot) so the first dashboard never waits.
    warmup_shapes: str = ""
    # span push-export target (ref: the Kamon Zipkin reporter,
    # KamonLogger.scala:16-40): "http(s)://host:port/api/v2/spans" or
    # "file:///path/spans.jsonl"; empty disables.  The in-memory trace
    # store stays bounded either way (256 traces x 512 events).
    trace_export_url: str = ""
    spread_assignment: List[SpreadAssignment] = dataclasses.field(default_factory=list)
    # structured event journal (utils/events.py; served at /admin/events):
    # bounded ring size + optional JSONL mirror ("" disables the sink —
    # the ring stays bounded either way)
    event_journal_max_entries: int = 2048
    event_journal_path: str = ""
    # OpenMetrics exemplars on latency histograms: Histogram.record
    # attaches the active trace id per bucket and
    # /metrics?format=openmetrics emits `# {trace_id="..."}` exemplar
    # suffixes (doc/observability.md).  Off = the record path drops the
    # exemplar argument and the exposition emits none.
    exemplars_enabled: bool = True
    query: QueryConfig = dataclasses.field(default_factory=QueryConfig)
    store: StoreConfig = dataclasses.field(default_factory=StoreConfig)
    breaker: BreakerConfig = dataclasses.field(default_factory=BreakerConfig)
    rules: RulesConfig = dataclasses.field(default_factory=RulesConfig)
    wal: WalConfig = dataclasses.field(default_factory=WalConfig)
    ingest: IngestConfig = dataclasses.field(default_factory=IngestConfig)
    selfmon: SelfMonConfig = dataclasses.field(default_factory=SelfMonConfig)
    replication: ReplicationConfig = dataclasses.field(
        default_factory=ReplicationConfig)
    index: IndexConfig = dataclasses.field(default_factory=IndexConfig)
    objectstore: ObjectStoreConfig = dataclasses.field(
        default_factory=ObjectStoreConfig)
    federation: FederationConfig = dataclasses.field(
        default_factory=FederationConfig)
    shard_key_level_metrics: bool = True
    quota_default: int = 2_000_000_000
    reassignment_min_interval_s: float = 2 * 3600.0

    # dataset schemas declared in config (None = built-in DEFAULT_SCHEMAS);
    # populated by overlay from the file's `schemas` block
    schemas: Optional[object] = None

    def spread_for(self, shard_key: Dict[str, str]) -> int:
        for a in self.spread_assignment:
            if all(shard_key.get(k) == v for k, v in a.shard_key.items()):
                return a.spread
        return self.spread_default

    # ------------------------------------------------------------- layering

    def overlay(self, raw: Dict[str, Any], source: str = "config"
                ) -> "FilodbSettings":
        """Apply one config layer with validation.  Mutates and returns self."""
        raw = dict(raw)
        schemas_raw = {}
        for sect in ("schemas", "partition_schema"):
            if sect in raw:
                schemas_raw[sect] = raw.pop(sect)
        if schemas_raw:
            from filodb_tpu_torch.core.schemas import Schemas
            try:
                self.schemas = Schemas.from_config(schemas_raw)
            except (ValueError, AttributeError, TypeError) as e:
                # AttributeError/TypeError: non-dict where a block was
                # expected — still a config mistake, same error surface
                raise ConfigError(f"{source}: {e}")
        for section, obj in (("query", self.query), ("store", self.store),
                             ("breaker", self.breaker),
                             ("rules", self.rules), ("wal", self.wal),
                             ("ingest", self.ingest),
                             ("selfmon", self.selfmon),
                             ("replication", self.replication),
                             ("index", self.index),
                             ("objectstore", self.objectstore),
                             ("federation", self.federation)):
            for k, v in (raw.pop(section, None) or {}).items():
                _set_field(obj, k, v, f"{source}: {section}.{k}")
        if "spread_assignment" in raw:
            entries = raw.pop("spread_assignment")
            try:
                self.spread_assignment = [
                    SpreadAssignment(dict(a["shard_key"]), int(a["spread"]))
                    for a in entries]
            except (TypeError, KeyError, ValueError):
                raise ConfigError(
                    f"{source}: spread_assignment entries must be objects "
                    "with 'shard_key' and 'spread' — declare them in a "
                    ".json config (HOCON-lite does not parse object lists)")
        for k, v in raw.items():
            _set_field(self, k, v, f"{source}: {k}")
        return self

    @classmethod
    def load(cls, path: Optional[str] = None,
             env: Optional[Dict[str, str]] = None) -> "FilodbSettings":
        """defaults <- file <- environment."""
        s = cls()
        if path:
            if path.endswith(".json"):
                with open(path) as f:
                    raw = json.load(f)
            else:
                from filodb_tpu_torch.utils import hoconlite
                raw = hoconlite.load(path)
                # allow the reference's `filodb { ... }` top-level wrapper
                if set(raw) == {"filodb"}:
                    raw = raw["filodb"]
            s.overlay(raw, source=path)
        env = os.environ if env is None else env
        overlay: Dict[str, Any] = {}
        top_fields = {f.name for f in dataclasses.fields(cls)}
        for name, val in env.items():
            if not name.startswith("FILODB_") or name == "FILODB_TPU_CONFIG":
                continue
            rest = name[len("FILODB_"):].lower()
            # env values get the same scalar parsing as .conf files, so
            # durations ("30 minutes") and booleans behave identically
            from filodb_tpu_torch.utils.hoconlite import _parse_scalar
            parsed = _parse_scalar(val)
            for section in ("query_", "store_", "breaker_", "rules_",
                            "wal_", "ingest_", "selfmon_", "replication_",
                            "index_", "objectstore_", "federation_"):
                if rest.startswith(section):
                    overlay.setdefault(section[:-1], {})[
                        rest[len(section):]] = parsed
                    break
            else:
                if rest in top_fields:
                    overlay[rest] = parsed
                # other FILODB_* vars belong
                # to sibling tools — not config keys, not typos: ignored
        if overlay:
            s.overlay(overlay, source="environment")
        return s

    @classmethod
    def from_json(cls, path: str) -> "FilodbSettings":
        return cls.load(path)


def _set_field(obj, key: str, value, where: str) -> None:
    fields = {f.name: f for f in dataclasses.fields(obj)}
    if key not in fields:
        raise ConfigError(f"{where}: unknown setting "
                          f"(valid: {sorted(fields)})")
    setattr(obj, key, _coerce(value, getattr(obj, key), key, where))


def _coerce(value, current, key: str, where: str):
    from filodb_tpu_torch.utils.hoconlite import Duration
    if isinstance(value, Duration):
        if key.endswith("_ms"):
            num = value.millis
        elif key.endswith("_s"):
            num = value.seconds
        else:
            raise ConfigError(f"{where}: duration given for "
                              f"non-duration field")
        # respect the field's declared type (int fields stay ints)
        return int(num) if isinstance(current, int) else float(num)
    want = type(current)
    if isinstance(current, bool):
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            low = value.lower()
            if low in ("true", "yes", "on", "1"):
                return True
            if low in ("false", "no", "off", "0"):
                return False
        raise ConfigError(f"{where}: expected a boolean, got {value!r}")
    if isinstance(current, (int, float)) and not isinstance(current, bool):
        try:
            out = want(value)
        except (TypeError, ValueError):
            raise ConfigError(f"{where}: expected {want.__name__}, "
                              f"got {value!r}")
        if isinstance(current, int) and isinstance(value, float) \
                and value != out:
            raise ConfigError(f"{where}: expected an integer, got {value!r}")
        return out
    if current is None or isinstance(current, (str, list, dict)):
        return value
    return value


def compute_dtype():
    """Value dtype for device kernels: float32 (the kernels' type), or
    float64 where torch's default dtype was set to it (the reference
    returns jnp.float64 under jax_enable_x64)."""
    import torch
    return (torch.float64 if torch.get_default_dtype() == torch.float64
            else torch.float32)


_SETTINGS: Optional[FilodbSettings] = None


def settings() -> FilodbSettings:
    global _SETTINGS
    if _SETTINGS is None:
        _SETTINGS = FilodbSettings.load(os.environ.get("FILODB_TPU_CONFIG"))
    return _SETTINGS


def apply_torch_runtime(cfg: FilodbSettings) -> None:
    """The torch counterpart of the reference's apply_jax_runtime: turn
    TF32 off for matmul and cuDNN, so every f32 product is computed in
    FP32 and two runs give the same bits (the port compiles nothing at
    query time, so there is no compile cache to point anywhere;
    cfg.jax_compile_cache_dir is kept as data only).  Idempotent."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def parse_warmup_shapes(spec: str):
    """cfg.warmup_shapes "SxTxWxG[;...]" -> [(S, T, W, G)] (ValueError on
    malformed entries: a typo'd warmup list must fail boot loudly, not
    silently skip the warmup it was deployed for)."""
    shapes = []
    for part in (spec or "").replace(",", ";").split(";"):
        part = part.strip()
        if not part:
            continue
        dims = part.lower().split("x")
        if len(dims) != 4:
            raise ConfigError(
                f"warmup_shapes entry {part!r}: expected SxTxWxG")
        try:
            shapes.append(tuple(int(d) for d in dims))
        except ValueError:
            raise ConfigError(
                f"warmup_shapes entry {part!r}: non-integer dimension")
    return shapes
