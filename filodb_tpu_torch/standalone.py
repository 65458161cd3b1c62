"""FiloServer — the standalone process entry point (port of
filodb_tpu/standalone.py).

ref: standalone/.../FiloServer.scala:39-60 — boots the coordinator, memstore,
and HTTP server for a single node owning every shard of its datasets.  The
standalone wires: memstore (+ optional local-disk persistence), shard mapper,
planner stack (shard-key regex fan-out over the single-cluster planner,
long-time-range split when downsampling or the persisted tier is on,
cross-cluster federation outermost when `federation.enabled`), gateway
pipeline with its WAL, the replication door with its fan-out and handoff
coordinators when `replication.enabled`, the ruler, self-monitoring, span
export and the HTTP API.

Device rule: `FiloServer(..., device="cuda")` is the default; without a
card the constructor raises unless the caller passes `device="cpu"`.  The
memstore, its downsample stores, the cold region and every engine live on
that device, and so do the leaves the federation door and the
replication door serve.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from filodb_tpu_torch.config import (ConfigError, FilodbSettings,
                                     apply_torch_runtime,
                                     parse_warmup_shapes,
                                     settings as default_settings)
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.core.store import (ColumnStore, InMemoryColumnStore,
                                         InMemoryMetaStore, MetaStore)
from filodb_tpu_torch.gateway.router import GatewayPipeline
from filodb_tpu_torch.http.routes import PromHttpApi
from filodb_tpu_torch.http.server import FiloHttpServer
from filodb_tpu_torch.parallel.shardmapper import (ShardEvent, ShardMapper,
                                                   ShardStatus,
                                                   SpreadProvider)
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.query.planner import SingleClusterPlanner
from filodb_tpu_torch.query.planners import (ShardKeyRegexPlanner,
                                             default_shard_key_matcher)
from filodb_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class DatasetConfig:
    """Per-dataset ingestion config (ref: conf/timeseries-dev-source.conf —
    dataset, num-shards, sourcefactory, store block)."""
    name: str = "prometheus"
    num_shards: int = 4
    downsample_resolutions: Sequence[int] = ()


class IndexCompactionLoop:
    """Churn maintenance for the part-key index (doc/index.md runbook).

    Eviction flips an alive bit and leaves a tombstone — O(1), no posting
    rewrite on the ingest path.  This daemon sweeps every shard of every
    dataset each interval and runs PartKeyIndex.compact() once a shard's
    tombstone backlog crosses `index.compaction_tombstone_threshold`,
    pruning dead postings, empty value/label dict entries, and fully-dead
    leading containers so index memory stays flat under series churn.
    Registered as the `index_compaction` job (GET /admin/jobs)."""

    def __init__(self, memstore, datasets: Sequence[str], interval_s: float,
                 tombstone_threshold: int):
        from filodb_tpu_torch.utils.jobs import jobs
        self.memstore = memstore
        self.datasets = list(datasets)
        self.interval_s = interval_s
        self.tombstone_threshold = tombstone_threshold
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.job = jobs.register("index_compaction", interval_s=interval_s)

    def start(self) -> "IndexCompactionLoop":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="filodb-index-compaction", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=30)
            self._thread = None

    def run_once(self) -> int:
        """One sweep over every shard; returns shards compacted."""
        compacted = 0
        for name in self.datasets:
            for sh in self.memstore.shards_for(name):
                if sh.compact_index(self.tombstone_threshold):
                    compacted += 1
        return compacted

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                with self.job.tick() as jt:
                    n = self.run_once()
                    if n == 0:
                        # below threshold everywhere: neutral tick, the
                        # backlog keeps accruing until worth a rewrite
                        jt.skip()
                    else:
                        self.job.set_progress(f"compacted {n} shard indexes")
            except Exception:  # noqa: BLE001 — recorded by tick(); the
                pass           # sweep must survive one bad shard


class FiloServer:

    def __init__(self, datasets: Optional[List[DatasetConfig]] = None,
                 column_store: Optional[ColumnStore] = None,
                 meta_store: Optional[MetaStore] = None,
                 config: Optional[FilodbSettings] = None,
                 http_host: str = "127.0.0.1", http_port: int = 0,
                 node_name: str = "local",
                 replication_peers: Optional[Dict[str, tuple]] = None,
                 device="cuda"):
        # the device rule first: a node asked for a card that is not
        # there is refused before it touches any process-wide state
        self.device = resolve_device(device)
        self.config = config or default_settings()
        # health model (utils/health.py): phase machinery + per-subsystem
        # verdicts, served at /healthz, /ready and /api/v1/status/health.
        # Created FIRST so every boot step below lands as a phase/journal
        # event — the flight recorder starts at "booting"
        from filodb_tpu_torch.utils.events import journal
        from filodb_tpu_torch.utils.health import BOOTING, HealthEvaluator
        self.health = HealthEvaluator(node_name=node_name, phase=BOOTING)
        journal.configure(
            max_entries=self.config.event_journal_max_entries,
            path=self.config.event_journal_path)
        journal.emit("server_boot", subsystem="server", node=node_name)
        # FP32 matmuls (no TF32) before any kernel runs: the port
        # compiles nothing at query time, so this is its whole runtime
        # setup (the reference points its XLA compile cache here)
        apply_torch_runtime(self.config)
        self.datasets = datasets or [DatasetConfig()]
        self.column_store = column_store or InMemoryColumnStore()
        self.meta_store = meta_store or InMemoryMetaStore()
        self.node_name = node_name
        self.memstore = TimeSeriesMemStore(
            column_store=self.column_store, meta_store=self.meta_store,
            config=self.config, device=self.device)
        self.mappers: Dict[str, ShardMapper] = {}
        self.spreads: Dict[str, SpreadProvider] = {}
        self.engines: Dict[str, QueryEngine] = {}
        self.gateways: Dict[str, GatewayPipeline] = {}
        self.ds_stores: Dict[str, object] = {}
        self.flush_schedulers: Dict[str, object] = {}
        self.index_compactor: Optional[IndexCompactionLoop] = None
        self.wals: Dict[str, object] = {}
        self._earliest_cache: Dict[str, tuple] = {}
        # historical tier: one cold DeviceMirror region (byte-budgeted LRU
        # of persisted-segment blocks) shared across datasets, plus a
        # per-dataset PersistedTier + compaction scheduler — wired only
        # when the column store is disk-backed (LocalDiskColumnStore)
        self.cold_cache = None
        self.persisted_tiers: Dict[str, object] = {}
        self.compaction_schedulers: Dict[str, object] = {}
        if self.config.store.segment_compaction_enabled and \
                hasattr(self.column_store, "iter_chunk_refs"):
            from filodb_tpu_torch.core.devicecache import ColdSegmentCache
            self.cold_cache = ColdSegmentCache(
                self.config.store.device_mirror_cold_limit_bytes,
                device=self.device)
        # disaggregated cold tier (persist/objectstore.py): when a shared
        # object-store root is configured next to a disk-backed segment
        # tier, compaction uploads content-addressed segments there,
        # retention gates on upload acks, and boot restores the local
        # segment dir from the manifests (doc/operations.md disk-loss
        # runbook)
        self.object_store = None
        self.uploaders: Dict[str, object] = {}
        if self.config.objectstore.root and self.cold_cache is not None \
                and getattr(self.column_store, "root", None):
            from filodb_tpu_torch.persist.objectstore import LocalObjectStore
            self.object_store = LocalObjectStore(
                self.config.objectstore.root)
        # observability singletons take their knobs from THIS server's
        # settings: the slow-query flight recorder (ring size, JSONL
        # sink) and the per-tenant usage window (utils/slowlog, usage)
        from filodb_tpu_torch.utils.slowlog import ingestlog, slowlog
        from filodb_tpu_torch.utils.usage import usage
        slowlog.configure(
            threshold_s=self.config.query.slow_query_threshold_s,
            max_entries=self.config.query.slowlog_max_entries,
            path=self.config.query.slowlog_path)
        usage.window_s = self.config.query.tenant_limit_window_s
        # multi-tenant QoS (query/qos.py): validate the share map at
        # boot — a typo'd share must fail the deploy loudly, not
        # silently schedule that tenant at the default — and journal the
        # effective config so "who had what share when" is answerable
        # from the flight recorder next to the overload events
        qc = self.config.query
        for ws, share in qc.tenant_shares.items():
            try:
                bad = not (float(share) > 0)
            except (TypeError, ValueError):
                bad = True
            if bad:
                raise ConfigError(
                    f"query.tenant_shares.{ws}: expected a positive "
                    f"number, got {share!r}")
        if qc.tenant_max_queue_depth < 0:
            raise ConfigError("query.tenant_max_queue_depth must be "
                              ">= 0 (0 = unbounded)")
        if qc.shuffle_shard_factor < 0:
            raise ConfigError("query.shuffle_shard_factor must be "
                              ">= 0 (0 = disabled)")
        journal.emit(
            "qos_config", subsystem="query",
            max_concurrent=qc.max_concurrent_queries,
            shares=",".join(f"{k}={float(v):g}" for k, v in
                            sorted(qc.tenant_shares.items())) or "equal",
            max_queue_depth=qc.tenant_max_queue_depth,
            shed_enabled=qc.shed_enabled,
            shuffle_shard_factor=qc.shuffle_shard_factor)
        # write-path observability (doc/observability.md): the ingest
        # flight recorder, the freshness SLO fold feeding the health
        # evaluator's `ingest` verdict, the exemplar toggle, and the
        # node name stamped on every span this process records
        from filodb_tpu_torch.utils import metrics as _metrics
        from filodb_tpu_torch.utils.freshness import freshness
        ingestlog.configure(
            threshold_s=self.config.ingest.slow_batch_threshold_s,
            max_entries=self.config.ingest.ingestlog_max_entries,
            path=self.config.ingest.ingestlog_path)
        freshness.configure(
            threshold_s=self.config.ingest.slow_batch_threshold_s,
            breach_count=self.config.ingest.freshness_breach_count,
            window_s=self.config.ingest.freshness_window_s)
        _metrics.set_exemplars_enabled(self.config.exemplars_enabled)
        # live query introspection (query/activequeries.py): wire the
        # registry's knobs, default the crash-durable active-query file
        # next to the WAL when one is configured, and journal whatever
        # the PREVIOUS process left running at crash time
        from filodb_tpu_torch.query.activequeries import active_queries
        aq_path = self.config.query.active_query_log_path
        if not aq_path and self.config.wal.enabled and self.config.wal.dir:
            aq_path = os.path.join(self.config.wal.dir, "queries.active")
        active_queries.configure(
            enabled=self.config.query.active_queries_enabled,
            path=aq_path)
        self._active_query_path = aq_path
        n_crash = active_queries.replay_crash_log()
        if n_crash:
            journal.emit("query_crash_replay", subsystem="query",
                         queries_active_at_crash=n_crash)
        if node_name != "local" or not _metrics.NODE_NAME:
            # an explicitly-named server stamps its spans (the cross-
            # node trace evidence); default-named embedded servers only
            # fill an empty slot so they never clobber a real identity
            _metrics.NODE_NAME = node_name
        # Cross-cluster federation (filodb_tpu_torch/federation; doc/
        # federation.md): the registry parses `federation.clusters` and
        # probes remote doors; the door is THIS cluster's dispatch
        # endpoint.  Both exist before the dataset loop so each
        # dataset's planner stack gains a FederationPlanner outermost
        # and registers its inner stack at the door.
        self.federation_registry = None
        self.federation_door = None
        fed = self.config.federation
        if fed.enabled:
            from filodb_tpu_torch.federation import (FederationDoor,
                                                     FederationRegistry)
            cluster = fed.cluster_name or node_name
            self.federation_registry = FederationRegistry(
                fed, local_name=cluster)
            self.federation_door = FederationDoor(
                cluster, host=fed.door_host, port=fed.door_port,
                device=self.device)
        for dc in self.datasets:
            self._setup_dataset(dc)
        if self.federation_door is not None:
            # bound in __init__ (not start()) so embedders that query
            # without start() — and the two-cluster test pair reading
            # back an ephemeral port — see a live door immediately
            self.federation_door.start()
            self.health.probes["federation"] = \
                self.federation_registry.health_probe
            journal.emit("federation_door_open", subsystem="federation",
                         cluster=self.federation_registry.local_name,
                         port=self.federation_door.port,
                         clusters=",".join(
                             sorted(self.federation_registry.clusters)))
        if self.uploaders:
            # the `persistence` health subsystem: upload backlog age +
            # breaker state per dataset, worst-wins into the verdict
            from filodb_tpu_torch.persist.objectstore import \
                persistence_probe
            self.health.probes["persistence"] = persistence_probe(
                self.uploaders,
                backlog_warn_s=self.config.objectstore.backlog_warn_s)
        first = self.datasets[0].name
        self.api = PromHttpApi(self.engines, gateways=self.gateways,
                               shard_mappers=self.mappers,
                               default_dataset=first,
                               batch_window_ms=self.config.query
                               .batch_window_ms,
                               config=self.config, health=self.health)
        if self.federation_registry is not None:
            self.api.federation = self.federation_registry
        self.http = FiloHttpServer(self.api, http_host, http_port)
        # Ruler — recording & alerting rules (filodb_tpu_torch/rules):
        # standing queries evaluated through this server's QueryFrontend
        # whose outputs write back through the columnar ingest path of
        # the configured dataset's shards.  Built AFTER the API so the
        # frontends exist; evaluation loops start in start().
        self.ruler = None
        if self.config.rules.enabled:
            from filodb_tpu_torch.rules import MemstoreSink, Ruler
            ds = self.config.rules.dataset or first
            if ds not in self.engines:
                raise ConfigError(
                    f"rules.dataset {ds!r} is not a served dataset "
                    f"(have: {sorted(self.engines)})")
            # reload() re-reads the conf file from disk when one backs
            # the process, so /admin/rules/reload picks up edits to the
            # inline rules.groups block too (not just rules.file)
            conf_path = os.environ.get("FILODB_TPU_CONFIG")
            config_source = None
            if conf_path:
                config_source = (lambda p=conf_path:
                                 FilodbSettings.load(p).rules)
            self.ruler = Ruler(
                self.api.frontends[ds],
                MemstoreSink(self.memstore, ds, self.mappers[ds],
                             self.spreads[ds]),
                config=self.config.rules,
                config_source=config_source)
            self.api.ruler = self.ruler
        # self-scrape meta-monitoring (utils/selfmon.py): built here so a
        # misconfigured dataset fails boot loudly; the loop starts in
        # start() next to the other background jobs
        self.selfmon = None
        if self.config.selfmon.enabled:
            from filodb_tpu_torch.utils.selfmon import SelfScraper
            sm_ds = self.config.selfmon.dataset or first
            if sm_ds not in self.engines:
                raise ConfigError(
                    f"selfmon.dataset {sm_ds!r} is not a served dataset "
                    f"(have: {sorted(self.engines)})")
            self.selfmon = SelfScraper(
                self.memstore, sm_ds, self.mappers[sm_ds],
                self.spreads[sm_ds], node_name=self.node_name,
                interval_s=self.config.selfmon.interval_s)
        # Replication layer (filodb_tpu_torch/replication;
        # doc/replication.md): this node's replication door accepts slab
        # appends / WAL-segment fetches / snapshot streams from peers;
        # with a peer
        # address book, ingest fans out through a ReplicationManager and
        # live handoffs drive through a HandoffCoordinator (both
        # surfaced at /admin/shards).  Single-node deployments without
        # peers still get the door — a future replica catches up from it.
        self.replication_server = None
        self.replicators: Dict[str, object] = {}
        self.handoff_coordinators: Dict[str, object] = {}
        if self.config.replication.enabled:
            from filodb_tpu_torch.replication import (
                HandoffCoordinator, ReplicaClient, ReplicationManager,
                ReplicationServer)
            self.replication_server = ReplicationServer(
                self.memstore, node=node_name, wals=self.wals)
            peers = dict(replication_peers or {})
            clients: Dict[str, ReplicaClient] = {}

            def client_for(node: str) -> ReplicaClient:
                cli = clients.get(node)
                if cli is None:
                    if node == node_name and node not in peers:
                        # a handoff OFF this node dials its own door
                        # (the from-node side of the stream)
                        host, port = self.replication_server.address
                    else:
                        host, port = peers[node]
                    clients[node] = cli = ReplicaClient(
                        host, port,
                        timeout_s=self.config.replication.append_timeout_s)
                return cli

            peer_names = sorted(n for n in peers if n != node_name)
            for dc in self.datasets:
                mapper = self.mappers[dc.name]
                if peers:
                    # the RF intent lands on the mapper only when peers
                    # exist to place replicas on — a single node running
                    # just the door must not pin the health verdict at
                    # degraded-underReplicated forever
                    mapper.replication_factor = \
                        self.config.replication.factor
                    # static placement: every shard's replica tail
                    # fills from the peer address book, rotated by
                    # shard so copies spread — without this the
                    # documented conf would build a fan-out manager
                    # whose owner lists never contain a replica (a
                    # silent no-op pinned at degraded).  ACTIVE: a
                    # configured peer door is the deployment's claim
                    # that the copy serves (the cluster path flips
                    # these from heartbeats instead).
                    for s in range(dc.num_shards):
                        for i in range(
                                self.config.replication.factor - 1):
                            if not peer_names:
                                break
                            peer = peer_names[(s + i) % len(peer_names)]
                            mapper.register_replica(
                                s, peer, status=ShardStatus.ACTIVE)
                    self.replicators[dc.name] = ReplicationManager(
                        dc.name, mapper, client_for,
                        config=self.config.replication,
                        local_node=node_name)
                    self.handoff_coordinators[dc.name] = \
                        HandoffCoordinator(
                            dc.name, mapper, client_for,
                            tombstone_grace_s=self.config.replication
                            .handoff_tombstone_grace_s,
                            health=self.health)
            self.api.replicators = self.replicators
            self.api.handoffs = self.handoff_coordinators
        # boot WAL replay: runs AFTER the API exists (the transport-
        # agnostic routes answer /healthz — and /ready with 503 — while
        # the log replays) and BEFORE start() declares the node serving;
        # by the time the constructor returns, replay is complete, so
        # embedders that query without start() see the recovered store
        self._replay_wals()
        from filodb_tpu_torch.utils.health import BOOTED
        self.health.set_phase(BOOTED)

    def _replay_wals(self) -> None:
        from filodb_tpu_torch.utils.health import REPLAYING_WAL
        if not self.wals or not self.config.wal.replay_on_start:
            return
        self.health.set_phase(REPLAYING_WAL)
        for dc in self.datasets:
            wal = self.wals.get(dc.name)
            if wal is None:
                continue
            restart_points = {
                s: self.meta_store.read_earliest_checkpoint(dc.name, s)
                for s in range(dc.num_shards)}
            stats = wal.replay(self.memstore, restart_points)
            self.health.note_wal(dc.name, enabled=True,
                                 replay_done=True, stats=stats)

    # ------------------------------------------------------------- wiring

    def _setup_dataset(self, dc: DatasetConfig) -> None:
        from filodb_tpu_torch.core.ratelimit import (CardinalityTracker,
                                                     QuotaSource)
        mapper = ShardMapper(dc.num_shards)
        spread = SpreadProvider(default_spread=self.config.spread_default)
        quota_source = QuotaSource(self.config.quota_default)
        shards = []
        for s in range(dc.num_shards):
            shard = self.memstore.setup(dc.name, s)
            # tracker attaches BEFORE index recovery so recovered series are
            # counted and quotas survive restarts by recount
            shard.cardinality_tracker = CardinalityTracker(
                shard_key_len=len(
                    self.memstore.schemas.part.options.shard_key_columns),
                quota_source=quota_source)
            shard.recover_index()
            shards.append(shard)
            mapper.update_from_event(
                ShardEvent("IngestionStarted", dc.name, s, self.node_name))
        raw_planner = SingleClusterPlanner(dc.name, mapper, spread)
        planner = raw_planner
        ds_planner = None
        if dc.downsample_resolutions:
            ds_planner = self._make_downsample(dc, mapper)
        persisted_planner = None
        tier = None
        if self.cold_cache is not None \
                and getattr(self.column_store, "root", None):
            tier = self._make_persisted_tier(dc, spread, mapper)
            from filodb_tpu_torch.query.planners import \
                PersistedClusterPlanner
            persisted_planner = PersistedClusterPlanner(
                dc.name, mapper, tier, spread_provider=spread)
        if ds_planner is not None or persisted_planner is not None:
            from filodb_tpu_torch.query.planners import LongTimeRangePlanner
            earliest = self._earliest_raw_time
            planner = LongTimeRangePlanner(
                raw_planner, ds_planner,
                earliest_raw_time_fn=lambda: earliest(dc.name),
                latest_downsample_time_fn=lambda: 1 << 62,
                persisted_planner=persisted_planner,
                persisted_range_fn=(tier.range if tier is not None
                                    else None))

        def label_vals(col: str) -> List[str]:
            out = set()
            for sh in shards:
                for v in sh.index.label_values(col):
                    out.add(v[0] if isinstance(v, tuple) else v)
            return sorted(out)

        matcher = default_shard_key_matcher(
            label_vals, self.memstore.schemas.part.options.shard_key_columns)
        planner = ShardKeyRegexPlanner(planner, matcher)
        if self.federation_registry is not None:
            # federation sits OUTERMOST: local-only selectors fall
            # straight through to the stack above; the door serves THIS
            # cluster's share of remote coordinators' queries through
            # the same inner stack (never the federated wrapper — a
            # mutually-federated pair must not bounce subtrees)
            from filodb_tpu_torch.federation import FederationPlanner
            inner = planner
            planner = FederationPlanner(
                inner, self.federation_registry, dataset=dc.name,
                config=self.config.federation)
            store_source = self._source()
            shards = self.memstore.shards_for(dc.name)
            self.federation_door.register(
                dc.name, inner, store_source,
                token_fn=lambda sh=shards: [
                    (s.keys_serial, s.keys_epoch, s.index.mutations,
                     s.append_horizon_ms()) for s in sh],
                default=(dc.name == self.datasets[0].name))
        self.mappers[dc.name] = mapper
        self.spreads[dc.name] = spread
        self.engines[dc.name] = QueryEngine(dc.name, self._source(), mapper,
                                            planner=planner,
                                            config=self.config,
                                            device=self.device)
        self.gateways[dc.name] = GatewayPipeline(self.memstore, dc.name,
                                                 mapper, spread,
                                                 config=self.config)
        if self.config.wal.enabled:
            # durability front: the remote_write door appends through
            # this manager and acks only after the group commit; boot
            # replays the log through the same columnar ingest path
            # BEFORE the HTTP server opens (filodb_tpu_torch/wal).  The
            # replay itself runs from __init__ AFTER the API is built
            # (see _replay_wals) so /ready can answer 503 while it runs.
            from filodb_tpu_torch.wal import WalManager
            wal = WalManager(self.config.wal.dir, dc.name,
                             config=self.config.wal)
            self.wals[dc.name] = wal
            self.gateways[dc.name].wal = wal
            self.health.note_wal(dc.name, enabled=True,
                                 replay_done=not
                                 self.config.wal.replay_on_start)

    def _make_downsample(self, dc: DatasetConfig, mapper: ShardMapper):
        from filodb_tpu_torch.downsample import (DownsampleClusterPlanner,
                                                 DownsampledTimeSeriesStore,
                                                 ShardDownsampler)
        ds_store = DownsampledTimeSeriesStore(
            dc.name, column_store=self.column_store,
            meta_store=self.meta_store,
            resolutions=dc.downsample_resolutions, config=self.config,
            device=self.device)
        self.ds_stores[dc.name] = ds_store
        for s in range(dc.num_shards):
            ds_store.setup_shard(s)
            ds_store.refresh_index(s)
            dsr = ShardDownsampler(resolutions=dc.downsample_resolutions)
            raw_shard = self.memstore.get_shard(dc.name, s)
            raw_shard.shard_downsampler = dsr
        return DownsampleClusterPlanner(ds_store, mapper)

    def _make_persisted_tier(self, dc: DatasetConfig, spread, mapper=None):
        """Segment store + cold tier + compaction job for one dataset
        (historical tier, doc/operations.md compaction runbook).  With a
        shared object store configured, this also mounts the shard
        manifests (restoring missing segments first when
        objectstore.restore_on_boot) and hangs a SegmentUploader off the
        compaction scheduler — /ready answers 503 until the mount
        lands."""
        from filodb_tpu_torch.persist.compactor import (CompactionScheduler,
                                                        SegmentCompactor)
        from filodb_tpu_torch.persist.segments import (PersistedTier,
                                                       SegmentStore)
        seg_store = SegmentStore(self.column_store.root)
        uploader = None
        if self.object_store is not None:
            from filodb_tpu_torch.persist.objectstore import (
                ObjectStoreError, SegmentUploader, restore_from_objectstore)
            from filodb_tpu_torch.utils.events import journal
            oc = self.config.objectstore
            self.health.note_manifest_mount(dc.name, False)
            uploader = SegmentUploader(
                self.object_store, seg_store, dc.name, dc.num_shards,
                node=self.node_name, mapper=mapper,
                retry_base_s=oc.retry_base_s, retry_max_s=oc.retry_max_s,
                max_attempts=oc.max_attempts)
            self.uploaders[dc.name] = uploader
            # durability ordering: every raw-chunk prune for this dataset
            # clamps through the upload-ack gate, whoever asks for it
            uploader.install_prune_guard(self.column_store)
            try:
                if oc.restore_on_boot:
                    restore_from_objectstore(
                        self.object_store, seg_store, dc.name,
                        dc.num_shards, retry_base_s=oc.retry_base_s,
                        retry_max_s=oc.retry_max_s,
                        max_attempts=oc.max_attempts, node=self.node_name)
                uploader.mount()
                self.health.note_manifest_mount(dc.name, True)
            except ObjectStoreError as e:
                # the mount stays pending, so /ready keeps answering 503
                # — a node that cannot see the shared tier must not serve
                journal.emit("objectstore_mount_failed",
                             subsystem="persistence", dataset=dc.name,
                             node=self.node_name, error=str(e)[:200])
        tier = PersistedTier(seg_store, dc.name, dc.num_shards,
                             self.cold_cache,
                             schemas=self.memstore.schemas)
        self.persisted_tiers[dc.name] = tier
        compactor = SegmentCompactor(
            self.column_store, seg_store, dc.name, dc.num_shards,
            window_ms=self.config.store.segment_window_ms,
            closed_lag_ms=self.config.store.segment_closed_lag_ms,
            schemas=self.memstore.schemas, tier=tier)
        self.compaction_schedulers[dc.name] = CompactionScheduler(
            compactor,
            interval_s=self.config.store.segment_compact_interval_ms
            / 1000.0,
            retain_raw_ms=self.config.store.segment_retain_raw_ms,
            uploader=uploader)
        return tier

    def _earliest_raw_time(self, dataset: str) -> int:
        """Raw retention floor: earliest live sample across shards, cached a
        few seconds — this sits on the planning hot path (a real deployment
        derives it from retention config).  A partition whose history is
        only in the column store (recovered at boot, paged in on demand)
        counts from its start time in the index: the reference reads the
        stores' timestamps alone, where a row not paged in yet holds the
        empty-slot sentinel (int64 max), so its node booted over flushed
        data routed every range to the downsample store."""
        import time
        cached = self._earliest_cache.get(dataset)
        now = time.monotonic()
        if cached is not None and now - cached[1] < 10.0:
            return cached[0]
        pad = np.iinfo(np.int64).max
        out = []
        for sh in self.memstore.shards_for(dataset):
            start = sh.index.earliest_start_time()
            if start is not None and start > 0:
                out.append(start)
            for store in sh.stores.values():
                live = store.ts[:store.num_series]
                if live.size:
                    valid = live[(live > 0) & (live < pad)]
                    if valid.size:
                        out.append(int(valid.min()))
        val = min(out) if out else 0
        self._earliest_cache[dataset] = (val, now)
        return val

    def _source(self):
        server = self

        class _Source:
            """Routes leaf dataset names to raw or downsample stores."""
            device = server.device

            def get_shard(self, dataset: str, shard_num: int):
                if "::ds::" in dataset:
                    raw = dataset.split("::ds::")[0]
                    ds_store = server.ds_stores.get(raw)
                    return ds_store.get_shard(dataset, shard_num) \
                        if ds_store else None
                return server.memstore.get_shard(dataset, shard_num)

            def shards_for(self, dataset: str):
                # the query frontend's result cache derives its
                # invalidation token from these shards.  Downsample
                # datasets — and raw datasets the planner may ROUTE to a
                # downsample store — return [] so the cache bypasses
                # them: downsampled points land with timestamps behind
                # the raw append horizon, invisible to the raw token
                if "::ds::" in dataset or dataset in server.ds_stores:
                    return []
                return server.memstore.shards_for(dataset)
        return _Source()

    # ------------------------------------------------------------ lifecycle

    def start(self, background_flush: bool = True) -> None:
        # seed the device-telemetry ledger with every local card (the
        # host when the node runs there) so /admin/devices lists the
        # fleet before the first dispatch
        from filodb_tpu_torch.utils.devicetelem import telem
        telem.register_devices(None if self.device.type == "cuda"
                               else [self.device])
        if self.replication_server is not None:
            self.replication_server.start()
        self.http.start()
        self.trace_exporter = None
        if self.config.trace_export_url:
            from filodb_tpu_torch.utils.traceexport import TraceExporter
            self.trace_exporter = TraceExporter(
                self.config.trace_export_url).start()
        self.warmup_thread = None
        shapes = parse_warmup_shapes(self.config.warmup_shapes)
        if shapes:
            # build the kernel libraries and launch the fused kernel at
            # the configured headline shapes off the boot path, so the
            # first dashboard query finds them loaded and the allocator
            # warm — the reference's "query path is always ready" stance
            # (ref: coordinator/../QueryActor.scala:98-117)

            def _warm():
                from filodb_tpu_torch.ops import fused
                from filodb_tpu_torch.utils.metrics import registry
                for (s, t, w, g) in shapes:
                    try:
                        secs = fused.warmup_compile(s, t, w, g,
                                                    device=self.device)
                        registry.gauge("warmup_compile_seconds") \
                            .update(secs)
                    except Exception:  # noqa: BLE001 — warmup is advisory
                        registry.counter("warmup_compile_errors").increment()

            self.warmup_thread = threading.Thread(
                target=_warm, name="filodb-warmup", daemon=True)
            self.warmup_thread.start()
        if background_flush:
            from filodb_tpu_torch.core.flush import FlushScheduler
            for dc in self.datasets:
                sched = FlushScheduler(
                    self.memstore, dc.name,
                    interval_s=self.config.store.flush_interval_ms / 1000.0,
                    wal=self.wals.get(dc.name))
                self.flush_schedulers[dc.name] = sched.start()
        for sched in self.compaction_schedulers.values():
            sched.start()
        if self.config.index.compaction_interval_s > 0:
            self.index_compactor = IndexCompactionLoop(
                self.memstore, [dc.name for dc in self.datasets],
                interval_s=self.config.index.compaction_interval_s,
                tombstone_threshold=self.config.index
                .compaction_tombstone_threshold).start()
        if self.ruler is not None:
            self.ruler.start()
        if self.selfmon is not None:
            self.selfmon.start()
        if self.federation_registry is not None:
            self.federation_registry.start()
        # the readiness flip: phase -> serving lands in the event
        # journal, so "replayed, recovered, took traffic" is one
        # greppable sequence at /admin/events
        from filodb_tpu_torch.utils.health import SERVING
        self.health.set_phase(SERVING)

    def shutdown(self) -> None:
        from filodb_tpu_torch.utils.health import STOPPING
        self.health.set_phase(STOPPING)
        if self.federation_registry is not None:
            self.federation_registry.stop()
        if self.federation_door is not None:
            self.federation_door.stop()
        if self.selfmon is not None:
            self.selfmon.stop()
        if self.ruler is not None:
            self.ruler.stop()
        if self.index_compactor is not None:
            self.index_compactor.stop()
            self.index_compactor = None
        for sched in self.compaction_schedulers.values():
            sched.stop()
        self.compaction_schedulers.clear()
        for sched in self.flush_schedulers.values():
            sched.stop(final_flush=True)
        self.flush_schedulers.clear()
        if getattr(self, "trace_exporter", None) is not None:
            self.trace_exporter.stop()
            self.trace_exporter = None
        self.http.stop()
        for repl in self.replicators.values():
            repl.stop()
        if self.replication_server is not None:
            self.replication_server.stop()
            self.replication_server = None
        for wal in self.wals.values():
            wal.close()
        self.wals.clear()
        # hand the process-wide crash log back (closing its handle), so
        # later queries never append under a WAL root that may be gone
        from filodb_tpu_torch.query.activequeries import active_queries
        if self._active_query_path and \
                active_queries.path == self._active_query_path:
            active_queries.configure(path="")

    def flush_and_downsample(self, dataset: str) -> int:
        """Flush all shards, then feed accumulated downsample records into
        the downsample store (the streaming ShardDownsampler → downsample
        ingestion hop, ref: ShardDownsampler.scala publishToDownsampleDataset)."""
        n = 0
        ds_store = self.ds_stores.get(dataset)
        for sh in self.memstore.shards_for(dataset):
            sh.flush_all_groups()
            if ds_store is not None and sh.shard_downsampler is not None:
                n += ds_store.ingest_downsample_batches(
                    sh.shard_num, sh.shard_downsampler.result_batches())
        return n
