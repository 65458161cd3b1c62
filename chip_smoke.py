#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (filodb_tpu_torch).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py [--seed N] [--series S] [--warm K]

Phases, each raising on failure (the script then exits non-zero and
prints no result):

1. the card's name and power limit (nvidia-smi), torch and CUDA
   versions; build every kernel from csrc/ (one nvcc per source, all
   started together) and print each kernel's registers, static shared
   memory and spills as `-Xptxas -v` reports them;
2. each kernel against its plain torch version on the card, at the main
   path's shape and at a small odd shape with two panels: K1/K3 (rate
   family), K2 (rate family over raw counters with two resets a row,
   in-kernel correction), K4 (last_over_time), K5 (sum/avg/count_over_
   time), each in group-sum mode and in its per-series mode K6; and the
   four ragged rate entries (K3, K2 ragged, each per series too) at an
   adversarial shape, 65,536 x 720 with ~30% of slots NaN in runs and
   rows with no, one or two valid samples, to the bit.  Max
   abs/rel error within rtol 1e-6 + atol 1e-5 (both compute the same f32
   operations in the same order; the bound allows for nothing else), two
   kernel runs bit-identical, the launch count rising, and for the rate
   family and last_over_time the gather=False launch (the reference's
   matmul selections, K7) the same kernel with the same bits; kernel,
   plain and one-call PyTorch yardstick times by CUDA events;
3. dense counters: made from --seed with numpy, ingested through
   TimeSeriesShard.ingest_columns in slabs, then
   `sum by (_ns_) (rate(request_total[5m]))` (K1) and
   `max by (_ns_) (rate(request_total[5m]))` (K1's per-series mode)
   through QueryEngine.query_range, each once cold and --warm times warm;
4. ragged counters: 65,536 series with ~1% of samples NaN (scrape gaps),
   the same two queries through K3;
5. dense gauges, --series x 720: the gauge and min/max dashboard panels
   (instant selector = K4, sum/avg_over_time = K5, count_over_time = host
   math, min/max_over_time = windowed torch reductions, max by = K6);
6. ragged gauges: 65,536 series with ~1% NaN, the same panels, with
   count_over_time through K5;
7. raw counters, --series x 720 with two resets each, made and rebased
   WITHOUT correction on the card, through the kernel-level API:
   fused_rate_groupsum(precorrected=False) for rate and increase (K2) and
   fused_leaf_agg_batch(precorrected=False) with sum, avg and max panels
   by _ns_ (K2 and K2's per-series mode), each call once cold and --warm
   times warm, against an f64 oracle computed on the card;
8. ragged raw counters: 65,536 series with ~1% NaN, the same calls.
In phases 3-8 every answer must match an f64 oracle within rtol 2e-4,
atol 1e-3 (ragged rtol 5e-4, atol 1e-4), each warm query must launch the
kernel named for it, and two warm answers must be bit-identical.  The
launch counts are set to 0 just before each phase and read just after
it.  Three more phases:

K8.  the column-selection probe (csrc/probe_select.cu) through its own
   entry point, python -m filodb_tpu_torch.tools.probe_slice's main, at
   the probe's shape (262,144 x 768 f32, 110 of 128 columns); then each
   of its three kernels against its plain version to the bit, timed
   beside one library call (index_select; matmul with TF32 off, by the
   one-hot matrix or by a +1/-1 difference matrix) and its bound, and
   against that call in 10 alternating rounds (A B, B A, ...; the median
   and range of the per-round time ratio); the gather also at
   index_select's own output, [rows, 110] (no zero columns), to the bit
   and in alternating rounds against it; the product also on the
   probe's adversarial inputs at the same shape (+-Inf, NaN, -0.0 in x;
   an all-zero column, a +1/-1 pair, three non-unit nonzeros, a NaN and
   a +Inf in o) to the bit.  Every bound is bytes over 3.35 TB/s against
   FP32 operations over 67 TFLOP/s, counting the operations these inputs
   need: the product's are 2 x rows x nnz(o), not 2 x rows x K x N;
general-1M.  over the dense 1M counter and gauge stores of phases 3 and
   5, the general path (ops/rangefns.py, ops/agg.py, the binary join):
   G1 sum by (_ns_) (irate(...)), G5 increase / on (_ns_) rate (two K1
   leaves), G2 avg by (_ns_) (deriv(...)), G3 stddev by (_ns_) of the
   instant selector, G4 max by (_ns_) (quantile_over_time(0.9, ...)),
   each once cold and max(3, --warm // 3) times warm (G4 at most
   twice),
   against an f64 oracle this script computes on the card slab
   by slab (oracle_general_t): rtol 2e-5 / atol 1e-4 for irate, 2e-4 /
   1e-3 for the rate ratio, 5e-4 / 2e-4 for deriv (set at the default
   width, 1,049 series a group, from its f32 error there, 7.3e-5, and
   the size of its answers, which each query's line prints; a narrower
   --series averages fewer series a group and may exceed it), 5e-4 /
   5e-3 for the others;
hist-classic-1M.  65,536 classic histograms x 16 `le` buckets
   (1,048,576 cumulative http_latency_bucket counters, _ns_ =
   App-{h % 1000}) made on the card: G6 histogram_quantile(0.9, sum by
   (le, _ns_) (rate(...))), K1 over 16,000 groups then the classic
   quantile, against an f64 oracle (rtol 2e-4, atol 1e-3);
hist-native-1M.  the same counts (the same generator and seed) as 65,536
   native histograms x 16 buckets ([S, T, B] columns of http_latency,
   ingested with their bucket bounds): the bench's panel
   histogram_quantile(0.9, sum(rate(http_latency[5m])) by (_ns_)), K1
   over 1,048,576 flattened bucket rows into 16,000 (group, bucket)
   slots, held to hist-classic-1M's oracle (rtol 2e-4, atol 1e-3); the
   general path's histogram_quantile(0.9, rate(http_latency[5m])) per
   histogram against an f64 per-histogram oracle (the same tolerance);
   then 4,096 native histograms with ~1% whole-scrape holes, the panel
   through K3 (rtol 5e-4, atol 1e-4);
host-route-1M.  over phase 3's dense counters (the store restart-1M
   recovered, kept alive after general-1M): H1 sum by (_ns_) (changes(...)) and H2 max by (_ns_)
   (max_over_time(...)), range queries, each once cold and once warm
   (H1's warm run under cProfile, the profile printed), and
   H3 sum by (_ns_) (resets(...)) through query_instant at the grid's end
   (cold, then max(3, --warm // 3) warm, to_prom_vector with 1000
   results): the leaf's windowed host gather of raw values, then the
   general path on the card.  Oracles from the raw slab on the card: H1
   exact against changes counted over the values as the device holds them
   (rebased, uncorrected, f32; the f64 count's difference printed), H2
   within rtol 2e-4 / atol 1e-3 of the f64 raw maximum, H3 exact against
   the f64 reset count.  Then the router at 2,048 series (~1.4M samples):
   sum by (_ns_) (rate(...)) with the router switched on through
   FILODB_TPU_FORCE_HOST_ROUTE (leaf_host_routed rises, no kernel
   launches) and off, the default (K1), both
   against the f64 rate oracle, their warm p50s printed; and, over
   hist-native-1M's store, histogram_quantile(0.9, http_latency) through
   query_instant (a 3-d host gather) against the f64 quantile of the raw
   counts at the last sample;
promql-1M.  over the same counters, each once cold and max(3, --warm //
   3) times warm, K1 under every plan node: P1 sort_desc, P2 `@ end()`,
   P3 max_over_time of a [30m:1m] subquery (the parser's inner grid), P4
   label_replace, P5 a ratio over scalar(); P6 absent() of present and
   missing series; the LabelValues and SeriesKeysByFilters plans, timed;
serve-1M.  over the same counters, through the port's HTTP stack
   (FiloHttpServer(PromHttpApi({"prometheus": eng}), port=0), driven over
   real HTTP from this process): the reference's 8-panel dashboard
   (bench.py:4128-4139) as one POST /api/v1/query_range_batch, cold and
   twice warm, each printing its K1 launches, exprfuse_fused and
   _degraded, leaf_gather_memo_hits and per-panel exec seconds; every
   panel's JSON bit-identical (value strings, label sets) to the panel
   alone through GET /api/v1/query_range with query.exprfuse_enabled off;
   the rate panels within rtol 2e-4 / atol 1e-3 of the f64 oracle (sum,
   avg, the ratio, increase, topk), the count panel each group's size, the
   bool panel 1, max_over_time as in host-route-1M; then 8 client threads
   polling the 4 rate-only panels once with query.batch_window_ms 50:
   answers bit-identical to the sequential ones, query_singleflight_hits
   and coalesce_merged_batches above 0, per-request p50/p99, peak device
   memory under 8 leaf gathers; the headline panel re-polled uncached and
   cached (verdicts from stats); and max by (_ns_) (quantile_over_time(0.9,
   ...)) killed through POST /admin/queries/<id>/kill 1 s into its run,
   answering query_canceled (the seconds from the kill printed); then
   sum(rate(request_total::nosuch[5m])), a column the schema lacks,
   answering the reference's 400, query_error and `KeyError: 'nosuch'`
   with no kernel launched;
ops-1M.  on the serve-1M server, over the same counters: /ready 200 and
   /api/v1/status/health ok in every subsystem; after one warm dashboard
   batch, /admin/devices shows cuda:0 with the batch's K1 launches as
   its rate-family ledger dispatches, busySeconds grown, booked `hot`
   bytes equal to the mirror's tensors (and within memory_allocated),
   and one compile a csrc/ source this process built; stats=all on the
   headline panel splits device_s by device and kernel (the engine's
   QueryStats to 1e-9); explain=true (query_range, query,
   /api/v1/explain) launches nothing and leaves memory_allocated as it
   was, analyze=true launches K1 once and its nodes' device seconds are
   the trace's ledger sum; `device.upload` armed: the query over a
   dropped mirror reports the fault with no device arrays left behind,
   the background rebuild's failure shows in the health model's jobs,
   then the answer comes back bit-identical and memory_allocated within
   one mirror of before; the sampling profiler over one warm headline
   panel.  It
   prints the padded-values cache's budget and its evictions per earlier
   phase;
write-1M.  on the serve-1M server after planners-1M, over the same
   counters: its PromHttpApi carries gateways={"prometheus":
   GatewayPipeline(...)} over the store (one shard, a one-shard mapper)
   whose `wal` is the WalManager restart-1M recovered, so every 204
   follows a group commit.  WRITE_SCRAPES scrapes of every series (one
   since the rules-1M phase came: two took 288-398 s of the main line
   and the whole script 1,068.5 s on one run, too near the 1,200 s
   limit), one sample each 10 s after the store's last, each counter going on by an increment
   from the seed (no reset), labels dense-1M's; each scrape as snappy
   prompb WriteRequests of 2,000 series (Prometheus' max_samples_per_
   send; 525 at 1M, the last 576), encoded before the clock, POSTed to
   /api/v1/write over localhost HTTP by 4 client threads.  Every request
   answers 204 and the store's new column is the values sent; the
   headline panel over the 110 steps ending at the scrape, through HTTP
   query_range, is no result-cache hit, pays an incremental refresh (no
   incremental error) and launches K1, runs warm bit-identical, both
   within rtol 2e-4 / atol 1e-3 of the f64 oracle of the grown slab.
   Then POST /api/v1/read of _ns_="App-7" over the last 10 min (every
   sample to the bit as the read computes it, the written ones exact),
   /api/v1/status/tsdb (1,048,576 series under _ws_=demo and
   request_total), /api/v1/metering/cardinality (tsCount 1,048,576 for
   ["demo"], the CardinalityTracker restart-1M attached before its
   replay), /admin/tenants' ingestSamples grown by exactly the samples
   sent, the WAL's seq grown by the slabs.  It prints each scrape's wall
   seconds and samples/s, the request p50 / p99, the door's IngestStats
   split summed over the requests (decode, admission, build_slabs,
   wal_append, ingest, commit wait), gc seconds, the refresh and the
   paying panel's seconds, peak host RSS and peak device memory;
rules-1M.  on the serve-1M server after write-1M, over the same
   counters at full width: a Ruler over the server's frontend and a
   MemstoreSink into the same memstore (api.ruler, as a node attaches
   it), a WebhookNotifier posting to a stdlib receiver on localhost, one
   group of three rules at interval 60 s evaluated by evaluate_group at
   the store's last timestamp minus 3, 2, 1 and 0 minutes: rule 1
   records sum by (_ws_, _ns_) (rate(request_total[5m])) (1,000
   series), rule 2 sum by (_ws_) of rule 1's output at the same
   timestamp, the alert ns:request_total:rate5m > T, `for: 2m`, T the
   f64 oracle's 90th percentile of rule 1 at the first evaluation.  Rule
   1 holds the f64 oracle of the grown slab (rtol 2e-4 / atol 1e-3) at
   each evaluation, bit-identical to the expression through HTTP
   /api/v1/query, and launches K1 once (the ledger shows it); rule 2 is
   the sum of rule 1's recorded values within rtol 1e-6 (its sum runs
   through K4 in f32); the alerts follow the state machine over the
   namespaces above T (those within the kernel tolerance of T may go
   either way), pending, then firing from the third evaluation; the
   receiver gets the firing set twice (the transitions, then the resend
   a minute later); /api/v1/rules and /api/v1/alerts show health ok and
   those states; a second Ruler restores every alert from
   ALERTS_FOR_STATE with its activeAt; POST /api/v1/read of the recorded
   series returns them (ms to the bit, values within 1e-12 of the
   largest); a TraceExporter on a file:// path under the run's temporary
   directory holds a Zipkin span of every evaluation's trace, none
   dropped.  Then a SelfScraper writes the metrics registry into a
   second dataset, filodb_self, on the same memstore, served by the same
   PromHttpApi: two scrapes 2 s apart, a counter incremented between
   them, an HTTP query returns both values, and no wall-clock timestamp
   enters the 1M dataset.  It prints each evaluation's seconds with the
   rule-1 query's and the write-backs' shares, K1's ledger ms, the
   receiver's POSTs, the exporter's spans and seconds;
live-ingest-1M.  over the same counters (the store's values, write-1M's
   column included, copied to the card for the oracle, its first
   slab checked against the seed's): 10 scrapes (100 s at 10 s)
   through TimeSeriesShard.ingest, each one grid RecordBatch of one
   sample a series with the same key list, 1% of the series restarting
   in scrape 5; after each, the panel `sum by (_ns_) (rate(...[5m]))`
   over the 110 one-minute steps ending at that scrape, once paying the
   mirror's refresh (which must be incremental, with no incremental
   error, and launch K1) and once warm (bit-identical), against an f64
   oracle of the grown slab (rtol 2e-4 / atol 1e-3); after scrape 10 the
   mirror against a fresh full upload (timestamps to the bit, absolutes
   within rtol 1e-6 / atol 1e-6); then an 11th scrape that 1% of the
   series miss (still incremental; the general path, rtol 5e-4 / atol
   5e-3).  Each scrape's ingest and refresh seconds and bytes, the p50
   and p99 of the panel that pays the refresh, the full upload's
   seconds, the peak device memory, the peak host RSS and the device
   copy that one refresh makes (CUDA events) are printed;
flush-page-16k.  16,384 counters x 720 in a fresh memstore with an
   InMemoryColumnStore and an InMemoryMetaStore: the panel (K1, the
   mirror built), flush_all_groups (chunks, encoded bytes, seconds),
   enforce_memory(budget_bytes=1, active_tail_rows=120), the same panel
   at once (its history paged back from the resident tier, served by
   the host gather while the mirror is rebuilt in the background), the
   rebuild joined (within 60 s), the panel twice on the rebuilt mirror
   (K1, bit-identical); every answer against the f64 oracle of the
   original slab.  Cut from 1M to 16,384 series for the time limit:
   flush encodes each series on the host;
planners-1M.  on the serve-1M server and store, after ops-1M: each
   composed planner's engine over the same memstore, its remote children
   calling the server over localhost HTTP through the port's
   planners._http_transport (the script's scan cap added to the
   parameters), once cold and max(3, --warm // 3) times warm, every
   answer bit-identical (f64 values, label sets) to the local-only one:
   HighAvailabilityPlanner with a 30 min local failure mid-range (local |
   PromQlRemoteExec | local under StitchRvsExec), MultiPartitionPlanner
   (a remote partition owns the first hour), ShardKeyRegexPlanner
   (sum by (_ns_) (rate(request_total{_ns_=~"App-1[0-9]"}[5m])) fanned
   out to 10 leaves under MultiPartitionReduceAggregateExec, its p50
   beside SingleClusterPlanner's), SinglePartitionPlanner by metric; the
   explain of each; K1 launches a run (the server's own for a remote
   child included) above 0 and the same in every warm run;
cold-65k.  the tier-stitched panel: 65,536 request counters x 6 h at
   10 s (2,160 samples, 0-20 requests a scrape; _ns_ = App-{i % 1000};
   one reset a row in the first 2 h and one exactly on the first segment
   boundary), from the seed;
   the first two 2 h windows written as segment files (encode_segment +
   SegmentStore.write, what the compactor writes), the live memstore the
   last 2 h and the 5 m before them; Q1 sum by (_ns_) (rate(...[5m]))
   over the 6 h at 1 m through LongTimeRangePlanner(SingleClusterPlanner,
   None, PersistedClusterPlanner(tier)) with a 4 GiB cold region: cold
   (both blocks paged in as CUDA tensors, the `cold` HBM booking equal to
   their bytes and within memory_allocated), then --warm times (cold_hit,
   K1 twice and two K1 ledger dispatches each: the merged cold block, the
   hot tail; warm answers bit-identical), against the f64 oracle and the
   all-in-memory engine (rtol 2e-4, atol 1e-3); explain (StitchRvsExec
   over the persisted leaf, tier=cold, and the hot leaf); Q1b max by
   (_ns_) (K6); a SegmentUploader uploads both segments to a
   LocalObjectStore (run_once), restore_from_objectstore into an empty
   SegmentStore gives both files byte for byte; Q2 over a span wholly in
   segments, its first scan on a fresh local tier and on a query-only
   tier (make_query_tier over a ColdSegmentCache on the card: K1
   launched, booked cold equal to its blocks), warm on the local tier,
   all bit-identical: samples/s against the all-in-memory engine's,
   cold_vs_mem (the fresh local tier's first scan, as
   bench.py:3669-3673's), objstore_vs_mem (the query-only tier's) and
   warm_cold (printed, not gated); Q2 on a
   region of one and a half blocks (evictions, the booking never above
   the budget) and Q3, over the first segment, on one of half a block
   (the host degrade: counted, nothing booked), both bit-identical.  Cut
   from 1M series to 65,536 for the time limit: the
   segment codec and the page-in's correction run on the host
   (PERF.md §4);
parity-65k.  after cold-65k in its process, over its segments and its
   object store: (a) a cold-read cluster on the card (one data node, two
   query-only NodeQueryServers, each on cuda): Q1's rate panel over the
   segments' span four times round-robin, then twice with the data node
   stopped, each answer bit-identical to a local query tier's and K1
   launched; (b) objectstore.get faulted: with allow_partial_results
   the answer is flagged partial with no error, without it the error is
   shard_unavailable; (c) 16,384 counters flushed to an in-memory column
   store, a store restarted over them (recover_index) and a query killed
   while it pages history: after the one batched column-store read of
   every partition (as in the reference), it ends query_canceled after
   decoding 2 of 16,384 partitions, keeps those 2, and a retry answers within rtol 2e-4 /
   atol 1e-3 of the f64 oracle; (d) a FiloServer whose config declares
   `env-schema` and store.groups_per_shard = 7: each shard has 7 flush
   groups, a series of the schema is ingested and answers its avg panel
   (K5) within rtol 2e-4 / atol 1e-3 of the oracle; (e) one remote write
   to that server whose trace holds the shard's ingest_columns span
   stamped with the server's node name;
compact-16k.  16,384 counters x 720 with 1% missed scrapes and 2,048
   integer gauges on a LocalDiskColumnStore in a temporary directory:
   the hot panel (K3), flush_all_groups, SegmentCompactor.compact_all
   over 1 h windows; the panel through PersistedClusterPlanner (K3 over
   the merged ragged block) within rtol 5e-4 / atol 1e-4 of the hot
   answer; sum(m) stitched (segments | a live tail, K4) bit-identical to
   the all-in-memory store; SelectChunkInfosExec and the panel after a
   restart (recover_index, then paging the frames back).  Both slabs go
   through a WalManager in the same directory (append without waiting,
   ingest at the seq, commit); a FlushScheduler (1 s interval,
   wal=the manager) flushes instead of flush_all_groups, and its first
   rotation's horizon report must prune the sealed segment of the
   counters' slab (wal_persisted_horizon = the earliest checkpoint);
   30 scrape records (5 min) follow the flush through the WAL; the
   restart replays the log from LocalDiskMetaStore's restart points
   (the slab record left skipped, exactly the 30 replayed), and the
   panel over the grid and the tail holds the f64 oracle within rtol
   5e-4 / atol 1e-4 (K3); then 8 gauges end, evict_ended_partitions
   and compact_index leave the panel the same to the bit.
broker-16k.  the port's gateway (GatewayServer on an ephemeral port, a
   KafkaContainerSink into a FileBackedBroker in a temporary directory)
   takes 16,384 request counters (dense-1M's labels) x 36 scrapes (6 min
   at 10 s) as Influx lines `request_total,<tags> counter=<v> <ts_ns>`
   through send_lines, one connection a scrape; create_stream(
   "filebroker", ...) under IngestionLifecycle ingests the log into a
   memstore on the card; sum by (_ns_) (rate(request_total[5m])) at 1 m
   steps over the 6 min launches K1 and holds its f64 oracle (rtol 2e-4,
   atol 1e-3); then POST /influx/write of 4,096 lines of one more scrape
   to a PromHttpApi over the same store, read back by /api/v1/read to
   the bit.  It prints lines/s for each door.  Cut from 1M to 16,384
   series for the time limit: the Influx parser runs per line in Python
   on the host.
downsample-16k.  8,192 request counters (dense-1M's labels, one reset
   each) and 8,192 gauges (gauge-1M's) x 720 at 10 s on a
   LocalDiskColumnStore in a temporary directory, on the card: a
   ShardDownsampler at the default resolutions (1 m, 5 m) on the shard,
   flush_all_groups, the drain into a DownsampledTimeSeriesStore on the
   card (the streaming path); a DownsamplerJob over the same disk store
   into a second LocalDiskColumnStore and a second downsample store over
   it (refresh_index, chunks paged on demand; the batch path).  On both:
   Q1 sum by (_ns_) (rate(request_total[5m])) at 1 m (resolution 1 m),
   Q2 sum by (_ns_) of min/max/sum/count/avg/last_over_time(heap_usage
   [10m]) at 5 m on windows aligned to the periods (resolution 5 m, the
   ds-gauge column each reads), Q3 Q2's panel but last through a
   LongTimeRangePlanner whose raw retention begins at the 60th minute
   (the first hour downsampled, the rest raw, stitched), each cold and 3
   times warm (bit-identical): every downsample answer against an f64
   oracle of the store's own host arrays (rtol 2e-4 / atol 1e-3), Q2 and
   Q3 against the raw store's answer (the same), Q1's total rate within
   5% of the raw panel's.  It prints the flush seconds and the
   downsampler's share, records per resolution, drain, ingest, the batch
   job's seconds and stats, refresh_index, each query's cold and warm
   p50 on both stores and on raw, whether the two stores answer
   bit-identically, the mirrors' bytes and the kernels launched.  Cut
   from 1M to 16,384 series for the time limit: flush encodes each
   series on the host;
restart-1M.  inside phase 3, at its full width: the build's 16 slabs
   go through a WalManager (WalConfig's defaults: fsync on, 64 MiB
   segments) in a tempfile.mkdtemp directory, each as the remote-write
   door takes it (append_grid without waiting, on the thread that makes
   the slabs, ahead of the ingest; ingest_columns at the seq; one commit
   of the last seq before the ack); the free disk space is checked
   first.  Right after phase 3's two queries the node crashes (their
   answers kept as numpy; the engine and the memstore dropped without a
   flush), and the port's FiloServer([DatasetConfig("prometheus", 1)],
   config=cfg, device="cuda") boots from the log, cfg.wal.enabled and
   cfg.wal.dir the log's root (its default InMemoryColumnStore holds no
   chunk until a flush, so no query pages from it): its constructor recovers the writer
   (recover_writer_state), attaches a CardinalityTracker to the shard
   and replays the log onto the card from the meta store's restart
   points (all -1); its phases are booting, replaying_wal, booted, its
   /ready 503 until start(background_flush=False) and 200 after it.
   The node's engine answers both queries, cold (the mirror upload) and
   warm, bit-identical to the answers before the crash, K1 and K6
   launched: 16 records, 1,048,576 x 720 samples, none skipped or
   corrupt.  What the demand-paging precheck costs at 1M once the
   store holds chunks, as after a first flush, is timed on a swapped
   store (paging_precheck_cost; answers bit-identical).  A
   [1,048,576, 1] scrape record through the recovered writer gets
   seq 16.  It prints the log's bytes and segments, the
   append and commit-wait seconds of the build, the constructor's
   seconds, the replay's seconds, samples/s and its split
   (ingest_columns and the tracker's series_created timed on their
   classes from outside the constructor; the rest reads, decompresses
   and decodes), boot to the first answer, the host's peak RSS, the
   scrape record's frame bytes, and a cProfile of reading and decoding
   one record.  The node serves general-1M and every later 1M phase on
   phase 3's counters, each against its oracle, serve-1M through
   rules-1M through its own PromHttpApi and FiloHttpServer; it is shut
   down before live-ingest-1M, and the directory deleted after it.
node-16k.  on the stores side: filo-cli as users run it (run_node_phase):
   an NPZ bundle of 16,384 request counters x 720 (one reset each)
   through jobs.batch_io, `python -m filodb_tpu_torch.cli init` and
   `importbundle` into a data directory, `serve --downsample 60000` as
   a subprocess on the card, `query` and `querybatch --host` against
   the f64 oracle (rtol 2e-4, atol 1e-3) with K1 in the server's
   ledger, the operations commands, SIGINT and a second boot over the
   same directory, the offline commands (on the host, --device cpu) and
   an exportbundle equal to the bundle imported; every step's seconds and the host flush's with
   the native host library (filodb_tpu_torch/native) loaded.  The
   script fails when that library does not build.
cluster-1M.  in the cluster side process, after cluster-e2e-4k
   (run_cluster_phase): the wire and the cluster at full width.
   dense-1M's 1,048,576 counters (the same seed) routed by the port's
   shard mapper and spread into 4 shards, 2 each on two data nodes A
   and B, each a TimeSeriesMemStore on the card behind its own
   NodeQueryServer on loopback TCP in this process
   (testcluster.make_fanout_cluster, fed columnar slabs through
   ingest_columns); the coordinator a QueryEngine over an empty
   memstore with RemoteNodeDispatchers.  sum by (_ns_) (rate(...[5m]))
   over 110 one-minute steps pushed down (one partial a node, K1 once a
   shard on the nodes) against the f64 oracle (rtol 2e-4, atol 1e-3),
   cold and warm, pushdown off the same bits; the ship-everything panel
   (ship_raw_series: [S, W] blocks streamed in CRC frames) within the
   same tolerance; quantile by (_ns_) (0.9, ...) pushed and shipped the
   same bits, within rtol 0.05 of the exact f64 quantile; a kill of the
   ship-everything query once its stream flows (query_canceled); B's
   server stopped (shard_unavailable without partial results, a flagged
   partial answer equal to the oracle of A's series with them).  It
   prints the wire bytes, frames, each panel's seconds and the wire's
   split (serialize, frames, socket, assemble);
replication-1M.  in the cluster side process, after cluster-1M
   (run_replication_phase), cut to 262,144 series (REPL_SERIES): dense-
   1M's counters (the same seed) in 4 shards at RF 2 over three data
   nodes A, B and C in that process (testcluster.make_replicated_cluster:
   a memstore on the card, a WAL under TMPDIR, a NodeQueryServer and a
   ReplicationServer on loopback TCP each, quorum acks); the history
   through ReplicationManager.replicate, 16 slabs a shard, with the
   build's split from the port's spans (encoding, each peer's round
   trips and longest append, the doors' WAL, the rest); one
   scrape at RF 2 against one into the primaries alone; the panel
   through failover_dispatcher_factory against the f64 oracle, cold and
   warm; the node that is primary of the most shards killed: the panel
   full (pushdown's per-shard fallback, query_replica_failovers risen,
   K1 on the replicas) with the bits of the answer before; a scrape it
   misses, its servers back over its memstore, catch-up from the
   survivors' WAL segments filtered by shard, its shards on it alone
   answering as the survivors; shard 0 handed live (as the handoff
   route runs it, its WAL tail included; each state's seconds and the
   host RSS in the snapshot and the tail) to the node that does not own
   it under a polling client and live scrapes: no failed or partial poll, the answer after it within
   rtol 1e-6 of before, memory_allocated and the booked `hot` bytes
   down by at least the dropped mirror's bytes after the tombstone;
federation-1M.  then (run_federation_phase), cut to 524,288 series
   (FED_SERIES): two FiloServer clusters on the card, east and west
   (testcluster.make_federated_pair booted empty), the counters with
   region east for the first half and west for the rest (every _ns_
   group spans both) through ingest_columns; the panel at east with
   west's share one pushed [G, W] partial, and in series mode, against
   the f64 oracle, K1 counted a cluster; the series-mode query killed
   mid-stream (a cancel on both sides of the door); west's door stopped
   (a flagged partial naming cluster:west equal to the oracle of east's
   series, the breaker open, the door back and the full answer); a
   cached re-poll, one scrape into west invalidating it through the
   federation token, the next answer carrying the new sample;
cluster-e2e-4k.  in a side process of its own (`--side cluster`) from K8
   on, then cluster-1M, replication-1M and federation-1M there
   (run_cluster_e2e_phase; each node's ready line must name its
   replication door's port): a ClusterCoordinator
   (4 shards, liveness
   2.5 s), `python -m filodb_tpu_torch.persist.netstore` and three
   `python -m filodb_tpu_torch.parallel.nodeapp --store-url ...`
   processes on the card, A started as the reference's scripts start a
   node (no --device: its empty --platform means the card), B and C
   with `--device cuda`; 4,096 counters x 90 samples
   as Influx lines through each node's control socket; the rate panel
   through a coordinator engine against the f64 oracle; a flush, SIGKILL
   of an owner, failover to the standby (index from the netstore, chunks
   paged on demand): the samples' sums within rtol 1e-9 of the ones
   before, the rate panel within its oracle's tolerance.  Every step's
   seconds, each node's boot to ready, and K1 launches from the nodes'
   stats.devices as they come back over the wire; the panel over A's
   shards alone (while A owns some) must show A's K1 launches under a
   cuda device;
mesh-1M.  on the gauge-hist side after hist-native-1M (run_mesh_phase;
   there its engine check, ~30 GB on the card, comes once the main line
   and the cluster side are done: placed beside them, the card ran out
   of memory), once the machine has MESH_HOST_NEED of host memory
   available (wait_for_host_memory, at most MESH_HOST_WAIT_S; its ~20
   GiB beside the three other processes' peaks did not fit the host),
   at full width: dense-1M's
   counters (the same seed) and 65,536 counters with ~1% NaN holes as a
   second metric in a 4-shard memstore on the card, routed by a 4-shard
   ShardMapper with spread 2; the port's MeshExecutor on a 4 x 1 and a
   4 x 2 mesh whose slots all name the card (the second splits the 110
   windows over two time slots), one pack serving both: the rate pack
   (its seconds split: row gather, host f64 correction and rebase,
   pack_shards, upload); on each mesh sum by (_ns_) (rate(...[5m])) cold
   and --warm times warm (bit-identical; p50, p99), avg and count (K1
   once a slot a panel; dense count is host math), max (the general mesh
   path, no kernel), the in-process merge on the card bit-identical to
   the host merge (its ms); on the 4 x 1 mesh run_agg_batch of four rate
   panels (one launch a slot, equal to the panels alone) and
   run_binop_agg sum / count; sum_over_time (K5), last_over_time (K4)
   and the ragged metric's rate (K3) on both meshes;
   every panel against its f64 oracle (rtol 2e-4 / atol 1e-3, the
   ragged 5e-4 / 1e-4); then the port's QueryEngine over the same store,
   one launch a shard, within MESH_ENGINE_TOL of the mesh.  It prints
   the peak device memory and the host RSS;
mesh-2proc-65k.  last on the main line, after live-ingest-1M frees
   its 1M store (run_mesh_2proc_phase): two
   worker processes of
   this script (--mesh-worker) on the card join one process group over
   localhost (gloo: they share the card), each keeping 2 of the 4
   shards of 65,536 counters; sum by (_ns_) (rate(...[5m])) over the
   4 x 1 global mesh, K1 on each process's two slots, the partials
   all-reduced, against the f64 oracle (rtol 2e-4 / atol 1e-3) and
   within 1e-12 relative of a one-process mesh over all four shards.
   The run fails if a worker fails or outlives MESH_2PROC_TIMEOUT_S;
multi-card.  then (run_multicard_checks), where the machine has two
   cards or more: the engine's per-shard mirrors placed over the cards,
   its 8 dashboard panels bit-identical to one card's, and a mesh over
   distinct cards bit-identical to the one-card mesh; on one card one
   line says they were not run and why;
flush-page-16k, cold-65k, parity-65k, compact-16k, downsample-16k,
broker-16k and node-16k, then phases 4 and
6-8, run in a second process (`--side stores`) from K8 on, beside phase
3, restart-1M and the 1M phases on their store; phase 5 (with
general-1M's gauge half), hist-classic-1M, hist-native-1M, then
mesh-1M in a third (`--side gauge-hist`) from the end of host-route-1M
on, beside
promql-1M through live-ingest-1M.  A side process loads the libraries built here, counts its own launches from 0
and writes them, its phases' seconds and its own to a file read when it
is joined; a side that fails fails the run, and one whose stdin (a pipe
from the script) closes ends itself, as do the mesh workers.  A
thread of this process samples the machine's memory in use each second
(HostMemoryWatch) and prints its peak, the split of it by process and
one sample a minute.
Every query runs with PlannerParams(scan_limit=2,000,000,000), as
bench.py raises it at this size: the default cap refuses a 1M-series
scan.  Every phase prints its seconds (phase 3's leave out restart-1M's,
which runs inside it); general-1M, hist-classic-1M and
hist-native-1M print each query's cold time, warm p50/p99 and the peak
device memory, and hist-native-1M the mirror upload seconds; a cold
query's line (phases 3-6 and general-1M) also gives the seconds of
garbage collection inside it.

Then one JSON line with the kernel table (K1-K8), and as the last line
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --ab CHECKOUT [CHECKOUT ...] [--rounds R]

instead times this checkout against others (e.g. the parent commit
unpacked with git archive) on one card in alternating rounds (run_ab);
its kernels cell also times index_select at K8's gather's own [rows,
128] output and logs the gather's ratio to it per round.
"""
from __future__ import annotations

import argparse
import contextlib
import cProfile
import functools
import gc
import io
import json
import os
import pstats
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np

START_MS = 1_600_000_000_000
STEP_MS = 10_000
T = 720
NUM_NS = 1000
SLAB = 65_536
RAGGED_SERIES = 65_536
ADVERSARIAL_SERIES = 65_536        # phase 2's ragged rows with NaN runs
RANGE_MS = 300_000
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, published
F32_OPS_PER_S = 67e12              # H100 SXM FP32 outside the tensor cores
SECTOR = 32                        # bytes per DRAM sector
# f32 operations per (series, window) in the rate epilogue (rate_one in
# csrc/fused_rate.cu: 25 arithmetic/compare/select ops) plus the add of
# the group sum; K3 adds a compare and a count per slot it scans
RATE_OPS = 26
# f32 operations per slot of the in-kernel reset correction (K2): the
# compare with the previous sample, the select of the drop, the prefix add
DROP_OPS = 3
RESETS = 2                         # counter restarts per raw series
SCAN_LIMIT = 2_000_000_000         # bench.py:1091's raised scan_limit

COUNTER_QUERIES = [
    # (PromQL, oracle key, aggregate, kernel launched: dense, ragged)
    ("sum by (_ns_) (rate(request_total[5m]))", "rate", "sum",
     "fused_rate_dense", "fused_rate_ragged"),
    ("max by (_ns_) (rate(request_total[5m]))", "rate", "max",
     "fused_rate_dense_series", "fused_rate_ragged_series"),
]
GAUGE_QUERIES = [
    ("sum by (_ns_) (heap_usage)", "last", "sum",
     "fused_last_dense", "fused_last_ragged"),
    ("max by (_ns_) (heap_usage)", "last", "max",
     "fused_last_dense_series", "fused_last_ragged_series"),
    ("sum(sum_over_time(heap_usage[5m]))", "sum", "sum_all",
     "fused_over_time_dense", "fused_over_time_ragged"),
    ("avg by (_ns_) (avg_over_time(heap_usage[5m]))", "avg", "avg",
     "fused_over_time_dense", "fused_over_time_ragged"),
    ("sum(count_over_time(heap_usage[5m]))", "count", "sum_all",
     None, "fused_over_time_ragged"),
    ("min by (_ns_) (min_over_time(heap_usage[5m]))", "min", "min",
     None, None),
    ("max(max_over_time(heap_usage[5m]))", "max", "max_all", None, None),
    ("max by (_ns_) (avg_over_time(heap_usage[5m]))", "avg", "max",
     "fused_over_time_dense_series", "fused_over_time_ragged_series"),
]


class SmokeFailure(RuntimeError):
    pass


def scan_params(**kw):
    """PlannerParams with the scan cap raised to SCAN_LIMIT, as bench.py
    raises it at this size: the default 50,000,000 refuses a 1M-series
    query over 690 samples a series (the leaf's scan cap)."""
    from filodb_tpu_torch.query.rangevector import PlannerParams
    return PlannerParams(scan_limit=SCAN_LIMIT, **kw)


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------ data + oracle

def window_bounds(ts_row, wends):
    first = np.searchsorted(ts_row, wends - RANGE_MS + 1, side="left")
    last = np.searchsorted(ts_row, wends, side="right") - 1
    return first, last


def make_counter_slab(rng, n, hole_frac):
    """Counters like ingest/generator.counter_batch: exponential
    increments, one reset per series in the second half; optional NaN
    scrape gaps."""
    incr = rng.exponential(10.0, size=(n, T))
    vals = np.cumsum(incr, axis=1)
    r = rng.integers(T // 2, T, size=n)
    before = vals[np.arange(n), r - 1][:, None]
    vals = np.where(np.arange(T)[None, :] >= r[:, None], vals - before, vals)
    if hole_frac:
        vals[rng.random((n, T)) < hole_frac] = np.nan
    return vals


def make_gauge_slab(rng, n, hole_frac):
    """Gauges like ingest/generator.gauge_batch: a sinusoid around 100
    with a random phase per series plus noise; optional NaN gaps."""
    phase = rng.uniform(0, 2 * np.pi, size=(n, 1))
    vals = 100.0 + 50.0 * np.sin(np.arange(T)[None, :] / 20.0 + phase) \
        + rng.normal(0, 2.0, size=(n, T))
    if hole_frac:
        vals[rng.random((n, T)) < hole_frac] = np.nan
    return vals


def window_slots(v, f, lst):
    """The slots of each window of a shared grid, gathered: v [n, T] on
    the card, f/lst [W] first and last slot -> (x [n, W, L], in-window
    mask [W, L]), L the widest window."""
    import torch
    L = int((lst - f + 1).max())
    j = f[:, None] + torch.arange(L, device=v.device)[None, :]
    return v[:, j.clamp(max=v.shape[1] - 1)], j <= lst[:, None]


def oracle_over_time_t(v, ts_row, wends):
    """Per (series, window) in f64 on the card, NaN samples absent: the
    value in the window's newest slot (the instant selector, slot
    semantics), sum/avg/count/min/max_over_time."""
    import torch
    dev = v.device
    first, last = window_bounds(ts_row, wends)
    f = torch.from_numpy(first).to(dev)
    lst = torch.from_numpy(last).to(dev)
    valid = ~torch.isnan(v)
    zero = torch.zeros((v.shape[0], 1), dtype=torch.float64, device=dev)
    cs = torch.cat([zero, torch.cumsum(torch.where(valid, v, 0.0), 1)], 1)
    cc = torch.cat([zero, torch.cumsum(valid.double(), 1)], 1)
    s = cs[:, lst + 1] - cs[:, f]
    n = cc[:, lst + 1] - cc[:, f]
    x, inw = window_slots(v, f, lst)
    ok = inw & ~torch.isnan(x)
    inf = torch.full((), float("inf"), dtype=torch.float64, device=dev)
    mn = torch.where(ok, x, inf).amin(2)
    mx = torch.where(ok, x, -inf).amax(2)
    some = n > 0
    nan = torch.full((), float("nan"), dtype=torch.float64, device=dev)
    return {"last": v[:, lst], "sum": torch.where(some, s, nan),
            "avg": torch.where(some, s / n, nan), "count": n,
            "min": torch.where(some, mn, nan),
            "max": torch.where(some, mx, nan)}


def oracle_general_t(v, ts_row, wends, kind):
    """The general path's per-series answers for G1-G4 in f64 on the card,
    for one slab of dense series v [n, T] on the shared grid ts_row
    (written here, apart from the port's ops/rangefns.py): counters ->
    irate over the reset-corrected values (G5's increase and rate come
    from oracle_rates_t); gauges -> deriv (the least-squares slope about
    each window's means), the instant selector's value (the newest sample
    of the 5 m lookback) and quantile_over_time(0.9) (Prometheus'
    interpolation between sorted ranks)."""
    import torch
    dev = v.device
    first, last = window_bounds(ts_row, wends)
    f = torch.from_numpy(first).to(dev)
    lst = torch.from_numpy(last).to(dev)
    ts = torch.from_numpy(ts_row.astype(np.float64)).to(dev)
    nslots = (lst - f + 1).to(torch.float64)             # [W], dense grid
    nan = torch.full((), float("nan"), dtype=torch.float64, device=dev)
    if kind == "counter":
        prev = torch.cat([v[:, :1], v[:, :-1]], dim=1)
        corr = v + torch.cumsum(torch.where(prev > v, prev,
                                            torch.zeros_like(v)), dim=1)
        lp = (lst - 1).clamp(min=0)
        irate = (corr[:, lst] - corr[:, lp]) / ((ts[lst] - ts[lp]) / 1000.0)
        return {"irate": torch.where(nslots >= 2, irate, nan)}
    x, inw = window_slots(v, f, lst)                      # [n, W, L]
    m = inw.to(torch.float64)
    j = (f[:, None] + torch.arange(inw.shape[1], device=dev)[None, :])
    t = ts[j.clamp(max=T - 1)] / 1000.0
    tbar = (t * m).sum(1) / nslots
    xbar = (x * m).sum(2) / nslots
    dt = (t - tbar[:, None]) * m
    slope = ((x - xbar[..., None]) * dt).sum(2) / (dt * dt).sum(1)
    srt = torch.sort(torch.where(inw, x, torch.full_like(x, float("inf"))),
                     dim=2).values
    rank = 0.9 * (nslots - 1)
    lo, hi = torch.floor(rank).long(), torch.ceil(rank).long()
    w = torch.arange(len(wends), device=dev)
    q90 = srt[:, w, lo] + (srt[:, w, hi] - srt[:, w, lo]) * (rank - lo)
    return {"deriv": torch.where(nslots >= 2, slope, nan),
            "last_lb": torch.where(nslots >= 1, v[:, lst], nan),
            "q90": torch.where(nslots >= 1, q90, nan)}


# The general path at full width (general-1M), over the dense counter
# and gauge stores: query, the store it reads, the oracle as (per-series
# key, group op) pairs (two pairs: their ratio), tolerance, warm repeats
# cap, and the kernels each run must launch.
GENERAL_QUERIES = {
    "counter": [
        dict(name="G1", query="sum by (_ns_) (irate(request_total[5m]))",
             oracle=[("irate", "sum")], tol=(2e-5, 1e-4), kernels=()),
        dict(name="G5", query="sum by (_ns_) (increase(request_total[5m])) "
             "/ on (_ns_) sum by (_ns_) (rate(request_total[5m]))",
             oracle=[("increase", "sum"), ("rate", "sum")],
             tol=(2e-4, 1e-3), kernels=("fused_rate_dense",)),
    ],
    "gauge": [
        dict(name="G2", query="avg by (_ns_) (deriv(heap_usage[5m]))",
             oracle=[("deriv", "avg")], tol=(5e-4, 2e-4), kernels=()),
        dict(name="G3", query="stddev by (_ns_) (heap_usage)",
             oracle=[("last_lb", "stddev")], tol=(5e-4, 5e-3), kernels=()),
        dict(name="G4", query="max by (_ns_) (quantile_over_time(0.9, "
             "heap_usage[5m]))", oracle=[("q90", "max")], tol=(5e-4, 5e-3),
             kernels=(), warm=2),
    ],
}


class GcPauses:
    """Seconds the interpreter spent in cyclic garbage collection inside a
    `with` block (gc.callbacks), and how many of those collections were
    full (generation 2)."""

    def __init__(self):
        self.seconds, self.full, self._t = 0.0, 0, None

    def _note(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.full += info["generation"] == 2
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self._note)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._note)

    def __str__(self):
        return f"gc {self.seconds:.4f} s, {self.full} full collections"


def run_queries(what, eng, specs, want, warm, start_s, end_s):
    """Each query once cold and `warm` times warm (a spec's own `warm`
    caps it) through QueryEngine.query_range, against `want`; every run
    must launch the spec's kernels; two warm answers bit-identical.  The
    launch counts are set to 0 just before the first query and read just
    after the last -> (launches, rows)."""
    import torch
    from filodb_tpu_torch.ops import kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    rows_out = []
    for spec in specs:
        q, reps = spec["query"], min(warm, spec.get("warm", warm))
        times, answers, pauses = [], [], GcPauses()
        for i in range(reps + 1):
            n0 = dict(kernels.LAUNCHES)
            with GcPauses() as gcp:
                t0 = time.perf_counter()
                answers.append(eng.query_range(q, start_s + 600, 60, end_s,
                                               spec.get("params")
                                               or scan_params()))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            if i == 0:
                pauses = gcp
            for k in spec["kernels"]:
                check(kernels.LAUNCHES[k] > n0[k],
                      f"{what}: run {i} of `{q}` did not launch {k}")
        rtol, atol = spec["tol"]
        checked = [compare(r, want[q], rtol, atol, f"{what} `{q}`",
                           spec.get("label", "_ns_")) for r in answers]
        check(np.array_equal(checked[-2][0], checked[-1][0], equal_nan=True),
              f"{what}: two warm answers of `{q}` differ")
        _, err, rel = checked[-1]
        warm_s = times[1:]
        p50, p99 = np.percentile(warm_s, 50), np.percentile(warm_s, 99)
        log(f"{what}: {spec['name']} `{q}` via "
            f"{'+'.join(spec['kernels']) or 'the general path, no kernel'}: "
            f"cold {times[0]:.4f} s ({pauses}); "
            f"warm x{reps} p50 {p50:.4f} s p99 "
            f"{p99:.4f} s; oracle max_abs_err {err} max_rel_err {rel} "
            f"(rtol {rtol}, atol {atol}; oracle max abs "
            f"{np.nanmax(np.abs(want[q]))}, median abs "
            f"{np.nanmedian(np.abs(want[q]))}); warm answers bit-identical")
        rows_out.append(dict(query=q, cold_s=times[0], p50=p50, p99=p99,
                             err=err))
    launches = dict(kernels.LAUNCHES)
    log(f"{what}: max_memory_allocated {torch.cuda.max_memory_allocated()} "
        f"B; launches {({k: v for k, v in launches.items() if v})}")
    return launches, rows_out


class GroupOracle:
    """f64 group aggregates on the card of per-series values [n, W] (NaN =
    absent), accumulated slab by slab."""

    def __init__(self, groups, W, device=None):
        import torch
        dev = device if device is not None else torch.device("cuda", 0)

        def full(x):
            return torch.full((groups, W), x, dtype=torch.float64,
                              device=dev)
        self.sum, self.sq, self.cnt = full(0.0), full(0.0), full(0.0)
        self.min, self.max = full(float("inf")), full(float("-inf"))

    def add(self, per, gids):
        """per [n, W] f64 and gids [n] int64, both on the card."""
        import torch
        ok = ~torch.isnan(per)
        x = torch.where(ok, per, 0.0)
        self.sum.index_add_(0, gids, x)
        self.sq.index_add_(0, gids, x * x)
        self.cnt.index_add_(0, gids, ok.to(torch.float64))
        idx = gids[:, None].expand_as(per)
        self.min.scatter_reduce_(0, idx, torch.where(ok, per, float("inf")),
                                 "amin")
        self.max.scatter_reduce_(0, idx, torch.where(ok, per, float("-inf")),
                                 "amax")

    def result(self, op):
        import torch
        mean = self.sum / self.cnt
        val = {"sum": self.sum, "avg": mean, "min": self.min,
               "max": self.max,
               "stddev": torch.sqrt(torch.clamp(self.sq / self.cnt
                                                - mean * mean, min=0.0))}[op]
        return torch.where(self.cnt > 0, val, float("nan")).cpu().numpy()


def build_store(kind, num_series, seed, hole_frac, queries, general=(),
                wal=None):
    """Ingest counters or gauges through the port's shard; return the
    memstore, the oracle's answer [G, W] per query (and per general-path
    query of `general`, from oracle_general_t on the card), the windows
    and timings.  One worker thread makes the slabs in order (the same
    values as made one after another), two ahead of the ingest; `gen_s`
    is the time the ingest waited for them.  With `wal` (a WalManager)
    each slab takes the remote-write door's sequence: append_grid
    (wait=False) on that thread, as a door appends one request while
    the shard ingests the one before, then ingest_columns at the
    record's seq, and one commit of the last seq once every slab is in
    (the ack); `append_s` is the thread's time in append_grid."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.core.partkey import PartKey
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    ms = TimeSeriesMemStore()
    shard = ms.setup("prometheus", 0)
    ts_row = START_MS + np.arange(T, dtype=np.int64) * STEP_MS
    wends = np.arange(START_MS + 600_000, int(ts_row[-1]) + 1, 60_000)
    W = len(wends)
    accs = {}                          # oracle key -> (by _ns_, all)
    gen_s = ingest_s = oracle_s = 0.0
    append_s = [0.0]
    seq = -1
    metric, schema, col = (("request_total", "prom-counter", "count")
                           if kind == "counter"
                           else ("heap_usage", "gauge", "value"))
    def make_slab(i0):
        n = min(SLAB, num_series - i0)
        vals = (make_counter_slab(rng, n, hole_frac) if kind == "counter"
                else make_gauge_slab(rng, n, hole_frac))
        keys = [PartKey.make(metric, {
            "_ws_": "demo", "_ns_": f"App-{i % NUM_NS}",
            "instance": f"Instance-{i}", "dc": f"DC{i % 2}"})
            for i in range(i0, i0 + n)]
        if wal is None:
            return n, vals, keys, -1
        ta = time.perf_counter()
        seq = wal.append_grid(0, schema, keys,
                              np.broadcast_to(ts_row, (n, T)), {col: vals},
                              wait=False)
        append_s[0] += time.perf_counter() - ta
        return n, vals, keys, seq

    starts = list(range(0, num_series, SLAB))
    pool = ThreadPoolExecutor(max_workers=1)
    ahead = [pool.submit(make_slab, i0) for i0 in starts[:2]]
    for k, i0 in enumerate(starts):
        t0 = time.perf_counter()
        n, vals, keys, seq = ahead.pop(0).result()
        if k + 2 < len(starts):
            ahead.append(pool.submit(make_slab, starts[k + 2]))
        gids = (np.arange(i0, i0 + n) % NUM_NS).astype(np.int64)
        ts = np.broadcast_to(ts_row, (n, T))
        gen_s += time.perf_counter() - t0
        t1 = time.perf_counter()
        shard.ingest_columns(schema, keys, ts, {col: vals}, offset=seq)
        t2 = time.perf_counter()
        v = torch.from_numpy(vals).to(dev)
        per_all = (oracle_rates_t(v, ts_row, wends) if kind == "counter"
                   else oracle_over_time_t(v, ts_row, wends))
        if general:
            per_all.update(oracle_general_t(v, ts_row, wends, kind))
        g = torch.from_numpy(gids).to(dev)
        for okey in {q[1] for q in queries} | {
                k for g_ in general for k, _ in g_["oracle"]}:
            a = accs.setdefault(okey, (GroupOracle(NUM_NS, W),
                                       GroupOracle(1, W)))
            a[0].add(per_all[okey], g)
            a[1].add(per_all[okey], torch.zeros_like(g))
        torch.cuda.synchronize()
        del v, per_all
        ingest_s += t2 - t1
        oracle_s += time.perf_counter() - t2
    pool.shutdown()
    commit_s = 0.0
    if wal is not None:
        t0 = time.perf_counter()
        wal.commit(seq)
        commit_s = time.perf_counter() - t0
    want = {}
    for q, okey, op, _, _ in queries:
        grouped, total = accs[okey]
        want[q] = (total.result(op[:-4]) if op.endswith("_all")
                   else grouped.result(op))
    for g in general:
        parts = [accs[okey][0].result(op) for okey, op in g["oracle"]]
        with np.errstate(invalid="ignore", divide="ignore"):
            want[g["query"]] = parts[0] if len(parts) == 1 \
                else parts[0] / parts[1]
    return ms, want, wends, dict(gen_s=gen_s, ingest_s=ingest_s,
                                 oracle_s=oracle_s, append_s=append_s[0],
                                 commit_s=commit_s, last_seq=seq)


def matrix_close(got, want, rtol, atol, what):
    """A [groups, W] answer against its oracle: the NaN pattern equal and
    every value within tolerance -> (max abs err, max rel err)."""
    check((np.isnan(got) == np.isnan(want)).all(),
          f"{what}: NaN pattern differs from the oracle")
    m = ~np.isnan(want)
    err = np.abs(got[m] - want[m])
    check((err <= atol + rtol * np.abs(want[m])).all(),
          f"{what}: max abs err {err.max()} over rtol {rtol} atol {atol}")
    return float(err.max()), float(
        (err / np.maximum(np.abs(want[m]), 1e-300)).max())


def compare(got_res, want, rtol, atol, what, label="_ns_"):
    """Each result series into row N of `want` by its `label` (App-N,
    Instance-N; row 0 without one), then held to it."""
    check(got_res.error is None, f"{what}: query error {got_res.error}")
    got = np.full_like(want, np.nan)
    for key, _, row in got_res.series():
        labels = dict(key.labels)
        got[int(labels[label].split("-")[1]) if label in labels else 0] = \
            row
    return (got,) + matrix_close(got, want, rtol, atol, what)


# --------------------------------------------------------------- timing

def cuda_ms(fn, reps, warm=2):
    import torch
    for _ in range(warm):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def slots_read(kind, ragged, plan):
    """Columns of the shared grid one row's windows read."""
    if kind == "rate_family" and not ragged:
        ok = plan.wvalid
        return np.union1d(plan.idx1[ok], plan.idx2[ok])
    ok = plan.wvalid1
    if kind == "last_over_time":
        return np.unique(plan.idx2[ok])
    return np.unique(np.concatenate([np.arange(a, b + 1) for a, b in
                                     zip(plan.idx1[ok], plan.idx2[ok])]))


def bound(kind, ragged, series_mode, num_rows, plan, Gp, with_drops=False):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and f32
    operations over the FP32 rate.  Bytes: the 32-byte sectors holding
    the columns a row's windows read (DRAM moves whole sectors; K2 reads
    every slot from 0 to the last window's last slot, plan.span), the
    per-row base (and CSR entry in group mode), and the outputs written
    once ([Gp, W] sums, or [rows, W] per series; a second plane for the
    ragged presence).  Operations per (row, window): the epilogue's
    arithmetic plus, for the kinds that scan a window, per-slot adds
    (and a compare and a count per slot when ragged); K2 adds a compare,
    a select and an add per slot of its span."""
    cols = (np.arange(plan.span) if with_drops
            else slots_read(kind, ragged, plan))
    sectors = np.unique(cols * 4 // SECTOR).size
    planes = 2 if ragged else 1
    per_row = sectors * SECTOR + 4 + (0 if series_mode else 4)
    outs = (num_rows if series_mode else Gp) * plan.W * 4 * planes
    nbytes = num_rows * per_row + outs
    ok = plan.wvalid1
    slots = float((plan.idx2 - plan.idx1 + 1)[ok].mean())
    if kind == "rate_family":
        per_window = RATE_OPS + ((2 * slots + 1) if ragged else 0)
    elif kind == "last_over_time":
        per_window = 7 if ragged else 5
    else:
        per_window = (3 * slots + 5) if ragged else (slots + 4)
    ops = num_rows * plan.W * per_window
    if with_drops:
        ops += num_rows * plan.span * DROP_OPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


# -------------------------------------------------------- phase 2: kernels

# (table name, kind, per-series mode); every kind is checked in its dense
# and ragged variants, named <name>_dense / <name>_ragged (+ _series)
KERNELS = [
    ("fused_rate", "rate_family", "filodb_tpu_torch/csrc/fused_rate.cu"),
    ("fused_last", "last_over_time",
     "filodb_tpu_torch/csrc/fused_over_time.cu"),
    ("fused_over_time", "avg_over_time",
     "filodb_tpu_torch/csrc/fused_over_time.cu"),
]
DROPS_KERNELS = [
    ("fused_rate_drops", "rate_family",
     "filodb_tpu_torch/csrc/fused_drops.cu"),
]
CHECK_KINDS = {"fused_over_time": ("sum_over_time", "avg_over_time",
                                   "count_over_time")}
# the TPU kernel variant each table entry replaces
# (filodb_tpu/ops/pallas_fused.py::_kernel, :466)
REPLACES = {"fused_rate_dense": 595, "fused_rate_ragged": 544,
            "fused_last_dense": 502, "fused_last_ragged": 485,
            "fused_over_time_dense": 510, "fused_over_time_ragged": 518,
            "fused_rate_drops_dense": 598, "fused_rate_drops_ragged": 554}


def nan_runs(v, gen, frac=0.3, longest=48):
    """Set about `frac` of v's slots NaN in runs of 1..longest-1 slots
    that start anywhere (so they cross 32-slot tiles, lane runs and window
    edges), every 1000th row wholly, and leave every 1000th row + 1 one
    valid sample and + 2 two."""
    import torch
    S, T_ = v.shape
    pos = torch.arange(T_, device=v.device)[None, :]
    starts = torch.rand((S, T_), generator=gen, device=v.device) < \
        -np.log1p(-frac) / (longest / 2)
    lens = torch.randint(1, longest, (S, T_), generator=gen, device=v.device)
    ends = torch.where(starts, pos + lens - 1, torch.full_like(lens, -1))
    v[torch.cummax(ends, dim=1).values >= pos] = float("nan")
    v[::1000] = float("nan")
    for k, keep in ((1, [T_ // 2]), (2, [T_ // 2 - 3, T_ // 2 + 4])):
        row = v[k::1000, keep].clone()
        v[k::1000] = float("nan")
        v[k::1000, keep] = row
    return v


def kernel_inputs(S, T_, panels, ragged, gen, device, resets=0,
                  holes="scatter"):
    import torch
    from filodb_tpu_torch.ops import fused
    ts_row = np.arange(T_, dtype=np.int64) * STEP_MS
    wends = np.arange(600_000, int(ts_row[-1]) + 1, 60_000)
    plan = fused.build_plan(ts_row, wends, RANGE_MS)
    v = torch.cumsum(torch.rand((S, T_), generator=gen, device=device)
                     * 20.0, dim=1)
    pos = torch.arange(T_, device=device)[None, :]
    for k in range(resets):             # raw counter restarts, in order
        r = torch.randint(max(1, k * T_ // resets), (k + 1) * T_ // resets,
                          (S, 1), generator=gen, device=device)
        restart = torch.rand((S, 1), generator=gen, device=device) * 5.0
        v = torch.where(pos >= r, v - v.gather(1, r - 1) + restart, v)
    del pos
    if ragged and holes == "runs":
        nan_runs(v, gen)
    elif ragged:
        v[torch.rand((S, T_), generator=gen, device=device) < 0.01] = \
            float("nan")
    vb = torch.rand(S, generator=gen, device=device,
                    dtype=torch.float64) * 1e6
    vals = fused.pad_values(v, vb, plan)
    del v
    groups = [fused.pad_groups(np.arange(S, dtype=np.int64) % g, S, g,
                               device=device) for g in panels]
    csr, _, total = fused.merge_groups(groups, panels)
    Gp = fused.pad_group_count(total)
    chunks = fused.chunk_plan(csr.offsets, Gp, device)
    return dict(plan=plan, vals=vals, csr=csr, chunks=chunks,
                rows=plan.device_rows(device), Gp=Gp, S=S)


def same_bits(a, b):
    """Equal to the bit, with NaN in the same cells."""
    import torch
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        a.masked_fill(na, 0).view(torch.int32),
        b.masked_fill(nb, 0).view(torch.int32)))


def kernel_call(inp, kind, ragged, series_mode, with_drops):
    """One launch of a kernel wrapper on phase 2's inputs `inp`."""
    from filodb_tpu_torch.ops import fused
    vals, rows, S = inp["vals"], inp["rows"], inp["S"]
    flags = (True, True, with_drops)      # is_counter, is_rate, drops
    if series_mode:
        return lambda: fused.fused_per_series(
            vals.vals_p, vals.vbase_p, rows, S, kind, ragged, *flags)
    args = (vals.vals_p, vals.vbase_p, inp["csr"], inp["chunks"], rows,
            inp["Gp"])
    return lambda: fused.group_launch(kind, ragged, *args, *flags)


def check_kernel(inp, base, kind, ragged, series_mode, gen, timed,
                 with_drops=False, exact=False):
    """Hold one kernel wrapper against its plain version on `inp` (to the
    bit when `exact`), and (rate family, last_over_time) its gather=False
    launch, the reference's matmul selections (K7), against its default
    one; returns the table row when `timed`, else the max abs err."""
    import torch
    from filodb_tpu_torch.ops import fused, kernels
    vals, rows, S = inp["vals"], inp["rows"], inp["S"]
    name = f"{base}_{'ragged' if ragged else 'dense'}" + \
        ("_series" if series_mode else "")
    flags = (True, True, with_drops)      # is_counter, is_rate, drops
    wrap = kernel_call(inp, kind, ragged, series_mode, with_drops)
    if series_mode:
        def plain():
            return fused.fused_per_series_plain(vals.vals_p, vals.vbase_p,
                                                rows, S, kind, ragged, *flags)
    else:
        def plain():
            return fused.group_plain(kind, ragged, vals.vals_p, vals.vbase_p,
                                     inp["csr"], inp["chunks"], rows,
                                     inp["Gp"], *flags)

    def planes(x):
        x = x if isinstance(x, tuple) else (x,)
        return [p for p in x if p is not None]

    n0 = kernels.LAUNCHES[name]
    k1, k2 = planes(wrap()), planes(wrap())
    torch.cuda.synchronize()
    check(kernels.LAUNCHES[name] == n0 + 2,
          f"{name} ({kind}): launch count did not rise")
    check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
          f"{name} ({kind}): two kernel runs differ")
    if kind in ("rate_family", "last_over_time"):
        g = planes(fused.run_kernel(
            vals.vals_p, vals.vbase_p, inp["csr"], rows,
            num_groups=inp["Gp"], is_counter=True, is_rate=True,
            with_drops=with_drops, kind=kind, ragged=ragged,
            per_series=series_mode, gather=False, num_rows=S))
        torch.cuda.synchronize()
        check(kernels.LAUNCHES[name] == n0 + 3
              and all(torch.equal(a, b) for a, b in zip(k1, g)),
              f"{name} ({kind}): gather=False did not launch the same "
              f"kernel to the same bits")
    p = planes(plain())
    check(len(p) == len(k1), f"{name}: kernel and plain planes differ")
    check(not exact or all(same_bits(a, b) for a, b in zip(k1, p)),
          f"{name} ({kind}): kernel and plain differ in some bit")
    max_abs = max_rel = 0.0
    for a, b in zip(k1, p):
        err = (a.double() - b.double()).abs()
        lim = 1e-5 + 1e-6 * b.double().abs()
        check(bool((err <= lim).all()),
              f"{name} ({kind}): kernel vs plain max abs err "
              f"{err.max().item()}")
        max_abs = max(max_abs, err.max().item())
        max_rel = max(max_rel, (err / b.double().abs().clamp(min=1e-30))
                      .max().item())
    plan = inp["plan"]
    log(f"check {name} ({kind}) S={S} W={plan.W} Gp={inp['Gp']}: "
        f"max_abs_err={max_abs} max_rel_err={max_rel} "
        f"bit_identical_repeat=True "
        + ("bit_identical_to_plain=True" if exact else "rtol=1e-6 atol=1e-5")
        + (" gather=False same kernel, same bits"
           if kind in ("rate_family", "last_over_time") else ""))
    if not timed:
        if exact:
            log(f"time {name} ({kind}) S={S} adversarial: kernel "
                f"{cuda_ms(wrap, reps=10):.4f} ms")
        return max_abs
    ms = cuda_ms(wrap, reps=20)
    plain_ms = cuda_ms(plain, reps=2, warm=1)
    # the nearest one-call yardstick on the same S x W operands: the
    # group sum alone (index_add_), or for the per-series mode the
    # min/max grouping that finishes it (scatter_reduce amax)
    gids = torch.from_numpy(np.arange(S) % NUM_NS).to(vals.vals_p.device)
    cells = torch.rand((S, plan.W), generator=gen,
                       device=vals.vals_p.device)
    if series_mode:
        idx = gids[:, None].expand(-1, plan.W)
        acc = torch.full((NUM_NS, plan.W), float("-inf"),
                         device=cells.device)
        library_ms = cuda_ms(lambda: acc.scatter_reduce_(
            0, idx, cells, "amax", include_self=True), reps=20)
        yard = "scatter_reduce amax"
    else:
        acc = torch.zeros((inp["Gp"], plan.W), device=cells.device)
        library_ms = cuda_ms(lambda: acc.index_add_(0, gids, cells), reps=20)
        yard = "index_add_"
    yardsticks = {yard: library_ms}
    del cells, acc
    if with_drops:
        # the one PyTorch call that computes K2's added work: the prefix
        # sum of an [S, Tp] drops matrix
        drops = torch.rand(vals.vals_p.shape, generator=gen,
                           device=vals.vals_p.device)
        library_ms = cuda_ms(lambda: torch.cumsum(drops, dim=1), reps=10)
        yardsticks["cumsum [S, Tp]"] = library_ms
        del drops
    bound_ms, bound_by = bound(kind, ragged, series_mode, S, plan,
                               inp["Gp"], with_drops)
    log(f"time {name} ({kind}) S={S} W={plan.W} G={inp['Gp']}: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in yardsticks.items())
        + f", bound {bound_ms:.4f} ms ({bound_by})")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                yardsticks=yardsticks)


def run_kernel_checks(num_series, seed, device):
    """Every kernel at a small odd shape and at the main path's shape,
    dense and ragged; K2's inputs are raw counters with RESETS restarts a
    row.  The ragged rate entries (K3, K2 ragged and their per-series
    modes) also at ADVERSARIAL_SERIES x T with ~30% NaN in runs, to the
    bit."""
    import torch
    table = {}
    shapes = [(1001, 333, (7, 3), False, "scatter"),
              (num_series, T, (NUM_NS,), True, "scatter")]
    for ragged in (False, True):
        for S, T_, panels, timed, holes in shapes + (
                [(ADVERSARIAL_SERIES, T, (NUM_NS,), False, "runs")]
                if ragged else []):
            for drops, kernel_list in ((False, KERNELS),
                                       (True, DROPS_KERNELS)):
                gen = torch.Generator(device=device)
                gen.manual_seed(seed)
                if holes == "runs":
                    kernel_list = [k for k in kernel_list
                                   if k[1] == "rate_family"]
                inp = kernel_inputs(S, T_, panels, ragged, gen, device,
                                    resets=RESETS if drops else 0,
                                    holes=holes)
                for base, kind, source in kernel_list:
                    for series_mode in (False, True):
                        name = f"{base}_{'ragged' if ragged else 'dense'}" \
                            + ("_series" if series_mode else "")
                        errs = [check_kernel(inp, base, k, ragged,
                                             series_mode, gen, False)
                                for k in CHECK_KINDS.get(base, ())
                                if k != kind]
                        row = check_kernel(inp, base, kind, ragged,
                                           series_mode, gen, timed, drops,
                                           exact=holes == "runs")
                        if timed:
                            row["max_abs_err"] = max([row["max_abs_err"]]
                                                     + errs)
                            row["source"] = source
                            table[name] = row
                del inp
                gc.collect()
                torch.cuda.empty_cache()
    return table


# --------------------------------------------------------- phases 3 to 6

# ------------------------------------------------- restart-1M: the WAL

WAL_KEY_BYTES = 100                # a PartKey's bytes in a key table, at most


def open_wal(num_series):
    """restart-1M's log: a WalManager with WalConfig's defaults (fsync
    on, 64 MiB segments) in a new tempfile.mkdtemp directory, once its
    disk is known to hold `num_series` x T counters and one scrape
    record; raises SmokeFailure when it does not."""
    import shutil
    import tempfile

    from filodb_tpu_torch.wal import WalManager
    root = tempfile.mkdtemp(prefix="filodb-wal-")
    # f64 values, one shared timestamp row a record, the key tables
    need = num_series * (T * 8 + 8 + 2 * WAL_KEY_BYTES)
    free = shutil.disk_usage(root).free
    if free < need + need // 10:
        shutil.rmtree(root, ignore_errors=True)
        raise SmokeFailure(
            f"restart-1M: {free} B free under {root}, the WAL of "
            f"{num_series} series x {T} samples needs about {need} B "
            f"(set TMPDIR to a larger disk)")
    log(f"restart-1M: WAL directory {root}, {free} B free, about {need} B "
        f"needed")
    return WalManager(root, "prometheus")


def wal_root(wal):
    """The directory open_wal made (the manager keeps its dataset's log
    one level below it)."""
    return os.path.dirname(wal.dir)


@contextlib.contextmanager
def timed_method(cls, name, spent, keep=None):
    """Time every call of cls.name (for every instance) into spent[0];
    with `keep`, append each call's result to it; restored on exit."""
    orig = getattr(cls, name)

    @functools.wraps(orig)
    def wrapper(*a, **kw):
        t = time.perf_counter()
        try:
            out = orig(*a, **kw)
        finally:
            spent[0] += time.perf_counter() - t
        if keep is not None:
            keep.append(out)
        return out
    setattr(cls, name, wrapper)
    try:
        yield
    finally:
        setattr(cls, name, orig)


def boot_node(wal, num_series, before, want, build):
    """restart-1M after the crash (the node's engine and memstore dropped
    without a flush; what survives is the committed log): the dead
    node's committer stopped, then the port's node as a user boots it,
    FiloServer([DatasetConfig("prometheus", 1)], config=cfg,
    device="cuda") with cfg.wal.enabled and cfg.wal.dir the log's root
    (its column store the default InMemoryColumnStore, empty until a
    flush, so no query pages from it), whose constructor recovers the
    writer (recover_writer_state),
    attaches a CardinalityTracker to the shard and replays the log onto
    the card from the meta store's restart points (all -1: nothing was
    flushed); the replay's ingest_columns, the tracker's series_created
    and the writer's recovery timed from outside the constructor.  Its
    phases must be booting -> replaying_wal -> booted, /ready 503 until
    start(background_flush=False) (no flush: a 1M flush on the host
    takes minutes), then 200 and serving; phase 3's two queries cold
    (the mirror upload) and warm through the node's engine, each
    bit-identical to `before` (its answer before the crash); the node's
    engine against a bare one; paging_precheck_cost (the demand-paging
    precheck once the store holds chunks); then one scrape record
    through the recovered writer -> (engine, memstore,
    node, launches).  cfg sets query.batch_window_ms to the clients
    step's (serve-1M) and index.compaction_interval_s to 0 (no index
    compaction loop)."""
    import torch
    from filodb_tpu_torch.config import FilodbSettings
    from filodb_tpu_torch.core.ratelimit import CardinalityTracker
    from filodb_tpu_torch.core.shard import TimeSeriesShard
    from filodb_tpu_torch.ops import kernels
    from filodb_tpu_torch.standalone import DatasetConfig, FiloServer
    from filodb_tpu_torch.utils.events import journal
    from filodb_tpu_torch.utils.metrics import registry
    from filodb_tpu_torch.wal import WalManager
    from filodb_tpu_torch.wal.segment import (WalRecord, list_segments,
                                              read_records)
    dev = torch.device("cuda", 0)
    b = build
    segs = list_segments(wal.dir)
    log_bytes = sum(os.path.getsize(p) for _, p in segs)
    committed = wal.writer.committed_seq
    records = -(-num_series // SLAB)
    check(committed == b["last_seq"] == records - 1,
          f"restart-1M: committed through seq {committed}, the build "
          f"appended through {b['last_seq']}")
    log(f"restart-1M: the build's {records} slabs through the WAL (fsync "
        f"{wal.writer.fsync}, {wal.writer.segment_max_bytes} B segments): "
        f"{len(segs)} segments, {log_bytes} B of log; append (encode, "
        f"frame, write; on the slab thread, ahead of the ingest) "
        f"{b['append_s']:.3f} s and commit wait {b['commit_s']:.3f} s over "
        f"the build, beside ingest_columns {b['ingest_s']:.3f} s; committed "
        f"through seq {committed} before the ack")
    wal.close()
    gc.collect()
    free_device_memory()
    cfg = FilodbSettings()
    cfg.wal.enabled = True
    cfg.wal.dir = wal_root(wal)
    cfg.query.batch_window_ms = SERVE_WINDOW_MS
    # no index compaction loop: the phases after it time their own work
    cfg.index.compaction_interval_s = 0
    check(cfg.wal.replay_on_start, "restart-1M: replay_on_start is off")
    rss0 = host_rss()
    seq0 = journal.next_seq
    recover_s, ingest_s, tracker_s, replay_s = [0.0], [0.0], [0.0], [0.0]
    stats = []
    t_boot = time.perf_counter()
    with timed_method(WalManager, "__init__", recover_s), \
            timed_method(WalManager, "replay", replay_s, stats), \
            timed_method(TimeSeriesShard, "ingest_columns", ingest_s), \
            timed_method(CardinalityTracker, "series_created", tracker_s):
        node = FiloServer([DatasetConfig("prometheus", 1)], config=cfg,
                          device="cuda")
    construct_s = time.perf_counter() - t_boot
    try:
        phases = [(e["frm"], e["to"]) for e in
                  journal.since(seq0 - 1, kind="phase")]
        check(phases == [("booting", "replaying_wal"),
                         ("replaying_wal", "booted")],
              f"restart-1M: the node's boot phases {phases}")
        st, ready = node.api.handle("GET", "/ready", {})
        check(st == 503 and ready.get("reason") == "phase=booted",
              f"restart-1M: /ready before start {st} {ready}")
        check(node.meta_store.read_earliest_checkpoint("prometheus", 0)
              == -1, "restart-1M: a restart point other than -1")
        nwal = node.wals["prometheus"]
        check(nwal.writer.next_seq == committed + 1,
              f"restart-1M: next seq {nwal.writer.next_seq} after "
              f"recover_writer_state, {committed + 1} expected")
        check(len(stats) == 1, f"restart-1M: {len(stats)} replays")
        st_ = stats[0]
        sh = node.memstore.get_shard("prometheus", 0)
        root = sh.cardinality_tracker.cardinality(())
        check(root is not None and root.ts_count == num_series,
              f"restart-1M: the tracker counted {root} after the replay")
        want_samples = num_series * T
        check((st_.records, st_.samples, st_.skipped_records,
               st_.corrupt_segments) == (records, want_samples, 0, 0),
              f"restart-1M: replay records {st_.records} samples "
              f"{st_.samples} skipped {st_.skipped_records} corrupt "
              f"{st_.corrupt_segments}, expected {records}, "
              f"{want_samples}, 0, 0")
        check(sh.device == dev, f"restart-1M: the replayed shard is on "
              f"{sh.device}")
        t0 = time.perf_counter()
        node.start(background_flush=False)
        start_s_ = time.perf_counter() - t0
        st, ready, _ = Http(node.http.port).call("GET", "/ready")
        check(st == 200 and ready == {"status": "ready"},
              f"restart-1M: /ready after start {st} {ready}")
        phases = [(e["frm"], e["to"]) for e in
                  journal.since(seq0 - 1, kind="phase")]
        check(phases[-1] == ("booted", "serving"),
              f"restart-1M: phases after start {phases}")
        eng = node.engines["prometheus"]
        start_s = START_MS // 1000
        end_s = start_s + (T - 1) * STEP_MS // 1000
        kernels.reset_launch_counts()
        first_s = None
        for q, _, op, kernel, _ in COUNTER_QUERIES:
            times = []
            for i in range(2):
                n0 = kernels.LAUNCHES[kernel]
                t0 = time.perf_counter()
                res = eng.query_range(q, start_s + 600, 60, end_s,
                                      scan_params())
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                if first_s is None:
                    first_s = time.perf_counter() - t_boot
                check(kernels.LAUNCHES[kernel] == n0 + 1,
                      f"restart-1M: `{q}` run {i} did not launch {kernel}")
                got, err, rel = compare(res, want[q], *KERNEL_TOL,
                                        f"restart-1M `{q}`")
                check(np.array_equal(got, before[q], equal_nan=True),
                      f"restart-1M: `{q}` run {i} after the replay is not "
                      f"bit-identical to the answer before the crash")
            log(f"restart-1M: `{q}` via {kernel} on the node's engine "
                f"(ShardKeyRegexPlanner over SingleClusterPlanner): cold "
                f"{times[0]:.4f} s (mirror upload included), warm "
                f"{times[1]:.4f} s; both bit-identical to the answer before "
                f"the crash; oracle max_abs_err {err} max_rel_err {rel}")
        # the node's engine against a bare QueryEngine over the same store
        # (the hand wiring this boot replaced), warm, in alternating turns
        from filodb_tpu_torch.query.engine import QueryEngine
        bare = QueryEngine("prometheus", node.memstore)
        q0 = COUNTER_QUERIES[0][0]
        turns = {"node": [], "bare": []}
        for i in range(6):
            order = (("node", eng), ("bare", bare)) if i % 2 == 0 \
                else (("bare", bare), ("node", eng))
            for name, e in order:
                t0 = time.perf_counter()
                res = e.query_range(q0, start_s + 600, 60, end_s,
                                    scan_params())
                torch.cuda.synchronize()
                turns[name].append(time.perf_counter() - t0)
                got, _, _ = compare(res, want[q0], *KERNEL_TOL,
                                    f"restart-1M {name} `{q0}`")
                check(np.array_equal(got, before[q0], equal_nan=True),
                      f"restart-1M: the {name} engine's `{q0}` is not "
                      f"bit-identical to the answer before the crash")
        del bare
        log(f"restart-1M: warm `{q0}` p50 {np.median(turns['node']):.4f} s "
            f"on the node's engine, {np.median(turns['bare']):.4f} s on a "
            f"bare QueryEngine over the same store (6 turns each, "
            f"alternating; both bit-identical to the answer before the "
            f"crash)")
        paging_precheck_cost(eng, sh, before[q0], want[q0],
                             np.median(turns["node"]), start_s, end_s)
        launches = dict(kernels.LAUNCHES)
        rss = host_rss()
        # continuity: one scrape-shaped record through the recovered writer
        store = sh.stores["prom-counter"]
        keys = [p.part_key for p in sh.partitions]
        nxt = np.full((num_series, 1), START_MS + T * STEP_MS, np.int64)
        vals = store.cols["count"][:num_series, T - 1:T] + 1.0
        appended = registry.counter("wal_append_bytes", dataset="prometheus")
        a0 = appended.value
        t0 = time.perf_counter()
        seq = nwal.append_grid(0, "prom-counter", keys, nxt, {"count": vals})
        scrape_s = time.perf_counter() - t0
        check(seq == committed + 1,
              f"restart-1M: the scrape after the restart got seq {seq}, "
              f"{committed + 1} expected")
        frame = int(appended.value - a0)
        del keys, vals
    except BaseException:
        node.shutdown()
        raise
    log(f"restart-1M: boot: FiloServer(...) {construct_s:.3f} s, of which "
        f"WalManager (recover_writer_state) {recover_s[0]:.3f} s, replay "
        f"{st_.elapsed_s:.3f} s ({st_.samples_per_sec:.1f} samples/s; "
        f"{st_.records} records, {st_.samples} samples, "
        f"{st_.skipped_records} skipped, {st_.corrupt_segments} corrupt) "
        f"of which ingest_columns {ingest_s[0]:.3f} s (the cardinality "
        f"tracker's series_created {tracker_s[0]:.3f} s of it, "
        f"{root.ts_count} series counted) and reading, decompressing and "
        f"decoding {st_.elapsed_s - ingest_s[0]:.3f} s, the rest of the "
        f"constructor {construct_s - recover_s[0] - replay_s[0]:.3f} s; "
        f"phases {' -> '.join([phases[0][0]] + [p[1] for p in phases])}; "
        f"start() {start_s_:.3f} s; boot to the first answer "
        f"{first_s:.3f} s; launches "
        f"{({k: v for k, v in launches.items() if v})}; host peak RSS "
        f"{rss0} B before the boot, {rss} B after the first panels")
    log(f"restart-1M: continuity: a [{num_series}, 1] scrape record through "
        f"the recovered writer got seq {seq} in {scrape_s:.3f} s, frame "
        f"{frame} B (its segment's first record inlines the "
        f"{num_series}-key table)")

    def decode_one():
        for body in read_records(segs[0][1]):
            return WalRecord.decode(body, {})
    log_profile("restart-1M", None, decode_one,
                label="reading and decoding one build record")
    return eng, node.memstore, node, launches


def paging_precheck_cost(eng, sh, before, want, own_warm_s, start_s,
                         end_s):
    """restart-1M: what the shard's demand-paging precheck costs at 1M
    once its column store holds chunks, as after the node's first flush
    (until then the node's InMemoryColumnStore holds none and no query
    pages).  The shard's store is swapped, for these queries only, for
    an InMemoryColumnStore that reports holding chunks but holds none of
    this shard's series, so every answer must stay bit-identical: the
    first panel warm (3 turns; each runs the precheck over every
    series), then P3's query, which reaches 35 min before the data, once
    on the node's own store and twice on the swapped one (the first
    pages every series' range from the store, the second finds it
    covered)."""
    import torch
    from filodb_tpu_torch.core.store import InMemoryColumnStore
    from filodb_tpu_torch.query.engine import QueryEngine

    class HoldsChunks(InMemoryColumnStore):
        def holds_chunks(self, dataset, shard):
            return True

    q0 = COUNTER_QUERIES[0][0]
    reach = f"max_over_time({q0}[30m:1m])"

    def run(q):
        t0 = time.perf_counter()
        res = eng.query_range(q, start_s + 600, 60, end_s, scan_params())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(res.error is None, f"restart-1M: `{q}`: {res.error}")
        return res, secs

    res, own_reach_s = run(reach)
    want_reach = QueryEngine.to_prom_matrix(res)["data"]["result"]
    own = sh.column_store
    sh.column_store = HoldsChunks()
    try:
        warm = []
        for _ in range(3):
            res, secs = run(q0)
            warm.append(secs)
            got, _, _ = compare(res, want, *KERNEL_TOL,
                                f"restart-1M precheck `{q0}`")
            check(np.array_equal(got, before, equal_nan=True),
                  f"restart-1M: `{q0}` over a store that holds chunks is "
                  f"not bit-identical to the answer before the crash")
        reach_s = []
        for _ in range(2):
            res, secs = run(reach)
            reach_s.append(secs)
            check(QueryEngine.to_prom_matrix(res)["data"]["result"]
                  == want_reach, f"restart-1M: `{reach}` over a store that "
                  f"holds chunks differs from the node's own answer")
    finally:
        sh.column_store = own
    log(f"restart-1M: the demand-paging precheck once the column store "
        f"holds chunks (an InMemoryColumnStore holding none of this "
        f"shard's series; every answer bit-identical): warm `{q0}` p50 "
        f"{np.median(warm):.4f} s (turns {[round(x, 4) for x in warm]}; "
        f"{own_warm_s:.4f} s on the node's own store, which holds none); "
        f"`{reach}` {reach_s[0]:.4f} s paging every series' range, then "
        f"{reach_s[1]:.4f} s ({own_reach_s:.4f} s on the node's own store)")


def run_path(kind, num_series, seed, hole_frac, warm, queries, tol,
             general=(), general_warm=0, keep=False, wal=None, boot=None):
    """Ingest, then drive each query once cold and `warm` times warm
    through QueryEngine.query_range; the launch counts are set to 0 just
    before the first query and read just after the last.  With `wal`
    the build goes through that log, and right after the queries the
    node crashes (the engine and the memstore dropped, no flush) and
    `boot` (boot_node, timed as restart-1M) brings it back from the log
    as a FiloServer; its launches join the path's.  Then, over the same
    store (the recovered node's after a crash), the general-path queries
    `general` (run_queries) -> (launches, rows, general launches, kept):
    with `keep` the engine, its memstore, the oracle's answers, the
    windows and the recovered node (None without `wal`) stay alive for
    later phases (kept = (eng, ms, want, wends, node)), else they are
    freed (None)."""
    import torch
    from filodb_tpu_torch.ops import kernels
    from filodb_tpu_torch.query.engine import QueryEngine
    ragged = bool(hole_frac)
    what = f"{kind} {'ragged' if ragged else 'dense'}"
    ms, want, wends, t = build_store(kind, num_series, seed, hole_frac,
                                     queries, general, wal)
    log(f"{what}: {num_series} series x {T} samples: waited "
        f"{t['gen_s']:.3f} s for the slabs (made "
        f"{'and appended ' if wal is not None else ''}ahead on a thread), "
        f"ingest_columns {t['ingest_s']:.3f} s, oracle "
        f"{t['oracle_s']:.3f} s")
    eng = QueryEngine("prometheus", ms)
    start_s = START_MS // 1000
    end_s = start_s + (T - 1) * STEP_MS // 1000
    schema = "prom-counter" if kind == "counter" else "gauge"

    def query(q):
        t0 = time.perf_counter()
        res = eng.query_range(q, start_s + 600, 60, end_s, scan_params())
        return res, time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    rows_out, last = [], {}
    for qi, (q, _, op, k_dense, k_ragged) in enumerate(queries):
        kernel = k_ragged if ragged else k_dense
        n0 = dict(kernels.LAUNCHES)
        with GcPauses() as pauses:
            res, cold_s = query(q)
        if kernel is not None:
            check(kernels.LAUNCHES[kernel] == n0[kernel] + 1,
                  f"{what}: cold `{q}` did not launch {kernel}")
        else:
            check(kernels.LAUNCHES == n0,
                  f"{what}: `{q}` launched a kernel, expected none")
        warm_s, answers = [], [res]
        for i in range(warm):
            n0 = kernels.LAUNCHES[kernel] if kernel else 0
            r, s = query(q)
            if kernel is not None:
                check(kernels.LAUNCHES[kernel] > n0,
                      f"{what}: warm `{q}` {i} did not launch {kernel}")
            warm_s.append(s)
            answers.append(r)
        rtol, atol = tol
        checked = [compare(r, want[q], rtol, atol, f"{what} `{q}`")
                   for r in answers]
        last[q], err, rel = checked[-1]
        check(np.array_equal(checked[-2][0], checked[-1][0], equal_nan=True),
              f"{what}: two warm answers of `{q}` differ")
        groups = want[q].shape[0]
        payload = QueryEngine.to_prom_matrix(answers[-1])
        check(payload["status"] == "success"
              and len(payload["data"]["result"]) == groups,
              f"{what}: Prometheus matrix of `{q}` has "
              f"{len(payload['data']['result'])} series, expected {groups}")
        p50, p99 = np.percentile(warm_s, 50), np.percentile(warm_s, 99)
        log(f"{what}: `{q}` via {kernel or 'no kernel'}: cold {cold_s:.4f} s "
            f"({pauses}); "
            f"warm x{warm} p50 {p50:.4f} s p99 {p99:.4f} s; oracle max_abs_err "
            f"{err} max_rel_err {rel} (rtol {rtol}, atol {atol}); warm "
            f"answers bit-identical")
        rows_out.append(dict(query=q, kernel=kernel, cold_s=cold_s, p50=p50,
                             p99=p99, err=err))
        if qi == 0:
            log_profile(what, q, lambda: query(q))
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    mirror = ms.get_shard("prometheus", 0).stores[schema].device_mirror
    snap = mirror.snapshot()
    idx = np.arange(num_series)
    gather_ms = cuda_ms(lambda: mirror.gather_cached(idx, snap), reps=5)
    samples = answers[-1].stats.samples_scanned
    log(f"{what}: windows={len(wends)} mirror upload "
        f"{mirror.last_upload_s:.4f} s; leaf gather {gather_ms:.3f} ms; "
        f"samples scanned/query {samples}; max_memory_allocated {peak} B; "
        f"launches {({k: v for k, v in launches.items() if v})}")
    del mirror, snap, answers, res
    node = None
    if wal is not None:
        # the crash, with the answers kept as numpy (`last`)
        eng = ms = r = None
        eng, ms, node, got = boot(wal, num_series, last, want, t)
        for k, c in got.items():
            launches[k] += c
    general_launches = {}
    if general:
        t0 = time.perf_counter()
        general_launches, g_rows = run_queries(
            f"general-1M {kind}", eng, general, want, general_warm,
            start_s, end_s)
        rows_out += g_rows
        log(f"general-1M {kind}: {time.perf_counter() - t0:.1f} s")
    if keep:
        return (launches, rows_out, general_launches,
                (eng, ms, want, wends, node))
    del eng, ms
    free_device_memory()
    return launches, rows_out, general_launches, None


def log_profile(what, q, run, label=None):
    """Where a warm query's host time goes: one more warm run under
    cProfile (host calls that wait on the card show it), top 6 by own
    time; `label` names another profiled call -> run's result."""
    prof = cProfile.Profile()
    prof.enable()
    out = run()
    prof.disable()
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(6)
    top = [ln for ln in buf.getvalue().splitlines()
           if ln.strip() and ln.lstrip()[0].isdigit()]
    log(f"{what}: cProfile of {label or f'one warm `{q}`'}, top 6 by own "
        f"time (ncalls tottime percall cumtime percall function):")
    for ln in top[-6:]:
        log(f"{what}:   {ln.strip()}")
    return out


def free_device_memory():
    """Drop the engine's fused-path caches and return the card's freed
    memory, between cells."""
    import torch
    from filodb_tpu_torch.query import execbase
    for cache in (execbase._FUSED_PLAN_CACHE, execbase._FUSED_VALS_CACHE,
                  execbase._FUSED_GROUP_CACHE,
                  execbase._FUSED_MINMAX_PAD_CACHE):
        cache.clear()
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------- K8: the selection probe

# the Pallas body of tools/probe_slice.py each K8 kernel replaces (the
# bodies its main() launches through run's pallas_call, :98)
PROBE_REPLACES = {"probe_gather": "tools/probe_slice.py:75",
                  "probe_two_gathers": "tools/probe_slice.py:81",
                  "probe_onehot_matmul": "tools/probe_slice.py:89"}


def alternate(fa, fb, rounds=10, reps=20):
    """fa's CUDA-event time over fb's in `rounds` rounds whose turns
    alternate (A B, B A, ...) -> median, min and max of the ratios."""
    ratios = []
    for k in range(rounds):
        t = {}
        for f in ((fa, fb) if k % 2 == 0 else (fb, fa)):
            t[f] = cuda_ms(f, reps=reps)
        ratios.append(t[fa] / t[fb])
    r = np.asarray(ratios)
    return dict(rounds=rounds, median=float(np.median(r)),
                min=float(r.min()), max=float(r.max()))


def run_probe_phase(dev, seed):
    """K8: the probe's own entry point (filodb_tpu_torch.tools.probe_slice
    main, its main path) with the launch counts set to 0 just before and
    read just after; then each kernel at the probe's shape against its
    plain version to the bit, timed beside one library call and its
    bound and against that call in alternating rounds, and the product on
    the adversarial inputs -> (table rows, launches)."""
    import torch
    from filodb_tpu_torch.ops import kernels, probe
    from filodb_tpu_torch.tools import probe_slice as ps
    kernels.reset_launch_counts()
    ps.main(["--grid", str(ps.GRID)])
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in PROBE_REPLACES}
    check(all(launches.values()),
          f"K8: the probe's entry point did not launch {launches}")
    x, o, i1, i2 = ps.inputs(ps.GRID, dev)
    rows, K = x.shape
    W, WP = ps.W, ps.WP
    sel1 = i1[:W].cpu().numpy()
    sel2 = i2[:W].cpu().numpy()

    def sectors(cols):
        return np.unique(np.asarray(cols) * 4 // SECTOR).size
    idx1 = i1[:W].long()
    # x[:, i2] - x[:, i1] as one product: +1 at (i2[w], w), -1 at
    # (i1[w], w); two nonzero terms a column, so exact in any order
    diff = torch.zeros(K, WP, dtype=x.dtype, device=dev)
    cols = torch.arange(W, device=dev)
    diff[i2[:W].long(), cols] = 1.0
    diff[idx1, cols] = -1.0
    nnz = int((o != 0).sum())      # o's nonzero entries, NaN included
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [
        ("probe_gather", lambda: probe.probe_gather(x, i1, W, WP),
         lambda: probe.probe_gather_plain(x, i1, W, WP),
         ("index_select", lambda: torch.index_select(x, 1, idx1)),
         rows * (sectors(sel1) * SECTOR + WP * 4), 0),
        ("probe_two_gathers", lambda: probe.probe_two_gathers(x, i1, i2, W,
                                                              WP),
         lambda: probe.probe_two_gathers_plain(x, i1, i2, W, WP),
         ("matmul FP32 by +1/-1, TF32 off", lambda: torch.matmul(x, diff)),
         rows * (sectors(np.union1d(sel1, sel2)) * SECTOR + WP * 4),
         rows * W),
        ("probe_onehot_matmul", lambda: probe.probe_onehot_matmul(x, o),
         lambda: probe.probe_onehot_matmul_plain(x, o),
         ("matmul FP32, TF32 off", lambda: torch.matmul(x, o)),
         4 * (rows * K + K * WP + rows * WP), 2 * rows * nnz),
    ]
    table = {}
    try:
        for name, kern, plain, lib, nbytes, ops in cases:
            got, again, want = kern(), kern(), plain()
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"{name}: two runs differ")
            check(same_bits(got, want),
                  f"{name}: kernel and plain differ in some bit")
            if lib[1]().shape == want.shape:
                check(torch.equal(lib[1](), want),
                      f"{name}: {lib[0]} and plain differ")
            ms = cuda_ms(kern, reps=20)
            plain_ms = cuda_ms(plain, reps=5)
            library_ms = cuda_ms(lib[1], reps=20)
            ab = alternate(kern, lib[1])
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
            bound_ms = 1e3 * max(t_bytes, t_ops)
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            log(f"K8 {name} [{rows}, {K}] -> [{rows}, {WP}]: bit-identical "
                f"to plain; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"{lib[0]} {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}: {nbytes} B, {ops} FP32 operations); kernel "
                f"over {lib[0]} in {ab['rounds']} alternating rounds: "
                f"median {ab['median']:.4f} ({ab['min']:.4f}-"
                f"{ab['max']:.4f})")
            table[name] = dict(
                max_abs_err=float((got - want).abs().max()), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, yardsticks={lib[0]: library_ms},
                ab_vs_library=ab,
                source="filodb_tpu_torch/csrc/probe_select.cu")
        # the gather like for like: index_select returns [rows, W], so the
        # kernel is timed at WP = W too (no zero columns to write)
        def gather_w():
            return probe.probe_gather(x, i1, W, W)

        def select_w():
            return torch.index_select(x, 1, idx1)
        got, want = gather_w(), select_w()
        torch.cuda.synchronize()
        check(same_bits(got, want), "probe_gather at [rows, W]: kernel and "
              "index_select differ in some bit")
        nbytes = rows * (sectors(sel1) * SECTOR + W * 4)
        eq = dict(shape=[rows, W], ms=cuda_ms(gather_w, reps=20),
                  library_ms=cuda_ms(select_w, reps=20),
                  bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes",
                  ab_vs_library=alternate(gather_w, select_w))
        table["probe_gather"]["equal_output"] = eq
        ab = eq["ab_vs_library"]
        log(f"K8 probe_gather [{rows}, {K}] -> [{rows}, {W}] (index_select's "
            f"output): bit-identical to index_select; kernel "
            f"{eq['ms']:.4f} ms, index_select {eq['library_ms']:.4f} ms, "
            f"bound {eq['bound_ms']:.4f} ms (bytes: {nbytes} B); kernel "
            f"over index_select in {ab['rounds']} alternating rounds: median "
            f"{ab['median']:.4f} ({ab['min']:.4f}-{ab['max']:.4f})")
        del diff
        xa, oa = ps.adversarial_inputs(rows, dev, seed)
        got = probe.probe_onehot_matmul(xa, oa)
        again = probe.probe_onehot_matmul(xa, oa)
        want = probe.probe_onehot_matmul_plain(xa, oa)
        torch.cuda.synchronize()
        check(same_bits(got, again), "probe_onehot_matmul: two runs on the "
              "adversarial inputs differ")
        check(same_bits(got, want), "probe_onehot_matmul: kernel and plain "
              "differ in some bit on the adversarial inputs")
        log(f"K8 probe_onehot_matmul adversarial [{rows}, {K}] -> [{rows}, "
            f"{WP}]: bit-identical to plain, {int(torch.isnan(got).sum())} "
            f"NaN cells, {int(torch.isinf(got).sum())} +-Inf, "
            f"{int((got == 0).sum())} zeros")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    del x, o, xa, oa, got, again, want
    gc.collect()
    torch.cuda.empty_cache()
    return table, launches


# ------------------------------ hist-classic-1M: classic histograms

LES = ["0.005", "0.01", "0.025", "0.05", "0.1", "0.25", "0.5", "1", "2.5",
       "5", "10", "25", "50", "100", "250", "+Inf"]
HIST_COUNT = 65_536                # x 16 buckets = 1,048,576 series
HIST_QUERY = ("histogram_quantile(0.9, sum by (le, _ns_) "
              "(rate(http_latency_bucket[5m])))")


def oracle_bucket_quantile(q, cum, les):
    """Prometheus' bucketQuantile in f64 over cumulative bucket rates
    [G, W, B] (les ascending, the last +Inf), with its monotonic fix-up:
    the first bucket reaching q x total, linear inside it from the bucket
    below (from 0 for the first); the +Inf bucket gives the highest finite
    le; no observations -> NaN."""
    cum = np.maximum.accumulate(cum, axis=-1)
    total = cum[..., -1]
    rank = q * total
    idx = np.argmax(cum >= rank[..., None], axis=-1)

    def take(a, i):
        return np.take_along_axis(a, i[..., None], axis=-1)[..., 0]
    lower = np.where(idx > 0, les[np.maximum(idx - 1, 0)], 0.0)
    c_lo = np.where(idx > 0, take(cum, np.maximum(idx - 1, 0)), 0.0)
    c_hi = take(cum, idx)
    with np.errstate(invalid="ignore", divide="ignore"):
        frac = np.where(c_hi > c_lo, (rank - c_lo) / (c_hi - c_lo), 0.0)
    out = lower + (les[idx] - lower) * frac
    out = np.where(idx == les.size - 1, les[-2], out)
    return np.where(total > 0, out, np.nan)


def run_hist_path(num_hist, seed, warm, dev):
    """hist-classic-1M: num_hist classic histograms x 16 `le` buckets,
    each bucket a cumulative http_latency_bucket counter (_ns_ =
    App-{h % NUM_NS}), made on the card slab by slab and ingested through
    TimeSeriesShard.ingest_columns; the f64 oracle (bucket rates by
    oracle_rates_t, summed by (le, _ns_), then oracle_bucket_quantile) is
    computed on the card beside them.  Then G6 through
    QueryEngine.query_range (run_queries) -> (launches, rows)."""
    import torch
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.core.partkey import PartKey
    from filodb_tpu_torch.query.engine import QueryEngine
    B = len(LES)
    les = np.array([float(x) for x in LES])
    ms = TimeSeriesMemStore()
    shard = ms.setup("prometheus", 0)
    ts_row = START_MS + np.arange(T, dtype=np.int64) * STEP_MS
    wends = np.arange(START_MS + 600_000, int(ts_row[-1]) + 1, 60_000)
    W = len(wends)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    sums = torch.zeros((NUM_NS * B, W), dtype=torch.float64, device=dev)
    per_slab = SLAB // B
    gen_s = ingest_s = oracle_s = 0.0
    for h0 in range(0, num_hist, per_slab):
        nh = min(per_slab, num_hist - h0)
        t0 = time.perf_counter()
        inc = torch.poisson(torch.full((nh, T, B), 2.0, device=dev),
                            generator=gen).double()
        vals = inc.cumsum(1).cumsum(2).permute(0, 2, 1).reshape(nh * B, T)
        keys = [PartKey.make("http_latency_bucket", {
            "_ws_": "demo", "_ns_": f"App-{h % NUM_NS}",
            "instance": f"Instance-{h}", "le": le})
            for h in range(h0, h0 + nh) for le in LES]
        host = vals.cpu().numpy()
        t1 = time.perf_counter()
        shard.ingest_columns("prom-counter", keys,
                             np.broadcast_to(ts_row, (nh * B, T)),
                             {"count": host})
        t2 = time.perf_counter()
        rates = oracle_rates_t(vals, ts_row, wends)["rate"]
        g = ((torch.arange(h0, h0 + nh, device=dev) % NUM_NS)[:, None] * B
             + torch.arange(B, device=dev)[None, :]).reshape(-1)
        sums.index_add_(0, g, torch.nan_to_num(rates, nan=0.0))
        torch.cuda.synchronize()
        gen_s += t1 - t0
        ingest_s += t2 - t1
        oracle_s += time.perf_counter() - t2
        del inc, vals, rates, host
    want = oracle_bucket_quantile(
        0.9, sums.reshape(NUM_NS, B, W).permute(0, 2, 1).cpu().numpy(), les)
    del sums
    log(f"hist-classic-1M: {num_hist} histograms x {B} buckets = "
        f"{num_hist * B} series x {T} samples: generate on the card "
        f"{gen_s:.3f} s, ingest_columns {ingest_s:.3f} s, f64 oracle "
        f"{oracle_s:.3f} s")
    eng = QueryEngine("prometheus", ms)
    start_s = START_MS // 1000
    end_s = start_s + (T - 1) * STEP_MS // 1000
    spec = dict(name="G6", query=HIST_QUERY, tol=(2e-4, 1e-3),
                kernels=("fused_rate_dense",))
    launches, rows = run_queries("hist-classic-1M", eng, [spec],
                                 {HIST_QUERY: want}, warm, start_s, end_s)
    del eng, ms
    free_device_memory()
    return launches, rows, want


# ------------------------------- hist-native-1M: native histograms

HIST_NATIVE_QUERY = ("histogram_quantile(0.9, sum(rate(http_latency[5m])) "
                     "by (_ns_))")        # bench.py:908-910, word for word
HIST_SERIES_QUERY = "histogram_quantile(0.9, rate(http_latency[5m]))"
NATIVE_RAGGED_COUNT = 4_096


def native_hist_store(num_hist, seed, dev, hole_frac=0.0):
    """num_hist native histograms x the 16 LES buckets x T samples
    (http_latency, _ns_ = App-{h % NUM_NS}) made on the card slab by slab
    with hist-classic-1M's Poisson generator and seed, so both hold the
    same counts, and ingested as [S, T, B] columns through
    TimeSeriesShard.ingest_columns.  hole_frac drops whole scrapes (every
    bucket, sum and count of a series at one sample).  The f64 oracle:
    per (histogram, window, bucket) rates by oracle_rates_t (NaN samples
    absent), then oracle_bucket_quantile per histogram ([H, W]) and, of
    the sums by _ns_, per group ([NUM_NS, W]) -> (memstore, the two
    oracles, each histogram's counts at its last sample [H, B], timings)."""
    import torch
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.core.partkey import PartKey
    B = len(LES)
    les = np.array([float(x) for x in LES])
    ms = TimeSeriesMemStore()
    shard = ms.setup("prometheus", 0)
    ts_row = START_MS + np.arange(T, dtype=np.int64) * STEP_MS
    wends = np.arange(START_MS + 600_000, int(ts_row[-1]) + 1, 60_000)
    W = len(wends)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    sums = torch.zeros((NUM_NS, W, B), dtype=torch.float64, device=dev)
    per_series = np.empty((num_hist, W))
    last = np.empty((num_hist, B))
    per_slab = SLAB // B
    gen_s = ingest_s = oracle_s = 0.0
    for h0 in range(0, num_hist, per_slab):
        nh = min(per_slab, num_hist - h0)
        t0 = time.perf_counter()
        inc = torch.poisson(torch.full((nh, T, B), 2.0, device=dev),
                            generator=gen).double()
        h = inc.cumsum(1).cumsum(2)                       # [nh, T, B]
        if hole_frac:
            h[torch.rand((nh, T), generator=gen, device=dev) < hole_frac] \
                = float("nan")
        keys = [PartKey.make("http_latency", {
            "_ws_": "demo", "_ns_": f"App-{i % NUM_NS}",
            "instance": f"Instance-{i}"}) for i in range(h0, h0 + nh)]
        host = h.cpu().numpy()
        last[h0:h0 + nh] = host[:, -1, :]
        t1 = time.perf_counter()
        shard.ingest_columns(
            "prom-histogram", keys, np.broadcast_to(ts_row, (nh, T)),
            {"h": host, "count": host[..., -1],
             "sum": host[..., -1] * 0.25}, bucket_les=les)
        t2 = time.perf_counter()
        rates = oracle_rates_t(h.permute(0, 2, 1).reshape(nh * B, T),
                               ts_row, wends)["rate"]
        rates = rates.reshape(nh, B, W).permute(0, 2, 1)   # [nh, W, B]
        g = torch.arange(h0, h0 + nh, device=dev) % NUM_NS
        sums.index_add_(0, g, torch.nan_to_num(rates, nan=0.0))
        per_series[h0:h0 + nh] = oracle_bucket_quantile(
            0.9, rates.cpu().numpy(), les)
        torch.cuda.synchronize()
        gen_s += t1 - t0
        ingest_s += t2 - t1
        oracle_s += time.perf_counter() - t2
        del inc, h, rates, host
    grouped = oracle_bucket_quantile(0.9, sums.cpu().numpy(), les)
    return ms, grouped, per_series, last, dict(
        gen_s=gen_s, ingest_s=ingest_s, oracle_s=oracle_s)


def run_hist_native_path(num_hist, seed, warm, dev, classic_want):
    """hist-native-1M: the bench's native panel HIST_NATIVE_QUERY (K1 over
    num_hist x 16 flattened bucket rows, 16,000 (group, bucket) slots)
    held to hist-classic-1M's oracle `classic_want` (the same counts), and
    the general path's per-histogram HIST_SERIES_QUERY held to its own
    f64 oracle; then NATIVE_RAGGED_COUNT histograms with ~1% whole-scrape
    holes through K3; between them, over the 1M store, host-route-1M's
    native instant query (run_hist_instant) -> (launches, rows, that
    query's row)."""
    from filodb_tpu_torch.query.engine import QueryEngine
    start_s = START_MS // 1000
    end_s = start_s + (T - 1) * STEP_MS // 1000
    launches, rows = {}, []
    for what, n, hole, tol in (
            ("hist-native-1M", num_hist, 0.0, (2e-4, 1e-3)),
            ("hist-native-ragged", NATIVE_RAGGED_COUNT, 0.01, (5e-4, 1e-4))):
        ms, grouped, per_series, last, t = native_hist_store(
            n, seed + (1 if hole else 0), dev, hole)
        if not hole:
            # the same counts: the two oracles differ only in the order
            # of their f64 group sums
            check(np.allclose(grouped, classic_want, rtol=1e-9, atol=0,
                              equal_nan=True),
                  f"{what}: the counts differ from hist-classic-1M's")
        log(f"{what}: {n} native histograms x {len(LES)} buckets x {T} "
            f"samples: generate on the card {t['gen_s']:.3f} s, "
            f"ingest_columns {t['ingest_s']:.3f} s, f64 oracle "
            f"{t['oracle_s']:.3f} s")
        eng = QueryEngine("prometheus", ms)
        specs = [dict(name="panel", query=HIST_NATIVE_QUERY, tol=tol,
                      kernels=("fused_rate_ragged" if hole
                               else "fused_rate_dense",))]
        want = {HIST_NATIVE_QUERY: classic_want if not hole else grouped}
        if not hole:
            # one value a histogram and window: over the default result
            # limit of 1,000,000 samples at 65,536 histograms
            specs.append(dict(name="per-series", query=HIST_SERIES_QUERY,
                              tol=tol, kernels=(), label="instance",
                              warm=2, params=scan_params(
                                  sample_limit=per_series.size)))
            want[HIST_SERIES_QUERY] = per_series
        got, r = run_queries(what, eng, specs, want, warm, start_s, end_s)
        mirror = ms.get_shard("prometheus", 0) \
            .stores["prom-histogram"].device_mirror
        snap = mirror.snapshot()
        idx = np.arange(n)
        log(f"{what}: mirror upload {mirror.last_upload_s:.3f} s; the "
            f"leaf's gather of [{n}, {T}, {len(LES)}] "
            f"{cuda_ms(lambda: mirror.gather_cached(idx, snap), reps=5):.3f}"
            f" ms")
        if not hole:
            log_profile(what, HIST_NATIVE_QUERY, lambda: eng.query_range(
                HIST_NATIVE_QUERY, start_s + 600, 60, end_s, scan_params()))
            hist_instant = run_hist_instant(eng, last, warm, end_s)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        rows += r
        del eng, ms, mirror, snap
        free_device_memory()
    return launches, rows, hist_instant


# ------------------------------ host-route-1M and promql-1M

H_QUERIES = [
    # (name, PromQL, oracle key, instant)
    ("H1", "sum by (_ns_) (changes(request_total[5m]))", "changes", False),
    ("H2", "max by (_ns_) (max_over_time(request_total[5m]))", "max",
     False),
    ("H3", "sum by (_ns_) (resets(request_total[5m]))", "resets", True),
]
ROUTER_SERIES = 2_048
# Instance-0 .. Instance-2047: the first ROUTER_SERIES series of the store
ROUTER_QUERY = ('sum by (_ns_) (rate(request_total{instance=~"Instance-'
                '([0-9]|[1-9][0-9]|[1-9][0-9][0-9]|1[0-9][0-9][0-9]|'
                '20[0-3][0-9]|204[0-7])"}[5m]))')
HIST_INSTANT_QUERY = "histogram_quantile(0.9, http_latency)"
RATE_Q = COUNTER_QUERIES[0][0]          # sum by (_ns_) (rate(...[5m]))
P_QUERIES = [
    ("P1", f"sort_desc({RATE_Q})"),
    ("P2", "sum by (_ns_) (rate(request_total[5m] @ end()))"),
    ("P3", f"max_over_time({RATE_Q}[30m:1m])"),
    ("P4", f'label_replace({RATE_Q}, "app", "$1", "_ns_", "App-(.*)")'),
    ("P5", f"{RATE_Q} / scalar(sum(rate(request_total[5m])))"),
]
ABSENT_QUERIES = [('absent(request_total{_ns_="App-1"})', 0),
                  ('absent(nonexistent_metric{_ns_="App-1"})', 1)]


def host_rss() -> int:
    """Peak resident set of this process, bytes."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def rss_now() -> int:
    """Resident set of this process now, bytes."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def meminfo() -> dict:
    """The machine's /proc/meminfo, bytes."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":", 1)
            out[k] = int(v.split()[0]) * 1024
    return out


def wait_for_host_memory(need, what, limit_s):
    """Wait until the machine has `need` bytes available (MemAvailable),
    at most limit_s seconds; log the wait -> seconds waited."""
    t0 = time.perf_counter()
    while True:
        avail, waited = meminfo()["MemAvailable"], time.perf_counter() - t0
        if avail >= need or waited >= limit_s:
            break
        time.sleep(1.0)
    log(f"{what}: waited {waited:.1f} s for {need / 2.0 ** 30:.0f} GiB of "
        f"host memory; {avail / 2.0 ** 30:.2f} GiB available"
        + ("" if avail >= need else " (the wait's limit came first)"))
    return waited


def fs_type(path) -> str:
    """The type of the filesystem `path` lies on, from /proc/mounts."""
    path, best, kind = os.path.realpath(path), "", "?"
    with open("/proc/mounts") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            mnt = parts[1].replace("\\040", " ")
            inside = path == mnt or path.startswith(mnt.rstrip("/") + "/")
            if inside and len(mnt) >= len(best):
                best, kind = mnt, parts[2]
    return kind


def keep_temp_files_on_disk(need=64 * 2 ** 30):
    """Where TMPDIR lies on a filesystem in memory (tmpfs, ramfs) and the
    checkout's does not and has `need` bytes free, point TMPDIR (this
    process's and its children's) at a new directory under the
    checkout's .scratch/: the 1M phases' WALs and stores, ~20 GB, would
    otherwise count against the host's memory.  -> that directory, to
    remove at the end, or None."""
    tmp = tempfile.gettempdir()
    here = os.path.dirname(os.path.abspath(__file__))
    kinds = (fs_type(tmp), fs_type(here))
    free = shutil.disk_usage(here).free
    moved = (kinds[0] in ("tmpfs", "ramfs") and kinds[1] not in
             ("tmpfs", "ramfs") and free >= need)
    new = None
    if moved:
        os.makedirs(os.path.join(here, ".scratch"), exist_ok=True)
        new = tempfile.mkdtemp(prefix="smoke-tmp-",
                               dir=os.path.join(here, ".scratch"))
        os.environ["TMPDIR"] = new
        tempfile.tempdir = None
    log(f"temporary files: TMPDIR {tmp} ({kinds[0]}), the checkout "
        f"{here} ({kinds[1]}, {free} B free)"
        + (f"; TMPDIR is now {new}" if moved else ""))
    return new


class HostMemoryWatch:
    """A thread that samples, each second, the memory the machine has in
    use (MemTotal - MemAvailable) and the resident sets of this script's
    processes, each under the side process (or this one) it descends
    from; it keeps the peak in use, when it came and the split at it, and
    one sample a minute.  `sides` ({name: (Popen, out)}) may grow while
    it runs."""

    def __init__(self, sides):
        self.sides, self.t0 = sides, time.perf_counter()
        self.total = meminfo()["MemTotal"]
        self.peak, self.peak_at, self.peak_split = 0, 0.0, {}
        self.minutes = []
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self.run, daemon=True)
        self.thread.start()

    def split(self):
        """Resident bytes of this script's processes, by the side (or
        "main", "main's children") each descends from."""
        page = os.sysconf("SC_PAGE_SIZE")
        parent, rss = {}, {}
        for d in os.listdir("/proc"):
            if not d.isdigit():
                continue
            try:
                with open(f"/proc/{d}/stat") as f:
                    parent[int(d)] = int(f.read().rsplit(")", 1)[1].split()[1])
                with open(f"/proc/{d}/statm") as f:
                    rss[int(d)] = int(f.read().split()[1]) * page
            except (OSError, IndexError, ValueError):
                continue
        me = os.getpid()
        names = {proc.pid: which for which, (proc, _) in
                 list(self.sides.items())}
        names[me] = "main"
        out = {}
        for pid, b in rss.items():
            p = pid
            while p not in names and p in parent and p > 1:
                p = parent[p]
            if p not in names:
                continue
            name = ("main's children" if p == me and pid != me
                    else names[p])
            out[name] = out.get(name, 0) + b
        return out

    def run(self):
        while not self.stop.wait(1.0):
            info = meminfo()
            used = self.total - info["MemAvailable"]
            t = time.perf_counter() - self.t0
            if used > self.peak:
                self.peak, self.peak_at = used, t
                self.peak_split = self.split()
                self.peak_split["shared memory and tmpfs"] = info["Shmem"]
            if t >= 60 * len(self.minutes):
                self.minutes.append(used)

    def report(self):
        self.stop.set()
        self.thread.join()
        gib = 2.0 ** 30
        log(f"host memory: MemTotal {self.total / gib:.2f} GiB; peak in "
            f"use {self.peak / gib:.2f} GiB at {self.peak_at:.0f} s after "
            f"the sides started (resident then: " + ", ".join(
                f"{k} {v / gib:.2f}" for k, v in
                sorted(self.peak_split.items())) + " GiB); in use each "
            f"minute: " + ", ".join(f"{u / gib:.1f}" for u in self.minutes)
            + " GiB")


def store_rows(ms, num_series):
    """The counter store of the dense 1M memstore, after checking that
    series i (instance Instance-i) sits in row i, as ingest_columns
    created them."""
    shard = ms.get_shard("prometheus", 0)
    store = shard.stores["prom-counter"]
    for pid in (0, num_series // 2, num_series - 1):
        p = shard.partitions[pid]
        check(p.row == pid and p.part_key.tags_dict["instance"]
              == f"Instance-{pid}", f"series {pid} is not in row {pid}")
    return store


def raw_oracles(store, num_series, ts_row, wends, inst_wend, inner_wends,
                dev):
    """From the store's raw slab, slab by slab on the card, by _ns_
    ([NUM_NS, W]): changes counted over the values as the device holds
    them (rebased by the first sample the leaf's gather copies, in f32)
    and in f64; the f64 raw maximum; resets in the one window ending at
    inst_wend; the rate oracle (oracle_rates_t) in the window ending at
    inst_wend and over the subquery's inner grid (NaN before the data)
    -> dict."""
    import torch
    # the first column the leaf's host gather copies of each row
    # (DenseSeriesStore.window_positions over the chunk-scan span): its
    # values are rebased by their first sample there
    lo = store.window_positions(int(wends[0]) - RANGE_MS, inst_wend)[0]
    first, last = window_bounds(ts_row, wends)
    f_i, l_i = window_bounds(ts_row, np.asarray([inst_wend]))
    live = inner_wends >= ts_row[0]
    W = len(wends)

    def zeros(width, fill=0.0):
        return torch.full((NUM_NS, width), fill, dtype=torch.float64,
                          device=dev)
    out = {"changes32": zeros(W), "changes64": zeros(W),
           "max": zeros(W, float("-inf")), "resets": zeros(1),
           "rate_at_end": zeros(1), "inner_rate": zeros(int(live.sum()))}
    for i0 in range(0, num_series, SLAB):
        i1 = min(i0 + SLAB, num_series)
        v = torch.from_numpy(np.ascontiguousarray(
            store.cols["count"][i0:i1, :T])).to(dev)
        g = torch.arange(i0, i1, device=dev) % NUM_NS
        x32 = (v[:, lo:] - v[:, lo:lo + 1]).float()

        def pair_counts(ind, fi, la):
            # ind[:, j] flags the pair (j, j+1); a window [f, l] counts
            # the pairs whose both samples it holds
            c = torch.cat([torch.zeros_like(ind[:, :1]),
                           torch.cumsum(ind, dim=1)], dim=1)
            fi = torch.from_numpy(fi).to(dev)
            la = torch.from_numpy(la).to(dev)
            return (c[:, la] - c[:, fi]).double()
        out["changes32"].index_add_(0, g, pair_counts(
            (x32[:, 1:] != x32[:, :-1]).long(), first - lo, last - lo))
        out["changes64"].index_add_(0, g, pair_counts(
            (v[:, 1:] != v[:, :-1]).long(), first, last))
        out["resets"].index_add_(0, g, pair_counts(
            (v[:, 1:] < v[:, :-1]).long(), f_i, l_i))
        mx = torch.stack([v[:, a:b + 1].amax(dim=1)
                          for a, b in zip(first, last)], dim=1)
        out["max"].scatter_reduce_(0, g[:, None].expand_as(mx), mx, "amax")
        rates = oracle_rates_t(v, ts_row, inner_wends[live])["rate"]
        out["inner_rate"].index_add_(0, g, torch.nan_to_num(rates, nan=0.0))
        out["rate_at_end"].index_add_(0, g, oracle_rates_t(
            v, ts_row, np.asarray([inst_wend]))["rate"])
        del v, x32, mx, rates
    res = {k: t.cpu().numpy() for k, t in out.items()}
    inner = np.full((NUM_NS, len(inner_wends)), np.nan)
    inner[:, live] = res.pop("inner_rate")
    # a window with fewer than two samples has no rate in any series
    n_inner = np.searchsorted(ts_row, inner_wends, side="right") \
        - np.searchsorted(ts_row, inner_wends - RANGE_MS + 1)
    inner[:, n_inner < 2] = np.nan
    res["inner_rate"] = inner
    res["inner_wends"] = inner_wends
    return res


def timed_runs(eng, q, reps, instant, end_s, start_s, kernels_each=(),
               routed_each=False, no_kernel=False):
    """One cold and `reps` warm runs -> (results, seconds); each run
    must launch every kernel of `kernels_each`, route a leaf to the host
    where `routed_each`, and launch nothing where `no_kernel`."""
    import torch
    from filodb_tpu_torch.ops import kernels
    from filodb_tpu_torch.utils.counters import counters
    out, secs = [], []
    for i in range(reps + 1):
        n0, r0 = dict(kernels.LAUNCHES), counters.get("leaf_host_routed")
        t0 = time.perf_counter()
        res = (eng.query_instant(q, end_s, scan_params()) if instant
               else eng.query_range(q, start_s + 600, 60, end_s,
                                    scan_params()))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        check(res.error is None, f"`{q}` run {i}: {res.error}")
        for k in kernels_each:
            check(kernels.LAUNCHES[k] > n0[k],
                  f"`{q}` run {i} did not launch {k}")
        if no_kernel:
            check(kernels.LAUNCHES == n0, f"`{q}` run {i} launched a kernel")
        if routed_each:
            check(counters.get("leaf_host_routed") > r0,
                  f"`{q}` run {i} routed no leaf to the host")
        out.append(res)
    return out, secs


def warm_line(secs):
    warm = secs[1:]
    return (f"cold {secs[0]:.4f} s; warm x{len(warm)} p50 "
            f"{np.percentile(warm, 50):.4f} s p99 "
            f"{np.percentile(warm, 99):.4f} s")


def same_answers(a, b, what):
    """Two results' series and values, bit for bit."""
    ka = [(k.labels, np.asarray(v).tobytes()) for k, _, v in a.series()]
    kb = [(k.labels, np.asarray(v).tobytes()) for k, _, v in b.series()]
    check(ka == kb, f"{what}: two warm answers differ")


def run_host_route_phase(eng, ms, num_series, wends, warm, dev):
    """host-route-1M over the dense counter store: H1-H3 (the windowed
    host gather of raw values, then the general path on the card), each
    held to its oracle from the raw slab; then the router at
    ROUTER_SERIES series, once with the router switched on
    (FILODB_TPU_FORCE_HOST_ROUTE) and once off, the default (K1)
    -> (launches, rows)."""
    import torch
    from filodb_tpu_torch.ops import kernels
    start_s = START_MS // 1000
    end_s = start_s + (T - 1) * STEP_MS // 1000
    ts_row = START_MS + np.arange(T, dtype=np.int64) * STEP_MS
    store = store_rows(ms, num_series)
    t0 = time.perf_counter()
    from filodb_tpu_torch.promql.parser import (TimeStepParams,
                                                query_range_to_logical_plan)
    inner = query_range_to_logical_plan(
        P_QUERIES[2][1], TimeStepParams(start_s + 600, 60, end_s)).inner
    inner_wends = np.arange(inner.start_ms, inner.end_ms + 1,
                            inner.step_ms, dtype=np.int64)
    orc = raw_oracles(store, num_series, ts_row, wends, end_s * 1000,
                      inner_wends, dev)
    log(f"host-route-1M: oracles from the raw slab on the card "
        f"{time.perf_counter() - t0:.3f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    rows = []
    for name, q, key, instant in H_QUERIES:
        # H1's one warm run is the profiled one
        reps = warm if instant else (0 if name == "H1" else 1)
        runs, secs = timed_runs(eng, q, reps, instant, end_s, start_s)
        if name == "H1":
            # the main thread's view: the host gather's worker threads
            # show as the wait on their futures
            t0 = time.perf_counter()
            runs.append(log_profile(
                "host-route-1M", q, lambda: eng.query_range(
                    q, start_s + 600, 60, end_s, scan_params())))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            check(runs[-1].error is None,
                  f"host-route-1M H1 profiled run: {runs[-1].error}")
        # counts are exact; the maximum within the rate tolerance
        want = orc["changes32" if key == "changes" else key]
        tol = (2e-4, 1e-3) if key == "max" else (0.0, 0.0)
        checked = [compare(r, want, tol[0], tol[1], f"host-route-1M {name}")
                   for r in runs]
        same_answers(runs[-2], runs[-1], f"host-route-1M {name}")
        extra = ""
        if key == "changes":
            d = np.abs(checked[-1][0] - orc["changes64"])
            extra = (f"; the f64 count differs in {int((d > 0).sum())} of "
                     f"{d.size} cells, by at most {d.max():.0f}")
        if instant:
            payload = eng.to_prom_vector(runs[-1])
            check(len(payload["data"]["result"]) == NUM_NS,
                  f"host-route-1M {name}: to_prom_vector has "
                  f"{len(payload['data']['result'])} results")
            extra += f"; to_prom_vector {NUM_NS} results"
        st = runs[-1].stats
        log(f"host-route-1M: {name} `{q}`{' (query_instant)' * instant}: "
            f"{warm_line(secs)}; oracle max_abs_err {checked[-1][1]} "
            f"(rtol {tol[0]}, atol {tol[1]}){extra}; samples scanned "
            f"{st.samples_scanned}; host gather {st.cpu_seconds:.4f} s; "
            f"upload {st.transfer_s:.4f} s "
            f"({st.bytes_transferred} B); max_memory_allocated "
            f"{torch.cuda.max_memory_allocated()} B; peak host RSS "
            f"{host_rss()} B; warm answers bit-identical")
        rows.append(dict(query=q, cold_s=secs[0],
                         p50=float(np.percentile(secs[1:], 50))))
    # the router: ROUTER_SERIES series, under query.host_route_max_samples
    # when it is switched on
    v = torch.from_numpy(np.ascontiguousarray(
        store.cols["count"][:ROUTER_SERIES, :T])).to(dev)
    rates = torch.nan_to_num(oracle_rates_t(v, ts_row, wends)["rate"])
    want = torch.zeros((NUM_NS, len(wends)), dtype=torch.float64,
                       device=dev).index_add_(
        0, torch.arange(ROUTER_SERIES, device=dev) % NUM_NS, rates)
    want = want.cpu().numpy()
    del v, rates
    p50 = {}
    for label, routed in (("routed", True), ("router off", False)):
        if routed:
            os.environ["FILODB_TPU_FORCE_HOST_ROUTE"] = "1"
        try:
            runs, secs = timed_runs(
                eng, ROUTER_QUERY, warm, False, end_s, start_s,
                kernels_each=() if routed else ("fused_rate_dense",),
                routed_each=routed, no_kernel=routed)
        finally:
            os.environ.pop("FILODB_TPU_FORCE_HOST_ROUTE", None)
        _, err, _ = compare(runs[-1], want, 2e-4, 1e-3,
                            f"host-route-1M router {label}")
        same_answers(runs[-2], runs[-1], f"host-route-1M router {label}")
        p50[label] = float(np.percentile(secs[1:], 50))
        log(f"host-route-1M: router at {ROUTER_SERIES} series "
            f"({runs[-1].stats.samples_scanned} samples scanned), {label}: "
            f"{warm_line(secs)}; host gather "
            f"{runs[-1].stats.cpu_seconds:.4f} s; oracle max_abs_err {err}")
    log(f"host-route-1M: router crossover evidence at {ROUTER_SERIES} "
        f"series: warm p50 routed {p50['routed']:.4f} s, router off "
        f"{p50['router off']:.4f} s")
    rows.append(dict(query=ROUTER_QUERY, **{f"p50_{k}": v
                                            for k, v in p50.items()}))
    launches = dict(kernels.LAUNCHES)
    log(f"host-route-1M: launches "
        f"{({k: n for k, n in launches.items() if n})}")
    return launches, rows, orc


def run_hist_instant(eng, last, warm, end_s):
    """host-route-1M's native histogram query: HIST_INSTANT_QUERY through
    query_instant at the grid's end, a 3-d host gather of the store's
    histograms x ~30 samples x 16 buckets, held to an f64 oracle of the
    raw cumulative counts at the last sample in the lookback -> row."""
    import torch
    from filodb_tpu_torch.ops import kernels
    les = np.array([float(x) for x in LES])
    want = oracle_bucket_quantile(0.9, last[:, None, :], les)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    runs, secs = timed_runs(eng, HIST_INSTANT_QUERY, warm, True, end_s,
                            START_MS // 1000)
    checked = [compare(r, want, 2e-4, 1e-3, "host-route-1M hist instant",
                       "instance") for r in runs]
    same_answers(runs[-2], runs[-1], "host-route-1M hist instant")
    st = runs[-1].stats
    log(f"host-route-1M: `{HIST_INSTANT_QUERY}` (query_instant) over "
        f"{len(last)} native histograms: {warm_line(secs)}; oracle "
        f"max_abs_err {checked[-1][1]} (rtol 2e-4, atol 1e-3); samples "
        f"scanned {st.samples_scanned}; host gather {st.cpu_seconds:.4f} "
        f"s; upload {st.transfer_s:.4f} s "
        f"({st.bytes_transferred} B); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B; launches "
        f"{({k: n for k, n in kernels.LAUNCHES.items() if n})}")
    return dict(query=HIST_INSTANT_QUERY, cold_s=secs[0],
                p50=float(np.percentile(secs[1:], 50)))


def run_promql_phase(eng, want_rate, orc, wends, warm, num_series):
    """promql-1M over the dense counter store: P1-P5 (K1 under each plan
    node), P6 absent, and the metadata plans, each held to an oracle
    derived from phase 3's f64 rate oracle `want_rate` [NUM_NS, W] or,
    where the query reads other windows (P2's pinned end, P3's inner
    grid), from the same oracle over the raw slab (orc) -> (launches,
    rows)."""
    import torch
    from filodb_tpu_torch.core.index import Equals
    from filodb_tpu_torch.ops import kernels
    from filodb_tpu_torch.query import logical as lp
    start_s = START_MS // 1000
    end_s = start_s + (T - 1) * STEP_MS // 1000
    tol = (2e-4, 1e-3)
    # P3's inner grid is the parser's (query/logical.py), as planned
    inner, inner_wends = orc["inner_rate"], orc["inner_wends"]
    p3 = np.full_like(want_rate, np.nan)
    for w, we in enumerate(wends):
        sel = inner[:, (inner_wends > we - 1_800_000) & (inner_wends <= we)]
        ok = ~np.isnan(sel).all(axis=1)
        p3[ok, w] = np.nanmax(sel[ok], axis=1)
    total = want_rate.sum(axis=0)
    oracles = {
        # `@ end()` pins the query's end, the window ending at end_s
        "P1": want_rate, "P2": np.repeat(orc["rate_at_end"], len(wends), 1),
        "P3": p3, "P4": want_rate, "P5": want_rate / total[None, :]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    rows = []
    for name, q in P_QUERIES:
        runs, secs = timed_runs(eng, q, warm, False, end_s, start_s,
                                kernels_each=("fused_rate_dense",))
        ptol = (2e-4, 1e-9) if name == "P5" else tol
        checked = [compare(r, oracles[name], ptol[0], ptol[1],
                           f"promql-1M {name}") for r in runs]
        same_answers(runs[-2], runs[-1], f"promql-1M {name}")
        got = checked[-1][0]
        extra = ""
        keys = [k.labels_dict for k, _, _ in runs[-1].series()]
        check(len(keys) == NUM_NS, f"promql-1M {name}: {len(keys)} series")
        if name == "P1":
            # the port ranks by its own f64 means; against the oracle's
            # order an adjacent pair may swap only where the two oracle
            # means lie within the tolerance of each other
            mean_o = np.nanmean(want_rate, axis=1)
            ranked = [int(k["_ns_"].split("-")[1]) for k in keys]
            mo = mean_o[ranked]
            slack = tol[1] + tol[0] * np.abs(mo)
            check((mo[:-1] >= mo[1:] - slack[1:]).all(),
                  "promql-1M P1: order against the oracle's means")
            exact = np.argsort(-mean_o, kind="stable")
            extra = (f"; order: {int((np.asarray(ranked) != exact).sum())} "
                     f"of {NUM_NS} ranks differ from the oracle's exact "
                     f"order, none by more than the tolerance")
        if name == "P4":
            check(all(k.get("app") == k["_ns_"].split("-")[1]
                      for k in keys), "promql-1M P4: the app label")
        if name == "P5":
            s_ = np.nansum(got, axis=0)
            check(np.abs(s_ - 1.0).max() <= 1e-4,
                  f"promql-1M P5: the groups sum to {s_.min()}..{s_.max()}")
            extra = f"; the groups sum to 1 within {np.abs(s_ - 1).max():.2e}"
        log(f"promql-1M: {name} `{q}`: {warm_line(secs)}; oracle "
            f"max_abs_err {checked[-1][1]} max_rel_err {checked[-1][2]}"
            f"{extra}; warm answers bit-identical")
        rows.append(dict(query=q, cold_s=secs[0],
                         p50=float(np.percentile(secs[1:], 50))))
    for q, n in ABSENT_QUERIES:
        runs, secs = timed_runs(eng, q, warm, False, end_s, start_s)
        got = list(runs[-1].series())
        check(len(got) == n, f"promql-1M `{q}`: {len(got)} series")
        if n:
            key, _, v = got[0]
            check(key.labels_dict == {"_ns_": "App-1"}
                  and (np.asarray(v) == 1.0).all()
                  and len(v) == len(wends), f"promql-1M `{q}`: {key} {v}")
        log(f"promql-1M: P6 `{q}`: {n} series as expected; "
            f"{warm_line(secs)}")
    end_ms = end_s * 1000
    for plan, count in (
            (lp.LabelValues(("_ns_",), (), START_MS, end_ms), NUM_NS),
            (lp.SeriesKeysByFilters((Equals("_ns_", "App-7"),), START_MS,
                                    end_ms), None)):
        secs = []
        for _ in range(warm + 1):
            t0 = time.perf_counter()
            res = eng.exec_logical_plan(plan)
            secs.append(time.perf_counter() - t0)
        data = res.data["_ns_"] if isinstance(res.data, dict) else res.data
        want_n = count or len(range(7, num_series, NUM_NS))
        check(res.error is None and len(data) == want_n,
              f"promql-1M {type(plan).__name__}: {len(data)} entries, "
              f"expected {want_n}")
        log(f"promql-1M: {type(plan).__name__}: {len(data)} entries; "
            f"{warm_line(secs)}")
    launches = dict(kernels.LAUNCHES)
    log(f"promql-1M: max_memory_allocated {torch.cuda.max_memory_allocated()}"
        f" B; launches {({k: n for k, n in launches.items() if n})}")
    return launches, rows


# --------------------------------- live-ingest-1M and flush-page-16k

SCRAPES = 10                       # live-ingest-1M: 100 s at 10 s
RESET_SCRAPE = 5                   # 1% of the series restart in this one
LIVE_QUERY = COUNTER_QUERIES[0][0]  # sum by (_ns_) (rate(request_total[5m]))
KERNEL_TOL = (2e-4, 1e-3)          # K1's answers
GENERAL_TOL = (5e-4, 5e-3)         # the general path's (general-1M's)
PAGE_SERIES = 16_384               # flush-page-16k (host encode: cut)
PAGE_TAIL = 120                    # samples a series keeps in memory


def rate_by_ns(vals, ts_row, wends):
    """f64 oracle of LIVE_QUERY over vals [n, T'] on the card (NaN =
    absent; series i in group App-{i % NUM_NS}) -> [NUM_NS, W] numpy."""
    import torch
    acc = GroupOracle(NUM_NS, len(wends))
    for i0 in range(0, vals.shape[0], SLAB):
        per = oracle_rates_t(vals[i0:i0 + SLAB], ts_row, wends)["rate"]
        acc.add(per, torch.arange(i0, i0 + per.shape[0],
                                  device=vals.device) % NUM_NS)
    return acc.result("sum")


def scrape_windows(end_ms):
    """(start_s, end_s, window ends in ms) of the panel's 110 one-minute
    steps ending at end_ms."""
    end_s = end_ms // 1000
    start_s = end_s - 109 * 60
    return start_s, end_s, np.arange(start_s * 1000, end_ms + 1, 60_000)


def mirror_matches_full_upload(mirror, store, shard, dev):
    """A fresh full upload of `store` against the mirror's snapshot:
    timestamps to the bit, absolute values (rebased + vbase) within rtol
    1e-6 / atol 1e-6 (the reference's bound for an incremental mirror)
    -> (full upload seconds, max abs difference of the absolutes)."""
    import torch
    from filodb_tpu_torch.core.devicecache import DeviceMirror
    fresh = DeviceMirror(device=dev, shard_num=shard.shard_num)
    with shard._write_locked("smoke_full_upload"):
        fresh.ensure_fresh(store)
    a, b = mirror.snapshot(), fresh.snapshot()
    check(a.gen == b.gen and torch.equal(a.ts_off, b.ts_off),
          "live-ingest-1M: mirror timestamps differ from a full upload")
    check(np.array_equal(a.counts, b.counts),
          "live-ingest-1M: mirror counts differ from a full upload")
    worst = 0.0
    for i0 in range(0, a.ts_off.shape[0], SLAB):
        sl = slice(i0, i0 + SLAB)
        x = a.cols["count"][sl].double() + a.vbases["count"][sl, None]
        y = b.cols["count"][sl].double() + b.vbases["count"][sl, None]
        check(bool(torch.isclose(x, y, rtol=1e-6, atol=1e-6,
                                 equal_nan=True).all()),
              f"live-ingest-1M: mirror rows {i0}+ differ from a full upload "
              f"beyond rtol 1e-6 / atol 1e-6")
        d = (x - y).abs().nan_to_num(0.0)
        worst = max(worst, float(d.max()))
    secs = fresh.last_upload_s
    del fresh, a, b
    return secs, worst


def run_live_ingest_phase(eng, ms, num_series, seed, dev, written=0):
    """live-ingest-1M over phase 3's dense counters (the store's values on
    the card for the oracle, the `written` columns write-1M added after
    its T included): SCRAPES scrapes through
    TimeSeriesShard.ingest, each one grid RecordBatch of one sample a
    series with the same key list, 1% of the series restarting in scrape
    RESET_SCRAPE; after each, the panel over the 110 steps ending at it
    pays the mirror's refresh, which must be incremental, launch K1 and
    match the f64 oracle of the grown slab, and a warm run must repeat it
    bit for bit.  Then the mirror against a fresh full upload, and a
    scrape that 1% of the series miss -> (launches, rows)."""
    import torch
    from filodb_tpu_torch.core.records import RecordBatch
    from filodb_tpu_torch.ops import kernels
    from filodb_tpu_torch.utils.counters import counters
    shard = ms.get_shard("prometheus", 0)
    store = store_rows(ms, num_series)
    mirror = store.device_mirror
    n_t = T + written + SCRAPES + 1
    ts_row = START_MS + np.arange(n_t, dtype=np.int64) * STEP_MS
    t0 = time.perf_counter()
    vals = torch.full((num_series, n_t), float("nan"), dtype=torch.float64,
                      device=dev)
    rng = np.random.default_rng(seed)
    first = make_counter_slab(rng, min(SLAB, num_series), 0.0)
    check(np.array_equal(first, store.cols["count"][:len(first), :T]),
          "live-ingest-1M: the first slab made again differs from the "
          "store's")
    check(np.array_equal(store.ts[0, :T + written], ts_row[:T + written]),
          f"live-ingest-1M: the store's first row does not hold "
          f"{T + written} samples on the grid")
    for i0 in range(0, num_series, SLAB):
        vals[i0:i0 + SLAB, :T + written] = torch.from_numpy(
            store.cols["count"][i0:min(i0 + SLAB, num_series),
                                :T + written]).to(dev)
    regen_s = time.perf_counter() - t0
    keys = [p.part_key for p in shard.partitions]      # row i = series i
    schema = shard.schemas["prom-counter"]
    all_idx = np.arange(num_series, dtype=np.int32)
    srng = np.random.default_rng(seed + 100)
    last = vals[:, T + written - 1].cpu().numpy()
    t_cap0 = store.ts.shape[1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    err0 = counters.get("device_mirror_incremental_errors")
    log(f"live-ingest-1M: {num_series} series on the card for the oracle "
        f"(the store's values, {written} written columns after the first "
        f"{T}; its first slab made again from the seed matches them) in "
        f"{regen_s:.3f} s; host store time capacity "
        f"{t_cap0}; mirror "
        f"{tuple(mirror.snapshot().ts_off.shape)}")
    paid, rows = [], []
    full_s = worst = None
    for j in range(1, SCRAPES + 2):
        c = T + written - 1 + j
        new = last + srng.exponential(10.0, size=num_series)
        if j == RESET_SCRAPE:
            hit = srng.random(num_series) < 0.01
            new[hit] = srng.exponential(5.0, size=int(hit.sum()))
        present = (srng.random(num_series) >= 0.01 if j == SCRAPES + 1
                   else np.ones(num_series, dtype=bool))
        last = np.where(present, new, last)
        batch = RecordBatch(schema, keys, all_idx[present],
                            np.full(int(present.sum()), ts_row[c]),
                            {"count": new[present]})
        t1 = time.perf_counter()
        got_n = shard.ingest(batch, offset=j)
        ingest_s = time.perf_counter() - t1
        check(got_n == int(present.sum()),
              f"live-ingest-1M: scrape {j} ingested {got_n} samples")
        vals[:, c] = torch.from_numpy(np.where(present, new, np.nan)).to(dev)
        start_s, end_s, wends = scrape_windows(int(ts_row[c]))
        incr0 = counters.get("device_mirror_incremental")
        n0 = dict(kernels.LAUNCHES)
        t1 = time.perf_counter()
        r1 = eng.query_range(LIVE_QUERY, start_s, 60, end_s, scan_params())
        q_s = time.perf_counter() - t1
        launched = sorted(k for k, v in kernels.LAUNCHES.items()
                          if v > n0.get(k, 0))
        check(counters.get("device_mirror_incremental") == incr0 + 1
              and mirror.last_refresh_kind == "incremental",
              f"live-ingest-1M: scrape {j}'s refresh was "
              f"{mirror.last_refresh_kind}, not incremental")
        check(counters.get("device_mirror_incremental_errors") == err0,
              f"live-ingest-1M: incremental errors after scrape {j}")
        uniform = bool(present.all())
        if uniform:
            check(launched == ["fused_rate_dense"],
                  f"live-ingest-1M: scrape {j}'s panel launched {launched}, "
                  f"not K1 (fused_rate_dense)")
        r2 = eng.query_range(LIVE_QUERY, start_s, 60, end_s, scan_params())
        same_answers(r1, r2, f"live-ingest-1M scrape {j}")
        want = rate_by_ns(vals[:, :c + 1], ts_row[:c + 1], wends)
        tol = KERNEL_TOL if launched else GENERAL_TOL
        _, err, rel = compare(r1, want, tol[0], tol[1],
                              f"live-ingest-1M scrape {j}")
        path = ("K1 (fused_rate_dense)" if launched == ["fused_rate_dense"]
                else f"the general path, kernels {launched}")
        log(f"live-ingest-1M: scrape {j}"
            f"{' (1% restart)' if j == RESET_SCRAPE else ''}"
            f"{' (1% absent)' if not uniform else ''}: ingest "
            f"{ingest_s:.4f} s ({got_n / ingest_s:.0f} samples/s); refresh "
            f"{mirror.last_refresh_kind} {mirror.last_refresh_s:.4f} s, "
            f"{mirror.last_upload_bytes} B uploaded; panel {q_s:.4f} s via "
            f"{path}; oracle max_abs_err {err} max_rel_err {rel} (rtol "
            f"{tol[0]}, atol {tol[1]}); warm answer bit-identical")
        rows.append(dict(scrape=j, ingest_s=ingest_s, query_s=q_s,
                         refresh_s=mirror.last_refresh_s,
                         upload_bytes=mirror.last_upload_bytes))
        if uniform:
            paid.append(q_s)
        if j == SCRAPES:
            full_s, worst = mirror_matches_full_upload(mirror, store, shard,
                                                       dev)
            log(f"live-ingest-1M: after scrape {j} the mirror equals a "
                f"fresh full upload (timestamps to the bit, absolutes max "
                f"abs diff {worst}, within rtol 1e-6 / atol 1e-6); the full "
                f"upload took {full_s:.4f} s")
    launches = dict(kernels.LAUNCHES)
    log(f"live-ingest-1M: the panel that pays the refresh, {len(paid)} "
        f"uniform scrapes: p50 {np.percentile(paid, 50):.4f} s p99 "
        f"{np.percentile(paid, 99):.4f} s; refresh p50 "
        f"{np.percentile([r['refresh_s'] for r in rows], 50):.4f} s against "
        f"the full upload's {full_s:.4f} s; host store time capacity "
        f"{t_cap0} -> {store.ts.shape[1]}; mirror "
        f"{tuple(mirror.snapshot().ts_off.shape)}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B; peak host RSS {host_rss()} "
        f"B; launches {({k: n for k, n in launches.items() if n})}")
    del vals
    # the device copy each refresh makes (new arrays one time column
    # wider, the old cells copied in), which slack capacity would skip
    snap = mirror.snapshot()
    grow_ms = cuda_ms(lambda: mirror._grown(snap, snap.ts_off.shape[0],
                                            snap.t_used + 1), reps=5)
    del snap
    log(f"live-ingest-1M: the device copy a refresh makes (new arrays of "
        f"{num_series} x {store.time_used + 1}, old cells copied): "
        f"{grow_ms:.4f} ms on the card")
    return launches, rows


def run_flush_page_phase(seed, dev):
    """flush-page-16k: PAGE_SERIES counters x T in a fresh memstore with
    an InMemoryColumnStore and an InMemoryMetaStore.  The panel builds
    the mirror (K1); flush_all_groups seals every series;
    enforce_memory(budget_bytes=1, active_tail_rows=PAGE_TAIL) evicts all
    but the tail and moves shift_version; the same panel then pages the
    history back from the resident tier and is served by the host
    gather while the mirror is rebuilt in the background; the rebuild
    must publish within 60 s, and the panel then runs on the mirror
    again (K1).  Every answer against the f64 oracle of the original
    slab -> (launches, rows)."""
    import torch
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.core.partkey import PartKey
    from filodb_tpu_torch.core.store import (InMemoryColumnStore,
                                             InMemoryMetaStore)
    from filodb_tpu_torch.ops import kernels
    from filodb_tpu_torch.query.engine import QueryEngine
    from filodb_tpu_torch.utils.counters import counters
    n = PAGE_SERIES
    vals = make_counter_slab(np.random.default_rng(seed), n, 0.0)
    keys = [PartKey.make("request_total", {
        "_ws_": "demo", "_ns_": f"App-{i % NUM_NS}",
        "instance": f"Instance-{i}", "dc": f"DC{i % 2}"}) for i in range(n)]
    cs, meta = InMemoryColumnStore(), InMemoryMetaStore()
    ms = TimeSeriesMemStore(column_store=cs, meta_store=meta)
    shard = ms.setup("prometheus", 0)
    ts_row = START_MS + np.arange(T, dtype=np.int64) * STEP_MS
    shard.ingest_columns("prom-counter", keys, np.broadcast_to(ts_row, (n, T)),
                         {"count": vals}, offset=0)
    store = shard.stores["prom-counter"]
    eng = QueryEngine("prometheus", ms)
    start_s, end_s = START_MS // 1000 + 600, int(ts_row[-1]) // 1000
    wends = np.arange(start_s * 1000, int(ts_row[-1]) + 1, 60_000)
    want = rate_by_ns(torch.from_numpy(vals).to(dev), ts_row, wends)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()

    def panel(what, kernel, tol):
        n0 = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        res = eng.query_range(LIVE_QUERY, start_s, 60, end_s, scan_params())
        secs = time.perf_counter() - t0
        launched = sorted(k for k, v in kernels.LAUNCHES.items()
                          if v > n0.get(k, 0))
        check(launched == ([kernel] if kernel else []),
              f"flush-page-16k: {what} launched {launched}, expected "
              f"{kernel or 'none'}")
        _, err, rel = compare(res, want, tol[0], tol[1],
                              f"flush-page-16k {what}")
        log(f"flush-page-16k: {what}: {secs:.4f} s via "
            f"{kernel or 'the host gather + the general path'}; samples "
            f"paged {res.stats.samples_paged}; oracle max_abs_err {err} "
            f"max_rel_err {rel} (rtol {tol[0]}, atol {tol[1]})")
        return res, secs

    panel("cold panel (mirror build)", "fused_rate_dense", KERNEL_TOL)
    mirror = store.device_mirror
    t0 = time.perf_counter()
    chunks = shard.flush_all_groups()
    flush_s = time.perf_counter() - t0
    encoded = sum(c.nbytes for p in shard.partitions
                  for c in cs.read_chunks("prometheus", 0, p.part_key, 0,
                                          1 << 62))
    ckpts = meta.read_checkpoints("prometheus", 0)
    check(chunks == n and cs.num_chunksets() == n,
          f"flush-page-16k: {chunks} chunks flushed, expected {n}")
    check(set(ckpts.values()) == {0},
          f"flush-page-16k: group checkpoints {set(ckpts.values())}")
    log(f"flush-page-16k: flush_all_groups: {chunks} chunks, {encoded} B "
        f"encoded ({encoded / (n * T):.2f} B/sample), {flush_s:.3f} s; "
        f"{len(ckpts)} group checkpoints at offset 0")
    shift0 = store.shift_version
    t0 = time.perf_counter()
    released = shard.enforce_memory(budget_bytes=1,
                                    active_tail_rows=PAGE_TAIL)
    enforce_s = time.perf_counter() - t0
    check(store.shift_version > shift0
          and int(store.counts[:n].max()) == PAGE_TAIL,
          "flush-page-16k: enforce_memory did not evict to the tail")
    log(f"flush-page-16k: enforce_memory: {released} B released, "
        f"{enforce_s:.3f} s; resident tier {shard.resident.bytes_used} B")
    fb0 = counters.get("device_mirror_query_fallbacks")
    rb0 = counters.get("device_mirror_bg_rebuilds")
    paged, paged_s = panel("panel after eviction", None, GENERAL_TOL)
    check(paged.stats.samples_paged > 0,
          "flush-page-16k: no samples paged back")
    check(counters.get("device_mirror_query_fallbacks") >= fb0 + 1,
          "flush-page-16k: the panel did not fall back to the host gather")
    t0 = time.perf_counter()
    check(mirror.join_rebuild(timeout=60),
          "flush-page-16k: the background rebuild did not publish in 60 s")
    wait_s = time.perf_counter() - t0
    check(counters.get("device_mirror_bg_rebuilds") > rb0
          and mirror.is_fresh(store),
          "flush-page-16k: the background rebuild did not publish")
    log(f"flush-page-16k: background rebuild published {wait_s:.3f} s after "
        f"the panel returned (full upload {mirror.last_upload_s:.4f} s)")
    fb1 = counters.get("device_mirror_query_fallbacks")
    r1, warm1 = panel("panel on the rebuilt mirror", "fused_rate_dense",
                      KERNEL_TOL)
    r2, warm2 = panel("warm panel", "fused_rate_dense", KERNEL_TOL)
    same_answers(r1, r2, "flush-page-16k")
    check(counters.get("device_mirror_query_fallbacks") == fb1,
          "flush-page-16k: a query fell back after the rebuild")
    launches = dict(kernels.LAUNCHES)
    log(f"flush-page-16k: max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B; launches "
        f"{({k: v for k, v in launches.items() if v})}")
    return launches, [dict(flush_s=flush_s, encoded=encoded,
                           paged_s=paged_s, warm_s=warm2)]


# ------------------------------------------ the persisted-segment tier

COLD_SERIES = 65_536               # cold-65k (host segment codec: cut)
COLD_WINDOW_MS = 2 * 3600 * 1000   # a Prometheus TSDB block
COLD_T = 3 * COLD_WINDOW_MS // STEP_MS      # 2,160 samples: 6 h at 10 s
COLD_SEG_T = COLD_WINDOW_MS // STEP_MS      # 720 samples a segment row
COLD_START_MS = START_MS - START_MS % COLD_WINDOW_MS
COLD_BUDGET = 4 << 30              # the cold region for Q1: both blocks
COLD_SLAB = 32_768                 # oracle rows at a time (2,160 wide)
COMPACT_SERIES = 16_384            # compact-16k's counters
COMPACT_GAUGES = 2_048             # its integer gauges
COMPACT_WINDOW_MS = 3600 * 1000    # two segments over the 2 h grid
COMPACT_FLUSH_S = 1.0              # the FlushScheduler's interval there
COMPACT_TAIL = 30                  # scrape records past the flush (5 min)
COMPACT_ENDED = 8                  # gauges ended, evicted, compacted away


def one_shard_mapper():
    from filodb_tpu_torch.parallel.shardmapper import ShardEvent, ShardMapper
    m = ShardMapper(1)
    m.update_from_event(ShardEvent("IngestionStarted", "prometheus", 0,
                                   "local"))
    return m


def counter_keys(n):
    """dense-1M's labels (bench.py:1-8): _ns_ = App-{i % 1000}."""
    from filodb_tpu_torch.core.partkey import PartKey
    return [PartKey.make("request_total", {
        "_ws_": "demo", "_ns_": f"App-{i % NUM_NS}",
        "instance": f"Instance-{i}", "dc": f"DC{i % 2}"}) for i in range(n)]


def make_cold_counters(rng, n):
    """[n, COLD_T] request counters: 0-20 requests a scrape, uniform (a
    request counter counts whole requests; the segment codec encodes
    these at about 2.3 B a sample where make_counter_slab's fractional
    increments take 6.9), one reset a row inside the first 2 h, and one
    on the first segment boundary (the first sample of window 2 below
    the last of window 1)."""
    out = np.empty((n, COLD_T))
    w = COLD_SEG_T
    for i0 in range(0, n, SLAB):
        m = min(SLAB, n - i0)
        v = np.cumsum(rng.integers(0, 21, size=(m, COLD_T)),
                      axis=1).astype(np.float64)
        r = rng.integers(1, w - 120, size=m)
        v -= np.where(np.arange(COLD_T)[None, :] >= r[:, None],
                      v[np.arange(m), r - 1][:, None], 0.0)
        v[:, w:] -= v[:, w - 1:w].copy()
        out[i0:i0 + m] = v
    check(bool((out[:, w] < out[:, w - 1]).all()),
          "cold-65k: the boundary reset is missing")
    return out


def cold_oracle(vals, ts_row, wends, dev):
    """f64 rate per series on the card, slab by slab -> {"sum", "max"} by
    _ns_ ([NUM_NS, W] numpy)."""
    import torch
    acc = GroupOracle(NUM_NS, len(wends))
    for i0 in range(0, vals.shape[0], COLD_SLAB):
        v = torch.from_numpy(vals[i0:i0 + COLD_SLAB]).to(dev)
        per = oracle_rates_t(v, ts_row, wends)["rate"]
        acc.add(per, torch.arange(i0, i0 + per.shape[0], device=dev)
                % NUM_NS)
        del v, per
    return {"sum": acc.result("sum"), "max": acc.result("max")}


def k1_ledger(dev):
    """K1's dispatches in the kernel ledger (its rate-family labels)."""
    from filodb_tpu_torch.utils.devicetelem import telem
    ks = telem.snapshot(recent=0)["devices"].get(str(dev), {}).get(
        "kernels", {})
    return sum(ks.get(k, {}).get("count", 0) for k in OPS_FUSED)


def launched(n0):
    from filodb_tpu_torch.ops import kernels
    return {k: v - n0.get(k, 0) for k, v in kernels.LAUNCHES.items()
            if v > n0.get(k, 0)}


def run_cold_phase(seed, warm, dev, keep=None):
    """cold-65k: the tier-stitched panel over the persisted tier.
    COLD_SERIES request counters x 6 h at 10 s (make_cold_counters, from
    the seed); the first two 2 h windows written as segment files
    (SegmentStore.write of encode_segment, what the compactor writes);
    the live memstore holds the last 2 h and the 5 m before them.  Q1
    sum by (_ns_) (rate(...[5m])) over the 6 h through
    LongTimeRangePlanner(SingleClusterPlanner, None, PersistedCluster-
    Planner(tier)): cold (both segments paged into the cold region as
    CUDA tensors), then `warm` times (cold_hit, two K1 launches and two
    K1 ledger dispatches each: the merged cold block and the hot tail),
    against the f64 oracle and the all-in-memory engine (rtol 2e-4, atol
    1e-3), warm answers bit-identical; the `cold` booking against the
    blocks and the allocator; explain; Q1b max by (_ns_) (K6); Q2 over a
    span wholly in segments: first-scan and warm samples/s against the
    all-in-memory engine's (bench.py:3669-3673); Q2 on a region that
    holds one block of the two (evictions, the booking never above it),
    and Q3 over the first segment on one below a block (the host
    degrade); then the shared object-store tier: a SegmentUploader over
    a LocalObjectStore uploads both segments (run_once),
    restore_from_objectstore into an empty SegmentStore reproduces both
    files byte for byte, and a stateless query node (make_query_tier
    over a ColdSegmentCache on the card) answers Q2 bit-identically to
    the local tier, K1 launched, booked `cold` equal to its blocks ->
    (launches, rows).  With a dict `keep`, the segments, the object
    store and Q2's span and oracle are left in it for parity-65k, which
    removes them."""
    import shutil
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from filodb_tpu_torch.config import FilodbSettings
    from filodb_tpu_torch.core.devicecache import ColdSegmentCache
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.ops import kernels
    from filodb_tpu_torch.persist.objectstore import (
        LocalObjectStore, SegmentUploader, make_query_tier,
        restore_from_objectstore)
    from filodb_tpu_torch.persist.segments import (PersistedTier,
                                                   SegmentStore,
                                                   encode_segment)
    from filodb_tpu_torch.promql.parser import (TimeStepParams,
                                                query_range_to_logical_plan)
    from filodb_tpu_torch.query.engine import QueryEngine
    from filodb_tpu_torch.query.planner import SingleClusterPlanner
    from filodb_tpu_torch.query.planners import (LongTimeRangePlanner,
                                                 PersistedClusterPlanner)
    from filodb_tpu_torch.query.rangevector import QueryContext
    from filodb_tpu_torch.utils.devicetelem import telem
    from filodb_tpu_torch.utils.metrics import registry
    n = COLD_SERIES
    t0 = time.perf_counter()
    vals = make_cold_counters(np.random.default_rng(seed), n)
    keys = counter_keys(n)
    ts_row = COLD_START_MS + np.arange(COLD_T, dtype=np.int64) * STEP_MS
    gen_s = time.perf_counter() - t0
    q1_start = COLD_START_MS // 1000 + 300          # 5 m into segment 1
    end_s = int(ts_row[-1]) // 1000
    q2_end = (COLD_START_MS + 2 * COLD_WINDOW_MS) // 1000 - 600
    wends = np.arange(q1_start * 1000, end_s * 1000 + 1, 60_000)
    w2 = int(np.searchsorted(wends, q2_end * 1000, side="right"))
    t0 = time.perf_counter()
    want = cold_oracle(vals, ts_row, wends, dev)
    oracle_s = time.perf_counter() - t0
    root = tempfile.mkdtemp(prefix="filodb-cold-")
    try:
        seg_store = SegmentStore(root)
        t0 = time.perf_counter()

        def write(w):
            w0 = COLD_START_MS + w * COLD_WINDOW_MS
            sl = slice(w * COLD_SEG_T, (w + 1) * COLD_SEG_T)
            payload = encode_segment(
                "prom-counter", w0, w0 + COLD_WINDOW_MS, keys,
                np.full(n, COLD_SEG_T, np.int32),
                np.broadcast_to(ts_row[sl], (n, COLD_SEG_T)),
                {"count": vals[:, sl]})
            seg_store.write("prometheus", 0, "prom-counter", w0,
                            w0 + COLD_WINDOW_MS, payload)
            return len(payload)
        with ThreadPoolExecutor(max_workers=2) as pool:
            seg_bytes = sum(pool.map(write, range(2)))
        encode_s = time.perf_counter() - t0
        metas = seg_store.list("prometheus", 0)
        check(len(metas) == 2, f"cold-65k: {len(metas)} segments")
        est = metas[0].device_bytes_estimate()
        # the live working set: the last 2 h and the lookback before them
        tail_from = 2 * COLD_SEG_T - RANGE_MS // STEP_MS
        earliest_raw = int(ts_row[tail_from])
        ms_live = TimeSeriesMemStore()
        t0 = time.perf_counter()
        ms_live.setup("prometheus", 0).ingest_columns(
            "prom-counter", keys,
            np.broadcast_to(ts_row[tail_from:], (n, COLD_T - tail_from)),
            {"count": vals[:, tail_from:]})
        ingest_s = time.perf_counter() - t0
        log(f"cold-65k: {n} series x {COLD_T} samples (6 h at 10 s), "
            f"generate {gen_s:.3f} s, oracle {oracle_s:.3f} s; 2 segments "
            f"of {COLD_SEG_T} samples a row written (encode_segment + "
            f"SegmentStore.write) in {encode_s:.3f} s, {seg_bytes} B "
            f"({seg_bytes / (2 * n * COLD_SEG_T):.2f} B/sample); "
            f"device_bytes_estimate {est} B a block; live memstore "
            f"{COLD_T - tail_from} samples a row, ingest {ingest_s:.3f} s")
        mapper = one_shard_mapper()

        def tiered(budget):
            tier = PersistedTier(seg_store, "prometheus", 1,
                                 ColdSegmentCache(budget))
            ltr = LongTimeRangePlanner(
                SingleClusterPlanner("prometheus", mapper), None,
                earliest_raw_time_fn=lambda: earliest_raw,
                latest_downsample_time_fn=lambda: 1 << 62,
                persisted_planner=PersistedClusterPlanner(
                    "prometheus", mapper, tier),
                persisted_range_fn=tier.range)
            return QueryEngine("prometheus", ms_live, mapper,
                               planner=ltr), tier

        def run(eng, q, end=end_s):
            t0 = time.perf_counter()
            res = eng.query_range(q, q1_start, 60, end, scan_params())
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            check(res.error is None, f"cold-65k `{q}`: {res.error}")
            return res, secs

        eng, tier = tiered(COLD_BUDGET)
        q1, q1b = RATE_Q, "max by (_ns_) (rate(request_total[5m]))"
        tree = eng.planner.materialize(query_range_to_logical_plan(
            q1, TimeStepParams(q1_start, 60, end_s)),
            QueryContext()).print_tree()
        check(tree.startswith("-E~StitchRvsExec()")
              and "E~SelectPersistedSegmentsExec(" in tree
              and "tier=cold" in tree
              and "E~MultiSchemaPartitionsExec(" in tree,
              f"cold-65k: explain of Q1:\n{tree}")
        log("cold-65k: explain of Q1:\n" + tree)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        n0 = dict(kernels.LAUNCHES)
        with GcPauses() as pauses:
            cold, cold_s = run(eng, q1)
        check(cold.stats.cold_tier == "cold_paged",
              f"cold-65k: Q1 cold verdict {cold.stats.cold_tier}")
        blocks = tier.cold_cache.blocks()
        check(len(blocks) == 2 and all(
            b.ts_off.is_cuda and all(c.is_cuda for c in b.cols.values())
            for b in blocks), "cold-65k: the cold blocks are not CUDA tensors")
        check(launched(n0) == {"fused_rate_dense": 2},
              f"cold-65k: Q1 cold launched {launched(n0)}")
        booked = telem.hbm_booked(dev, "cold")
        nbytes = sum(b.nbytes for b in blocks)
        alloc = torch.cuda.memory_allocated(dev)
        check(booked == nbytes == tier.cold_cache.bytes_booked
              and booked <= alloc,
              f"cold-65k: booked cold {booked} B, blocks {nbytes} B, "
              f"allocated {alloc} B")
        got, err, rel = compare(cold, want["sum"], *KERNEL_TOL,
                                "cold-65k Q1 cold")
        log(f"cold-65k: Q1 cold {cold_s:.3f} s ({pauses}): cold_paged, "
            f"samples paged {cold.stats.samples_paged}, bytes paged "
            f"{cold.stats.bytes_paged}; 2 K1 launches; blocks on "
            f"{blocks[0].ts_off.device}; booked cold {booked} B = the "
            f"blocks' nbytes, memory_allocated {alloc} B; oracle "
            f"max_abs_err {err} max_rel_err {rel}")
        hits = registry.counter("device_mirror_cold_hits")
        warm_s, answers = [], [cold]
        for i in range(warm):
            n0, l0, h0 = dict(kernels.LAUNCHES), k1_ledger(dev), hits.value
            res, s = run(eng, q1)
            check(res.stats.cold_tier == "cold_hit"
                  and hits.value >= h0 + 2,
                  f"cold-65k: Q1 warm {i} verdict {res.stats.cold_tier}")
            check(launched(n0) == {"fused_rate_dense": 2}
                  and k1_ledger(dev) - l0 == 2,
                  f"cold-65k: Q1 warm {i} launched {launched(n0)}, ledger "
                  f"{k1_ledger(dev) - l0}")
            warm_s.append(s)
            answers.append(res)
        same_answers(answers[-2], answers[-1], "cold-65k Q1")
        _, err, rel = compare(answers[-1], want["sum"], *KERNEL_TOL,
                              "cold-65k Q1 warm")
        log(f"cold-65k: Q1 warm x{warm} p50 {np.percentile(warm_s, 50):.4f}"
            f" s p99 {np.percentile(warm_s, 99):.4f} s: cold_hit, 2 K1 "
            f"launches and 2 K1 ledger dispatches each (the merged cold "
            f"block, the hot tail); oracle max_abs_err {err} max_rel_err "
            f"{rel}; warm answers bit-identical")
        n0 = dict(kernels.LAUNCHES)
        r1b, q1b_s = run(eng, q1b)
        check(launched(n0) == {"fused_rate_dense_series": 2},
              f"cold-65k: Q1b launched {launched(n0)}")
        _, err_b, rel_b = compare(r1b, want["max"], *KERNEL_TOL,
                                  "cold-65k Q1b")
        log(f"cold-65k: Q1b `{q1b}` {q1b_s:.4f} s via K6 (2 launches); "
            f"oracle max_abs_err {err_b} max_rel_err {rel_b}")
        peak_tier = torch.cuda.max_memory_allocated()
        # the all-in-memory engine over the same 6 h
        ms_ref = TimeSeriesMemStore()
        t0 = time.perf_counter()
        sh = ms_ref.setup("prometheus", 0)
        for i0 in range(0, n, SLAB):
            sh.ingest_columns("prom-counter", keys[i0:i0 + SLAB],
                              np.broadcast_to(ts_row, (min(SLAB, n - i0),
                                                       COLD_T)),
                              {"count": vals[i0:i0 + SLAB]})
        ref_ingest_s = time.perf_counter() - t0
        eng_ref = QueryEngine("prometheus", ms_ref, mapper)
        mem_first, mem_first_s = run(eng_ref, q1, q2_end)
        mem_best = min(run(eng_ref, q1, q2_end)[1] for _ in range(3))
        ref_q1, _ = run(eng_ref, q1)
        mem_got, _, _ = compare(ref_q1, want["sum"], *KERNEL_TOL,
                                "cold-65k Q1 all-in-memory")
        m = ~np.isnan(mem_got)
        diff = np.abs(got[m] - mem_got[m])
        check(bool((diff <= KERNEL_TOL[1] + KERNEL_TOL[0]
                    * np.abs(mem_got[m])).all()),
              f"cold-65k: Q1 tiered against all-in-memory {diff.max()}")
        samples = mem_first.stats.samples_scanned
        del eng_ref, ms_ref, sh, mem_first, ref_q1
        free_device_memory()
        # Q2 on a fresh local tier (every block decoded and uploaded
        # again, warm code paths): bench.py's cold_vs_mem
        eng2, tier2 = tiered(COLD_BUDGET)
        q2_fresh, fresh_scan_s = run(eng2, q1, q2_end)
        check(q2_fresh.stats.cold_tier == "cold_paged",
              f"cold-65k: Q2 first scan {q2_fresh.stats.cold_tier}")
        del eng2, tier2
        # the shared object-store tier: both segments uploaded, restored
        # byte for byte; Q2's first scan on a query-only tier over it
        # (every block fetched, decoded and uploaded again), then warm on
        # the first tier
        store = LocalObjectStore(os.path.join(root, "bucket"),
                                 name="cold-65k")
        up = SegmentUploader(store, seg_store, "prometheus", 1)
        up.mount()
        t0 = time.perf_counter()
        uploaded = up.run_once()
        upload_s = time.perf_counter() - t0
        check(uploaded == 2 and up.backlog_segments() == 0,
              f"cold-65k: uploaded {uploaded}, backlog "
              f"{up.backlog_segments()}")
        fresh = SegmentStore(os.path.join(root, "restored"))
        t0 = time.perf_counter()
        rs = restore_from_objectstore(store, fresh, "prometheus", 1)
        restore_s = time.perf_counter() - t0
        restored = {m.start_ms: m.path for m in fresh.list("prometheus", 0)}
        check(rs.segments_fetched == 2 and sorted(restored)
              == sorted(m.start_ms for m in metas)
              and all(open(m.path, "rb").read()
                      == open(restored[m.start_ms], "rb").read()
                      for m in metas),
              "cold-65k: the restored segment files differ from the "
              "written ones")
        cache = ColdSegmentCache(COLD_BUDGET, device=dev)
        qtier, _ = make_query_tier(store, "prometheus", 1, cold_cache=cache)
        eng_q = QueryEngine("prometheus", TimeSeriesMemStore(), mapper,
                            planner=PersistedClusterPlanner(
                                "prometheus", mapper, qtier))
        booked0 = telem.hbm_booked(dev, "cold")
        n0 = dict(kernels.LAUNCHES)
        q2_cold, cold_scan_s = run(eng_q, q1, q2_end)
        check(q2_cold.stats.cold_tier == "cold_paged"
              and set(launched(n0)) == {"fused_rate_dense"},
              f"cold-65k: Q2 first scan on the query tier "
              f"{q2_cold.stats.cold_tier}, launched {launched(n0)}")
        qblocks = cache.blocks()
        qbooked = telem.hbm_booked(dev, "cold") - booked0
        check(len(qblocks) == 2 and qbooked == cache.bytes_booked
              == sum(b.nbytes for b in qblocks),
              f"cold-65k: the query tier booked {qbooked} B for "
              f"{len(qblocks)} blocks of {sum(b.nbytes for b in qblocks)} B")
        q2_warm, _ = run(eng, q1, q2_end)
        warm_best = min(run(eng, q1, q2_end)[1] for _ in range(3))
        same_answers(q2_fresh, q2_warm, "cold-65k Q2 fresh tier")
        same_answers(q2_cold, q2_warm, "cold-65k Q2 object-store tier")
        q_warm = []
        for _ in range(3):
            res, secs = run(eng_q, q1, q2_end)
            same_answers(res, q2_warm, "cold-65k Q2 object-store tier warm")
            q_warm.append(secs)
        log(f"cold-65k: object-store tier: run_once uploaded {uploaded} "
            f"segments, {up.upload_bytes} B, in {upload_s:.3f} s; "
            f"restore_from_objectstore fetched {rs.segments_fetched} "
            f"({rs.bytes_fetched} B) in {restore_s:.3f} s, the files byte "
            f"for byte; the query-only tier (make_query_tier) Q2 first scan "
            f"{cold_scan_s:.3f} s, warm x3 p50 "
            f"{np.percentile(q_warm, 50):.4f} s, booked cold {qbooked} B = "
            f"its blocks, bit-identical to the local tier's Q2")
        cache.clear()
        del eng_q, qtier, cache
        check(q2_warm.stats.cold_tier == "cold_hit",
              f"cold-65k: Q2 warm {q2_warm.stats.cold_tier}")
        cold_samples = q2_warm.stats.samples_scanned
        compare(q2_warm, want["sum"][:, :w2], *KERNEL_TOL, "cold-65k Q2")
        # cold_vs_mem is the fresh local tier's first scan (decode,
        # upload), objstore_vs_mem the query-only tier's (fetch, decode,
        # upload)
        rates = dict(mem_first=samples / mem_first_s,
                     mem=samples / mem_best,
                     cold_scan=cold_samples / fresh_scan_s,
                     objstore_scan=cold_samples / cold_scan_s,
                     warm=cold_samples / warm_best)
        log(f"cold-65k: Q2 (span wholly in segments, {w2} steps): samples "
            f"scanned tiered {cold_samples}, all-in-memory {samples}; "
            f"samples/s: all-in-memory first {rates['mem_first']:.1f} "
            f"({mem_first_s:.3f} s, upload included), all-in-memory warm "
            f"{rates['mem']:.1f} ({mem_best:.4f} s best of 3), cold first "
            f"scan {rates['cold_scan']:.1f} ({fresh_scan_s:.3f} s, fresh "
            f"tier), object-store first scan {rates['objstore_scan']:.1f} "
            f"({cold_scan_s:.3f} s, the query-only tier), warm "
            f"{rates['warm']:.1f} ({warm_best:.4f} s best of 3); cold_vs_mem "
            f"{rates['cold_scan'] / rates['mem_first']:.3f}, objstore_vs_mem "
            f"{rates['objstore_scan'] / rates['mem_first']:.3f}, warm_cold "
            f"{rates['warm'] / rates['mem']:.3f}; all-in-memory ingest "
            f"{ref_ingest_s:.3f} s")
        # the LRU: a region that holds one block of the two (the config's
        # default, 2 GiB, holds both at this size)
        budget = est + est // 2
        check(FilodbSettings().store.device_mirror_cold_limit_bytes
              >= 2 * est, "cold-65k: the config's cold region is below "
              "two blocks")
        eng3, tier3 = tiered(budget)
        ev = registry.counter("device_mirror_cold_evictions")
        e0, peak, stop = ev.value, [0], threading.Event()

        def sample():
            while not stop.is_set():
                peak[0] = max(peak[0], tier3.cold_cache.bytes_booked)
                time.sleep(0.001)
        th = threading.Thread(target=sample, daemon=True)
        th.start()
        try:
            lru, lru_s = run(eng3, q1, q2_end)
        finally:
            stop.set()
            th.join()
        check(ev.value - e0 >= 1 and peak[0] <= budget
              and tier3.cold_cache.bytes_booked <= budget,
              f"cold-65k: LRU evictions {ev.value - e0}, peak booked "
              f"{peak[0]} B over {budget} B")
        same_answers(lru, q2_warm, "cold-65k Q2 one-block region")
        log(f"cold-65k: Q2 on a {budget} B region (one block of two): "
            f"{lru_s:.3f} s, {int(ev.value - e0)} evictions, peak booked "
            f"{peak[0]} B <= budget, answer bit-identical; the config's "
            f"default region holds both blocks at this size")
        del eng3, tier3
        # the over-budget degrade: a region below one block, a span in
        # the first segment (Q3)
        over = registry.counter("device_mirror_cold_over_budget")
        q3_end = (COLD_START_MS + COLD_WINDOW_MS) // 1000 - 600
        q3_res, _ = run(eng, q1, q3_end)
        o0, b0 = over.value, telem.hbm_booked(dev, "cold")
        eng4, tier4 = tiered(est // 2)
        n0 = dict(kernels.LAUNCHES)
        deg, deg_s = run(eng4, q1, q3_end)
        check(over.value - o0 == 1 and tier4.cold_cache.bytes_booked == 0
              and telem.hbm_booked(dev, "cold") == b0
              and launched(n0) == {"fused_rate_dense": 1},
              f"cold-65k: degrade over_budget +{over.value - o0}, booked "
              f"{tier4.cold_cache.bytes_booked} B, launched {launched(n0)}")
        same_answers(deg, q3_res, "cold-65k Q3 over-budget degrade")
        log(f"cold-65k: Q3 (the first segment's span) on a {est // 2} B "
            f"region (below one block): the host degrade, {deg_s:.3f} s, "
            f"device_mirror_cold_over_budget +1, nothing booked, K1 over "
            f"the uploaded block, the answer equal to the resident "
            f"region's to the bit")
        del eng4, tier4
        launches = dict(kernels.LAUNCHES)
        log(f"cold-65k: max_memory_allocated (Q1, Q1b) {peak_tier} B; "
            f"launches {({k: v for k, v in launches.items() if v})}")
        tier.cold_cache.clear()
        if keep is not None:
            keep.update(root=root, store=store, q_start=q1_start,
                        q_end=q2_end, want=want["sum"][:, :w2])
        return launches, [dict(cold_s=cold_s, p50=float(np.percentile(
            warm_s, 50)), p99=float(np.percentile(warm_s, 99)),
            upload_s=upload_s, restore_s=restore_s,
            **rates)]
    finally:
        if keep is None or "root" not in keep:
            shutil.rmtree(root, ignore_errors=True)


PARITY_ROUNDS = 4                  # (a): round-robin rounds, all nodes up
PARITY_KILL_AT = 2                 # (c): the partition whose read kills
PARITY_SENSORS = 4_096             # (d): env-schema series
PARITY_SENSOR_NS = 64              # (d): their _ns_ groups
PARITY_SCHEMA = {"env-schema": {"columns": ["timestamp:ts", "v:double"],
                                "value_column": "v"}}
PARITY_NODE = "parity-65k"


def parity_cold_cluster(cold, dev):
    """(a): the cold-read cluster on the card against a local query tier
    over the same object store -> its row."""
    import torch
    from filodb_tpu_torch.config import settings
    from filodb_tpu_torch.core.devicecache import ColdSegmentCache
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.ops import kernels
    from filodb_tpu_torch.parallel.testcluster import make_cold_read_cluster
    from filodb_tpu_torch.persist.objectstore import make_query_tier
    from filodb_tpu_torch.query.engine import QueryEngine
    from filodb_tpu_torch.query.planners import PersistedClusterPlanner
    mapper = one_shard_mapper()
    span = (cold["q_start"], 60, cold["q_end"])
    qtier, _ = make_query_tier(cold["store"], "prometheus", 1,
                               cold_cache=ColdSegmentCache(COLD_BUDGET,
                                                           device=dev))
    local = QueryEngine("prometheus", TimeSeriesMemStore(), mapper,
                        planner=PersistedClusterPlanner("prometheus",
                                                        mapper, qtier))
    want = local.query_range(RATE_Q, *span, scan_params())
    _, err, rel = compare(want, cold["want"], *KERNEL_TOL,
                          "parity-65k (a) local query tier")
    qtier.cold_cache.clear()
    del local, qtier
    # the cluster's shared tier takes its cold region from the setting a
    # FiloServer reads: set it to the local tier's budget for this build
    store_cfg = settings().store
    limit = store_cfg.device_mirror_cold_limit_bytes
    store_cfg.device_mirror_cold_limit_bytes = COLD_BUDGET
    try:
        c = make_cold_read_cluster(cold["store"], num_shards=1,
                                   dataset="prometheus",
                                   data_nodes=("data0",),
                                   query_nodes=("q1", "q2"), device=dev)
    finally:
        store_cfg.device_mirror_cold_limit_bytes = limit
    check(c.tier.cold_cache.limit_bytes == COLD_BUDGET,
          f"parity-65k (a): the shared tier's cold region "
          f"{c.tier.cold_cache.limit_bytes} bytes")
    secs = []
    try:
        check(c.mapper.query_nodes == ["q1", "q2"]
              and all(q not in c.mapper.owners(0) for q in ("q1", "q2"))
              and all(s.device == dev for s in c.servers.values()),
              f"parity-65k (a): query nodes {c.mapper.query_nodes}, "
              f"owners {c.mapper.owners(0)}, devices "
              f"{[str(s.device) for s in c.servers.values()]}")
        for i in range(PARITY_ROUNDS + 2):
            if i == PARITY_ROUNDS:
                c.servers["data0"].stop()
            n0 = dict(kernels.LAUNCHES)
            t0 = time.perf_counter()
            res = c.engine.query_range(RATE_Q, *span, scan_params())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            check(res.error is None and not res.partial,
                  f"parity-65k (a) round {i}: error {res.error}, partial "
                  f"{res.partial}")
            check(set(launched(n0)) == {"fused_rate_dense"},
                  f"parity-65k (a) round {i}: launched {launched(n0)}")
            same_answers(res, want, f"parity-65k (a) round {i} against "
                                    f"the local query tier")
        blocks = c.tier.cold_cache.blocks()
        check(len(blocks) == 2 and all(b.ts_off.is_cuda for b in blocks),
              f"parity-65k (a): the shared tier holds {len(blocks)} blocks "
              f"on {[str(b.ts_off.device) for b in blocks]}")
        c.tier.cold_cache.clear()
    finally:
        c.stop()
    log(f"parity-65k (a): cold-read cluster on {dev} (data0, query-only "
        f"q1 and q2, each a NodeQueryServer on the card): Q1 `{RATE_Q}` "
        f"over the segments' span, {PARITY_ROUNDS} rounds round-robin, "
        f"then 2 with data0 stopped; each K1 and bit-identical to the "
        f"local query tier; the local tier against the oracle "
        f"max_abs_err {err} max_rel_err {rel}; seconds "
        f"{[round(x, 3) for x in secs]}")
    return {"cluster_first_s": secs[0],
            "cluster_p50_s": float(np.percentile(secs[1:], 50))}


def parity_dead_store(cold, dev):
    """(b): objectstore.get faulted under a query-only tier -> its row."""
    from filodb_tpu_torch.core.devicecache import ColdSegmentCache
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.parallel.breaker import breakers
    from filodb_tpu_torch.persist.objectstore import RemoteSegmentStore
    from filodb_tpu_torch.persist.segments import PersistedTier
    from filodb_tpu_torch.query.engine import QueryEngine
    from filodb_tpu_torch.query.planners import PersistedClusterPlanner
    from filodb_tpu_torch.utils.faults import faults
    mapper = one_shard_mapper()

    def engine():
        # built before the fault arms, as a node that mounted its store
        remote = RemoteSegmentStore(cold["store"], "prometheus", 1,
                                    ttl_s=1_000.0)
        remote.mount()
        tier = PersistedTier(remote, "prometheus", 1,
                             ColdSegmentCache(COLD_BUDGET, device=dev))
        return QueryEngine("prometheus", TimeSeriesMemStore(), mapper,
                           planner=PersistedClusterPlanner(
                               "prometheus", mapper, tier))
    lenient, strict = engine(), engine()
    span = (cold["q_start"], 60, cold["q_end"])
    breakers.configure(failure_threshold=2, open_base_s=0.05,
                       open_max_s=0.1, jitter=0.0)
    try:
        with faults.plan("objectstore.get", "error", first_k=1_000_000):
            t0 = time.perf_counter()
            part = lenient.query_range(RATE_Q, *span, scan_params(
                allow_partial_results=True))
            part_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            err = strict.query_range(RATE_Q, *span, scan_params())
            err_s = time.perf_counter() - t0
    finally:
        faults.disarm()
        breakers.configure()
        breakers.reset()
    check(part.error is None and part.partial and part.num_series == 0,
          f"parity-65k (b): with allow_partial_results error {part.error}, "
          f"partial {part.partial}, {part.num_series} series")
    check(err.error is not None and err.error.startswith(
        "shard_unavailable: shard 0: cold tier unavailable"),
          f"parity-65k (b): without allow_partial_results {err.error}")
    log(f"parity-65k (b): objectstore.get faulted: with "
        f"allow_partial_results flagged partial, no error, "
        f"{part.num_series} series ({part_s:.3f} s); without it "
        f"`{err.error[:120]}` ({err_s:.3f} s)")
    return {"dead_partial_s": part_s, "dead_error_s": err_s}


def parity_cancel_paging(seed, dev):
    """(c): a query killed while it pages history, then its retry ->
    its row."""
    import torch
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.core.store import (InMemoryColumnStore,
                                             InMemoryMetaStore)
    from filodb_tpu_torch.ops import kernels
    from filodb_tpu_torch.query.activequeries import (active_queries,
                                                      set_admission)
    from filodb_tpu_torch.query.engine import QueryEngine
    n = PAGE_SERIES
    vals = make_counter_slab(np.random.default_rng(seed), n, 0.0)
    keys = counter_keys(n)
    ts_row = START_MS + np.arange(T, dtype=np.int64) * STEP_MS
    cs, meta = InMemoryColumnStore(), InMemoryMetaStore()
    first = TimeSeriesMemStore(column_store=cs, meta_store=meta)
    sh = first.setup("prometheus", 0)
    sh.ingest_columns("prom-counter", keys, np.broadcast_to(ts_row, (n, T)),
                      {"count": vals}, offset=0)
    t0 = time.perf_counter()
    chunks = sh.flush_all_groups()
    flush_s = time.perf_counter() - t0
    del first, sh
    ms = TimeSeriesMemStore(column_store=cs, meta_store=meta)
    sh = ms.setup("prometheus", 0)
    check(sh.recover_index() == n and chunks == n,
          f"parity-65k (c): {chunks} chunks flushed, index recovered "
          f"{sh.num_partitions} of {n}")
    start_s, end_s = START_MS // 1000 + 600, int(ts_row[-1]) // 1000
    wends = np.arange(start_s * 1000, int(ts_row[-1]) + 1, 60_000)
    want = rate_by_ns(torch.from_numpy(vals).to(dev), ts_row, wends)
    eng = QueryEngine("prometheus", ms)
    ent = active_queries.register("parity-65k-kill", LIVE_QUERY)
    read = sh._read_sealed_chunks
    seen = []

    def read_then_kill(info, *a, **kw):
        seen.append(info.part_id)
        if len(seen) == PARITY_KILL_AT:
            active_queries.kill(ent.query_id, detail="parity-65k")
        return read(info, *a, **kw)
    sh._read_sealed_chunks = read_then_kill
    set_admission(ent)
    try:
        t0 = time.perf_counter()
        killed = eng.query_range(LIVE_QUERY, start_s, 60, end_s,
                                 scan_params())
        kill_s = time.perf_counter() - t0
    finally:
        del sh._read_sealed_chunks
        set_admission(None)
        active_queries.deregister(ent, "killed")
    store = sh.stores["prom-counter"]
    kept = int((store.counts[:n] > 0).sum())
    check(killed.error is not None
          and killed.error.startswith("query_canceled")
          and len(seen) == PARITY_KILL_AT and kept == PARITY_KILL_AT,
          f"parity-65k (c): killed query error {killed.error}, partitions "
          f"decoded {len(seen)}, kept {kept} of {n}")
    n0 = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    retry = eng.query_range(LIVE_QUERY, start_s, 60, end_s, scan_params())
    torch.cuda.synchronize()
    retry_s = time.perf_counter() - t0
    _, err, rel = compare(retry, want, *KERNEL_TOL, "parity-65k (c) retry")
    check(retry.stats.samples_paged > 0
          and bool((store.counts[:n] > 0).all()),
          f"parity-65k (c): the retry paged {retry.stats.samples_paged} "
          f"samples, {int((store.counts[:n] > 0).sum())} of {n} rows hold "
          f"samples")
    log(f"parity-65k (c): {n} counters x {T} flushed ({chunks} chunks, "
        f"{flush_s:.3f} s), a store restarted over them; `{LIVE_QUERY}` "
        f"killed while paging: `{killed.error[:100]}` after the batched "
        f"read of all {n} partitions and {len(seen)} decodes, in "
        f"{kill_s:.3f} s, {kept} kept; "
        f"the retry paged {retry.stats.samples_paged} samples in "
        f"{retry_s:.3f} s, launched {launched(n0)}, oracle max_abs_err "
        f"{err} max_rel_err {rel}")
    return {"kill_s": kill_s, "retry_s": retry_s}


def parity_config_server(seed, dev):
    """(d) and (e): a FiloServer whose config declares env-schema and
    store.groups_per_shard = 7 -> its row."""
    import torch
    from filodb_tpu_torch.config import FilodbSettings
    from filodb_tpu_torch.core.partkey import PartKey
    from filodb_tpu_torch.http import remotepb
    from filodb_tpu_torch.ops import kernels
    from filodb_tpu_torch.standalone import DatasetConfig, FiloServer
    from filodb_tpu_torch.utils import metrics, snappy
    cfg = FilodbSettings().overlay({"schemas": PARITY_SCHEMA})
    cfg.store.groups_per_shard = 7
    n, k = PARITY_SENSORS, T
    rng = np.random.default_rng(seed)
    vals = np.round(rng.uniform(15.0, 30.0, (n, k)), 2)
    ts_row = START_MS + np.arange(k, dtype=np.int64) * STEP_MS
    keys = [PartKey.make("room_temp", {
        "_ws_": "demo", "_ns_": f"App-{i % PARITY_SENSOR_NS}",
        "instance": f"Sensor-{i}"}) for i in range(n)]
    node_before = metrics.NODE_NAME
    srv = FiloServer([DatasetConfig("prometheus", 1)], config=cfg,
                     node_name=PARITY_NODE)
    try:
        shards = srv.memstore.shards_for("prometheus")
        groups = [s._groups for s in shards]
        check("env-schema" in srv.memstore.schemas and groups == [7]
              and all(s.config is cfg for s in shards),
              f"parity-65k (d): schemas "
              f"{sorted(srv.memstore.schemas.by_name)}, groups {groups}")
        got = shards[0].ingest_columns(
            "env-schema", keys, np.broadcast_to(ts_row, (n, k)), {"v": vals})
        check(got == n * k, f"parity-65k (d): ingested {got} of {n * k}")
        start_s, end_s = START_MS // 1000 + 600, int(ts_row[-1]) // 1000
        wends = np.arange(start_s * 1000, int(ts_row[-1]) + 1, 60_000)
        per = oracle_over_time_t(torch.from_numpy(vals).to(dev), ts_row,
                                 wends)["avg"]
        acc = GroupOracle(PARITY_SENSOR_NS, len(wends))
        acc.add(per, torch.arange(n, device=dev) % PARITY_SENSOR_NS)
        q = "avg by (_ns_) (avg_over_time(room_temp[5m]))"
        n0 = dict(kernels.LAUNCHES)
        res = srv.engines["prometheus"].query_range(q, start_s, 60, end_s,
                                                    scan_params())
        check(set(launched(n0)) == {"fused_over_time_dense"},
              f"parity-65k (d): `{q}` launched {launched(n0)}")
        _, err, rel = compare(res, acc.result("avg"), *KERNEL_TOL,
                              "parity-65k (d) env-schema panel")
        log(f"parity-65k (d): FiloServer on {dev} with `env-schema` from "
            f"its config and store.groups_per_shard = 7: {groups} groups; "
            f"{n} env-schema series x {k} ingested; `{q}` via K5, oracle "
            f"max_abs_err {err} max_rel_err {rel}")
        series = [remotepb.PromTimeSeries(
            [("__name__", "parity_write_total"), ("_ws_", "demo"),
             ("_ns_", f"App-{i % 4}"), ("instance", f"W-{i}")],
            [(float(i + j), int(ts_row[-1]) + 10_000 * (j + 1))
             for j in range(3)]) for i in range(8)]
        st, pay = srv.api.handle(
            "POST", "/api/v1/write", {},
            snappy.compress(remotepb.encode_write_request(series)))
        check(st == 204, f"parity-65k (e): remote write answered {st}")
        tid = pay["_headers"]["X-Trace-Id"]
        events = metrics.collector.trace(tid) or []
        ingest = [e for e in events if e["span"].endswith("ingest_columns")]
        check(ingest and all(e["node"] == PARITY_NODE for e in ingest),
              f"parity-65k (e): trace {tid} spans "
              f"{[(e['span'], e.get('node')) for e in events]}")
        log(f"parity-65k (e): one remote write (8 series x 3): trace {tid} "
            f"holds {len(events)} spans, {len(ingest)} ingest_columns "
            f"stamped node={PARITY_NODE}: "
            f"{sorted({e['span'].rsplit('.', 1)[-1] for e in events})}")
    finally:
        srv.shutdown()
        metrics.NODE_NAME = node_before
    return {"sensor_err": err}


def run_parity_phase(cold, seed, dev):
    """parity-65k: the repairs of the parity audit on the card, over
    cold-65k's segments and object store (`cold`, left by
    run_cold_phase(keep=...)), which it removes -> (launches, rows)."""
    import shutil

    from filodb_tpu_torch.ops import kernels
    check("root" in cold, "parity-65k: cold-65k left no object store")
    kernels.reset_launch_counts()
    row = {}
    try:
        row.update(parity_cold_cluster(cold, dev))
        row.update(parity_dead_store(cold, dev))
    finally:
        shutil.rmtree(cold.pop("root"), ignore_errors=True)
        cold.clear()
    row.update(parity_cancel_paging(seed, dev))
    row.update(parity_config_server(seed, dev))
    launches = dict(kernels.LAUNCHES)
    log(f"parity-65k: launches {({k: v for k, v in launches.items() if v})}")
    return launches, [row]


def run_compact_phase(seed, dev):
    """compact-16k: COMPACT_SERIES counters x T with 1% missed scrapes
    (make_counter_slab's NaN gaps) and COMPACT_GAUGES integer gauges `m`
    (bench.py's longrange values), on a LocalDiskColumnStore in a
    temporary directory, each slab through a WalManager there in the
    remote-write door's sequence: the hot panel (K3); a FlushScheduler
    (COMPACT_FLUSH_S interval, wal=the manager) flushes every group,
    reports the persisted horizon (the earliest checkpoint) and so
    prunes the sealed segment that holds the counters' slab, then stops
    with a final flush; SegmentCompactor.compact_all over 1 h windows
    (two segments a schema); the panel through PersistedClusterPlanner
    over the segments (K3 over the merged ragged block) against the hot
    answer (rtol 5e-4, atol 1e-4); sum(m) stitched by
    LongTimeRangePlanner (segments | a live tail) bit-identical to the
    all-in-memory store; COMPACT_TAIL scrape records past the flush
    through the WAL; a restart (a fresh memstore on the directory,
    recover_index, then WalManager.replay from the restart points in
    LocalDiskMetaStore: the slab record left in the log skipped, exactly
    the tail replayed) whose panel pages the frames back and answers as
    before, and over the grid and the tail within rtol 5e-4 / atol 1e-4
    of the f64 oracle (K3); a few gauges ended, evicted
    (evict_ended_partitions) and compact_index: the panel the same to the
    bit; and SelectChunkInfosExec over the flushed chunks -> (launches,
    rows)."""
    import shutil
    import tempfile

    import torch
    from filodb_tpu_torch.core.devicecache import ColdSegmentCache
    from filodb_tpu_torch.core.flush import FlushScheduler
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.core.partkey import PartKey
    from filodb_tpu_torch.ops import kernels
    from filodb_tpu_torch.persist.compactor import SegmentCompactor
    from filodb_tpu_torch.persist.localstore import (LocalDiskColumnStore,
                                                     LocalDiskMetaStore)
    from filodb_tpu_torch.persist.segments import PersistedTier, SegmentStore
    from filodb_tpu_torch.query.engine import QueryEngine
    from filodb_tpu_torch.query.metaexec import SelectChunkInfosExec
    from filodb_tpu_torch.query.planner import SingleClusterPlanner
    from filodb_tpu_torch.query.planners import (LongTimeRangePlanner,
                                                 PersistedClusterPlanner)
    from filodb_tpu_torch.query.rangevector import QueryContext
    from filodb_tpu_torch.utils.metrics import registry
    from filodb_tpu_torch.wal import WalManager
    from filodb_tpu_torch.wal.segment import list_segments
    n = COMPACT_SERIES
    rng = np.random.default_rng(seed)
    vals = make_counter_slab(rng, n, 0.01)
    ng = COMPACT_GAUGES
    gauge = (np.arange(ng)[:, None] % 97 * 10.0
             + (np.arange(T) % 11)[None, :])
    ts_row = COLD_START_MS + np.arange(T, dtype=np.int64) * STEP_MS
    keys = counter_keys(n)
    gkeys = [PartKey("m", (("inst", f"i{i}"), ("_ws_", "bench"),
                           ("_ns_", "lr"))) for i in range(ng)]
    start_s, end_s = COLD_START_MS // 1000 + 600, int(ts_row[-1]) // 1000
    wends = np.arange(start_s * 1000, int(ts_row[-1]) + 1, 60_000)
    want = rate_by_ns(torch.from_numpy(vals).to(dev), ts_row, wends)
    root = tempfile.mkdtemp(prefix="filodb-compact-")
    kernels.reset_launch_counts()
    mapper = one_shard_mapper()

    def panel(eng, what, kernel, q=RATE_Q, tol=(5e-4, 1e-4), oracle=True,
              end=end_s):
        n0 = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        res = eng.query_range(q, start_s, 60, end, scan_params())
        secs = time.perf_counter() - t0
        check(res.error is None, f"compact-16k {what}: {res.error}")
        check(set(launched(n0)) == {kernel},
              f"compact-16k: {what} launched {launched(n0)}, expected "
              f"{kernel}")
        msg = ""
        if oracle:
            _, err, rel = compare(res, want if end == end_s else want_tail,
                                  *tol, f"compact-16k {what}")
            msg = f"; oracle max_abs_err {err} max_rel_err {rel}"
        log(f"compact-16k: {what}: {secs:.4f} s via {kernel}; cold tier "
            f"{res.stats.cold_tier or '-'}; samples paged "
            f"{res.stats.samples_paged}{msg}")
        return res

    wal_root = os.path.join(root, "wal")
    wal = None
    try:
        cs = LocalDiskColumnStore(root)
        ms = TimeSeriesMemStore(column_store=cs,
                                meta_store=LocalDiskMetaStore(root))
        shard = ms.setup("prometheus", 0)
        wal = WalManager(wal_root, "prometheus")

        def door(schema, part_keys, ts, cols):
            """One remote-write request: append, ingest at the seq, commit
            before the ack."""
            seq = wal.append_grid(0, schema, part_keys, ts, cols, wait=False)
            shard.ingest_columns(schema, part_keys, ts, cols, offset=seq)
            wal.commit(seq)
            return seq
        door("prom-counter", keys, np.broadcast_to(ts_row, (n, T)),
             {"count": vals})
        slab_seq = door("gauge", gkeys, np.broadcast_to(ts_row, (ng, T)),
                        {"value": gauge})
        wal_segs = list_segments(wal.dir)
        eng = QueryEngine("prometheus", ms, mapper)
        hot = panel(eng, "hot panel", "fused_rate_ragged")
        pruned = registry.counter("wal_segments_pruned", dataset="prometheus")
        horizon_g = registry.gauge("wal_persisted_horizon",
                                   dataset="prometheus")
        p0, c0 = pruned.value, shard.stats.chunks_flushed
        sched = FlushScheduler(ms, "prometheus", interval_s=COMPACT_FLUSH_S,
                               wal=wal)
        t0 = time.perf_counter()
        sched.start()
        # the first full rotation ends with the horizon report
        deadline = t0 + 300
        while horizon_g.value != slab_seq and time.perf_counter() < deadline:
            time.sleep(0.05)
        rotation_s = time.perf_counter() - t0
        sched.stop(final_flush=True)
        flush_s = time.perf_counter() - t0
        chunks = shard.stats.chunks_flushed - c0
        check(chunks == n + ng, f"compact-16k: {chunks} chunks flushed")
        earliest = ms.meta_store.read_earliest_checkpoint("prometheus", 0)
        horizon = horizon_g.value
        left = list_segments(wal.dir)
        check(pruned.value - p0 >= 1 and horizon == earliest == slab_seq,
              f"compact-16k: the WAL pruned {pruned.value - p0} segments "
              f"(persisted horizon {horizon}, earliest checkpoint "
              f"{earliest}, last slab seq {slab_seq})")
        log(f"compact-16k: the slabs as WAL records 0-{slab_seq} in "
            f"{len(wal_segs)} segments; FlushScheduler ({COMPACT_FLUSH_S} s "
            f"interval, wal=the manager): the first rotation reported the "
            f"horizon after {rotation_s:.3f} s, {sched.flushes} group "
            f"flushes, {sched.errors} errors; wal_persisted_horizon "
            f"{horizon} = the earliest checkpoint; "
            f"{int(pruned.value - p0)} sealed segment(s) pruned, "
            f"{len(left)} left")
        seg_store = SegmentStore(root)
        comp = SegmentCompactor(cs, seg_store, "prometheus", 1,
                                window_ms=COMPACT_WINDOW_MS,
                                closed_lag_ms=0)
        t0 = time.perf_counter()
        written = comp.compact_all(now_ms=int(ts_row[-1])
                                   + 10 * COMPACT_WINDOW_MS)
        compact_s = time.perf_counter() - t0
        metas = seg_store.list("prometheus", 0)
        check(written == 4 and len(metas) == 4,
              f"compact-16k: {written} segments written, {len(metas)} "
              f"listed")
        seg_bytes = sum(m.file_bytes for m in metas)
        counter_meta = next(m for m in metas
                            if m.schema_name == "prom-counter")
        t0 = time.perf_counter()
        seg_store.load(counter_meta)
        decode_s = time.perf_counter() - t0
        log(f"compact-16k: {n} counters (1% missed scrapes) and {ng} "
            f"integer gauges x {T}: the scheduler and its final flush "
            f"{chunks} chunks in {flush_s:.3f} s; compact_all {written} segments in "
            f"{compact_s:.3f} s, {seg_bytes} B; one counter segment "
            f"({counter_meta.num_series} x {counter_meta.num_steps}) "
            f"decoded in {decode_s:.3f} s")
        tier = PersistedTier(seg_store, "prometheus", 1,
                             ColdSegmentCache(COLD_BUDGET))
        eng_p = QueryEngine("prometheus", ms, mapper,
                            planner=PersistedClusterPlanner(
                                "prometheus", mapper, tier))
        cold = panel(eng_p, "persisted panel", "fused_rate_ragged")
        check(cold.stats.cold_tier == "cold_paged",
              f"compact-16k: persisted verdict {cold.stats.cold_tier}")
        a = {k: v for k, _, v in hot.series()}
        for k, _, v in cold.series():
            check(bool(np.allclose(v, a[k], rtol=5e-4, atol=1e-4,
                                   equal_nan=True)),
                  f"compact-16k: persisted panel {k} differs from the hot "
                  f"answer")
        panel(eng_p, "persisted panel warm", "fused_rate_ragged")
        # the stitched integer gauges (bench.py:3524-3525)
        tail_from = T - (T // 4)
        ms_live = TimeSeriesMemStore()
        ms_live.setup("prometheus", 0).ingest_columns(
            "gauge", gkeys, np.broadcast_to(ts_row[tail_from:],
                                            (ng, T - tail_from)),
            {"value": gauge[:, tail_from:]})
        earliest_raw = int(ts_row[tail_from])
        ltr = LongTimeRangePlanner(
            SingleClusterPlanner("prometheus", mapper), None,
            earliest_raw_time_fn=lambda: earliest_raw,
            latest_downsample_time_fn=lambda: 1 << 62,
            persisted_planner=PersistedClusterPlanner("prometheus", mapper,
                                                      tier),
            persisted_range_fn=tier.range)
        eng_t = QueryEngine("prometheus", ms_live, mapper, planner=ltr)
        st = panel(eng_t, "sum(m) stitched", "fused_last_dense", "sum(m)",
                   oracle=False)
        ref = panel(eng, "sum(m) all in memory", "fused_last_dense",
                    "sum(m)", oracle=False)
        same_answers(st, ref, "compact-16k sum(m) stitched")
        log("compact-16k: sum(m) stitched (segments | live tail) "
            "bit-identical to the all-in-memory store")
        del eng_t, ms_live, eng_p, tier
        # scrapes past the last flush: acknowledged, in the WAL only
        valid = ~np.isnan(vals)
        lastv = vals[np.arange(n), T - 1 - np.argmax(valid[:, ::-1], axis=1)]
        tail = lastv[:, None] + np.cumsum(
            rng.exponential(10.0, size=(n, COMPACT_TAIL)), axis=1)
        ts_tail = int(ts_row[-1]) + STEP_MS * np.arange(
            1, COMPACT_TAIL + 1, dtype=np.int64)
        t0 = time.perf_counter()
        for j in range(COMPACT_TAIL):
            tail_seq = door("prom-counter", keys,
                            np.full((n, 1), ts_tail[j], np.int64),
                            {"count": tail[:, j:j + 1]})
        tail_s = time.perf_counter() - t0
        ts_ext = np.concatenate([ts_row, ts_tail])
        end_tail = int(ts_ext[-1]) // 1000
        want_tail = rate_by_ns(
            torch.from_numpy(np.concatenate([vals, tail], axis=1)).to(dev),
            ts_ext, np.arange(start_s * 1000, int(ts_ext[-1]) + 1, 60_000))
        # a restart on the same directory: the crash leaves the committed
        # log and the column store
        wal.close()
        cs.close()
        meta2 = LocalDiskMetaStore(root)
        ms2 = TimeSeriesMemStore(column_store=LocalDiskColumnStore(root),
                                 meta_store=meta2)
        shard2 = ms2.setup("prometheus", 0)
        t0 = time.perf_counter()
        recovered = shard2.recover_index()
        recover_s = time.perf_counter() - t0
        check(recovered == n + ng,
              f"compact-16k: recover_index found {recovered} partitions")
        wal = WalManager(wal_root, "prometheus")
        # the slab records still in the log (the pruned segment held the
        # counters' record)
        in_log = slab_seq - list_segments(wal.dir)[0][0] + 1
        restart_points = {0: meta2.read_earliest_checkpoint("prometheus", 0)}
        st = wal.replay(ms2, restart_points)
        check(restart_points == {0: slab_seq}
              and (st.records, st.samples, st.skipped_records,
                   st.corrupt_segments, st.last_seq)
              == (COMPACT_TAIL, COMPACT_TAIL * n, in_log, 0, tail_seq),
              f"compact-16k: replay from {restart_points}: records "
              f"{st.records}, samples {st.samples}, skipped "
              f"{st.skipped_records}, corrupt {st.corrupt_segments}, last "
              f"seq {st.last_seq}")
        log(f"compact-16k: {COMPACT_TAIL} scrape records (seqs "
            f"{slab_seq + 1}-{tail_seq}) past the flush in {tail_s:.3f} s; "
            f"restart: replay from the restart point {restart_points[0]} "
            f"skipped the {in_log} slab record(s) left in the log and "
            f"replayed {st.records} records, {st.samples} samples, in "
            f"{st.elapsed_s:.3f} s")
        plan = SelectChunkInfosExec(
            QueryContext(), "prometheus", 0, [], 0, 1 << 62)
        res, _ = plan._do_execute(ms2)
        tiers = {}
        for r in res.data:
            tiers[r["tier"]] = tiers.get(r["tier"], 0) + 1
        check(tiers == {"persisted": n + ng, "dense": n},
              f"compact-16k: SelectChunkInfosExec rows by tier {tiers}")
        eng2 = QueryEngine("prometheus", ms2, mapper)
        again = panel(eng2, "panel after restart", "fused_rate_ragged")
        check(again.stats.samples_paged > 0,
              "compact-16k: the restart paged nothing back")
        for k, _, v in again.series():
            check(bool(np.allclose(v, a[k], rtol=5e-4, atol=1e-4,
                                   equal_nan=True)),
                  f"compact-16k: {k} after the restart differs")
        same = [(k.labels, np.asarray(v).tobytes())
                for k, _, v in again.series()] == \
            [(k.labels, np.asarray(v).tobytes()) for k, _, v in hot.series()]
        covered = panel(eng2, "panel over the grid and the replayed tail",
                        "fused_rate_ragged", end=end_tail)
        # a few gauges end; eviction tombstones them, compaction prunes
        # the index's postings: the panel's answer stays to the bit
        ended = [p.part_id for p in shard2.partitions
                 if p.schema_name == "gauge"][:COMPACT_ENDED]
        for pid in ended:
            shard2.index.update_end_time(pid, int(ts_row[-1]))
        evicted = shard2.evict_ended_partitions(int(ts_ext[-1]))
        tombstones = shard2.index.tombstone_count
        compacted = shard2.compact_index()
        check(evicted == len(ended) == tombstones and compacted
              and shard2.index.tombstone_count == 0,
              f"compact-16k: evicted {evicted} of {len(ended)} ended gauges, "
              f"tombstones {tombstones}, compact_index {compacted}")
        after = panel(eng2, "panel after compact_index", "fused_rate_ragged",
                      end=end_tail)
        same_answers(after, covered, "compact-16k compact_index")
        log(f"compact-16k: {evicted} ended gauges evicted, compact_index "
            f"pruned {tombstones} tombstones; the panel over the tail "
            f"bit-identical before and after")
        log(f"compact-16k: restart: recover_index {recovered} partitions "
            f"in {recover_s:.3f} s; the panel paged back "
            f"{again.stats.samples_paged} samples and answers as before "
            f"({'bit-identical' if same else 'within rtol 5e-4 / atol 1e-4'}"
            f"); SelectChunkInfosExec over the recovered shard: rows by "
            f"tier {tiers}")
        launches = dict(kernels.LAUNCHES)
        return launches, [dict(flush_s=flush_s, compact_s=compact_s,
                               seg_bytes=seg_bytes, decode_s=decode_s,
                               replay_s=st.elapsed_s)]
    finally:
        if wal is not None:
            wal.close()
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------- the composed planners

SKR_QUERY = 'sum by (_ns_) (rate(request_total{_ns_=~"App-1[0-9]"}[5m]))'


def run_planners_phase(eng, http, warm):
    """planners-1M on the serve-1M server and store: each composed
    planner's engine over the same memstore, its remote children calling
    the server over localhost HTTP through planners._http_transport (with
    the scan cap every query of this script raises), once cold and
    `warm` times warm, each answer bit-identical to the local-only one:
    HighAvailabilityPlanner (a 30 min local failure mid-range: local |
    PromQlRemoteExec | local), MultiPartitionPlanner (the remote
    partition owns the first hour), ShardKeyRegexPlanner (SKR_QUERY
    fanned out to 10 leaves under MultiPartitionReduceAggregateExec,
    against a SingleClusterPlanner engine's p50 and answer),
    SinglePartitionPlanner by metric; explain of each; K1 launches
    counted per run (the server's own, for the remote children,
    included).  The local-only answer is the node's engine's, whose
    ShardKeyRegexPlanner also fans SKR_QUERY out to 10 leaves ->
    (launches, rows)."""
    import torch
    from filodb_tpu_torch.ops import kernels
    from filodb_tpu_torch.promql.parser import (TimeStepParams,
                                                query_range_to_logical_plan)
    from filodb_tpu_torch.query import planners as pl
    from filodb_tpu_torch.query.engine import QueryEngine
    from filodb_tpu_torch.query.planner import SingleClusterPlanner
    from filodb_tpu_torch.query.planutils import TimeRange
    from filodb_tpu_torch.query.rangevector import QueryContext
    start_s = START_MS // 1000 + 600
    end_s = START_MS // 1000 + (T - 1) * STEP_MS // 1000
    endpoint = http.base + "/api/v1/query_range"

    def transport(ep, params):
        return pl._http_transport(ep, {**params, "scanLimit": SCAN_LIMIT})

    def local():
        return SingleClusterPlanner("prometheus", eng.shard_mapper)

    mid = start_s * 1000 + 40 * 60_000

    class Failures(pl.FailureProvider):
        def get_failures(self, dataset, tr):
            return [pl.FailureTimeRange("local", TimeRange(
                mid, mid + 30 * 60_000))]

    class Partitions(pl.PartitionLocationProvider):
        def get_partitions(self, filters, tr):
            cut = start_s * 1000 + 3600_000
            return [pl.PartitionAssignment("remote", endpoint,
                                           TimeRange(0, cut - 1)),
                    pl.PartitionAssignment("local", "",
                                           TimeRange(cut, 1 << 62))]
    shard = eng.source.get_shard("prometheus", 0)
    cases = [
        ("ha", RATE_Q, pl.HighAvailabilityPlanner(
            "prometheus", local(), Failures(), endpoint,
            transport=transport)),
        ("multi-partition", RATE_Q, pl.MultiPartitionPlanner(
            Partitions(), "local", local(), transport=transport)),
        ("shard-key regex", SKR_QUERY, pl.ShardKeyRegexPlanner(
            local(), pl.default_shard_key_matcher(
                shard.index.label_values, ("_ws_", "_ns_")))),
        ("single-partition", RATE_Q, pl.SinglePartitionPlanner(
            {"raw": local(), "other": pl.ShardKeyRegexPlanner(
                local(), lambda fs: [])},
            planner_selector=lambda m: "raw" if m == "request_total"
            else "other")),
    ]
    expect_root = {"ha": "StitchRvsExec", "multi-partition": "StitchRvsExec",
                   "shard-key regex": "MultiPartitionReduceAggregateExec",
                   "single-partition": "ReduceAggregateExec"}
    kernels.reset_launch_counts()
    rows = []

    def run(e, q):
        n0 = kernels.LAUNCHES["fused_rate_dense"]
        t0 = time.perf_counter()
        res = e.query_range(q, start_s, 60, end_s, scan_params())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(res.error is None, f"planners-1M `{q}`: {res.error}")
        return res, secs, kernels.LAUNCHES["fused_rate_dense"] - n0

    refs = {}
    for name, q, planner in cases:
        if q not in refs:
            refs[q] = run(eng, q)
        ref = refs[q][0]
        composed = QueryEngine("prometheus", eng.source, eng.shard_mapper,
                               planner=planner)
        ep = planner.materialize(query_range_to_logical_plan(
            q, TimeStepParams(start_s, 60, end_s)), QueryContext())
        tree = ep.print_tree()
        check(type(ep).__name__ == expect_root[name],
              f"planners-1M {name}: plan root {type(ep).__name__}")
        if name == "ha":
            kinds = [type(c).__name__ for c in ep.children]
            check(len(kinds) == 3 and kinds[1] == "PromQlRemoteExec"
                  and kinds[0] == kinds[2] != "PromQlRemoteExec",
                  f"planners-1M ha: children {kinds}")
        if name == "shard-key regex":
            check(len(ep.children) == 10,
                  f"planners-1M: {len(ep.children)} fan-out leaves")
        log(f"planners-1M: explain {name}:\n{tree}")
        secs, k1 = [], []
        for i in range(warm + 1):
            res, s, n_k1 = run(composed, q)
            ka = [(k.labels, np.asarray(v, np.float64).tobytes())
                  for k, _, v in res.series()]
            kb = [(k.labels, np.asarray(v, np.float64).tobytes())
                  for k, _, v in ref.series()]
            check(ka == kb, f"planners-1M {name} run {i}: not bit-identical "
                  f"to the local-only answer")
            secs.append(s)
            k1.append(n_k1)
        check(min(k1) > 0 and len(set(k1[1:])) == 1,
              f"planners-1M {name}: K1 launches a run {k1}")
        line = (f"planners-1M: {name} `{q}`: {warm_line(secs)}; K1 launches "
                f"a run {k1} (cold, then warm); bit-identical to the local "
                f"answer ({res.num_series} series)")
        if name == "shard-key regex":
            bare = QueryEngine("prometheus", eng.source, eng.shard_mapper,
                               planner=local())
            single = [run(bare, q) for _ in range(warm + 1)]
            single_s = [s for _, s, _ in single]
            for i, (r, _, _) in enumerate(single):
                kc = [(k.labels, np.asarray(v, np.float64).tobytes())
                      for k, _, v in r.series()]
                check(kc == kb, f"planners-1M: SingleClusterPlanner run {i} "
                      f"is not bit-identical to the node's engine")
            line += (f"; the node's engine (ShardKeyRegexPlanner over "
                     f"SingleClusterPlanner) K1 launches {refs[q][2]}; "
                     f"SingleClusterPlanner alone: {warm_line(single_s)}, "
                     f"K1 launches a run {[k for _, _, k in single]}, "
                     f"bit-identical")
        log(line)
        rows.append(dict(name=name, p50=float(np.percentile(secs[1:], 50)),
                         k1=k1))
    return dict(kernels.LAUNCHES), rows


# ----------------------------------------------------------- the doors

WRITE_SCRAPES = 1                  # write-1M: scrapes of every series
WRITE_BATCH = 2_000                # queue_config.max_samples_per_send
WRITE_CLIENTS = 4                  # remote-write shards of the sender
READ_NS = "App-7"                  # write-1M's remote-read selector
BROKER_SERIES = 16_384             # broker-16k (host line parsing: cut)
BROKER_SCRAPES = 36                # 6 min at 10 s
INFLUX_HTTP_LINES = 4_096          # broker-16k's POST /influx/write


def post_raw(port, path, body, headers=None):
    """One POST to the localhost server -> (status, body bytes,
    seconds)."""
    import http.client
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, body=body, headers=headers or {})
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, raw, time.perf_counter() - t0
    finally:
        conn.close()


def write_labels(i):
    """Series i's labels as a Prometheus server sends them (dense-1M's:
    counter_keys)."""
    return [("__name__", "request_total"), ("_ws_", "demo"),
            ("_ns_", f"App-{i % NUM_NS}"), ("instance", f"Instance-{i}"),
            ("dc", f"DC{i % 2}")]


def write_label_blobs(num_series):
    """Each series' labels as the bytes of a prompb TimeSeries without
    samples, made once: a scrape's request is then these bytes and one
    Sample each (write_request)."""
    from filodb_tpu_torch.http import remotepb
    return [remotepb.encode_timeseries(remotepb.PromTimeSeries(
        write_labels(i), [])) for i in range(num_series)]


def write_request(blobs, vals, ts_ms, lo, hi):
    """The WriteRequest bytes of series lo..hi-1, one sample each: field
    1 (TimeSeries, length-delimited) around each series' label bytes
    followed by its Sample field, what remotepb.encode_write_request
    gives for the same series (checked on the first request)."""
    from filodb_tpu_torch.http import remotepb
    from filodb_tpu_torch.utils.varint import write_uvarint
    out = []
    for i in range(lo, hi):
        ts = blobs[i] + remotepb.encode_timeseries(remotepb.PromTimeSeries(
            [], [(float(vals[i]), ts_ms)]))
        out.append(b"\x0a" + write_uvarint(len(ts)) + ts)
    return b"".join(out)


def run_write_phase(eng, ms, api, http, wal, num_series, seed, dev):
    """write-1M on the serve-1M server over the recovered dense-1M store
    (its gateway pipeline's WAL the recovered WalManager): WRITE_SCRAPES
    scrapes of every series, one sample each 10 s after the store's last,
    each series' counter going on by an increment from the seed; each
    scrape as snappy WriteRequests of WRITE_BATCH series (encoded before
    the clock starts), POSTed to /api/v1/write by WRITE_CLIENTS threads.
    Every request answers 204; the store's new column is the values
    sent; the headline panel over the 110 steps ending at the scrape,
    through HTTP query_range, is no result-cache hit, pays an incremental
    refresh and launches K1, runs warm bit-identical, both within rtol
    2e-4 / atol 1e-3 of the f64 oracle of the grown slab.  Then remote
    read of READ_NS over the last 10 min to the bit, status/tsdb,
    metering/cardinality, the tenant panel's ingest grown by the samples
    sent, and the WAL's seq grown by the slabs -> (launches, rows)."""
    import torch
    from filodb_tpu_torch.http import remotepb
    from filodb_tpu_torch.ops import kernels
    from filodb_tpu_torch.utils import snappy
    from filodb_tpu_torch.utils.counters import counters
    shard = ms.get_shard("prometheus", 0)
    store = store_rows(ms, num_series)
    mirror = store.device_mirror
    n_t = T + WRITE_SCRAPES
    ts_row = START_MS + np.arange(n_t, dtype=np.int64) * STEP_MS
    check(int(store.counts[:num_series].min()) == T
          and int(store.counts[:num_series].max()) == T,
          "write-1M: the store does not hold T samples a series")
    t0 = time.perf_counter()
    vals = torch.full((num_series, n_t), float("nan"), dtype=torch.float64,
                      device=dev)
    for i0 in range(0, num_series, SLAB):
        vals[i0:i0 + SLAB, :T] = torch.from_numpy(
            store.cols["count"][i0:min(i0 + SLAB, num_series), :T]).to(dev)
    last = store.cols["count"][:num_series, T - 1].copy()
    blobs = write_label_blobs(num_series)
    prep_s = time.perf_counter() - t0
    # the door's stage split, summed over the requests of a scrape
    door = []
    traced = api._remote_write_traced

    def keep_stats(dataset, body, hdr, stats):
        try:
            return traced(dataset, body, hdr, stats)
        finally:
            door.append(stats)
    api._remote_write_traced = keep_stats

    def tenants():
        """-> (tenant demo's ingestSamples, every tenant row's); the
        accountant keeps UsageAccountant.MAX_TENANTS (ws, ns) rows and
        books the rest under the overflow row, so demo's 1,000 _ns_ are
        partly there."""
        st, p, _ = http.call("GET", "/admin/tenants")
        check(st == 200, f"write-1M: /admin/tenants answered {st}")
        rows = p["data"]["tenants"]
        return (sum(t["ingestSamples"] for t in rows if t["ws"] == "demo"),
                sum(t["ingestSamples"] for t in rows))
    demo0, all0 = tenants()
    seq0 = wal.writer.next_seq
    srng = np.random.default_rng(seed + 200)
    scan = {"scanLimit": str(SCAN_LIMIT), "stats": "true"}
    headers = {"Content-Type": "application/x-protobuf",
               "Content-Encoding": "snappy",
               "X-Prometheus-Remote-Write-Version": "0.1.0"}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    err0 = counters.get("device_mirror_incremental_errors")
    log(f"write-1M: {num_series} series' values on the card for the oracle "
        f"and their label bytes made in {prep_s:.3f} s; /admin/tenants' "
        f"ingestSamples {all0} (demo's row {demo0}); WAL next seq {seq0}")
    rows = []
    slabs = 0
    try:
        for j in range(1, WRITE_SCRAPES + 1):
            c = T - 1 + j
            ts_ms = int(ts_row[c])
            new = last + srng.exponential(10.0, size=num_series)
            t1 = time.perf_counter()
            bounds = [(lo, min(lo + WRITE_BATCH, num_series))
                      for lo in range(0, num_series, WRITE_BATCH)]
            bodies = [snappy.compress(write_request(blobs, new, ts_ms, lo,
                                                    hi))
                      for lo, hi in bounds]
            enc_s = time.perf_counter() - t1
            if j == 1:
                lo, hi = bounds[0]
                check(snappy.decompress(bodies[0])
                      == remotepb.encode_write_request([
                          remotepb.PromTimeSeries(write_labels(i),
                                                  [(float(new[i]), ts_ms)])
                          for i in range(lo, hi)]),
                      "write-1M: a request's bytes differ from "
                      "remotepb.encode_write_request")
            del door[:]
            lock = threading.Lock()
            todo = iter(range(len(bodies)))
            answers = [None] * len(bodies)

            def client():
                while True:
                    with lock:
                        k = next(todo, None)
                    if k is None:
                        return
                    st, raw, secs = post_raw(http.port, "/api/v1/write",
                                             bodies[k], headers)
                    answers[k] = (st, secs, raw[:200])
            with GcPauses() as gcp:
                t1 = time.perf_counter()
                threads = [threading.Thread(target=client)
                           for _ in range(WRITE_CLIENTS)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                wall = time.perf_counter() - t1
            bad = [(k, a) for k, a in enumerate(answers)
                   if a is None or a[0] != 204]
            check(not bad, f"write-1M: scrape {j}: {len(bad)} requests did "
                  f"not answer 204, first {bad[:1]}")
            check(len(door) == len(bodies),
                  f"write-1M: {len(door)} door stats for {len(bodies)} "
                  f"requests")
            check(np.array_equal(store.ts[:num_series, c],
                                 np.full(num_series, ts_ms))
                  and store.cols["count"][:num_series, c].tobytes()
                  == new.tobytes(),
                  f"write-1M: scrape {j}: the store's new column is not the "
                  f"values sent")
            vals[:, c] = torch.from_numpy(new).to(dev)
            last = new
            lat = [a[1] for a in answers]
            split = {k: sum(getattr(s, k) for s in door) for k in (
                "decode_s", "admission_s", "build_slabs_s", "wal_append_s",
                "ingest_s", "wal_commit_wait_s")}
            slabs += sum(s.slabs for s in door)
            check(sum(s.ingested for s in door) == num_series
                  and sum(s.dropped for s in door) == 0,
                  f"write-1M: scrape {j} ingested "
                  f"{sum(s.ingested for s in door)} dropped "
                  f"{sum(s.dropped for s in door)}")
            # the headline panel over the 110 steps ending at the scrape
            start_s, end_s, wends = scrape_windows(ts_ms)
            params = {"query": LIVE_QUERY, "start": start_s, "end": end_s,
                      "step": 60, **scan}
            incr0 = counters.get("device_mirror_incremental")
            n0 = dict(kernels.LAUNCHES)
            st, p1, q_s = http.call("GET", "/api/v1/query_range", params)
            check(st == 200, f"write-1M: the panel answered {st}: "
                  f"{p1.get('error')}")
            launched = sorted(k for k, v in kernels.LAUNCHES.items()
                              if v > n0.get(k, 0))
            check(launched == ["fused_rate_dense"],
                  f"write-1M: scrape {j}'s panel launched {launched}, not "
                  f"K1 (fused_rate_dense)")
            check(counters.get("device_mirror_incremental") == incr0 + 1
                  and mirror.last_refresh_kind == "incremental",
                  f"write-1M: scrape {j}'s refresh was "
                  f"{mirror.last_refresh_kind}, not incremental")
            check(counters.get("device_mirror_incremental_errors") == err0,
                  f"write-1M: incremental errors after scrape {j}")
            verdict = p1["stats"]["cache"]["result"]
            check(verdict != "hit",
                  f"write-1M: scrape {j}'s panel was a result-cache hit")
            st, p2, warm_s = http.call("GET", "/api/v1/query_range", params)
            check(st == 200 and series_map(p2) == series_map(p1),
                  f"write-1M: scrape {j}'s warm panel is not bit-identical")
            want = rate_by_ns(vals[:, :c + 1], ts_row[:c + 1], wends)
            err, rel = matrix_close(matrix_of(p1, wends), want, *KERNEL_TOL,
                                    f"write-1M scrape {j}")
            log(f"write-1M: scrape {j}: {len(bodies)} requests of "
                f"{WRITE_BATCH} series by {WRITE_CLIENTS} clients in "
                f"{wall:.3f} s ({num_series / wall:.1f} samples/s; encoded "
                f"before the clock in {enc_s:.3f} s, "
                f"{sum(len(b) for b in bodies)} B); request p50 "
                f"{np.percentile(lat, 50):.4f} s p99 "
                f"{np.percentile(lat, 99):.4f} s; door split summed over "
                f"the requests (s): "
                + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
                + f"; {gcp}; refresh {mirror.last_refresh_kind} "
                f"{mirror.last_refresh_s:.4f} s, {mirror.last_upload_bytes} "
                f"B; the paying panel {q_s:.4f} s via K1 (result cache "
                f"{verdict or 'bypass'}), warm {warm_s:.4f} s "
                f"({p2['stats']['cache']['result'] or 'bypass'}), "
                f"bit-identical; oracle max_abs_err {err} max_rel_err {rel}")
            rows.append(dict(scrape=j, wall_s=wall, encode_s=enc_s,
                             p50=float(np.percentile(lat, 50)),
                             p99=float(np.percentile(lat, 99)), gc_s=gcp.seconds,
                             refresh_s=mirror.last_refresh_s, query_s=q_s,
                             **split))
    finally:
        del api._remote_write_traced
    launches = dict(kernels.LAUNCHES)
    del vals
    # remote read: READ_NS over the last 10 min, to the bit
    end_ms = int(ts_row[-1])
    lo_ms = end_ms - 600_000
    rq = snappy.compress(remotepb.encode_read_request([remotepb.PromQuery(
        lo_ms, end_ms, [remotepb.LabelMatcher(remotepb.EQ, "_ns_",
                                              READ_NS)])]))
    st, raw, read_s = post_raw(http.port, "/api/v1/read", rq,
                               {"Content-Type": "application/x-protobuf"})
    check(st == 200, f"write-1M: remote read answered {st}: {raw[:200]}")
    got = remotepb.decode_read_response(snappy.decompress(raw))[0]
    want_rows = [i for i in range(num_series)
                 if f"App-{i % NUM_NS}" == READ_NS]
    check(len(got) == len(want_rows),
          f"write-1M: remote read returned {len(got)} series, "
          f"{len(want_rows)} expected")
    # the read gathers each series' window rebased in f64 on its first
    # gathered sample b and adds b back, as the reference's does: (v - b)
    # + b, which is v but where v - b rounds (a reset inside the window);
    # timestamps to the bit, values within that rounding (1e-12 of the
    # window's largest value, as tests/test_remote_read.py holds it)
    n_samples = n_exact = n_first = 0
    moved = 0.0
    for s in got:
        i = int(dict(s.labels)["instance"].split("-")[1])
        cnt = int(store.counts[i])
        ts_i = store.ts[i, :cnt]
        sel = (ts_i >= lo_ms) & (ts_i <= end_ms)
        t_got = np.array([t for _, t in s.samples], dtype=np.int64)
        v_got = np.array([v for v, _ in s.samples], dtype=np.float64)
        v_store = store.cols["count"][i, :cnt][sel]
        ok_ts = np.array_equal(t_got, ts_i[sel]) and t_got[-1] == end_ms
        diff = np.abs(v_got - v_store) if ok_ts else np.array([np.inf])
        check(ok_ts and (diff <= 1e-12 * max(1.0, float(np.abs(
                  v_store).max()))).all(),
              f"write-1M: remote read of Instance-{i} differs from the "
              f"store: timestamps {'equal' if ok_ts else 'differ'} "
              f"({len(t_got)} read, {int(sel.sum())} stored), max abs "
              f"diff {float(diff.max())}; read {v_got[:4].tolist()} ... "
              f"{v_got[-2:].tolist()}, stored {v_store[:4].tolist()} ... "
              f"{v_store[-2:].tolist()}")
        n_samples += len(t_got)
        n_exact += int((v_got == v_store).sum())
        n_first += int((v_got == (v_store - v_store[0]) + v_store[0]).sum())
        moved = max(moved, float(diff.max()))
    st, tsdb, tsdb_s = http.call("GET", "/api/v1/status/tsdb")
    data = tsdb["data"]
    check(st == 200 and data["headStats"]["numSeries"] == num_series
          and {"name": "demo", "value": num_series}
          in data["seriesCountByTenant"]
          and {"name": "request_total", "value": num_series}
          in data["seriesCountByMetricName"],
          f"write-1M: /api/v1/status/tsdb answered {st}: "
          f"{data.get('headStats')}")
    st, card, card_s = http.call("GET", "/api/v1/metering/cardinality",
                                 {"prefix": "", "k": "5"})
    check(st == 200 and card["data"][0]["prefix"] == ["demo"]
          and card["data"][0]["tsCount"] == num_series,
          f"write-1M: metering/cardinality answered {st}: "
          f"{card.get('data', [])[:1]}")
    demo1, all1 = tenants()
    check(all1 - all0 == WRITE_SCRAPES * num_series,
          f"write-1M: the tenants' ingestSamples grew by {all1 - all0} "
          f"(demo {demo1 - demo0}), {WRITE_SCRAPES * num_series} sent")
    seq1 = wal.writer.next_seq
    check(seq1 - seq0 == slabs and wal.writer.committed_seq == seq1 - 1,
          f"write-1M: the WAL's seq grew by {seq1 - seq0} (committed "
          f"{wal.writer.committed_seq}), {slabs} slabs appended")
    log(f"write-1M: remote read of _ns_={READ_NS} over the last 10 min: "
        f"{len(got)} series, {n_samples} samples in {read_s:.4f} s, "
        f"timestamps to the bit; values: {n_exact} bit-identical to the "
        f"store's, {n_first} to (v - b) + b with b the window's first "
        f"sample, max abs diff {moved}; status/tsdb "
        f"{data['headStats']} in {tsdb_s:.3f} s; metering/cardinality "
        f"{card['data'][0]} in {card_s:.3f} s; /admin/tenants' "
        f"ingestSamples +{all1 - all0} (demo's row +{demo1 - demo0}, the "
        f"overflow row the rest); WAL seq {seq0} -> {seq1} "
        f"({slabs} slabs, committed); peak host RSS {host_rss()} B; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B; "
        f"launches {({k: n for k, n in launches.items() if n})}")
    return launches, rows


def run_broker_phase(seed, dev):
    """broker-16k: the port's gateway (GatewayServer on an ephemeral port,
    a KafkaContainerSink into a FileBackedBroker in a temporary
    directory) takes BROKER_SERIES request counters x BROKER_SCRAPES
    scrapes as Influx lines through send_lines, one connection a scrape;
    a `filebroker` stream under IngestionLifecycle ingests the log into
    a memstore on the card; the panel sum by (_ns_) (rate(...[5m])) at
    1 m steps over the 6 min launches K1 and holds the f64 oracle (rtol
    2e-4, atol 1e-3); then POST /influx/write of INFLUX_HTTP_LINES lines
    of one more scrape to a PromHttpApi over the same store, read back by
    /api/v1/read to the bit -> (launches, rows)."""
    import torch
    import filodb_tpu_torch.ingest  # noqa: F401 the stream factories
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.gateway.router import GatewayPipeline
    from filodb_tpu_torch.gateway.server import (GatewayServer,
                                                 KafkaContainerSink,
                                                 send_lines)
    from filodb_tpu_torch.http import remotepb
    from filodb_tpu_torch.http.routes import PromHttpApi
    from filodb_tpu_torch.http.server import FiloHttpServer
    from filodb_tpu_torch.ingest.filebroker import FileBackedBroker
    from filodb_tpu_torch.ingest.stream import (IngestionLifecycle,
                                                create_stream)
    from filodb_tpu_torch.ops import kernels
    from filodb_tpu_torch.parallel.shardmapper import SpreadProvider
    from filodb_tpu_torch.query.engine import QueryEngine
    from filodb_tpu_torch.utils import snappy
    n, k = BROKER_SERIES, BROKER_SCRAPES
    rng = np.random.default_rng(seed)
    vals = np.cumsum(rng.exponential(10.0, size=(n, k + 1)), axis=1)
    ts_row = START_MS + np.arange(k + 1, dtype=np.int64) * STEP_MS
    tags = [f"request_total,_ws_=demo,_ns_=App-{i % NUM_NS},"
            f"instance=Instance-{i},dc=DC{i % 2} counter=" for i in range(n)]

    def lines(t, rows):
        return [f"{tags[i]}{float(vals[i, t])!r} "
                f"{int(ts_row[t]) * 1_000_000}" for i in rows]
    root = tempfile.mkdtemp(prefix="broker-16k-")
    topic = "timeseries"
    kernels.reset_launch_counts()
    try:
        broker = FileBackedBroker(root)
        sink = KafkaContainerSink(broker.produce, topic, one_shard_mapper(),
                                  SpreadProvider(0))
        server = GatewayServer(sink, port=0)
        server.start()
        try:
            # a scrape is published whole before the next one is sent:
            # the listener takes each connection on a thread of its own,
            # and two scrapes' frames interleaved would arrive out of
            # order at the store
            t0 = time.perf_counter()
            for t in range(k):
                send_lines("127.0.0.1", server.port, lines(t, range(n)))
                deadline = time.time() + 120
                while sink.stats()["records_out"] < n * (t + 1) \
                        and time.time() < deadline:
                    time.sleep(0.01)
            gw_s = time.perf_counter() - t0
        finally:
            server.stop()
        stats = sink.stats()
        check(stats["records_out"] == n * k and not stats["drops"],
              f"broker-16k: the gateway published {stats}")
        ms = TimeSeriesMemStore(device=dev)
        shard = ms.setup("prometheus", 0)
        stream = create_stream("filebroker", topic=topic, shard=0,
                               broker_dir=root)
        t0 = time.perf_counter()
        got_n = IngestionLifecycle(shard, stream).start()
        consume_s = time.perf_counter() - t0
        stream.teardown()
        check(got_n == n * k, f"broker-16k: the stream ingested {got_n} "
              f"samples, {n * k} published")
        eng = QueryEngine("prometheus", ms, device=dev)
        start_s = int(ts_row[0]) // 1000 + 50
        end_s = int(ts_row[k - 1]) // 1000
        wends = np.arange(start_s * 1000, end_s * 1000 + 1, 60_000)
        want = rate_by_ns(torch.from_numpy(
            np.ascontiguousarray(vals[:, :k])).to(dev), ts_row[:k], wends)
        n0 = kernels.LAUNCHES["fused_rate_dense"]
        t0 = time.perf_counter()
        res = eng.query_range(LIVE_QUERY, start_s, 60, end_s, scan_params())
        q_s = time.perf_counter() - t0
        check(kernels.LAUNCHES["fused_rate_dense"] == n0 + 1,
              "broker-16k: the panel did not launch K1")
        _, err, rel = compare(res, want, *KERNEL_TOL, "broker-16k")
        # the HTTP door: one more scrape of INFLUX_HTTP_LINES series
        gw = GatewayPipeline(ms, "prometheus", one_shard_mapper())
        srv = FiloHttpServer(PromHttpApi({"prometheus": eng},
                                         gateways={"prometheus": gw}),
                             port=0)
        srv.start()
        try:
            body = "\n".join(lines(k, range(INFLUX_HTTP_LINES))).encode()
            st, raw, post_s = post_raw(srv.port, "/influx/write", body,
                                       {"Content-Type": "text/plain"})
            check(st == 204, f"broker-16k: /influx/write answered {st}: "
                  f"{raw[:200]}")
            rq = snappy.compress(remotepb.encode_read_request([
                remotepb.PromQuery(int(ts_row[k]), int(ts_row[k]), [
                    remotepb.LabelMatcher(remotepb.EQ, "__name__",
                                          "request_total")])]))
            st, raw, read_s = post_raw(srv.port, "/api/v1/read", rq,
                                       {"Content-Type":
                                        "application/x-protobuf"})
            check(st == 200, f"broker-16k: remote read answered {st}")
        finally:
            srv.stop()
        series = remotepb.decode_read_response(snappy.decompress(raw))[0]
        check(len(series) == n, f"broker-16k: remote read returned "
              f"{len(series)} series")
        for s in series:
            i = int(dict(s.labels)["instance"].split("-")[1])
            want_s = ([(float(vals[i, k]), int(ts_row[k]))]
                      if i < INFLUX_HTTP_LINES else [])
            check([(np.float64(v).tobytes(), t) for v, t in s.samples]
                  == [(np.float64(v).tobytes(), t) for v, t in want_s],
                  f"broker-16k: remote read of Instance-{i} is "
                  f"{s.samples[:2]}, {want_s} written")
        launches = dict(kernels.LAUNCHES)
        log(f"broker-16k: {n} counters x {k} scrapes as Influx lines: the "
            f"gateway took and published {n * k} lines in {gw_s:.3f} s "
            f"({n * k / gw_s:.1f} lines/s; {stats['frames_out']} frames); "
            f"the filebroker stream under IngestionLifecycle ingested "
            f"them into the card store in {consume_s:.3f} s "
            f"({got_n / consume_s:.1f} samples/s); the panel over the 6 min "
            f"at 1 m {q_s:.4f} s via K1 (mirror upload included), oracle "
            f"max_abs_err {err} max_rel_err {rel}; POST /influx/write of "
            f"{INFLUX_HTTP_LINES} lines {post_s:.4f} s "
            f"({INFLUX_HTTP_LINES / post_s:.1f} lines/s), read back by "
            f"/api/v1/read to the bit in {read_s:.4f} s; launches "
            f"{({name: c for name, c in launches.items() if c})}")
        return launches, dict(gateway_s=gw_s, consume_s=consume_s,
                              query_s=q_s, post_s=post_s)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------ phases 7 and 8: raw

RULES_GROUP = "request-rates"      # rules-1M's group, interval 60 s
RULE1 = "ns:request_total:rate5m"
RULE1_EXPR = "sum by (_ws_, _ns_) (rate(request_total[5m]))"
RULE2 = "ws:request_total:rate5m"
RULE2_EXPR = f"sum by (_ws_) ({RULE1})"
RULE_ALERT = "NamespaceRequestRateHigh"
RULE_FOR_S = 120.0                 # the alert's `for:`
RULE2_RTOL = 1e-6                  # rule 2's sum runs through K4 in f32
SELF_DATASET = "filodb_self"       # selfmon's dataset on the same memstore


class _Receiver:
    """A stdlib webhook receiver on localhost: every POSTed JSON body."""

    def __init__(self):
        import http.server
        posts = self.posts = []

        class H(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                posts.append(json.loads(self.rfile.read(
                    int(self.headers["Content-Length"]))))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *a):
                pass
        self.srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.srv.server_port}/alerts"

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(10)


def vector_by_ns(payload, what):
    """An instant-vector payload -> {App-N: value string}."""
    check(payload["status"] == "success",
          f"{what}: error payload {payload.get('error')}")
    return {r["metric"]["_ns_"]: r["value"][1]
            for r in payload["data"]["result"]}


def expected_alerts(above, eval_s):
    """The alert state machine (no keep_firing_for) over the namespaces
    above the threshold at each evaluation -> per evaluation {ns:
    (state, activeAt seconds)}."""
    since, out = {}, []
    for k, ts in enumerate(eval_s):
        since = {ns: since.get(ns, ts) for ns in above[k]}
        out.append({ns: ("firing" if ts - t0 >= RULE_FOR_S else "pending",
                         t0) for ns, t0 in since.items()})
    return out


def alerts_by_ns(payload):
    return {a["labels"]["_ns_"]: (a["state"], a["activeAt"])
            for a in payload["alerts"]}


def run_rules_phase(eng, ms, api, http, num_series, dev, out_dir):
    """rules-1M (rules_phase) with its webhook receiver and span
    exporter, both stopped whatever the outcome."""
    from filodb_tpu_torch.utils.traceexport import TraceExporter
    receiver = _Receiver()
    exporter = TraceExporter(
        f"file://{os.path.join(out_dir, 'rules-spans.jsonl')}",
        flush_interval_s=1.0)
    try:
        return rules_phase(eng, ms, api, http, num_series, dev, receiver,
                           exporter)
    finally:
        exporter.stop()
        receiver.close()
        api.ruler = None


def rules_phase(eng, ms, api, http, num_series, dev, receiver, exporter):
    """rules-1M on the serve-1M server over the dense 1M counters, after
    write-1M: a Ruler over the server's frontend and a MemstoreSink into
    the same memstore (attached as api.ruler), a WebhookNotifier posting
    to a stdlib receiver on localhost, one group of three rules
    evaluated at the store's last timestamp minus 3, 2, 1 and 0 minutes
    (evaluate_group): rule 1 records sum by (_ws_, _ns_) (rate(...[5m]))
    (1,000 series), rule 2 sums rule 1's output at the same timestamp,
    the alert fires for `for: 2m` on rule 1 above the f64 oracle's 90th
    percentile at the first evaluation.  The TraceExporter writes the
    phase's spans to a file.  Then a second Ruler restores
    the alerts from ALERTS_FOR_STATE, remote read returns the recorded
    samples, and a SelfScraper writes the registry into a second
    dataset of the memstore, served by the same API -> (launches, rows)."""
    import torch
    from filodb_tpu_torch.config import RulesConfig
    from filodb_tpu_torch.http import remotepb
    from filodb_tpu_torch.ops import kernels
    from filodb_tpu_torch.rules import (MemstoreSink, Rule, RuleGroup,
                                        Ruler, WebhookNotifier)
    from filodb_tpu_torch.rules.ruler import _iso
    from filodb_tpu_torch.utils import snappy
    from filodb_tpu_torch.utils.devicetelem import telem
    from filodb_tpu_torch.utils.metrics import registry
    t_phase = time.perf_counter()
    shard = ms.get_shard("prometheus", 0)
    store = store_rows(ms, num_series)
    n_t = int(store.counts[:num_series].max())
    check(int(store.counts[:num_series].min()) == n_t,
          "rules-1M: the counters hold different sample counts")
    ts_row = START_MS + np.arange(n_t, dtype=np.int64) * STEP_MS
    last_ms = int(ts_row[-1])
    check(int(store.ts[0, n_t - 1]) == last_ms,
          "rules-1M: the store's last timestamp is off the grid")
    eval_s = [last_ms // 1000 - 60 * k for k in (3, 2, 1, 0)]
    wends = np.asarray(eval_s, dtype=np.int64) * 1000
    t0 = time.perf_counter()
    vals = torch.empty((num_series, n_t), dtype=torch.float64, device=dev)
    for i0 in range(0, num_series, SLAB):
        vals[i0:i0 + SLAB] = torch.from_numpy(
            store.cols["count"][i0:min(i0 + SLAB, num_series), :n_t]).to(dev)
    want1 = rate_by_ns(vals, ts_row, wends)          # [NUM_NS, 4]
    del vals
    oracle_s = time.perf_counter() - t0
    check(not np.isnan(want1).any(), "rules-1M: the oracle has gaps")
    thr = float(np.percentile(want1[:, 0], 90))
    band = KERNEL_TOL[1] + KERNEL_TOL[0] * abs(thr)
    above_oracle = [{f"App-{g}" for g in np.flatnonzero(want1[:, k] > thr)}
                    for k in range(len(eval_s))]
    ambiguous = {f"App-{g}" for g in np.flatnonzero(
        (np.abs(want1 - thr) <= band).any(axis=1))}
    log(f"rules-1M: f64 oracle of rule 1 at {eval_s} in {oracle_s:.3f} s; "
        f"threshold (90th percentile at the first) {thr!r}; namespaces "
        f"above it {[len(a) for a in above_oracle]}; within the kernel "
        f"tolerance of it at some evaluation: {sorted(ambiguous)}")
    mapper = one_shard_mapper()
    sink = MemstoreSink(ms, "prometheus", mapper)
    group = RuleGroup(RULES_GROUP, 60.0, (
        Rule(RULE1, RULE1_EXPR, "recording"),
        Rule(RULE2, RULE2_EXPR, "recording"),
        Rule(RULE_ALERT, f"{RULE1} > {thr!r}", "alerting",
             labels=(("severity", "page"),), for_s=RULE_FOR_S)))
    cfg = RulesConfig()
    fe = api.frontends["prometheus"]
    notifier = WebhookNotifier(url=receiver.url)
    ruler = Ruler(fe, sink, groups=[group], config=cfg, notifier=notifier)
    api.ruler = ruler
    # each evaluation's instant queries and write-backs, timed
    calls, writes = [], []
    query_instant, write = fe.query_instant, sink.write

    def fused_s():
        ks = telem.snapshot(recent=0)["devices"].get(str(dev), {}).get(
            "kernels", {})
        return sum(ks.get(k, {}).get("seconds", 0.0) for k in OPS_FUSED)

    def timed_query(promql, time_s, *a, **kw):
        n0, l0, s0 = (kernels.LAUNCHES.get("fused_rate_dense", 0),
                      k1_ledger(dev), fused_s())
        t = time.perf_counter()
        res = query_instant(promql, time_s, *a, **kw)
        calls.append(dict(q=promql, s=time.perf_counter() - t,
                          k1=kernels.LAUNCHES.get("fused_rate_dense", 0)
                          - n0, ledger=k1_ledger(dev) - l0,
                          k1_s=fused_s() - s0, trace=res.trace_id))
        return res

    def timed_write(keys, ts_ms, values):
        t = time.perf_counter()
        n = write(keys, ts_ms, values)
        writes.append(time.perf_counter() - t)
        return n
    fe.query_instant, sink.write = timed_query, timed_write
    spans_path = exporter.url[len("file://"):]
    dropped0 = registry.counter("trace_export_dropped").value
    shipped0 = registry.counter("trace_export_spans").value
    exporter.start()
    kernels.reset_launch_counts()
    rows, traces, above_rec, states = [], [], [], []
    rec_vals = {}
    try:
        for k, ts in enumerate(eval_s):
            del calls[:], writes[:]
            t = time.perf_counter()
            ok = ruler.evaluate_group(RULES_GROUP, ts)
            secs = time.perf_counter() - t
            errs = [r["lastError"] for g in ruler.rules_payload()["groups"]
                    for r in g["rules"] if r["health"] != "ok"]
            check(ok and not errs,
                  f"rules-1M: evaluation {k + 1} failed: {errs}")
            (r1,) = [c for c in calls if c["q"] == RULE1_EXPR]
            check(r1["k1"] == 1 and r1["ledger"] == 1,
                  f"rules-1M: evaluation {k + 1}: rule 1 launched K1 "
                  f"{r1['k1']} times, the ledger shows {r1['ledger']}")
            traces += [c["trace"] for c in calls]
            # rule 1 through HTTP: recorded, and the expression itself
            st, prec, _ = http.call("GET", "/api/v1/query", {
                "query": RULE1, "time": ts})
            rec = vector_by_ns(prec, f"rules-1M {RULE1}")
            st, pexp, _ = http.call("GET", "/api/v1/query", {
                "query": RULE1_EXPR, "time": ts,
                "scanLimit": str(SCAN_LIMIT)})
            check(rec == vector_by_ns(pexp, "rules-1M rule 1's expression"),
                  f"rules-1M: evaluation {k + 1}: the recorded vector is not "
                  f"bit-identical to the expression at {ts}")
            got = np.full(NUM_NS, np.nan)
            for ns, v in rec.items():
                got[int(ns.split("-")[1])] = float(v)
            err, rel = matrix_close(got[:, None], want1[:, k:k + 1],
                                    *KERNEL_TOL, f"rules-1M rule 1 at {ts}")
            rec_vals[ts] = got
            st, p2, _ = http.call("GET", "/api/v1/query", {
                "query": RULE2, "time": ts})
            check(st == 200 and len(p2["data"]["result"]) == 1,
                  f"rules-1M: rule 2 answered {st}: {p2.get('error')}")
            v2 = float(p2["data"]["result"][0]["value"][1])
            s1 = float(np.sum(got))
            rel2 = abs(v2 - s1) / abs(s1)
            check(rel2 <= RULE2_RTOL,
                  f"rules-1M: rule 2 {v2!r} against the sum of rule 1's "
                  f"recorded values {s1!r}: rel err {rel2}")
            above = {f"App-{g}" for g in np.flatnonzero(got > thr)}
            check(above - ambiguous == above_oracle[k] - ambiguous,
                  f"rules-1M: evaluation {k + 1}: namespaces above the "
                  f"threshold differ from the oracle's: "
                  f"{sorted(above ^ above_oracle[k])[:8]}")
            above_rec.append(above)
            states.append(alerts_by_ns(ruler.alerts_payload()))
            rows.append(dict(eval=k + 1, ts=ts, seconds=secs,
                             rule1_s=r1["s"], writeback_s=sum(writes),
                             k1_ms=r1["k1_s"] * 1000.0,
                             max_abs_err=err, max_rel_err=rel,
                             rule2_rel=rel2))
            log(f"rules-1M: evaluation {k + 1} at {ts}: {secs:.4f} s "
                f"(rule 1's query {r1['s']:.4f} s = "
                f"{100 * r1['s'] / secs:.1f}%, the write-backs "
                f"{sum(writes):.4f} s = {100 * sum(writes) / secs:.1f}%, "
                f"queries {[(c['q'][:24], round(c['s'], 4)) for c in calls]}"
                f"); K1 once, ledger {r1['k1_s'] * 1000.0:.4f} ms; rule 1 "
                f"max_abs_err {err} max_rel_err {rel}, bit-identical to "
                f"the expression over HTTP; rule 2 rel err {rel2:.3e}; "
                f"alerts {len(above)} ({sum(s == 'firing' for s, _ in states[-1].values())} firing)")
    finally:
        fe.query_instant, sink.write = query_instant, write
    want_states = expected_alerts(above_rec, eval_s)
    for k, ts in enumerate(eval_s):
        want = {ns: (st_, _iso(float(a))) for ns, (st_, a)
                in want_states[k].items()}
        check(states[k] == want,
              f"rules-1M: alert states at evaluation {k + 1} differ: "
              f"{sorted(set(states[k].items()) ^ set(want.items()))[:6]}")
    first = above_rec[0]
    check(all(states[k][ns][0] == ("pending" if k < 2 else "firing")
              for ns in first & above_rec[1] & above_rec[2] & above_rec[3]
              for k in range(4)) and first,
          "rules-1M: the alerts present throughout are not pending, "
          "pending, firing, firing")
    # the receiver: one batch a firing evaluation (new firing alerts,
    # then the resend a minute later), each the firing set
    firing = [{ns for ns, (s, _) in st_.items() if s == "firing"}
              for st_ in states]
    deadline = time.time() + 60
    while time.time() < deadline and (
            len(notifier.snapshot()) < 2 or not notifier._queue.empty()):
        time.sleep(0.05)
    posted = [{a["labels"]["_ns_"] for a in p["alerts"]}
              for p in receiver.posts]
    check(posted == [firing[2], firing[3]] and all(
              a["status"] == "firing" and a["labels"]["severity"] == "page"
              for p in receiver.posts for a in p["alerts"]),
          f"rules-1M: the receiver got {[len(p) for p in posted]} alerts in "
          f"{len(posted)} POSTs, {[len(f) for f in firing[2:]]} firing")
    st, prules, _ = http.call("GET", "/api/v1/rules")
    (g,) = prules["data"]["groups"]
    check(st == 200 and [r["health"] for r in g["rules"]] == ["ok"] * 3
          and g["rules"][2]["state"] == "firing"
          and len(g["rules"][2]["alerts"]) == len(states[-1]),
          f"rules-1M: /api/v1/rules answered {st}: "
          f"{[(r['name'], r['health']) for r in g['rules']]}")
    st, palerts, _ = http.call("GET", "/api/v1/alerts")
    check(st == 200 and alerts_by_ns(palerts["data"]) == states[-1],
          f"rules-1M: /api/v1/alerts answered {st} with other states")
    # a restart: a second ruler over the same sink restores the alerts
    t = time.perf_counter()
    ruler2 = Ruler(fe, sink, groups=[group], config=cfg,
                   notifier=WebhookNotifier(sleep=lambda s: None))
    check(ruler2.evaluate_group(RULES_GROUP, eval_s[-1]),
          "rules-1M: the second ruler's evaluation failed")
    restore_s = time.perf_counter() - t
    check(alerts_by_ns(ruler2.alerts_payload()) == states[-1],
          "rules-1M: the second ruler did not restore every alert with its "
          "activeAt")
    # remote read of the recorded series: ms to the bit, values to 1e-12
    gstore = shard.stores["gauge"]
    rq = snappy.compress(remotepb.encode_read_request([remotepb.PromQuery(
        int(wends[0]) - 1, int(wends[-1]), [remotepb.LabelMatcher(
            remotepb.EQ, "__name__", RULE1)])]))
    st, raw, read_s = post_raw(http.port, "/api/v1/read", rq,
                               {"Content-Type": "application/x-protobuf"})
    check(st == 200, f"rules-1M: remote read answered {st}: {raw[:200]}")
    got_series = remotepb.decode_read_response(snappy.decompress(raw))[0]
    check(len(got_series) == NUM_NS,
          f"rules-1M: remote read returned {len(got_series)} series")
    worst = 0.0
    for s in got_series:
        g_ = int(dict(s.labels)["_ns_"].split("-")[1])
        t_got = [t_ for _, t_ in s.samples]
        v_got = np.array([v for v, _ in s.samples])
        want_v = np.array([rec_vals[t_ // 1000][g_] for t_ in t_got])
        diff = np.abs(v_got - want_v)
        check(t_got == wends.tolist() and (
                  diff <= 1e-12 * max(1.0, float(np.abs(want_v).max())))
              .all(),
              f"rules-1M: remote read of App-{g_}: {t_got} {v_got.tolist()}"
              f", recorded {want_v.tolist()}")
        worst = max(worst, float(diff.max()))
    # the exporter: a span file holding every evaluation's traces
    t = time.perf_counter()
    exporter.stop()
    export_s = time.perf_counter() - t
    shipped = registry.counter("trace_export_spans").value - shipped0
    with open(spans_path) as f:
        spans = [json.loads(line) for line in f]
    span_traces = {s["traceId"] for s in spans}
    missing = {tr for tr in traces if tr.replace("-", "").lower()
               not in span_traces}
    check(spans and not missing and len(spans) == shipped
          and registry.counter("trace_export_dropped").value == dropped0,
          f"rules-1M: the span file holds {len(spans)} spans ({shipped} "
          f"shipped), {len(missing)} evaluation traces missing, dropped "
          f"{registry.counter('trace_export_dropped').value - dropped0}")
    launches = dict(kernels.LAUNCHES)
    self_s = run_selfmon_check(ms, api, http, dev, last_ms, num_series)
    log(f"rules-1M: {len(eval_s)} evaluations, seconds "
        f"{[round(r['seconds'], 4) for r in rows]}, K1 ms "
        f"{[round(r['k1_ms'], 4) for r in rows]}; alerts pending/firing "
        f"{[(sum(s == 'pending' for s, _ in x.values()), sum(s == 'firing' for s, _ in x.values())) for x in states]}"
        f"; the receiver got {len(receiver.posts)} POSTs "
        f"({sum(len(p['alerts']) for p in receiver.posts)} alerts); the "
        f"second ruler restored {len(states[-1])} alerts in "
        f"{restore_s:.4f} s; remote read of {RULE1}: {len(got_series)} "
        f"series in {read_s:.4f} s, max abs diff {worst}; the exporter "
        f"shipped {int(shipped)} spans of {len(set(traces))} evaluation traces, "
        f"its stop (the final drain) {export_s:.4f} s; selfmon "
        f"{self_s:.3f} s; phase {time.perf_counter() - t_phase:.1f} s; "
        f"launches {({k: n for k, n in launches.items() if n})}")
    return launches, rows


def run_selfmon_check(ms, api, http, dev, last_ms, num_series):
    """selfmon inside rules-1M: a SelfScraper writes the metrics registry
    into SELF_DATASET on the same memstore, served by the same API; two
    scrapes 2 s apart, a counter incremented between them; an HTTP query
    returns the registry's two values, and no wall-clock timestamp
    entered the 1M dataset -> seconds."""
    from filodb_tpu_torch.parallel.shardmapper import ShardEvent, ShardMapper
    from filodb_tpu_torch.query.engine import QueryEngine
    from filodb_tpu_torch.query.frontend import QueryFrontend
    from filodb_tpu_torch.utils.metrics import registry
    from filodb_tpu_torch.utils.selfmon import SelfScraper
    t0 = time.perf_counter()
    smapper = ShardMapper(1)
    smapper.update_from_event(ShardEvent("IngestionStarted", SELF_DATASET,
                                         0, "local"))
    ms.setup(SELF_DATASET, 0)
    seng = QueryEngine(SELF_DATASET, ms, smapper, device=dev)
    api.engines[SELF_DATASET] = seng
    api.frontends[SELF_DATASET] = QueryFrontend(seng, config=api._config)
    scraper = SelfScraper(ms, SELF_DATASET, smapper, node_name="chip-smoke")
    probe = registry.counter("chip_smoke_selfmon_probe")
    probe.increment(3)
    v1, n1, s1 = probe.value, scraper.scrape_once(), time.time()
    time.sleep(2.0)
    probe.increment(4)
    v2, n2, s2 = probe.value, scraper.scrape_once(), time.time()
    st, p, q_s = http.call(
        "GET", f"/promql/{SELF_DATASET}/api/v1/query_range", {
            "query": 'chip_smoke_selfmon_probe_total{job="filodb"}',
            "start": int(s1) - 1, "end": int(s2) + 2, "step": 1})
    check(st == 200 and len(p["data"]["result"]) == 1,
          f"rules-1M selfmon: the query answered {st}: {p.get('error')}")
    seen = sorted({float(v) for _, v in p["data"]["result"][0]["values"]})
    check(seen == [float(v1), float(v2)],
          f"rules-1M selfmon: the scraped counter reads {seen}, the "
          f"registry {[v1, v2]}")
    shard = ms.get_shard("prometheus", 0)
    for name, store in shard.stores.items():
        n = store.counts
        m = n > 0
        newest = int(store.ts[np.flatnonzero(m), n[m] - 1].max()) \
            if m.any() else 0
        check(newest <= last_ms,
              f"rules-1M selfmon: the 1M dataset's {name} store has a "
              f"sample at {newest}, after its last {last_ms}")
    check(int(shard.stores["prom-counter"].counts[:num_series].max())
          == (last_ms - START_MS) // STEP_MS + 1,
          "rules-1M selfmon: the counters' grid grew")
    log(f"rules-1M selfmon: two scrapes of {n1} and {n2} series into "
        f"{SELF_DATASET} ({s2 - s1:.2f} s apart); the counter through "
        f"HTTP in {q_s:.4f} s reads {seen}; the 1M dataset's stores end "
        f"at or before {last_ms}")
    return time.perf_counter() - t0


DS_SERIES = 8_192                  # downsample-16k: counters, and as many gauges
DS_RAW_FROM_MS = START_MS + 3_600_000   # Q3: raw retention from the 60th minute
DS_GAUGE_FNS = {"min_over_time": ("min", "min"),   # fn -> (column, reduce)
                "max_over_time": ("max", "max"),
                "sum_over_time": ("sum", "sum"),
                "count_over_time": ("count", "sum"),
                "avg_over_time": ("avg", "avg"),
                "last_over_time": ("avg", "last")}


class DsFanout:
    """The leaves of a `<raw>::ds::<res>` dataset read the downsample
    store, the others the raw memstore; shards_for answers [] for the
    downsample datasets and the raw dataset the planner may route there,
    so the result cache bypasses them (the reference's
    FiloServer._source)."""

    def __init__(self, ms, ds_store):
        self.ms, self.ds_store, self.device = ms, ds_store, ms.device

    def get_shard(self, dataset, shard_num):
        if "::ds::" in dataset:
            return self.ds_store.get_shard(dataset, shard_num)
        return self.ms.get_shard(dataset, shard_num)

    def shards_for(self, dataset):
        if "::ds::" in dataset or dataset == self.ds_store.raw_dataset:
            return []
        return self.ms.shards_for(dataset)


def ds_arrays(store, res, schema, col):
    """(ts, values, counts, group ids) of one downsample dataset's
    schema store, the host arrays the store holds (after a query paged
    them in)."""
    from filodb_tpu_torch.downsample import ds_dataset_name
    sh = store.get_shard(ds_dataset_name("prometheus", res), 0)
    st = sh.stores[schema]
    infos = [p for p in sh.partitions if p is not None
             and p.schema_name == schema]
    rows = np.array([p.row for p in infos], dtype=np.int64)
    gids = np.array([int(p.part_key.tags_dict["_ns_"].split("-")[1])
                     for p in infos], dtype=np.int64)
    counts = st.counts[rows].astype(np.int64)
    n = int(counts.max())
    return st.ts[rows, :n], st.cols[col][rows, :n], counts, gids


def ds_rate_oracle(ts, vals, counts, gids, wends):
    """f64 sum by group of the Prometheus extrapolated rate over rows of
    their own timestamps (`counts` samples each, resets corrected) ->
    [NUM_NS, W]; NaN where a group has no row with two samples."""
    S, n = vals.shape
    r = np.arange(S)
    valid = np.arange(n)[None, :] < counts[:, None]
    v = np.where(valid, vals, np.nan)
    prev = np.concatenate([v[:, :1], v[:, :-1]], axis=1)
    drop = np.where(valid & (prev > v), prev, 0.0)
    corr = v + np.cumsum(drop, axis=1)
    tsf = np.where(valid, ts, np.iinfo(np.int64).max)
    out = np.full((NUM_NS, len(wends)), np.nan)
    for w, we in enumerate(wends):
        ws = we - RANGE_MS
        first = (tsf <= ws).sum(axis=1)
        last = (tsf <= we).sum(axis=1) - 1
        nv = last - first + 1
        ok = nv >= 2
        f, lst = np.clip(first, 0, n - 1), np.clip(last, 0, n - 1)
        t1, t2 = ts[r, f].astype(np.float64), ts[r, lst].astype(np.float64)
        v1, v2 = corr[r, f], corr[r, lst]
        with np.errstate(invalid="ignore", divide="ignore"):
            dur_start = (t1 - ws) / 1000.0
            dur_end = (we - t2) / 1000.0
            sampled = (t2 - t1) / 1000.0
            avg = sampled / (nv - 1)
            delta = v2 - v1
            dur_zero = sampled * (v1 / delta)
            dur_start = np.where((delta > 0) & (v1 >= 0)
                                 & (dur_zero < dur_start), dur_zero,
                                 dur_start)
            thr = avg * 1.1
            extrap = (sampled + np.where(dur_start < thr, dur_start, avg / 2)
                      + np.where(dur_end < thr, dur_end, avg / 2))
            rate = delta * (extrap / sampled) / RANGE_MS * 1000.0
        s = np.zeros(NUM_NS)
        c = np.zeros(NUM_NS)
        np.add.at(s, gids[ok], rate[ok])
        np.add.at(c, gids[ok], 1.0)
        out[:, w] = np.where(c > 0, s, np.nan)
    return out


def ds_gauge_oracle(ts, vals, counts, gids, wends, reduce):
    """f64 sum by group of one reduction over each row's samples in
    (we - 10m, we] -> [NUM_NS, W]."""
    n = vals.shape[1]
    valid = np.arange(n)[None, :] < counts[:, None]
    out = np.full((NUM_NS, len(wends)), np.nan)
    for w, we in enumerate(wends):
        inw = valid & (ts > we - 600_000) & (ts <= we)
        some = inw.any(axis=1)
        x = np.where(inw, vals, np.nan)
        with np.errstate(invalid="ignore"), warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            if reduce == "last":
                idx = np.where(inw, np.arange(n)[None, :], -1).max(axis=1)
                per = vals[np.arange(len(vals)), np.maximum(idx, 0)]
            else:
                per = {"min": np.nanmin, "max": np.nanmax, "sum": np.nansum,
                       "avg": np.nanmean}[reduce](x, axis=1)
        s = np.zeros(NUM_NS)
        c = np.zeros(NUM_NS)
        np.add.at(s, gids[some], per[some])
        np.add.at(c, gids[some], 1.0)
        out[:, w] = np.where(c > 0, s, np.nan)
    return out


def bits_equal(a, b):
    """Two arrays (or lists of rows) equal to the bit as f64, NaN in the
    same cells."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    na, nb = np.isnan(a), np.isnan(b)
    return a.shape == b.shape and bool((na == nb).all()) and \
        np.where(na, 0.0, a).tobytes() == np.where(nb, 0.0, b).tobytes()


def ds_query(eng, q, start_s, step_s, end_s, warm):
    """q cold then `warm` times -> (answer [NUM_NS, W], cold s, warm p50
    s, kernels launched by the cold run); warm answers bit-identical."""
    from filodb_tpu_torch.ops import kernels
    n0 = dict(kernels.LAUNCHES)
    t = time.perf_counter()
    res = eng.query_range(q, start_s, step_s, end_s, scan_params())
    cold = time.perf_counter() - t
    check(res.error is None, f"downsample-16k: {q}: {res.error}")
    ks = sorted(k for k, v in kernels.LAUNCHES.items() if v > n0.get(k, 0))
    wends = np.arange(start_s, end_s + 1, step_s) * 1000
    got = np.full((NUM_NS, len(wends)), np.nan)
    for key, _, row in res.series():
        got[int(key.labels_dict["_ns_"].split("-")[1])] = np.asarray(row)
    secs = []
    for _ in range(warm):
        t = time.perf_counter()
        again = eng.query_range(q, start_s, step_s, end_s, scan_params())
        secs.append(time.perf_counter() - t)
        check(again.error is None and bits_equal(
                  [np.asarray(r) for _, _, r in again.series()],
                  [np.asarray(r) for _, _, r in res.series()]),
              f"downsample-16k: {q}: a warm answer differs from the cold one")
    return got, cold, float(np.median(secs)), ks


def run_downsample_phase(seed, dev, warm=3):
    """downsample-16k (see the module docstring) -> (launches, rows)."""
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.core.partkey import PartKey
    from filodb_tpu_torch.downsample import (DEFAULT_RESOLUTIONS,
                                             DownsampleClusterPlanner,
                                             DownsampledTimeSeriesStore,
                                             DownsamplerJob,
                                             ShardDownsampler,
                                             ds_dataset_name)
    from filodb_tpu_torch.ops import kernels
    from filodb_tpu_torch.persist.localstore import (LocalDiskColumnStore,
                                                     LocalDiskMetaStore)
    from filodb_tpu_torch.query.engine import QueryEngine
    from filodb_tpu_torch.query.planner import SingleClusterPlanner
    from filodb_tpu_torch.query.planners import LongTimeRangePlanner
    rng = np.random.default_rng(seed)
    root = tempfile.mkdtemp(prefix="downsample-16k-")
    rows_out = []
    try:
        raw_cs = LocalDiskColumnStore(os.path.join(root, "raw"))
        ms = TimeSeriesMemStore(column_store=raw_cs, meta_store=
                                LocalDiskMetaStore(os.path.join(root, "raw")),
                                device=dev)
        shard = ms.setup("prometheus", 0)
        ts_row = START_MS + np.arange(T, dtype=np.int64) * STEP_MS
        ts2d = np.broadcast_to(ts_row, (DS_SERIES, T))
        shard.ingest_columns("prom-counter", counter_keys(DS_SERIES), ts2d,
                             {"count": make_counter_slab(rng, DS_SERIES,
                                                         0.0)})
        shard.ingest_columns("gauge", [PartKey.make("heap_usage", {
            "_ws_": "demo", "_ns_": f"App-{i % NUM_NS}",
            "instance": f"Instance-{i}", "dc": f"DC{i % 2}"})
            for i in range(DS_SERIES)], ts2d,
            {"value": make_gauge_slab(rng, DS_SERIES, 0.0)})
        mapper = one_shard_mapper()
        raw_eng = QueryEngine("prometheus", ms, mapper, device=dev)
        # the streaming path, attached as a node attaches it to each of
        # its shards: a ShardDownsampler at the default resolutions
        dsr = ShardDownsampler()
        check(dsr.resolutions == (60_000, 300_000) == DEFAULT_RESOLUTIONS,
              f"downsample-16k: resolutions {dsr.resolutions}")
        ds_s = [0.0]
        downsample = dsr.downsample

        def timed_downsample(*a, **kw):
            t = time.perf_counter()
            try:
                return downsample(*a, **kw)
            finally:
                ds_s[0] += time.perf_counter() - t
        dsr.downsample = timed_downsample
        shard.shard_downsampler = dsr
        kernels.reset_launch_counts()
        t = time.perf_counter()
        chunks = shard.flush_all_groups()
        flush_s = time.perf_counter() - t
        t = time.perf_counter()
        drain = dsr.result_batches()
        drain_s = time.perf_counter() - t
        emitted = {res: sum(b.num_records for b in bs)
                   for res, bs in drain.items()}
        # a period a minute (five) for every series, and one more for
        # each counter whose reset falls inside a period
        check(set(emitted) == {60_000, 300_000}
              and emitted[60_000] >= 2 * DS_SERIES * (T // 6)
              and emitted[300_000] >= 2 * DS_SERIES * (T // 30),
              f"downsample-16k: records emitted {emitted}")
        stream = DownsampledTimeSeriesStore("prometheus", device=dev)
        stream.setup_shard(0)
        t = time.perf_counter()
        ingested = stream.ingest_downsample_batches(0, drain)
        ingest_s = time.perf_counter() - t
        check(ingested == sum(emitted.values()),
              f"downsample-16k: the stream store took {ingested} records")
        del drain
        # the batch path over the same disk store
        ds_cs = LocalDiskColumnStore(os.path.join(root, "ds"))
        t = time.perf_counter()
        stats = DownsamplerJob(raw_cs, ds_cs, "prometheus").run(
            [0], START_MS, START_MS + T * STEP_MS)
        job_s = time.perf_counter() - t
        check(stats.parts_scanned == 2 * DS_SERIES
              and stats.records_emitted == sum(emitted.values())
              and stats.chunks_written == 4 * DS_SERIES,
              f"downsample-16k: the batch job's stats {stats}")
        batch = DownsampledTimeSeriesStore("prometheus", column_store=ds_cs,
                                           device=dev)
        batch.setup_shard(0)
        t = time.perf_counter()
        refreshed = batch.refresh_index(0)
        refresh_s = time.perf_counter() - t
        check(refreshed == 4 * DS_SERIES,
              f"downsample-16k: refresh_index found {refreshed} part keys")
        log(f"downsample-16k: {2 * DS_SERIES} series x {T} flushed in "
            f"{flush_s:.3f} s ({chunks} chunks; the downsampler "
            f"{ds_s[0]:.3f} s of it = {100 * ds_s[0] / flush_s:.1f}%); "
            f"records emitted {emitted}; drain {drain_s:.3f} s, the stream "
            f"store's ingest {ingest_s:.3f} s; the batch job {job_s:.3f} s "
            f"({stats}); refresh_index {refresh_s:.3f} s "
            f"({refreshed} part keys, chunks paged on demand)")
        first_s = START_MS // 1000
        last_s = int(ts_row[-1]) // 1000
        q1 = (-(-(first_s + 600) // 60) * 60, 60, last_s // 60 * 60)
        q2 = (-(-(first_s + 900) // 300) * 300, 300, last_s // 300 * 300)
        check(batch.pick_resolution(60_000, RANGE_MS) == 60_000
              and batch.pick_resolution(300_000, 600_000) == 300_000,
              "downsample-16k: pick_resolution")
        Q1 = "sum by (_ns_) (rate(request_total[5m]))"
        raw_ans = {}
        t = time.perf_counter()
        raw_ans["Q1"], *raw_t1 = ds_query(raw_eng, Q1, *q1, warm)
        timings = [("raw", "Q1", *raw_t1)]
        for fn in DS_GAUGE_FNS:
            q = f"sum by (_ns_) ({fn}(heap_usage[10m]))"
            raw_ans[fn], *tt = ds_query(raw_eng, q, *q2, warm)
            timings.append(("raw", fn, *tt))
        answers = {}
        for name, store in (("stream", stream), ("batch", batch)):
            eng = QueryEngine("prometheus", store, mapper, device=dev,
                              planner=DownsampleClusterPlanner(store, mapper))
            got, *tt = ds_query(eng, Q1, *q1, warm)
            timings.append((name, "Q1", *tt))
            want = ds_rate_oracle(*ds_arrays(store, 60_000, "prom-counter",
                                             "count"),
                                  np.arange(q1[0], q1[2] + 1, 60) * 1000)
            err, rel = check_close(got, want, *KERNEL_TOL,
                                   f"downsample-16k {name} Q1")
            # the total rate (every namespace's) within 5% of raw's, as
            # tests/test_downsample.py::test_ds_counter_rate_close holds
            # sum(rate(...)): a namespace of ~8 counters estimates its
            # rate from 5 one-minute samples a window against 30 raw ones
            tot, raw_tot = np.nansum(got, axis=0), np.nansum(raw_ans["Q1"],
                                                             axis=0)
            check(np.allclose(tot, raw_tot, rtol=0.05),
                  f"downsample-16k: {name} Q1's total rate is not within 5% "
                  f"of the raw panel's: max rel "
                  f"{float(np.max(np.abs(tot / raw_tot - 1)))}")
            cell = np.abs(got / raw_ans["Q1"] - 1)
            answers[(name, "Q1")] = got
            log(f"downsample-16k: {name} Q1 {Q1} at 1 m (resolution 1 m) "
                f"launched {tt[2]}; f64 oracle of the store's arrays "
                f"max_abs_err {err} max_rel_err {rel}; the total rate "
                f"within {float(np.max(np.abs(tot / raw_tot - 1))):.4f} "
                f"(rel) of raw's, a namespace's cell p50 / max rel "
                f"{float(np.nanmedian(cell)):.4f} / {float(np.nanmax(cell)):.4f}")
            ds_eng = LongTimeRangePlanner(
                SingleClusterPlanner("prometheus", mapper),
                DownsampleClusterPlanner(store, mapper),
                lambda: DS_RAW_FROM_MS, lambda: int(ts_row[-1]))
            stitched = QueryEngine("prometheus", DsFanout(ms, store), mapper,
                                   device=dev, planner=ds_eng)
            for fn, (col, red) in DS_GAUGE_FNS.items():
                q = f"sum by (_ns_) ({fn}(heap_usage[10m]))"
                got, *tt = ds_query(eng, q, *q2, warm)
                timings.append((name, fn, *tt))
                want = ds_gauge_oracle(*ds_arrays(store, 300_000, "ds-gauge",
                                                  col),
                                       np.arange(q2[0], q2[2] + 1, 300)
                                       * 1000, red)
                err, rel = check_close(got, want, *KERNEL_TOL,
                                       f"downsample-16k {name} {fn}")
                answers[(name, fn)] = got
                if fn == "last_over_time":
                    # a period's `avg` is not its last raw sample: no raw
                    # comparison, and Q3 leaves it out
                    log(f"downsample-16k: {name} Q2 {fn} at 5 m launched "
                        f"{tt[2]}, oracle max_abs_err {err} max_rel_err "
                        f"{rel}")
                    continue
                check_close(got, raw_ans[fn], *KERNEL_TOL,
                            f"downsample-16k {name} {fn} against raw")
                g3, *t3 = ds_query(stitched, q, *q2, warm)
                timings.append((name + "+raw", fn, *t3))
                e3, r3 = check_close(g3, raw_ans[fn], *KERNEL_TOL,
                                     f"downsample-16k {name} Q3 {fn} "
                                     f"against raw")
                check_close(g3, want, *KERNEL_TOL,
                            f"downsample-16k {name} Q3 {fn} against the "
                            f"oracle")
                log(f"downsample-16k: {name} Q2 {fn} at 5 m launched "
                    f"{tt[2]}, oracle max_abs_err {err} max_rel_err {rel}; "
                    f"Q3 (raw from minute 60) launched {t3[2]}, against "
                    f"raw max_abs_err {e3} max_rel_err {r3}")
        same = {k[1]: bits_equal(answers[("stream", k[1])],
                                answers[("batch", k[1])])
                for k in answers if k[0] == "stream"}
        ds_bytes = sum(mirror_nbytes(s, ds_dataset_name("prometheus", r))
                       for s in (stream, batch) for r in DEFAULT_RESOLUTIONS)
        raw_bytes = mirror_nbytes(ms)
        launches = dict(kernels.LAUNCHES)
        for who, q, cold, p50, ks in timings:
            rows_out.append(dict(store=who, query=q, cold_s=cold,
                                 warm_p50_s=p50, kernels=ks))
        log("downsample-16k: cold / warm p50 s: " + "; ".join(
            f"{who} {q} {cold:.4f} / {p50:.4f}"
            for who, q, cold, p50, _ in timings))
        log(f"downsample-16k: the stream and batch stores answer "
            f"bit-identically: {same}; downsample mirrors {ds_bytes} B "
            f"(both stores), the raw mirror {raw_bytes} B; launches "
            f"{({k: n for k, n in launches.items() if n})}")
        return launches, rows_out
    finally:
        shutil.rmtree(root, ignore_errors=True)



def make_raw_counters_t(gen, n, hole_frac, device):
    """[n, T] f64 raw counters on the card, like make_counter_slab but with
    RESETS restarts a series (one in each of RESETS equal spans of the
    row, so they never coincide) and optional NaN scrape gaps."""
    import torch
    v = torch.empty((n, T), dtype=torch.float64, device=device)
    v.exponential_(0.1, generator=gen)          # mean increment 10
    v = torch.cumsum(v, dim=1)
    pos = torch.arange(T, device=device)[None, :]
    for k in range(RESETS):
        r = torch.randint(max(6, k * T // RESETS), (k + 1) * T // RESETS,
                          (n, 1), generator=gen, device=device)
        restart = torch.empty((n, 1), dtype=torch.float64, device=device)
        restart.exponential_(0.2, generator=gen)
        v = torch.where(pos >= r, v - v.gather(1, r - 1) + restart, v)
    if hole_frac:
        v[torch.rand((n, T), generator=gen, device=device) < hole_frac] = \
            float("nan")
    return v


def oracle_rates_t(vals, ts_row, wends):
    """Prometheus extrapolated rate and increase per (series, window) in
    f64 on the card, NaN samples absent (tests/oracle.py semantics): the
    counters corrected against the previous valid sample, then the
    extrapolated increase between each window's first and last valid
    sample (NaN where fewer than two)."""
    import torch
    dev = vals.device
    n_s, n_t = vals.shape
    valid = ~torch.isnan(vals)
    pos = torch.arange(n_t, device=dev).expand(n_s, n_t)
    last_v = torch.cummax(torch.where(valid, pos, torch.full_like(pos, -1)),
                          dim=1).values
    prev_idx = torch.cat([torch.full_like(last_v[:, :1], -1),
                          last_v[:, :-1]], dim=1)
    prev = vals.gather(1, prev_idx.clamp(min=0))
    drop = torch.where(valid & (prev_idx >= 0) & (prev > vals), prev,
                       torch.zeros_like(vals))
    corr = vals + torch.cumsum(drop, dim=1)
    nxt = torch.flip(torch.cummin(torch.flip(
        torch.where(valid, pos, torch.full_like(pos, n_t)), [1]), dim=1)
        .values, [1])
    cnt = torch.cumsum(valid.to(torch.int32), dim=1)
    first, last = (torch.from_numpy(x).to(dev)
                   for x in window_bounds(ts_row, wends))
    nv = cnt[:, last] - cnt[:, first] + valid[:, first].to(torch.int32)
    j1 = nxt[:, first].clamp(max=n_t - 1)
    j2 = last_v[:, last].clamp(min=0)
    v1, v2 = corr.gather(1, j1), corr.gather(1, j2)
    ts = torch.from_numpy(ts_row.astype(np.float64)).to(dev)
    t1, t2 = ts[j1], ts[j2]
    we = torch.from_numpy(wends.astype(np.float64)).to(dev)[None, :]
    ws = we - RANGE_MS
    dur_start = (t1 - ws) / 1000.0
    dur_end = (we - t2) / 1000.0
    sampled = (t2 - t1) / 1000.0
    avg = sampled / (nv - 1)
    delta = v2 - v1
    dur_zero = sampled * (v1 / delta)
    dur_start = torch.where((delta > 0) & (v1 >= 0) & (dur_zero < dur_start),
                            dur_zero, dur_start)
    thr = avg * 1.1
    extrap = (sampled + torch.where(dur_start < thr, dur_start, avg / 2)
              + torch.where(dur_end < thr, dur_end, avg / 2))
    inc = delta * (extrap / sampled)
    nan = torch.full_like(inc, float("nan"))
    ok = nv >= 2
    return {"increase": torch.where(ok, inc, nan),
            "rate": torch.where(ok, inc / (we - ws) * 1000.0, nan)}


def check_close(got, want, rtol, atol, what):
    """got and want [G, W] f64 numpy, NaN = absent -> (max abs err, max
    rel err); fails on a NaN pattern or a value off the tolerance."""
    check(got.shape == want.shape,
          f"{what}: shape {got.shape}, expected {want.shape}")
    check((np.isnan(got) == np.isnan(want)).all(),
          f"{what}: NaN pattern differs from the oracle")
    m = ~np.isnan(want)
    check(m.any(), f"{what}: the oracle has no present cell")
    err = np.abs(got[m] - want[m])
    check((err <= atol + rtol * np.abs(want[m])).all(),
          f"{what}: max abs err {err.max()} over rtol {rtol} atol {atol}")
    return (float(err.max()),
            float((err / np.maximum(np.abs(want[m]), 1e-300)).max()))


def raw_counter_inputs(num_series, seed, hole_frac, dev):
    """Raw request_total counters (RESETS restarts each, `_ns_ =
    App-{i % NUM_NS}`) made on the card, rebased WITHOUT correction on the
    card (ops/counter.rebase_rows_t) in slabs and padded for the
    kernel-level API -> (plan, prepared inputs, the f64 oracle's answers,
    set-up timings)."""
    import torch
    from filodb_tpu_torch.ops import counter, fused
    ts_row = np.arange(T, dtype=np.int64) * STEP_MS     # offsets from START
    wends = np.arange(600_000, int(ts_row[-1]) + 1, 60_000)
    W = len(wends)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    gids = np.arange(num_series) % NUM_NS
    gids_t = torch.from_numpy(gids).to(dev)
    o_sum = {k: torch.zeros((NUM_NS, W), dtype=torch.float64, device=dev)
             for k in ("rate", "increase")}
    o_cnt = torch.zeros((NUM_NS, W), dtype=torch.float64, device=dev)
    o_max = torch.full((NUM_NS, W), float("-inf"), dtype=torch.float64,
                       device=dev)
    reb32 = torch.empty((num_series, T), dtype=torch.float32, device=dev)
    vb32 = torch.empty((num_series,), dtype=torch.float32, device=dev)
    gen_s = prep_s = oracle_s = 0.0
    for i0 in range(0, num_series, SLAB):
        n = min(SLAB, num_series - i0)
        t0 = time.perf_counter()
        v = make_raw_counters_t(gen, n, hole_frac, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        per = oracle_rates_t(v, ts_row, wends)
        g = gids_t[i0:i0 + n]
        for k, x in per.items():
            o_sum[k].index_add_(0, g, torch.nan_to_num(x, nan=0.0))
        ok = ~torch.isnan(per["rate"])
        o_cnt.index_add_(0, g, ok.to(torch.float64))
        o_max.scatter_reduce_(
            0, g[:, None].expand(-1, W),
            torch.where(ok, per["rate"], torch.full_like(per["rate"],
                                                         float("-inf"))),
            "amax")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        reb, vb, _ = counter.rebase_rows_t(v, correct_counter=False)
        reb32[i0:i0 + n] = reb
        vb32[i0:i0 + n] = vb
        torch.cuda.synchronize()
        gen_s += t1 - t0
        oracle_s += t2 - t1
        prep_s += time.perf_counter() - t2
        del v, per, reb, vb
    t0 = time.perf_counter()
    plan = fused.build_plan(ts_row, wends, RANGE_MS)
    prepared = fused.pad_inputs(reb32, vb32, gids, plan, NUM_NS, device=dev)
    torch.cuda.synchronize()
    pad_s = time.perf_counter() - t0
    del reb32, vb32
    present = (o_cnt > 0).cpu().numpy()

    def oracle(x):
        return np.where(present, x.cpu().numpy(), np.nan)

    want = {"rate": oracle(o_sum["rate"]),
            "increase": oracle(o_sum["increase"]),
            "avg": oracle(o_sum["rate"] / o_cnt.clamp(min=1.0)),
            "max": oracle(o_max)}
    return plan, prepared, want, dict(gen_s=gen_s, oracle_s=oracle_s,
                                      prep_s=prep_s, pad_s=pad_s)


def raw_counter_calls(plan, prepared, ragged, num_series):
    """[(label, kernels it launches, call, oracle keys)]: the kernel-level
    API calls of phases 7 and 8."""
    import torch
    from filodb_tpu_torch.ops import agg, fused
    groups = prepared.groups
    panels = [(groups, NUM_NS, "sum"), (groups, NUM_NS, "avg"),
              (groups, NUM_NS, "max")]
    mode = "ragged" if ragged else "dense"
    return [
        ("fused_rate_groupsum(rate, precorrected=False)",
         [f"fused_rate_drops_{mode}"],
         lambda: [fused.present_sum(*fused.fused_rate_groupsum(
             None, None, None, plan, NUM_NS, "rate", precorrected=False,
             prepared=prepared, ragged=ragged))], ["rate"]),
        ("fused_rate_groupsum(increase, precorrected=False)",
         [f"fused_rate_drops_{mode}"],
         lambda: [fused.present_sum(*fused.fused_rate_groupsum(
             None, None, None, plan, NUM_NS, "increase", precorrected=False,
             prepared=prepared, ragged=ragged))], ["increase"]),
        ("fused_leaf_agg_batch(rate, [sum, avg, max] by _ns_, "
         "precorrected=False)",
         [f"fused_rate_drops_{mode}", f"fused_rate_drops_{mode}_series"],
         lambda: [agg.present(op, torch.from_numpy(c)).numpy()
                  for c, (_, _, op) in zip(fused.fused_leaf_agg_batch(
                      plan, prepared.values, panels, "rate",
                      precorrected=False, ragged=ragged,
                      num_series=num_series), panels)],
         ["rate", "avg", "max"]),
    ]


def run_raw_counter_path(num_series, seed, hole_frac, warm, tol, dev):
    """The raw counters of raw_counter_inputs through the port's
    kernel-level API: fused_rate_groupsum(precorrected=False) for rate and
    increase (K2, group mode) and fused_leaf_agg_batch(precorrected=False)
    with sum, avg and max panels by _ns_ (K2 group + K2 per-series).  Each
    call once cold and `warm` times warm, against an f64 oracle; the
    launch counts are set to 0 just before the first call and read just
    after the last."""
    import torch
    from filodb_tpu_torch.ops import kernels
    ragged = bool(hole_frac)
    what = f"raw-counter {'ragged' if ragged else 'dense'}"
    plan, prepared, want, t = raw_counter_inputs(num_series, seed,
                                                 hole_frac, dev)
    log(f"{what}: {num_series} series x {T} samples, {RESETS} resets each: "
        f"generate on the card {t['gen_s']:.3f} s, f64 oracle "
        f"{t['oracle_s']:.3f} s, rebase without correction "
        f"{t['prep_s']:.3f} s, pad_inputs {t['pad_s']:.3f} s")
    W = plan.W
    calls = raw_counter_calls(plan, prepared, ragged, num_series)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    rows_out = []
    for label, names, fn, keys in calls:
        answers, times = [], []
        for i in range(warm + 1):
            n0 = {k: kernels.LAUNCHES[k] for k in names}
            t0 = time.perf_counter()
            answers.append(fn())
            times.append(time.perf_counter() - t0)
            for k in names:
                check(kernels.LAUNCHES[k] == n0[k] + 1,
                      f"{what}: {label} call {i} did not launch {k} once")
        errs = [check_close(np.asarray(g, np.float64), want[k], *tol,
                            f"{what} {label} [{k}]")
                for g, k in zip(answers[-1], keys)]
        for g, k in zip(answers[0], keys):
            check_close(np.asarray(g, np.float64), want[k], *tol,
                        f"{what} {label} [{k}] cold")
        check(all(np.array_equal(a, b, equal_nan=True)
                  for a, b in zip(answers[-2], answers[-1])),
              f"{what}: two warm answers of {label} differ")
        warm_s = times[1:]
        p50, p99 = np.percentile(warm_s, 50), np.percentile(warm_s, 99)
        log(f"{what}: {label} via {'+'.join(names)}: cold {times[0]:.4f} s; "
            f"warm x{warm} p50 {p50:.4f} s p99 {p99:.4f} s; oracle "
            + ", ".join(f"[{k}] max_abs_err {e} max_rel_err {r}"
                        for k, (e, r) in zip(keys, errs))
            + f" (rtol {tol[0]}, atol {tol[1]}); warm answers bit-identical")
        rows_out.append(dict(call=label, cold_s=times[0], p50=p50, p99=p99))
    launches = dict(kernels.LAUNCHES)
    log(f"{what}: windows={W} max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B; launches "
        f"{({k: v for k, v in launches.items() if v})}")
    del prepared, calls
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rows_out


# ------------------------------------------ same-card A/B of two checkouts

AB_CELLS = ("kernels", "counter", "gauge", "raw")
# every entry of phase 2's table, K1-K6: (name, kind, ragged, in-kernel
# drops, per series); K8's three wrappers join them at the probe's shape
AB_KERNELS = [
    (f"{name}_{'ragged' if ragged else 'dense'}{'_series' if series else ''}",
     kind, ragged, drops, series)
    for (name, kind, _), drops in ([(k, False) for k in KERNELS]
                                   + [(k, True) for k in DROPS_KERNELS])
    for ragged in (False, True) for series in (False, True)]


def ab_setup(cell, num_series, seed, dev):
    """One A/B cell in this process -> {panel: (clock, call)}: "kernels"
    every kernel wrapper, K1-K6 at phase 2's shape and K8 at the probe's
    (CUDA events), "counter" and
    "gauge" the first panel of phases 3 and 5 through
    QueryEngine.query_range (after its cold query), "raw" phase 7's
    fused_rate_groupsum(rate) and fused_leaf_agg_batch (host clock)."""
    import torch
    if cell == "kernels":
        from filodb_tpu_torch.ops import probe
        from filodb_tpu_torch.tools import probe_slice as ps
        fns = {}
        for drops in (False, True):
            for ragged in (False, True):
                gen = torch.Generator(device=dev)
                gen.manual_seed(seed)
                inp = kernel_inputs(num_series, T, (NUM_NS,), ragged, gen,
                                    dev, resets=RESETS if drops else 0)
                for name, kind, r, d, series in AB_KERNELS:
                    if (r, d) == (ragged, drops):
                        fns[name] = ("cuda", kernel_call(
                            inp, kind, ragged, series, drops))
        x, o, i1, i2 = ps.inputs(ps.GRID, dev)
        W, WP = ps.W, ps.WP
        # K8's gather beside index_select at its own [rows, WP] output:
        # the same bytes written (index_select takes i1's WP entries, the
        # W selected slots then WP - W zeros, so its last columns copy
        # column 0 where the kernel writes zeros)
        idx_wp = i1[:WP].long()
        fns.update(
            probe_gather=("cuda", lambda: probe.probe_gather(x, i1, W, WP)),
            index_select_wp=("cuda",
                             lambda: torch.index_select(x, 1, idx_wp)),
            probe_two_gathers=("cuda", lambda: probe.probe_two_gathers(
                x, i1, i2, W, WP)),
            probe_onehot_matmul=("cuda",
                                 lambda: probe.probe_onehot_matmul(x, o)))
        return fns
    if cell == "raw":
        plan, prepared, _, _ = raw_counter_inputs(num_series, seed, 0.0, dev)
        return {label: ("host", fn) for label, _, fn, _ in
                raw_counter_calls(plan, prepared, False, num_series)
                if "increase" not in label}
    from filodb_tpu_torch.query.engine import QueryEngine
    ms, _, _, _ = build_store(cell, num_series, seed, 0.0, [])
    eng = QueryEngine("prometheus", ms)
    q = (COUNTER_QUERIES if cell == "counter" else GAUGE_QUERIES)[0][0]
    start_s = START_MS // 1000
    end_s = start_s + (T - 1) * STEP_MS // 1000

    def call():
        return eng.query_range(q, start_s + 600, 60, end_s, scan_params())

    call()
    return {q: ("host", call)}


def ab_turn(fns, reps):
    """{panel: [ms, ...]}: `reps` host-clock calls each, or one CUDA-event
    mean over `reps` launches."""
    out = {}
    for name, (clock, fn) in fns.items():
        if clock == "cuda":
            out[name] = [cuda_ms(fn, reps=reps)]
        else:
            out[name] = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                out[name].append(1e3 * (time.perf_counter() - t0))
    return out


def ab_worker(tree, num_series, seed) -> int:
    """One arm of run_ab: the port of checkout `tree`, built from its own
    sources, driven by JSON lines on stdin ({"op": "setup", "cell": c},
    {"op": "turn", "reps": k}, {"op": "quit"}), each answered by one JSON
    line on stdout; logs go to stderr."""
    sys.path.insert(0, tree)
    reply, sys.stdout = sys.stdout, sys.stderr
    import torch
    from filodb_tpu_torch.ops import kernels
    check(kernels.__file__.startswith(tree),
          f"A/B worker loaded {kernels.__file__}, not {tree}")
    warnings.simplefilter("ignore", RuntimeWarning)
    kernels.finish_builds(kernels.start_builds())
    dev = torch.device("cuda", 0)
    fns = {}
    print(json.dumps({"ready": tree}), file=reply, flush=True)
    for line in sys.stdin:
        cmd = json.loads(line)
        if cmd["op"] == "setup":
            fns = {}
            free_device_memory()
            t0 = time.perf_counter()
            fns = ab_setup(cmd["cell"], num_series, seed, dev)
            ans = {"setup_s": time.perf_counter() - t0}
        elif cmd["op"] == "turn":
            ans = ab_turn(fns, cmd["reps"])
        else:
            break
        print(json.dumps(ans), file=reply, flush=True)
    return 0


def run_ab(others, rounds, cells, num_series, seed, reps) -> int:
    """This checkout against `others` (checkouts of the repo, e.g. the
    parent commit unpacked with git archive) on one card: one worker
    process per checkout; per cell, every worker sets it up, then
    `rounds` rounds each give every checkout one turn, in forward order
    and then backward (A B, B A, ...), so slow spells of the shared host
    fall on both; prints each panel's per-turn p50s, their median, and
    each other checkout's per-round ratio to this one."""
    from pathlib import Path
    here = Path(__file__).resolve().parent
    trees = [str(here)] + [str(Path(o).resolve()) for o in others]
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60).stdout.strip())
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--ab-worker", t,
         "--series", str(num_series), "--seed", str(seed)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        for t in trees]

    def send(i, **cmd):
        procs[i].stdin.write(json.dumps(cmd) + "\n")
        procs[i].stdin.flush()

    def recv(i):
        line = procs[i].stdout.readline()
        check(line, f"A/B worker for {trees[i]} ended")
        return json.loads(line)

    try:
        for i in range(len(trees)):
            recv(i)
        for cell in cells:
            for i in range(len(trees)):
                send(i, op="setup", cell=cell)
            setup = [recv(i)["setup_s"] for i in range(len(trees))]
            turns = [[] for _ in trees]
            for k in range(rounds):
                order = range(len(trees))
                for i in (order if k % 2 == 0 else reversed(order)):
                    send(i, op="turn", reps=reps)
                    turns[i].append(recv(i))
            if cell == "kernels":
                # K8's gather over index_select at equal width, per round,
                # in each arm that times both
                for tree, arm in zip(trees, turns):
                    if "index_select_wp" not in arm[0]:
                        continue
                    r = np.asarray([np.median(t["probe_gather"])
                                    / np.median(t["index_select_wp"])
                                    for t in arm])
                    log(json.dumps({"ab": cell, "tree": tree,
                                    "probe_gather_over_index_select_wp": dict(
                                        median=float(np.median(r)),
                                        min=float(r.min()),
                                        max=float(r.max()),
                                        rounds=len(r))}))
            for panel in turns[0][0]:
                if any(panel not in arm[0] for arm in turns):
                    continue
                p50 = [[float(np.median(t[panel])) for t in arm]
                       for arm in turns]
                rows = [dict(tree=t, setup_s=s, turn_p50_ms=x,
                             median_ms=float(np.median(x)))
                        for t, s, x in zip(trees, setup, p50)]
                for row, x in zip(rows[1:], p50[1:]):
                    r = np.asarray(x) / np.asarray(p50[0])
                    row["ratio_to_this"] = dict(
                        median=float(np.median(r)), min=float(r.min()),
                        max=float(r.max()))
                log(json.dumps({"ab": cell, "panel": panel, "rounds": rounds,
                                "reps": reps, "arms": rows}))
    finally:
        for i, pr in enumerate(procs):
            if pr.poll() is None:
                try:
                    send(i, op="quit")
                    pr.wait(timeout=60)
                except (OSError, subprocess.TimeoutExpired):
                    pr.kill()
    return 0


# ------------------------------------------------------------------ main

# ---------------------------------------------------------------- serve-1M

# the reference's 8-panel dashboard (bench.py:4128-4139, measure_exprfuse)
# with m = request_total
DASHBOARD = [
    "sum by (_ns_)(rate(request_total[5m]))",
    "avg by (_ns_)(rate(request_total[5m]))",
    "max by (_ns_)(max_over_time(request_total[5m]))",
    "count by (_ns_)(rate(request_total[5m]))",
    "sum by (_ns_)(rate(request_total[5m]))"
    " / on (_ns_) count by (_ns_)(rate(request_total[5m]))",
    "sum by (_ns_)(increase(request_total[5m]))",
    "topk(3, sum by (_ns_)(rate(request_total[5m])))",
    "sum by (_ns_)(rate(request_total[5m]))"
    " > bool on (_ns_) avg by (_ns_)(rate(request_total[5m]))",
]
RATE_ONLY = (0, 1, 3, 5)           # the panels that read only rate/increase
SERVE_CLIENTS = 8
SERVE_CLIENT_PASSES = 1            # each client polls the rate-only panels once
SERVE_WINDOW_MS = 50.0             # query.batch_window_ms of the clients step
SERVE_BATCH_WARM = 2
SERVE_CACHE_POLLS = 5
# G4's function over the counters: the raw values through the host
# gather, then the general path's quantile on the card
KILL_QUERY = "max by (_ns_) (quantile_over_time(0.9, request_total[5m]))"
# a column the counter schema lacks: the reference answers 400
# query_error with the KeyError of its lookup
UNKNOWN_COLUMN_QUERY = "sum(rate(request_total::nosuch[5m]))"
KILL_AFTER_S = 1.0


class Http:
    """A JSON client of one FiloHttpServer on localhost."""

    def __init__(self, port):
        self.port = port
        self.base = f"http://127.0.0.1:{port}"

    def call(self, method, path, params=None, body=None, text=False):
        """-> (status, payload, seconds); the payload is the body's text
        where `text` (a text route), else its JSON."""
        import urllib.error
        import urllib.parse
        import urllib.request
        url = self.base + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        req = urllib.request.Request(
            url, data=body, method=method,
            headers={"Content-Type": "application/json"} if body else {})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=600) as f:
                status, raw = f.status, f.read()
        except urllib.error.HTTPError as e:
            status, raw = e.code, e.read()
        return (status, raw.decode() if text else json.loads(raw),
                time.perf_counter() - t0)


def series_map(payload):
    """A matrix payload's series: label set -> its [time, value string]
    points, for a bit-for-bit comparison."""
    check(payload["status"] == "success",
          f"error payload {payload.get('error')}")
    return {tuple(sorted(r["metric"].items())): r["values"]
            for r in payload["data"]["result"]}


def matrix_of(payload, wends):
    """A by-_ns_ matrix payload as [NUM_NS, W] floats (NaN = absent)."""
    out = np.full((NUM_NS, len(wends)), np.nan)
    for r in payload["data"]["result"]:
        g = int(r["metric"]["_ns_"].split("-")[1])
        for t, v in r["values"]:
            out[g, (int(round(float(t) * 1000)) - int(wends[0])) // 60_000] = \
                float(v)
    return out


def run_serve_phase(eng, api, http, want_rate, orc, wends, num_series):
    """serve-1M over the dense counter store, through the recovered node's
    HTTP stack (its FiloHttpServer, driven over real HTTP from this
    process): the
    dashboard batch (POST /api/v1/query_range_batch, cold and
    SERVE_BATCH_WARM warm) bit for bit against each panel alone (GET
    /api/v1/query_range, exprfuse off) and against the f64 oracles;
    SERVE_CLIENTS clients polling the rate-only panels with the coalescer
    on; the result cache; a kill; a column the schema lacks answering the
    reference's 400 -> (launches, rows)."""
    import threading

    import torch
    from filodb_tpu_torch.config import settings
    from filodb_tpu_torch.ops import kernels
    from filodb_tpu_torch.utils.metrics import registry
    start_s = START_MS // 1000
    end_s = start_s + (T - 1) * STEP_MS // 1000
    grid = {"start": start_s + 600, "step": 60, "end": end_s}
    scan = {"scanLimit": str(SCAN_LIMIT)}
    tol = (2e-4, 1e-3)
    gsize = np.bincount(np.arange(num_series) % NUM_NS,
                        minlength=NUM_NS).astype(np.float64)
    avg = want_rate / gsize[:, None]
    fe = api.frontends["prometheus"]

    def counter(name, **tags):
        return registry.counter(name, **tags).value

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    rows = []
    # 1. the dashboard batch
    body = json.dumps({"queries": DASHBOARD, **grid}).encode()
    batches, secs = [], []
    for i in range(SERVE_BATCH_WARM + 1):
        n0 = dict(kernels.LAUNCHES)
        memo0 = counter("leaf_gather_memo_hits")
        with GcPauses() as gcp:
            st, pay, s = http.call("POST", "/api/v1/query_range_batch",
                                   {**scan, "stats": "true"}, body)
        check(st == 200, f"serve-1M batch {i}: status {st} {pay}")
        k1 = {k: kernels.LAUNCHES[k] - n0[k] for k in kernels.LAUNCHES
              if kernels.LAUNCHES[k] > n0[k]}
        check(k1.get("fused_rate_dense", 0) >= 1,
              f"serve-1M batch {i} did not launch K1: {k1}")
        res = pay["results"]
        fusedn = sum(r["stats"]["exprfuse"]["fused"] for r in res)
        degr = sum(r["stats"]["exprfuse"]["degraded"] for r in res)
        log(f"serve-1M: batch {'cold' if i == 0 else f'warm {i}'} "
            f"{s:.4f} s ({gcp}); launches {k1}; exprfuse_fused "
            f"{fusedn} exprfuse_degraded {degr}; leaf_gather_memo_hits "
            f"{counter('leaf_gather_memo_hits') - memo0:.0f}; per-panel "
            "exec_s " + json.dumps(
                [r["stats"]["phases"]["exec_s"] for r in res])
            + " transfer_s " + json.dumps(
                [r["stats"]["phases"]["transfer_s"] for r in res]))
        batches.append(res)
        secs.append(s)
    log(f"serve-1M: dashboard batch {warm_line(secs)}")
    # the same batch through the engine alone, warm: the rest of the
    # HTTP batch's wall is the HTTP layer and JSON, both ways
    with GcPauses() as gcp:
        t0 = time.perf_counter()
        direct = eng.query_range_batch(DASHBOARD, grid["start"], 60,
                                       end_s, scan_params())
        direct_s = time.perf_counter() - t0
    check(all(r.error is None for r in direct),
          "serve-1M: the engine's batch failed")
    log(f"serve-1M: the engine's query_range_batch alone {direct_s:.4f}"
        f" s ({gcp}); the HTTP layer and JSON "
        f"{np.percentile(secs[1:], 50) - direct_s:.4f} s of the warm "
        "p50")
    del direct
    for a, b in zip(batches[-2], batches[-1]):
        check(series_map(a) == series_map(b),
              "serve-1M: two warm batches differ")
    last = batches[-1]
    # 2. each panel alone, exprfuse off (the node's engine reads its
    # own settings)
    qconf = (eng.config or settings()).query
    qconf.exprfuse_enabled = False
    singles, single_s, single_gc = [], [], []
    try:
        for q in DASHBOARD:
            with GcPauses() as gcp:
                st, pay, s = http.call("GET", "/api/v1/query_range",
                                       {"query": q, **grid, **scan})
            single_gc.append(round(gcp.seconds, 4))
            check(st == 200, f"serve-1M single `{q}`: {st} {pay}")
            singles.append(pay)
            single_s.append(s)
    finally:
        qconf.exprfuse_enabled = True
    for q, b, s1, s in zip(DASHBOARD, last, singles, single_s):
        check(series_map(b) == series_map(s1),
              f"serve-1M: batch panel `{q}` differs from its run alone")
    log("serve-1M: every batch panel bit-identical to its run alone "
        "(exprfuse off), value strings and label sets; singles s "
        + json.dumps([round(s, 4) for s in single_s]) + ", gc s in them "
        + json.dumps(single_gc))
    # the f64 oracles
    m = [matrix_of(p, wends) for p in last]
    errs = {
        "sum rate": check_close(m[0], want_rate, *tol, "serve-1M p1"),
        "avg rate": check_close(m[1], avg, *tol, "serve-1M p2"),
        "max_over_time": check_close(m[2], orc["max"], *tol,
                                     "serve-1M p3"),
        "ratio": check_close(m[4], avg, *tol, "serve-1M p5"),
        "increase": check_close(m[5], want_rate * (RANGE_MS / 1000),
                                *tol, "serve-1M p6"),
    }
    errs = {k: v[0] for k, v in errs.items()}
    check(np.array_equal(m[3], np.broadcast_to(gsize[:, None],
                                               m[3].shape)),
          "serve-1M p4: count by (_ns_) is not each group's size")
    check(np.array_equal(m[7], np.ones_like(m[7])),
          "serve-1M p8: sum > bool avg is not 1 everywhere")
    third = np.sort(want_rate, axis=0)[-3]
    top = m[6]
    check(((~np.isnan(top)).sum(axis=0) == 3).all(),
          "serve-1M p7: topk(3) has not 3 series a step")
    ok = ~np.isnan(top)
    errs["topk"] = check_close(np.where(ok, top, np.nan),
                               np.where(ok, want_rate, np.nan), *tol,
                               "serve-1M p7")[0]
    check((top[ok] >= (third[None, :] * (1 - tol[0]) - tol[1])
           .repeat(NUM_NS, 0)[ok]).all(),
          "serve-1M p7: a topk(3) member below the oracle's third")
    log("serve-1M: oracle max_abs_err " + json.dumps(errs)
        + f" (rtol {tol[0]}, atol {tol[1]}); count exact; bool exact")
    rows.append(dict(query="dashboard batch", cold_s=secs[0],
                     p50=float(np.percentile(secs[1:], 50))))
    # 3. concurrent clients, the coalescer on
    fe.cache.clear()
    fe.coalescer.window_s = SERVE_WINDOW_MS / 1000.0
    sf0, cb0 = counter("query_singleflight_hits"), \
        counter("coalesce_merged_batches")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lat, answers, errors, verdicts = [], [], [], []
    barrier = threading.Barrier(SERVE_CLIENTS)

    def client(c):
        try:
            barrier.wait()
            for _ in range(SERVE_CLIENT_PASSES):
                for j in range(len(RATE_ONLY)):
                    p = RATE_ONLY[(c + j) % len(RATE_ONLY)]
                    st, pay, s = http.call(
                        "GET", "/api/v1/query_range",
                        {"query": DASHBOARD[p], **grid, **scan,
                         "stats": "true"})
                    lat.append(s)
                    answers.append((p, st, pay))
                    verdicts.append(pay["stats"]["cache"]["result"])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SERVE_CLIENTS)]
    with GcPauses() as gcp:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    check(not errors and not any(t.is_alive() for t in threads),
          f"serve-1M clients: {errors[:3]}")
    for p, st, pay in answers:
        check(st == 200 and series_map(pay) == series_map(singles[p]),
              f"serve-1M: a client's `{DASHBOARD[p]}` differs from the "
              "sequential answer")
    sf = counter("query_singleflight_hits") - sf0
    cb = counter("coalesce_merged_batches") - cb0
    check(sf > 0, "serve-1M: no singleflight hit")
    check(cb > 0, "serve-1M: the coalescer merged no batch")
    gather = num_series * T * 8        # int32 offsets + f32 values
    check(peak < SERVE_CLIENTS * gather,
          f"serve-1M: peak device memory {peak} B over "
          f"{SERVE_CLIENTS} gathers ({SERVE_CLIENTS * gather} B)")
    log(f"serve-1M: {SERVE_CLIENTS} clients x "
        f"{SERVE_CLIENT_PASSES * len(RATE_ONLY)} "
        f"requests in {wall:.3f} s ({gcp}; cache verdicts "
        f"{ {v: verdicts.count(v) for v in sorted(set(verdicts))} }): p50 "
        f"{np.percentile(lat, 50):.4f} s p99 "
        f"{np.percentile(lat, 99):.4f} s; query_singleflight_hits "
        f"{sf:.0f}; coalesce_merged_batches {cb:.0f}; peak device "
        f"memory above the baseline {peak} B (one gather {gather} B); "
        "answers bit-identical to the sequential ones")
    rows.append(dict(query="clients", p50=float(np.percentile(lat, 50)),
                     p99=float(np.percentile(lat, 99))))
    # 4. the result cache, on the headline panel
    fe.coalescer.window_s = 0.0
    head = {"query": DASHBOARD[0], **grid, **scan, "stats": "true"}
    timings = {"miss": [], "hit": []}
    for verdict in ("miss", "hit"):
        for _ in range(SERVE_CACHE_POLLS):
            if verdict == "miss":
                fe.cache.clear()
            st, pay, s = http.call("GET", "/api/v1/query_range", head)
            got = pay["stats"]["cache"]["result"]
            check(st == 200 and got == verdict,
                  f"serve-1M: cache verdict {got}, expected {verdict}")
            check(series_map(pay) == series_map(singles[0]),
                  f"serve-1M: a cache {verdict} differs")
            timings[verdict].append(s)
    log(f"serve-1M: headline panel uncached p50 "
        f"{np.percentile(timings['miss'], 50):.4f} s, cached p50 "
        f"{np.percentile(timings['hit'], 50):.4f} s "
        f"({SERVE_CACHE_POLLS} polls each, verdicts from stats)")
    # 5. a kill
    fe.cache.clear()
    out = []
    t = threading.Thread(target=lambda: out.append(http.call(
        "GET", "/api/v1/query_range",
        {"query": KILL_QUERY, **grid, **scan})))
    t_start = time.perf_counter()
    t.start()
    qid = None
    while qid is None and time.perf_counter() - t_start < 120:
        _, pay, _ = http.call("GET", "/admin/queries")
        for r in pay["data"]["queries"]:
            if r["promql"] == KILL_QUERY and r["phase"] == "executing":
                qid = r["queryID"]
        time.sleep(0.02)
    check(qid is not None, "serve-1M: the query to kill never ran")
    time.sleep(KILL_AFTER_S)
    t_kill = time.perf_counter()
    st, pay, _ = http.call("POST", f"/admin/queries/{qid}/kill")
    check(st == 200 and pay["data"]["killed"],
          f"serve-1M: kill answered {st} {pay}")
    t.join(timeout=600)
    back = time.perf_counter() - t_kill
    st, pay, _ = out[0]
    check(st != 200 and pay.get("errorType") == "canceled"
          and pay["error"].startswith("query_canceled"),
          f"serve-1M: the killed query answered {st} {pay}")
    log(f"serve-1M: `{KILL_QUERY}` killed "
        f"{t_kill - t_start:.3f} s after it was sent; answered "
        f"{st} {pay['errorType']} {back:.4f} s after the kill: "
        f"{pay['error']}")
    rows.append(dict(query=KILL_QUERY, kill_latency_s=back))
    # 6. a column the schema lacks: the reference's 400 and its error
    n0 = dict(kernels.LAUNCHES)
    st, pay, s = http.call("GET", "/api/v1/query_range",
                           {"query": UNKNOWN_COLUMN_QUERY, **grid, **scan})
    want_err = (400, "error", "query_error", "KeyError: 'nosuch'")
    got_err = (st, pay.get("status"), pay.get("errorType"), pay.get("error"))
    check(got_err == want_err, f"serve-1M: `{UNKNOWN_COLUMN_QUERY}` "
          f"answered {got_err}, the reference {want_err}")
    check(dict(kernels.LAUNCHES) == n0,
          f"serve-1M: `{UNKNOWN_COLUMN_QUERY}` launched a kernel")
    log(f"serve-1M: `{UNKNOWN_COLUMN_QUERY}` answered {st} "
        f"{pay['errorType']} `{pay['error']}` in {s:.4f} s, as the "
        "reference; no kernel launched")
    launches = dict(kernels.LAUNCHES)
    log(f"serve-1M: max_memory_allocated {torch.cuda.max_memory_allocated()}"
        f" B; launches {({k: v for k, v in launches.items() if v})}")
    return launches, rows


OPS_FUSED = ("fused_rate", "fused_increase", "fused_delta")  # K1's labels


def mirror_nbytes(memstore, dataset="prometheus"):
    """The bytes of every device tensor of the mirrors' snapshots of a
    dataset's shards (holding no reference to them)."""
    n = 0
    for sh in memstore.shards_for(dataset):
        for store in sh.stores.values():
            m = getattr(store, "device_mirror", None)
            snap = m.snapshot() if m is not None else None
            if snap is not None:
                n += sum(t.numel() * t.element_size() for t in
                         (snap.ts_off, *snap.cols.values(),
                          *snap.vbases.values()))
    return n


def run_ops_phase(eng, api, http, built, evictions):
    """ops-1M, on the serve-1M server over the same 1M-series store: /ready
    and the health model; /admin/devices after one warm dashboard batch
    (K1's ledger dispatches against its launches, busy seconds, the
    booked `hot` bytes against the mirror's tensors and the allocator,
    one compile a source this process built); stats=all's device split;
    explain (no launch, no device memory) and explain-analyze (K1, its
    ledger sum); a `device.upload` fault in an inline refresh and in the
    background rebuild, then the same answer bit for bit; the profiler.
    `built`: the csrc/ sources this process compiled; `evictions`: the
    padded-values cache's evictions per earlier phase -> (launches,
    rows)."""
    import gc

    import torch
    from filodb_tpu_torch.ops import kernels
    from filodb_tpu_torch.query import execbase
    from filodb_tpu_torch.utils.devicetelem import telem
    from filodb_tpu_torch.utils.faults import faults
    from filodb_tpu_torch.utils.jobs import jobs
    dev = eng.device
    start_s = START_MS // 1000
    end_s = start_s + (T - 1) * STEP_MS // 1000
    grid = {"start": start_s + 600, "step": 60, "end": end_s}
    scan = {"scanLimit": str(SCAN_LIMIT)}
    fe = api.frontends["prometheus"]
    body = json.dumps({"queries": DASHBOARD, **grid}).encode()
    head = {"query": DASHBOARD[0], **grid, **scan}
    kernels.reset_launch_counts()
    rows = []
    log(f"ops-1M: fused values budget {execbase._fused_vals_budget()} B "
        f"(device {dev}, total memory {torch.cuda.mem_get_info(dev)[1]} B,"
        f" mirror budget {execbase._MIRROR_LIMIT_SEEN} B); cache evictions "
        "per phase " + json.dumps(evictions))

    # 1. readiness and the health model
    st, pay, _ = http.call("GET", "/ready")
    check(st == 200 and pay == {"status": "ready"}, f"ops-1M /ready {st} {pay}")

    def health_ok(what):
        st, pay, _ = http.call("GET", "/api/v1/status/health")
        subs = pay["data"]["subsystems"]
        bad = {k: v for k, v in subs.items() if v["status"] != "ok"}
        check(st == 200 and not bad and pay["data"]["status"] == "ok",
              f"ops-1M: health {what}: {bad or pay}")
        return subs
    subs = health_ok("at start")
    log("ops-1M: /ready 200; /api/v1/status/health ok in "
        + ", ".join(sorted(subs)))
    # the node's shard mapper, as the cluster routes show it
    st, status, _ = http.call("GET", "/cluster/prometheus/status")
    check(st == 200 and status["data"] == [
        {"shard": 0, "status": "Active", "address": "local"}],
        f"ops-1M: /cluster/prometheus/status {st} {status}")
    st, shards, _ = http.call("GET", "/admin/shards")
    ent = shards["data"]["datasets"].get("prometheus", {}) \
        if st == 200 else {}
    check(ent.get("numShards") == 1 and ent.get("replicationFactor") == 1
          and [(r["shard"], r["primary"], r["status"], r["liveOwners"])
               for r in ent.get("shards", [])] == [(0, "local", "Active", 1)]
          and "replicaLag" not in ent,
          f"ops-1M: /admin/shards {st} {shards}")
    # the replication and federation routes (once 501, before those layers
    # were ported) answer as the reference's on a node without either
    st_f, fed, _ = http.call("GET", "/admin/federation")
    check(st_f == 200 and fed["data"] == {"cluster": "", "clusters": []},
          f"ops-1M: /admin/federation {st_f} {fed}")
    st_h, hand, _ = http.call("POST", "/admin/shards/0/handoff",
                              {"to": "B"})
    check(st_h == 400 and "no handoff coordinator" in hand.get("error", ""),
          f"ops-1M: POST /admin/shards/0/handoff {st_h} {hand}")
    log(f"ops-1M: /cluster/prometheus/status {status['data']}; "
        f"/admin/shards {json.dumps(ent)}; /admin/federation {st_f} "
        f"{json.dumps(fed['data'])}; the handoff route {st_h} "
        f"({hand['error'][:60]})")

    # 2. /admin/devices over one warm dashboard batch
    st, pay, _ = http.call("POST", "/api/v1/query_range_batch", scan, body)
    check(st == 200, f"ops-1M: warm-up batch {st}")

    def devices():
        st, pay, _ = http.call("GET", "/admin/devices", {"recent": "0"})
        check(st == 200, f"ops-1M: /admin/devices {st} {pay}")
        return pay["data"]["devices"]

    def k1_dispatches(d):
        ks = d.get(str(dev), {}).get("kernels", {})
        return sum(ks.get(k, {}).get("count", 0) for k in OPS_FUSED)
    d0 = devices()
    n0 = dict(kernels.LAUNCHES)
    st, pay, batch_s = http.call("POST", "/api/v1/query_range_batch", scan,
                                 body)
    check(st == 200, f"ops-1M: batch {st}")
    torch.cuda.synchronize()
    d1 = devices()
    k1 = sum(kernels.LAUNCHES[k] - n0[k] for k in
             ("fused_rate_dense", "fused_rate_dense_series"))
    disp = k1_dispatches(d1) - k1_dispatches(d0)
    card = d1.get(str(dev))
    check(card is not None, f"ops-1M: no {dev} row in /admin/devices: "
          f"{sorted(d1)}")
    check(k1 >= 1 and disp == k1, f"ops-1M: K1 launched {k1} times, the "
          f"ledger shows {disp} fused rate-family dispatches")
    check(card["busySeconds"] > d0.get(str(dev), {}).get("busySeconds", 0),
          f"ops-1M: busySeconds did not grow: {card['busySeconds']}")
    nbytes = mirror_nbytes(eng.source)
    alloc = torch.cuda.memory_allocated(dev)
    check(card["hbm"].get("hot") == nbytes,
          f"ops-1M: booked hot {card['hbm']} != the mirror's {nbytes} B")
    check(nbytes <= alloc, f"ops-1M: booked {nbytes} B over the "
          f"allocator's {alloc} B")
    compiles = sum(d.get("compiles", 0) for d in d1.values())
    check(compiles == len(built), f"ops-1M: {compiles} compile entries, "
          f"this process built {built}")
    log(f"ops-1M: warm batch {batch_s:.4f} s; K1 launches {k1} = ledger "
        f"dispatches {disp}; {dev} busySeconds {card['busySeconds']} "
        f"utilEwma {card['utilEwma']} dispatches {card['dispatches']}; "
        f"kernels " + json.dumps(card["kernels"]) + f"; booked hot "
        f"{nbytes} B = the mirror's tensors, memory_allocated {alloc} B, "
        f"high water {card['hbmHighWaterBytes']} B; compiles {compiles} "
        f"(built here: {built})")
    rows.append(dict(query="ops batch", seconds=batch_s, k1=k1,
                     busy_s=card["busySeconds"]))

    # 3. stats=all: the device split of a warm fused panel
    fe.cache.clear()
    http.call("GET", "/api/v1/query_range", head)
    fe.cache.clear()
    st, pay, _ = http.call("GET", "/api/v1/query_range",
                           {**head, "stats": "all"})
    check(st == 200, f"ops-1M: stats=all {st}")
    s = pay["stats"]
    split = [c["seconds"] for dv in s["devices"].values()
             for c in dv.values()]
    check(s["phases"]["device_s"] > 0 and split, f"ops-1M: stats {s}")
    check(abs(sum(split) - s["phases"]["device_s"]) <= 1e-6 * len(split),
          f"ops-1M: device split {sum(split)} != device_s "
          f"{s['phases']['device_s']} (6-decimal JSON)")
    res = eng.query_range(DASHBOARD[0], grid["start"], 60, end_s,
                          scan_params())
    st_ = res.stats
    exact = sum(c[0] for c in st_.device_calls.values())
    check(res.error is None and st_.device_seconds > 0
          and abs(exact - st_.device_seconds) <= 1e-9,
          f"ops-1M: QueryStats split {exact} != {st_.device_seconds}")
    log(f"ops-1M: stats=all device_s {s['phases']['device_s']} s = sum of "
        f"devices " + json.dumps(s["devices"]) + f"; engine QueryStats "
        f"device_seconds {st_.device_seconds} = its split to 1e-9")

    # 4. explain launches nothing; analyze runs K1 once
    torch.cuda.synchronize()
    n0, m0 = dict(kernels.LAUNCHES), torch.cuda.memory_allocated(dev)
    for path, extra in (("/api/v1/query_range", {"explain": "true"}),
                        ("/api/v1/query", {"explain": "true",
                                           "time": str(end_s)}),
                        ("/api/v1/explain", {})):
        st, pay, _ = http.call("GET", path, {**head, **extra})
        check(st == 200 and pay["data"]["resultType"] == "execPlan",
              f"ops-1M: explain {path} {st} {pay}")
    torch.cuda.synchronize()
    check(kernels.LAUNCHES == n0, "ops-1M: explain launched a kernel")
    m1 = torch.cuda.memory_allocated(dev)
    check(m1 == m0, f"ops-1M: explain moved memory_allocated {m0} -> {m1}")
    tree = pay["data"]["result"]
    st, pay, an_s = http.call("GET", "/api/v1/explain",
                              {**head, "analyze": "true"})
    check(st == 200 and pay["data"]["resultType"] == "execPlanAnalysis",
          f"ops-1M: analyze {st} {pay}")
    k1 = kernels.LAUNCHES["fused_rate_dense"] - n0["fused_rate_dense"]
    check(k1 == 1, f"ops-1M: analyze launched K1 {k1} times")
    tid = pay["data"]["traceID"]
    ledger = sum(e["seconds"] for e in telem.recent(limit=512,
                                                     kind="kernel")
                 if e["origin"] == tid)
    node_dev = sum(n["device_s"] for n in pay["data"]["nodes"])
    check(ledger > 0 and abs(node_dev - ledger) <= 1e-5,
          f"ops-1M: analyze device {node_dev} s, its ledger {ledger} s")
    log("ops-1M: explain (query_range, query, /api/v1/explain) launched "
        f"nothing, memory_allocated {m0} B before and after; tree "
        + json.dumps(tree) + f"; analyze {an_s:.4f} s, K1 once, nodes' "
        f"device {node_dev:.6f} s = the trace's ledger {ledger:.6f} s: "
        + json.dumps(pay["data"]["result"]))

    # 5. device.upload: the inline first build, then a background rebuild
    shard = eng.source.get_shard("prometheus", 0)
    store = next(x for x in shard.stores.values()
                 if getattr(x, "device_mirror", None) is not None)
    fe.cache.clear()
    st, before, _ = http.call("GET", "/api/v1/query_range", head)
    check(st == 200, f"ops-1M: the answer before the fault {st}")
    torch.cuda.synchronize()
    m_before = torch.cuda.memory_allocated(dev)
    mirror_bytes = store.device_mirror.booked_bytes
    store.device_mirror = None
    gc.collect()
    torch.cuda.synchronize()
    m_dropped = torch.cuda.memory_allocated(dev)
    faults.arm("device.upload", "error", first_k=2)
    try:
        fe.cache.clear()
        st, pay, _ = http.call("GET", "/api/v1/query_range", head)
        check(st != 200 and "device.upload" in pay.get("error", ""),
              f"ops-1M: the faulted query answered {st} {pay}")
        fault_err = pay["error"]
        torch.cuda.synchronize()
        m_fault = torch.cuda.memory_allocated(dev)
        mirror = store.device_mirror
        check(mirror.snapshot() is None and mirror.booked_bytes == 0
              and m_fault <= m_dropped,
              f"ops-1M: the failed upload left device arrays: "
              f"{m_dropped} -> {m_fault} B")
        check(mirror.request_background_refresh(shard, store)
              and mirror.join_rebuild(120),
              "ops-1M: the background rebuild did not run")
    finally:
        faults.disarm()
    key = f"mirror_rebuild:prometheus/{shard.shard_num}"
    st, pay, _ = http.call("GET", "/api/v1/status/health")
    job = pay["data"]["subsystems"]["jobs"]["jobs"].get(key, {})
    check(job.get("status") == "degraded"
          and "device.upload" in job.get("lastError", ""),
          f"ops-1M: health shows no failed rebuild: {job}")
    fe.cache.clear()
    t0 = time.perf_counter()
    st, after, _ = http.call("GET", "/api/v1/query_range", head)
    reup_s = time.perf_counter() - t0
    check(st == 200 and series_map(after) == series_map(before),
          "ops-1M: the answer after the fault differs from the one before")
    torch.cuda.synchronize()
    m_after = torch.cuda.memory_allocated(dev)
    check(abs(m_after - m_before) <= mirror_bytes,
          f"ops-1M: memory_allocated {m_before} -> {m_after} B, more than "
          f"one mirror ({mirror_bytes} B)")
    check(mirror.request_background_refresh(shard, store)
          and mirror.join_rebuild(120), "ops-1M: the clean rebuild")
    health_ok("after the fault drill")
    snap = [j for j in jobs.snapshot() if j["job"] == "mirror_rebuild"]
    log(f"ops-1M: device.upload armed: the query answered `{fault_err}`; "
        f"memory_allocated {m_before} -> {m_dropped} (mirror dropped) -> "
        f"{m_fault} (failed upload) -> {m_after} B (re-uploaded in "
        f"{reup_s:.3f} s, mirror {mirror_bytes} B); health jobs showed "
        f"`{job['lastError']}`, ok again after a clean rebuild; the answer "
        f"bit-identical to the one before; jobs " + json.dumps(snap))

    # 6. the profiler over one warm headline panel
    st, pay, _ = http.call("POST", "/admin/profiler/start", {"hz": "100"})
    check(st == 200, f"ops-1M: profiler start {st} {pay}")
    st, _, prof_s = http.call("GET", "/api/v1/query_range", head)
    st, pay, _ = http.call("POST", "/admin/profiler/stop")
    check(st == 200 and pay["samples"] > 0,
          f"ops-1M: profiler stop {st} {pay}")
    samples = pay["samples"]
    st, rep, _ = http.call("GET", "/admin/profiler/report", {"top": "8"},
                           text=True)
    check(st == 200 and "samples" in rep, f"ops-1M: profiler report {st}")
    log(f"ops-1M: profiler {samples} samples over a {prof_s:.3f} s panel; "
        "report:\n" + rep[:2000])
    launches = dict(kernels.LAUNCHES)
    log(f"ops-1M: launches {({k: v for k, v in launches.items() if v})}")
    return launches, rows


def log_ptxas(kernels):
    """Each kernel's registers, static shared memory and spills as ptxas
    reported them (-Xptxas -v), and the warps an SM its registers allow
    (65,536 registers an SM; the staged kernels run 4 warps a block)."""
    for lib in kernels.SOURCES:
        for r in kernels.ptxas_report(lib):
            try:
                name = subprocess.run(["c++filt", r["kernel"]],
                                      capture_output=True, text=True,
                                      timeout=10).stdout.strip()
                name = name.replace("(anonymous namespace)::", "")
                name = name.removeprefix("void ").split("(")[0]
            except (OSError, subprocess.SubprocessError):
                name = r["kernel"]
            regs = r["registers"]
            log(f"ptxas {lib} {name}: {regs} registers, {r['smem']} B "
                f"static smem, spill stores {r['spill_stores']} B loads "
                f"{r['spill_loads']} B; warps an SM by registers "
                f"{65536 // (regs * 32) if regs else 'n/a'}")


NODE_SERIES = 16_384                # node-16k (host flush and page-in: cut)
NODE_QUERY = RATE_Q                 # sum by (_ns_) (rate(request_total[5m]))
NODE_TOTAL = "sum(rate(request_total[5m]))"
HERE = os.path.dirname(os.path.abspath(__file__))


def cli_run(*args, timeout=900):
    """`python -m filodb_tpu_torch.cli ARGS` from the repository root ->
    (stdout, seconds); fails the phase on a non-zero exit."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "filodb_tpu_torch.cli",
                          *args], cwd=HERE, capture_output=True, text=True,
                         timeout=timeout)
    secs = time.perf_counter() - t0
    check(out.returncode == 0, f"node-16k: filo-cli {' '.join(args[:1])} "
          f"exited {out.returncode}: {out.stderr[-2000:]}{out.stdout[-500:]}")
    return out.stdout, secs


class Serve:
    """`python -m filodb_tpu_torch.cli serve` as a subprocess, its output
    read on a thread; `host` once it printed its address."""

    def __init__(self, data_dir, timeout_s=600):
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "filodb_tpu_torch.cli", "serve",
             "--data-dir", data_dir, "--port", "0", "--downsample", "60000"],
            cwd=HERE, stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, bufsize=1)
        self.lines = []
        self._ready = threading.Event()
        threading.Thread(target=self._read, daemon=True).start()
        if not self._ready.wait(timeout_s) or self.proc.poll() is not None:
            self.kill()
            raise SmokeFailure("node-16k: serve did not start: "
                               + "".join(self.lines)[-2000:])
        self.host = self.lines[-1].split()[-1]
        self.up_s = time.perf_counter() - self.t0

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line)
            if line.startswith("serving "):
                self._ready.set()

    def stop(self, timeout_s=600):
        """SIGINT, then wait for the final flush -> seconds."""
        t0 = time.perf_counter()
        self.proc.send_signal(signal.SIGINT)
        try:
            rc = self.proc.wait(timeout_s)
        except subprocess.TimeoutExpired:
            self.kill()
            raise SmokeFailure("node-16k: serve did not stop on SIGINT")
        check(rc == 0, f"node-16k: serve exited {rc} on SIGINT: "
              + "".join(self.lines)[-2000:])
        return time.perf_counter() - t0

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def node_matrix(payload, wends, what):
    check(payload.get("status") == "success", f"node-16k {what}: "
          f"{payload.get('error')}")
    return matrix_of(payload, wends)


def run_node_phase(seed, dev):
    """node-16k: filo-cli as users run it, on the card.  NODE_SERIES
    request counters x 720 at 10 s (one reset each, _ns_ = App-{i %
    1000}) written as an NPZ bundle through jobs.batch_io (from a host
    memstore over a disk column store, whose flush is timed with the
    native host library loaded); `init` and `importbundle` into a data
    directory (a disk column store; the import flushes); `serve
    --data-dir D --port 0 --downsample 60000` as a subprocess on the
    card; `query` and `querybatch --host` held to the f64 oracle (rtol
    2e-4 / atol 1e-3), K1 counted by the server's /admin/devices
    ledger; health, jobs, devices, status, shards, tenants, cardinality
    and events each answering; SIGINT and the final flush, then `serve`
    again over the same directory, its panel within the same tolerance
    (bit-identical or not, printed) and its boot to the first answer
    timed; the offline commands list, indexnames, indexvalues,
    topkcard, decodechunks, chunkinfos, partkey, validateSchemas and an
    exportbundle whose arrays equal the bundle imported, series by
    series, those that open a memstore with --device cpu (no kernel runs
    in them) -> (launches, rows): this process launches nothing; the
    server's K1 is counted by its ledger.  Cut from 1M to NODE_SERIES
    for the time limit: the flush encodes and the first panel pages back
    every series on the host."""
    import torch
    from filodb_tpu_torch import native
    from filodb_tpu_torch.core.index import Equals
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.core.partkey import PartKey
    from filodb_tpu_torch.core.store import InMemoryMetaStore
    from filodb_tpu_torch.jobs import batch_io
    from filodb_tpu_torch.persist import LocalDiskColumnStore
    lib = native.lib
    check(lib is not None, f"node-16k: no native host library: "
          f"{native.build_error()}")
    n = NODE_SERIES
    rng = np.random.default_rng(seed)
    vals = make_counter_slab(rng, n, 0.0)
    ts_row = START_MS + np.arange(T, dtype=np.int64) * STEP_MS
    wends = np.arange(START_MS + 600_000, int(ts_row[-1]) + 1, 60_000)
    start_s, end_s = int(wends[0]) // 1000, int(ts_row[-1]) // 1000
    grid = ["--start", str(start_s), "--end", str(end_s), "--step", "60"]
    want = rate_by_ns(torch.from_numpy(vals).to(dev), ts_row, wends)
    want_total = np.nansum(want, axis=0)
    want_total[np.isnan(want).all(axis=0)] = np.nan
    tmp = tempfile.mkdtemp(prefix="filodb-node-")
    steps = {}
    servers = []
    try:
        # 1. the bundle, through a host memstore whose flush is timed
        t0 = time.perf_counter()
        ms = TimeSeriesMemStore(
            column_store=LocalDiskColumnStore(os.path.join(tmp, "bundle")),
            meta_store=InMemoryMetaStore(), device="cpu")
        keys = [PartKey.make("request_total", {
            "_ws_": "demo", "_ns_": f"App-{i % NUM_NS}",
            "instance": f"Instance-{i}"}) for i in range(n)]
        ms.setup("prometheus", 0).ingest_columns(
            "prom-counter", keys, np.broadcast_to(ts_row, (n, T)),
            {"count": vals})
        t1 = time.perf_counter()
        chunks = ms.get_shard("prometheus", 0).flush_all_groups()
        flush_s = time.perf_counter() - t1
        bundle = os.path.join(tmp, "counters.npz")
        exported = batch_io.export_series(
            ms, "prometheus", [Equals("_metric_", "request_total")],
            START_MS, int(ts_row[-1]), bundle)
        check(exported == n, f"node-16k: the bundle holds {exported}")
        del ms, keys
        steps["bundle"] = time.perf_counter() - t0
        log(f"node-16k: {n} series x {T} samples: a host flush of "
            f"{chunks} chunks in {flush_s:.3f} s ({1e3 * flush_s / n:.3f} ms "
            f"a series) with the native host library {lib.path} loaded; "
            f"the bundle {os.path.getsize(bundle)} B")
        # 2. init and importbundle into a data directory
        d = os.path.join(tmp, "data")
        out, steps["init"] = cli_run("init", "--data-dir", d)
        out, steps["importbundle"] = cli_run("importbundle", "--data-dir", d,
                                             "--bundle", bundle)
        check(out.strip() == f"imported {n * T} samples from {bundle}",
              f"node-16k: importbundle said {out!r}")
        # 3. serve on the card
        srv = Serve(d)
        servers.append(srv)
        steps["serve up"] = srv.up_s

        def ledger():
            out, _ = cli_run("devices", "--host", srv.host, "--raw")
            devs = json.loads(out)["data"]["devices"]
            ks = devs.get(str(dev), {}).get("kernels", {})
            return sum(ks.get(k, {}).get("count", 0) for k in OPS_FUSED)
        k0 = ledger()
        # 4. query and querybatch over HTTP
        out, steps["query cold"] = cli_run(
            "query", "--host", srv.host, "--promql", NODE_QUERY, "--raw",
            *grid)
        first = node_matrix(json.loads(out), wends, "query")
        err, rel = matrix_close(first, want, *KERNEL_TOL, "node-16k query")
        out, steps["query warm"] = cli_run(
            "query", "--host", srv.host, "--promql", NODE_QUERY, "--raw",
            *grid)
        warm = node_matrix(json.loads(out), wends, "warm query")
        matrix_close(warm, want, *KERNEL_TOL, "node-16k warm query")
        out, steps["querybatch"] = cli_run(
            "querybatch", "--host", srv.host, "--promql", NODE_QUERY,
            "--promql", NODE_TOTAL, "--raw", *grid)
        batch = json.loads(out)
        check(batch.get("status") == "success"
              and [r["status"] for r in batch["results"]] == ["success"] * 2,
              f"node-16k: querybatch {str(batch)[:500]}")
        matrix_close(node_matrix(batch["results"][0], wends, "batch"),
                     want, *KERNEL_TOL, "node-16k querybatch panel 1")
        total = np.full(len(wends), np.nan)
        for r in batch["results"][1]["data"]["result"]:
            for t, v in r["values"]:
                total[(int(round(float(t) * 1000)) - int(wends[0]))
                      // 60_000] = float(v)
        matrix_close(total[None, :], want_total[None, :], *KERNEL_TOL,
                     "node-16k querybatch panel 2")
        k1 = ledger() - k0
        check(k1 >= 3, f"node-16k: the server's ledger shows {k1} K1 "
              f"dispatches over the query, its warm run and the batch")
        # 5. the operations commands
        answers = {}
        for cmd in ("health", "jobs", "devices", "status", "shards",
                    "tenants", "cardinality", "events"):
            extra = ["--raw"] if cmd in ("jobs", "devices", "shards",
                                         "tenants", "cardinality") else []
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "filodb_tpu_torch.cli", cmd,
                 "--host", srv.host, *extra], cwd=HERE,
                capture_output=True, text=True, timeout=300)
            steps[cmd] = time.perf_counter() - t0
            if cmd == "health" and proc.returncode == 1:
                subs = json.loads(proc.stdout)["data"]["subsystems"]
                raise SmokeFailure("node-16k: the node is degraded: "
                                   + json.dumps({k: v for k, v in
                                                 subs.items()
                                                 if v["status"] != "ok"}
                                                )[:3000])
            check(proc.returncode == 0,
                  f"node-16k: {cmd} exited {proc.returncode}: "
                  f"{proc.stdout[-1000:]}{proc.stderr[-1000:]}")
            if cmd == "events":
                evs = [json.loads(x) for x in proc.stdout.splitlines() if x]
                check(any(e["kind"] == "phase" and e["to"] == "serving"
                          for e in evs), "node-16k: no serving event")
                answers[cmd] = f"{len(evs)} events"
                continue
            pay = json.loads(proc.stdout)
            check(pay.get("status") == "success",
                  f"node-16k: {cmd} {str(pay)[:500]}")
            answers[cmd] = pay["data"]
        health = answers["health"]
        check(health["status"] == "ok" and health["phase"] == "serving",
              f"node-16k: health {health['status']} in phase "
              f"{health['phase']}")
        log(f"node-16k: health {health['status']}, subsystems "
            + json.dumps({k: v["status"] for k, v in
                          health["subsystems"].items()}))
        check(answers["status"] == [
            {"shard": 0, "status": "Active", "address": "local"}],
            f"node-16k: status {answers['status']}")
        check(answers["cardinality"]["headStats"]["numSeries"] == n,
              f"node-16k: cardinality {answers['cardinality']['headStats']}")
        check(str(dev) in answers["devices"]["devices"],
              f"node-16k: devices {sorted(answers['devices']['devices'])}")
        # 6. SIGINT, the final flush, and a second boot
        steps["stop"] = srv.stop()
        servers.remove(srv)
        t0 = time.perf_counter()
        srv = Serve(d)
        servers.append(srv)
        out, _ = cli_run("query", "--host", srv.host, "--promql",
                         NODE_QUERY, "--raw", *grid)
        steps["reboot to first answer"] = time.perf_counter() - t0
        again = node_matrix(json.loads(out), wends, "query after restart")
        matrix_close(again, want, *KERNEL_TOL, "node-16k after restart")
        same = np.array_equal(again, first, equal_nan=True)
        steps["stop 2"] = srv.stop()
        servers.remove(srv)
        # 7. the offline commands over the same directory, on the host
        # (--device cpu): they read the index and the disk store and run
        # no kernel, so they open no CUDA context beside the main line
        offline = {}
        for args in (["list"], ["indexnames"],
                     ["indexvalues", "--label", "_ns_", "--limit", "3"],
                     ["topkcard"], ["decodechunks", "--limit", "4"],
                     ["chunkinfos", 'request_total{_ns_="App-7"}',
                      "--limit", "4"],
                     ["partkey", 'request_total{_ws_="demo",_ns_="App-7",'
                      'instance="Instance-7"}', "--num-shards", "1"],
                     ["validateSchemas"]):
            local = {"partkey": [], "validateSchemas": [],
                     "list": ["--data-dir", d]}.get(
                args[0], ["--data-dir", d, "--device", "cpu"])
            out, steps[args[0]] = cli_run(*args, *local)
            offline[args[0]] = out
        check("prometheus\tshards=1" in offline["list"].splitlines(),
              f"node-16k: list {offline['list']!r}")
        check({"__name__", "_ns_", "_ws_", "instance"}
              <= set(offline["indexnames"].split()),
              f"node-16k: indexnames {offline['indexnames']!r}")
        check(offline["topkcard"].split()[:2] == [str(n), "demo"],
              f"node-16k: topkcard {offline['topkcard']!r}")
        check(f"rows={T}" in offline["decodechunks"],
              f"node-16k: decodechunks {offline['decodechunks'][:300]!r}")
        infos = [json.loads(x) for x in offline["chunkinfos"].splitlines()]
        check(infos and all(i["_ns_"] == "App-7" and i["numRows"] == T
                            for i in infos),
              f"node-16k: chunkinfos {infos[:2]}")
        check("ingestionShard 0" in offline["partkey"]
              and "Validation passed" in offline["validateSchemas"],
              "node-16k: partkey or validateSchemas")
        back = os.path.join(tmp, "back.npz")
        out, steps["exportbundle"] = cli_run(
            "exportbundle", "--data-dir", d, "--metric", "request_total",
            "--start", str(START_MS), "--end", str(int(ts_row[-1])),
            "--out", back, "--device", "cpu")
        check(out.strip() == f"exported {n} series to {back}",
              f"node-16k: exportbundle said {out!r}")

        def by_labels(path):
            labels, schemas, series = batch_io.load_bundle(path)
            return {tuple(sorted(lab.items())): (sch, s) for lab, sch, s
                    in zip(labels, schemas, series)}
        a, b = by_labels(back), by_labels(bundle)
        check(sorted(a) == sorted(b), "node-16k: exported series differ")
        for k in a:
            (sa, xa), (sb, xb) = a[k], b[k]
            check(sa == sb and np.array_equal(xa["ts"], xb["ts"])
                  and sorted(xa["cols"]) == sorted(xb["cols"])
                  and all(np.array_equal(xa["cols"][c], xb["cols"][c])
                          for c in xa["cols"]),
                  f"node-16k: exported {k} differs from the bundle")
    finally:
        for srv in servers:
            srv.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"node-16k: query oracle max_abs_err {err} max_rel_err {rel}; "
        f"K1 dispatches in the server's ledger {k1}; after the restart "
        f"the panel is {'' if same else 'not '}bit-identical to the first "
        f"boot's; the server's /admin/shards "
        f"{json.dumps(answers['shards']['datasets'])}; every step's "
        "seconds " + json.dumps({k: round(v, 3) for k, v in steps.items()}))
    return {}, [dict(query=NODE_QUERY, kernel="fused_rate_dense", err=err)]


def phase_timer(dev, phase_s, phase_evictions):
    """timed(name, fn, *a, **kw): run one phase, log its seconds, the
    padded-values cache's evictions in it (its byte budget,
    query/execbase._fused_vals_budget, is what ops-1M prints) and the
    kernel ledger's busy seconds on the card in it (launch through
    readback of the fused calls; enqueue time of the mirror gathers).
    A phase's seconds leave out a phase run inside it (restart-1M's
    inside dense-1M's)."""
    from filodb_tpu_torch.utils.devicetelem import telem
    from filodb_tpu_torch.utils.metrics import registry
    evictions = registry.counter("fused_vals_cache_evictions")

    def busy():
        return telem.snapshot(recent=0)["devices"].get(
            str(dev), {}).get("busySeconds", 0.0)

    spent = [0.0]                      # seconds of the phases that ended

    def timed(name, fn, *a, **kw):
        t, e0, b0 = time.perf_counter(), evictions.value, busy()
        s0 = spent[0]
        out = fn(*a, **kw)
        total = time.perf_counter() - t
        phase_s[name] = total - (spent[0] - s0)
        spent[0] = s0 + total
        phase_evictions[name] = int(evictions.value - e0)
        b = busy() - b0
        log(f"phase {name}: {phase_s[name]:.1f} s; fused values cache "
            f"evictions {phase_evictions[name]}; ledger busy seconds on "
            f"{dev} {b:.4f} ({100 * b / phase_s[name]:.2f}% of the phase)")
        return out
    return timed


# ---------------------------------------- mesh-1M, mesh-2proc-65k, cards

MESH_SHARDS = 4
MESH_SPREAD = 2                    # tests/test_mesh.py::_mk_store's spread
MESH_RAGGED = 65_536               # mesh-1M's NaN-holed counters (K3)
MESH_RAGGED_METRIC = "request_ragged"
MESH_2PROC_SERIES = 65_536         # mesh-2proc-65k
MESH_2PROC_TIMEOUT_S = 420         # both workers, CUDA start included
# mesh-1M's side grows by ~20 GiB of host memory (the 4-shard store and
# its keys); it starts once the machine has that and 12 GiB besides
# available, or after MESH_HOST_WAIT_S of waiting
MESH_HOST_NEED = 32 * 2 ** 30
MESH_HOST_WAIT_S = 180
# mesh against the engine over the same store: both run K1 over each
# shard's rows in f32 and merge the shards in f64, the mesh in its pack's
# row order, the engine in its mirror's; over <= 1,049 positive rates a
# group the f32 sums of two row orders differ by at most ~n * 2^-24
# relative (n ~ 262 rows a group a shard: 1.6e-5)
MESH_ENGINE_TOL = (2e-5, 1e-9)
MESH_BATCH = [(("_ns_",), (), "sum"), (("_ns_",), (), "avg"),
              (("dc",), (), "sum"), (("_ns_",), (), "count")]


def mesh_labels(labels_of_i):
    return {"_ws_": "demo", "_ns_": f"App-{labels_of_i % NUM_NS}",
            "instance": f"Instance-{labels_of_i}",
            "dc": f"DC{labels_of_i % 2}"}


def mesh_store(num_series, seed, dev, ragged=MESH_RAGGED, shards=None,
               oracles=("rate", "over_time")):
    """mesh-1M's data: a TimeSeriesMemStore on the card whose MESH_SHARDS
    shards are routed by a MESH_SHARDS-shard ShardMapper with spread 2
    (tests/test_mesh.py::_mk_store): dense-1M's counters (the same seed,
    slab by slab, through ingest_columns) and `ragged` counters with ~1%
    NaN scrape holes as a second metric (MESH_RAGGED_METRIC); `shards`
    (default all) are the ones this store keeps.  Their f64 group
    oracles on the card, those `oracles` names: "rate" (by _ns_ and by
    dc, and the ragged rate by _ns_), "over_time" (sum_over_time and
    last_over_time, the slot value, by _ns_) ->
    (memstore, mapper, {oracle: GroupOracle}, wends, seconds)."""
    import torch
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.core.partkey import PartKey
    from filodb_tpu_torch.parallel.shardmapper import ShardEvent, ShardMapper
    from filodb_tpu_torch.core.blockstore import DenseSeriesStore
    t0 = time.perf_counter()
    keep = list(range(MESH_SHARDS)) if shards is None else list(shards)
    ms = TimeSeriesMemStore(device=dev)
    mapper = ShardMapper(MESH_SHARDS)
    for s in range(MESH_SHARDS):
        mapper.update_from_event(
            ShardEvent("IngestionStarted", "prometheus", s, "local"))
    ts_row = START_MS + np.arange(T, dtype=np.int64) * STEP_MS
    wends = np.arange(START_MS + 600_000, int(ts_row[-1]) + 1, 60_000)
    W = len(wends)
    orc = {k: GroupOracle(NUM_NS, W, dev)
           for k in ("rate", "sum_over_time", "last_over_time", "ragged")}
    orc["rate_dc"] = GroupOracle(2, W, dev)
    sets = []
    for metric, n_all, hole, rng in (
            ("request_total", num_series, 0.0, np.random.default_rng(seed)),
            (MESH_RAGGED_METRIC, min(ragged, num_series), 0.01,
             np.random.default_rng(seed + 13))):
        keys = [PartKey.make(metric, mesh_labels(i)) for i in range(n_all)]
        to = np.asarray([mapper.ingestion_shard(
            pk.shard_key_hash(), pk.partition_hash(), MESH_SPREAD)
            for pk in keys], np.int64)
        sets.append((keys, to, hole, rng))
    per_shard = sum(np.bincount(to, minlength=MESH_SHARDS)
                    for _, to, _, _ in sets)
    route_s = time.perf_counter() - t0
    # each shard's store made at its final extent (its rows, T slots)
    # through the store's public constructor, before the first ingest:
    # the default growth doubles a 278,000-row store to 524,288 rows and
    # its 720 slots to 1,024 (34 GB of host arrays for 1M series, not 13)
    for s in keep:
        sh = ms.setup("prometheus", s)
        sh.stores["prom-counter"] = DenseSeriesStore(
            sh.schemas["prom-counter"], initial_series=int(per_shard[s]),
            initial_time=T)
    for keys, to, hole, rng in sets:
        mesh_ingest(ms, orc, keys, to, hole, rng, keep, ts_row, wends, dev,
                    oracles)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    log(f"mesh: built {num_series} + {min(ragged, num_series)} ragged "
        f"series over {MESH_SHARDS} shards (spread {MESH_SPREAD}; series a "
        f"shard {per_shard.tolist()}, kept {keep}) in {sec:.1f} s (keys and "
        f"routing {route_s:.1f} s); host RSS {rss_now() / 2.0 ** 30:.2f} GiB")
    return ms, mapper, orc, wends, sec


def mesh_ingest(ms, orc, keys, to, hole, rng, keep, ts_row, wends, dev,
                oracles):
    """One metric of mesh_store, slab by slab: each slab's counters into
    the kept shards through ingest_columns, and into the oracles 16,384
    rows at a time (the over_time oracle gathers [rows, W, 30] f64; the
    card is shared with the script's other processes)."""
    import torch
    for i0 in range(0, len(keys), SLAB):
        n = min(SLAB, len(keys) - i0)
        vals = make_counter_slab(rng, n, hole)
        slab_to = to[i0:i0 + n]
        for s in keep:
            rows = np.flatnonzero(slab_to == s)
            if len(rows):
                ms.get_shard("prometheus", s).ingest_columns(
                    "prom-counter", [keys[i0 + r] for r in rows],
                    np.broadcast_to(ts_row, (len(rows), T)),
                    {"count": vals[rows]})
        for j in range(0, n, 16_384) if oracles else ():
            v = torch.from_numpy(vals[j:j + 16_384]).to(dev)
            idx = torch.arange(i0 + j, i0 + j + len(v), device=dev)
            rates = oracle_rates_t(v, ts_row, wends)["rate"]
            if hole:
                orc["ragged"].add(rates, idx % NUM_NS)
                continue
            orc["rate"].add(rates, idx % NUM_NS)
            orc["rate_dc"].add(rates, idx % 2)
            if "over_time" in oracles:
                ot = oracle_over_time_t(v, ts_row, wends)
                orc["sum_over_time"].add(ot["sum"], idx % NUM_NS)
                orc["last_over_time"].add(ot["last"], idx % NUM_NS)


def oracle_of(orc, op):
    """An oracle's [G, W] answer for a panel's aggregate."""
    if op == "count":
        c = orc.cnt.cpu().numpy()
        return np.where(c > 0, c, np.nan)
    return orc.result(op)


def by_group(vals, labels, key, groups):
    """A mesh answer [G, W] in the oracle's row order: App-g -> row g,
    DCd -> row d."""
    check(len(labels) == groups,
          f"{len(labels)} groups by {key}, expected {groups}")
    out = np.full((groups, vals.shape[1]), np.nan)
    for i, d in enumerate(labels):
        v = d[key]
        out[int(v.split("-")[1]) if key == "_ns_" else int(v[2:])] = vals[i]
    return out


def run_mesh_phase(num_series, seed, warm, dev):
    """mesh-1M: the port's MeshExecutor at full width over mesh_store's
    4-shard memstore, on a 4 x 1 and a 4 x 2 mesh whose slots all name
    this card (make_mesh(4, n, devices=[dev] * 4n); the 4 x 2 mesh splits
    the 110 windows over two time slots), one pack serving both.  The
    rate pack (its seconds split: the store's row gather, the host f64
    reset correction and rebase, pack_shards, the upload); on each mesh
    sum by (_ns_) (rate(...[5m])) cold and `warm` times warm
    (bit-identical, p50), avg and count (K1 once a slot a panel; dense
    count is host math), max (the general mesh path, no kernel), the
    in-process merge bit-identical to the host merge (its ms); on the
    4 x 1 mesh run_agg_batch of four rate panels (one launch a slot,
    equal to the panels alone) and run_binop_agg sum / count; then
    sum_over_time (K5) and last_over_time (K4) over one pack of the
    values as stored, and the ragged metric's rate (K3), on both meshes.
    Every panel
    against its f64 oracle: rtol 2e-4 / atol 1e-3, the ragged 5e-4 /
    1e-4.  Last, the port's QueryEngine over the same memstore answers
    the rate panel within MESH_ENGINE_TOL of the mesh, one launch a
    shard.  -> its launches."""
    import torch
    from filodb_tpu_torch.core.blockstore import DenseSeriesStore
    from filodb_tpu_torch.core.index import Equals
    from filodb_tpu_torch.ops import counter as counter_ops
    from filodb_tpu_torch.ops import kernels
    from filodb_tpu_torch.parallel import mesh as pmesh
    from filodb_tpu_torch.parallel.shardmapper import SpreadProvider
    from filodb_tpu_torch.query.engine import QueryEngine
    from filodb_tpu_torch.query.execbase import release_mirror_caches
    from filodb_tpu_torch.utils.counters import counters
    n0 = dict(kernels.LAUNCHES)
    ms, mapper, orc, wends, _ = mesh_store(num_series, seed, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t_lo, t_hi = int(wends[0]) - RANGE_MS, int(wends[-1])
    total = [Equals("_metric_", "request_total")]
    k1, k3, k4, k5 = ("fused_rate_dense", "fused_rate_ragged",
                      "fused_last_dense", "fused_over_time_dense")
    exs = {f"4x{n}": pmesh.MeshExecutor(
        ms, "prometheus", pmesh.make_mesh(4, n, devices=[dev] * (4 * n)))
        for n in (1, 2)}
    slots = {"4x1": 4, "4x2": 8}
    summary = {}

    def pack(ex, flt, fn, what):
        spent = {k: [0.0] for k in ("gather", "correct", "pack", "upload")}
        with timed_method(DenseSeriesStore, "gather_rows", spent["gather"]), \
                timed_method(counter_ops, "rebase_values", spent["correct"]), \
                timed_method(pmesh, "pack_shards", spent["pack"]), \
                timed_method(pmesh, "device_put_packed", spent["upload"]):
            t = time.perf_counter()
            pk = ex.lookup_and_pack(flt, t_lo, t_hi, by=("_ns_",),
                                    fn_name=fn)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t
        s = {k: v[0] for k, v in spent.items()}
        nbytes = sum(a.nbytes for a in (pk.ts_off, pk.values, pk.group_ids,
                                        pk.vbase))
        log(f"mesh-1M {what}: pack {sec:.2f} s; thread-seconds over "
            f"{pmesh.PACK_WORKERS} workers: row gather {s['gather']:.2f}, host "
            f"f64 correction and rebase {s['correct']:.2f}, pack_shards "
            f"{s['pack']:.2f}, upload {s['upload']:.2f}; {nbytes} B on the "
            f"card; host RSS now {rss_now() / 2.0 ** 30:.2f} GiB")
        summary.setdefault("pack_s", {})[what] = dict(total=sec, **s)
        return pk

    def panel(mk, pk, fn, op, kernel, oracle, tol, what, key="_ns_",
              groups=NUM_NS):
        ex = exs[mk]
        l0 = dict(kernels.LAUNCHES)
        t = time.perf_counter()
        out, labels = ex.run_agg(pk, wends, range_ms=RANGE_MS, fn_name=fn,
                                 agg_op=op)
        sec = time.perf_counter() - t
        got = launched(l0)
        if kernel is None:
            check(not got, f"mesh-1M {mk} {what}: launched {got}, expected "
                  f"no kernel")
        else:
            check(got == {kernel: slots[mk]},
                  f"mesh-1M {mk} {what}: launched {got}, expected "
                  f"{kernel} once a slot ({slots[mk]})")
        err = check_close(by_group(out, labels, key, groups),
                          oracle_of(orc[oracle], op), *tol,
                          f"mesh-1M {mk} {what}")
        log(f"mesh-1M {mk} {what}: {sec * 1e3:.1f} ms, launches {got}, max "
            f"abs/rel err {err[0]:.3g} / {err[1]:.3g}")
        return out, labels

    def run_binop(mk, ex):
        l0 = dict(kernels.LAUNCHES)
        t = time.perf_counter()
        ratio, rl = ex.run_binop_agg(total, total, t_lo, t_hi, wends,
                                     range_ms=RANGE_MS, fn_name="rate",
                                     op="/", agg_op_l="sum",
                                     agg_op_r="count", by=("_ns_",))
        sec = time.perf_counter() - t
        check(launched(l0) == {k1: slots[mk]},
              f"mesh-1M {mk} binop: launched {launched(l0)}")
        err = check_close(by_group(ratio, rl, "_ns_", NUM_NS),
                          oracle_of(orc["rate"], "avg"), *KERNEL_TOL,
                          f"mesh-1M {mk} sum / count")
        log(f"mesh-1M {mk} run_binop_agg sum(rate) / count(rate): "
            f"{sec * 1e3:.1f} ms, K1 {slots[mk]}, max abs/rel err "
            f"{err[0]:.3g} / {err[1]:.3g}")

    # one pack serves both meshes: every slot names this card, so the 4 x
    # 1 executor's placed blocks are the 4 x 2 mesh's too
    t = time.perf_counter()
    pk = pack(exs["4x1"], total, "rate", "rate")
    pack_s = time.perf_counter() - t
    t = time.perf_counter()
    check(exs["4x1"].lookup_and_pack(total, t_lo, t_hi, by=("_ns_",),
                                     fn_name="rate") is pk,
          "mesh-1M: the repeat lookup repacked")
    hit_ms = 1e3 * (time.perf_counter() - t)
    for mk in ("4x1", "4x2"):
        ex = exs[mk]
        t = time.perf_counter()
        captured = []
        orig_merge = pmesh.merge_device_partials

        def capture(parts, mesh, comb="sum", collective=None):
            captured.append((parts, mesh, comb))
            return orig_merge(parts, mesh, comb, collective)
        pmesh.merge_device_partials = capture
        try:
            sums, labels = panel(mk, pk, "rate", "sum", k1, "rate",
                                 KERNEL_TOL, "sum by (_ns_) (rate)")
        finally:
            pmesh.merge_device_partials = orig_merge
        cold = time.perf_counter() - t + (pack_s if mk == "4x1" else 0.0)
        times = []
        for _ in range(warm):
            t = time.perf_counter()
            out, _ = ex.run_agg(pk, wends, range_ms=RANGE_MS,
                                fn_name="rate", agg_op="sum")
            times.append(time.perf_counter() - t)
            check(out.tobytes() == sums.tobytes(),
                  f"mesh-1M {mk}: a warm answer differs in some bit")
        parts, mesh, comb = captured[0]
        host = pmesh.merge_device_partials(parts, mesh, comb,
                                           collective=False)
        t = time.perf_counter()
        coll = pmesh.merge_device_partials(parts, mesh, comb,
                                           collective=True)
        merge_ms = 1e3 * (time.perf_counter() - t)
        check(coll.tobytes() == host.tobytes(),
              f"mesh-1M {mk}: the in-process merge and the host merge differ")
        log(f"mesh-1M {mk} sum by (_ns_) (rate): cold "
            f"{'(the pack included) ' if mk == '4x1' else ''}{cold:.2f} s, "
            f"warm p50 {1e3 * np.median(times):.2f} ms p99 "
            f"{1e3 * np.percentile(times, 99):.2f} ms over {warm} (the pack "
            f"cache's hit {hit_ms:.2f} ms besides); "
            f"K1 {slots[mk]} a panel; merge of {len(parts)} partials "
            f"{parts[(0, 0)].shape} on the card {merge_ms:.3f} ms, "
            f"bit-identical to the host merge")
        summary[mk] = dict(cold_s=cold, warm_p50_ms=1e3 * np.median(times),
                           merge_ms=merge_ms, pack_hit_ms=hit_ms,
                           peak_gib=torch.cuda.max_memory_allocated(dev)
                           / 2.0 ** 30)
        avg, _ = panel(mk, pk, "rate", "avg", k1, "rate", KERNEL_TOL,
                       "avg by (_ns_) (rate)")
        panel(mk, pk, "rate", "count", None, "rate", KERNEL_TOL,
              "count by (_ns_) (rate) (host math)")
        panel(mk, pk, "rate", "max", None, "rate", KERNEL_TOL,
              "max by (_ns_) (rate) (general path)")
        if mk == "4x2":
            # run_agg_batch and run_binop_agg look their pack up through
            # the executor: the 4 x 2 one would pack the 1M series again
            # (another 6.7 GB on the card) and group them again in Python
            continue
        l0 = dict(kernels.LAUNCHES)
        b0 = counters.get("mesh_fused_batch_panels")
        t = time.perf_counter()
        batch = ex.run_agg_batch(total, t_lo, t_hi, wends, range_ms=RANGE_MS,
                                 fn_name="rate", panels=MESH_BATCH)
        sec = time.perf_counter() - t
        check(launched(l0) == {k1: slots[mk]},
              f"mesh-1M {mk} batch: launched {launched(l0)}")
        check(counters.get("mesh_fused_batch_panels") - b0 == 3,
              f"mesh-1M {mk} batch: the panels did not merge")
        for (by, _, op), (vals, labs), alone in zip(
                MESH_BATCH, batch, (sums, avg, None, None)):
            key = by[0]
            check_close(by_group(vals, labs, key, NUM_NS if key == "_ns_"
                                 else 2),
                        oracle_of(orc["rate" if key == "_ns_" else "rate_dc"],
                                  op), *KERNEL_TOL,
                        f"mesh-1M {mk} batch {op} by {key}")
            if alone is not None:
                check(np.allclose(vals, alone, rtol=1e-6, atol=1e-9,
                                  equal_nan=True),
                      f"mesh-1M {mk} batch {op} by {key}: differs from the "
                      f"panel alone")
        log(f"mesh-1M {mk} run_agg_batch of {len(MESH_BATCH)} rate panels: "
            f"{sec * 1e3:.1f} ms, K1 {slots[mk]} (one launch a slot), equal "
            f"to the panels alone")
        run_binop(mk, ex)
        del parts, captured
    # each pack's card memory goes with it: the executor's cache would
    # keep it
    del pk
    exs["4x1"]._pack_cache.clear()
    # one pack each, run on both meshes; sum_over_time's pack (values not
    # reset-corrected) also feeds last_over_time, which reads the same
    for fns, kernels_of, oracle, tol, flt, what in (
            (("sum_over_time", "last_over_time"), (k5, k4), None,
             KERNEL_TOL, total, "uncorrected"),
            (("rate",), (k3,), "ragged", (5e-4, 1e-4),
             [Equals("_metric_", MESH_RAGGED_METRIC)], "ragged")):
        pk = pack(exs["4x1"], flt, fns[0], what)
        check(pk.dense is (what != "ragged"),
              f"mesh-1M {what}: dense {pk.dense}")
        for fn, kernel in zip(fns, kernels_of):
            for mk in ("4x1", "4x2"):
                panel(mk, pk, fn, "sum", kernel, oracle or fn, tol,
                      f"sum by (_ns_) ({fn}{', ragged' if oracle else ''})")
        del pk
        exs["4x1"]._pack_cache.clear()
    free_device_memory()
    eng = QueryEngine("prometheus", ms, mapper,
                      SpreadProvider(default_spread=MESH_SPREAD), device=dev)
    l0 = dict(kernels.LAUNCHES)
    t = time.perf_counter()
    res = eng.query_range("sum by (_ns_) (rate(request_total[5m]))",
                          int(wends[0]) // 1000, 60, int(wends[-1]) // 1000,
                          scan_params())
    sec = time.perf_counter() - t
    check(res.error is None, f"mesh-1M engine: {res.error}")
    # the ragged metric shares the counter column, whose mirror is then
    # not certified hole-free: the engine's leaf runs K3 over the rows
    check(launched(l0) in ({k1: MESH_SHARDS}, {k3: MESH_SHARDS}),
          f"mesh-1M engine: launched {launched(l0)}")
    ns = {k.labels_dict["_ns_"]: np.asarray(v, np.float64)
          for k, _, v in res.series()}
    eng_vals = np.stack([ns[d["_ns_"]] for d in labels])
    err = check_close(eng_vals, sums, *MESH_ENGINE_TOL,
                      "mesh-1M mesh against the engine")
    log(f"mesh-1M the engine's sum by (_ns_) (rate) over the same 4-shard "
        f"store: cold {sec:.2f} s, launches {launched(l0)}; the mesh within "
        f"rtol {MESH_ENGINE_TOL[0]} (max abs/rel {err[0]:.3g} / "
        f"{err[1]:.3g})")
    for sh in ms.shards_for("prometheus"):
        for st in sh.stores.values():
            m = getattr(st, "device_mirror", None)
            if m is not None:
                m.release()
                release_mirror_caches(m.serial)
    del eng, res, ms, exs
    free_device_memory()
    log(f"mesh-1M: {json.dumps(summary)}; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2.0 ** 30:.2f} GiB; host "
        f"RSS now {rss_now() / 2.0 ** 30:.2f} GiB, peak "
        f"{host_rss() / 2.0 ** 30:.2f} GiB")
    return launched(n0)


def mesh_worker(args) -> int:
    """A mesh-2proc-65k worker: rank r of 2 keeps shards 2r and 2r + 1 of
    mesh_store's 4 (MESH_2PROC_SERIES counters, the same seed), joins the
    process group over localhost (multihost.initialize; gloo where the
    ranks share this card), and answers sum by (_ns_) (rate(...[5m]))
    over the 4 x 1 global mesh (its two slots on its card) against the
    f64 oracle (rtol 2e-4 / atol 1e-3) and against a one-process 4 x 1
    mesh over a store of all four shards (within 1e-12 relative: the
    merges differ only in association); writes its result to the file
    args.mesh_worker[2]."""
    import torch
    from filodb_tpu_torch.core.index import Equals
    from filodb_tpu_torch.ops import kernels
    from filodb_tpu_torch.parallel import mesh as pmesh
    from filodb_tpu_torch.parallel import multihost
    rank, port, out = int(args.mesh_worker[0]), int(args.mesh_worker[1]), \
        args.mesh_worker[2]
    exit_when_orphaned()
    warnings.simplefilter("ignore", RuntimeWarning)
    for name in kernels.SOURCES:
        check(kernels.library_path(name).exists(),
              f"mesh worker {rank}: {name} is not built")
        kernels.library(name)
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    backend = multihost.initialize(f"127.0.0.1:{port}", num_processes=2,
                                   process_id=rank, device=dev,
                                   timeout_s=MESH_2PROC_TIMEOUT_S)
    join_s = time.perf_counter() - t0
    mine = [2 * rank, 2 * rank + 1]
    ms, _, orc, wends, build_s = mesh_store(MESH_2PROC_SERIES, args.seed,
                                            dev, ragged=0, shards=mine,
                                            oracles=("rate",))
    full, _, _, _, _ = mesh_store(MESH_2PROC_SERIES, args.seed, dev,
                                  ragged=0, oracles=())
    total = [Equals("_metric_", "request_total")]
    t_lo, t_hi = int(wends[0]) - RANGE_MS, int(wends[-1])

    def answer(ex):
        n0 = dict(kernels.LAUNCHES)
        t = time.perf_counter()
        pk = ex.lookup_and_pack(total, t_lo, t_hi, by=("_ns_",),
                                fn_name="rate")
        vals, labels = ex.run_agg(pk, wends, range_ms=RANGE_MS,
                                  fn_name="rate", agg_op="sum")
        return (by_group(vals, labels, "_ns_", NUM_NS),
                time.perf_counter() - t, launched(n0))
    mesh = multihost.global_mesh(n_shard=4, n_time=1, devices=[dev, dev])
    check(mesh.local_shard_rows() == mine,
          f"mesh worker {rank}: rows {mesh.local_shard_rows()}")
    got, sec, l_global = answer(pmesh.MeshExecutor(ms, "prometheus", mesh))
    one, _, l_one = answer(pmesh.MeshExecutor(
        full, "prometheus", pmesh.make_mesh(4, 1, devices=[dev] * 4)))
    check(l_global == {"fused_rate_dense": 2},
          f"mesh worker {rank}: launched {l_global} on its two slots")
    err = check_close(got, oracle_of(orc["rate"], "sum"), *KERNEL_TOL,
                      f"mesh-2proc-65k rank {rank} against the oracle")
    check((np.isnan(got) == np.isnan(one)).all(),
          f"mesh-2proc-65k rank {rank}: NaN pattern differs from one process")
    ok = ~np.isnan(one)
    rel = float((np.abs(got[ok] - one[ok])
                 / np.maximum(np.abs(one[ok]), 1e-300)).max())
    check(rel <= 1e-12, f"mesh-2proc-65k rank {rank}: {rel} relative from "
          f"the one-process mesh")
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump({"rank": rank, "backend": backend, "join_s": join_s,
                   "build_s": build_s, "panel_s": sec,
                   "oracle_err": err, "rel_to_one_process": rel,
                   "launches": {k: l_global.get(k, 0) + l_one.get(k, 0)
                                for k in set(l_global) | set(l_one)}}, f)
    return 0


def run_mesh_2proc_phase(seed, dev):
    """mesh-2proc-65k: two mesh_worker processes on the card join one
    process group over localhost (gloo: they share the card), each with
    2 of the 4 shards; the run fails if either fails, exits other than
    0, or outlives MESH_2PROC_TIMEOUT_S -> their launches."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tmp = tempfile.mkdtemp(prefix="mesh-2proc-")
    outs = [os.path.join(tmp, f"worker-{r}.json") for r in (0, 1)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-worker", str(r),
         str(port), outs[r], "--seed", str(seed)], stdin=subprocess.PIPE)
        for r in (0, 1)]
    rcs = []
    try:
        for p in procs:
            left = MESH_2PROC_TIMEOUT_S - (time.perf_counter() - t0)
            try:
                rcs.append(p.wait(timeout=max(left, 1.0)))
            except subprocess.TimeoutExpired:
                rcs.append(None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            p.stdin.close()
    check(rcs == [0, 0], f"mesh-2proc-65k: workers ended with {rcs} "
          f"(None: killed at the {MESH_2PROC_TIMEOUT_S} s limit)")
    res = []
    for o in outs:
        with open(o) as f:
            res.append(json.load(f))
    shutil.rmtree(tmp, ignore_errors=True)
    launches = {}
    for r in res:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    log(f"mesh-2proc-65k: {time.perf_counter() - t0:.1f} s, backend "
        f"{res[0]['backend']}; " + "; ".join(
            f"rank {r['rank']}: joined {r['join_s']:.2f} s, built "
            f"{r['build_s']:.1f} s, panel {r['panel_s']:.2f} s, max abs/rel "
            f"err to the oracle {r['oracle_err'][0]:.3g} / "
            f"{r['oracle_err'][1]:.3g}, {r['rel_to_one_process']:.3g} "
            f"relative to one process" for r in res)
        + f"; launches {launches}")
    return launches


def run_multicard_checks(seed, dev):
    """Where this machine has two cards or more: (1) the engine over a
    4-shard store with sharded mirrors (store.device_mirror_sharded, the
    default) places them over the cards through the MirrorPlacer; (2) it
    answers serve-1M's 8 dashboard panels with the bits of the engine
    with every mirror on one card; (3) a 4 x 1 mesh over distinct cards
    gives the bits of the one-card mesh.  On one card it prints that they
    were not run, and why -> launches."""
    import torch
    from filodb_tpu_torch.config import settings
    from filodb_tpu_torch.core.index import Equals
    from filodb_tpu_torch.ops import kernels
    from filodb_tpu_torch.parallel import mesh as pmesh
    from filodb_tpu_torch.parallel.shardmapper import SpreadProvider
    from filodb_tpu_torch.query.engine import QueryEngine
    n = torch.cuda.device_count()
    if n < 2:
        log(f"multi-card checks: NOT RUN: this machine has {n} card "
            f"(torch.cuda.device_count() == {n}); the placer across cards, "
            f"the engine with sharded mirrors against one card and a mesh "
            f"over distinct cards need two or more")
        return {}
    n0 = dict(kernels.LAUNCHES)
    ms, mapper, _, wends, _ = mesh_store(MESH_2PROC_SERIES, seed, dev,
                                         ragged=0, oracles=())
    s0, s1 = int(wends[0]) // 1000, int(wends[-1]) // 1000
    store_cfg = settings().store
    was = store_cfg.device_mirror_sharded

    def answers():
        eng = QueryEngine("prometheus", ms, mapper,
                          SpreadProvider(default_spread=MESH_SPREAD),
                          device=dev)
        out = {}
        for q in DASHBOARD:
            res = eng.query_range(q, s0, 60, s1, scan_params())
            check(res.error is None, f"multi-card {q}: {res.error}")
            out[q] = {k.labels: np.asarray(v).tobytes()
                      for k, _, v in res.series()}
        return out

    def drop_mirrors():
        devs = set()
        for sh in ms.shards_for("prometheus"):
            for st in sh.stores.values():
                m = getattr(st, "device_mirror", None)
                if m is not None:
                    devs.add(str(m.device))
                    m.release()
                    st.device_mirror = None
        free_device_memory()
        return devs
    try:
        store_cfg.device_mirror_sharded = False
        flat = answers()
        flat_devs = drop_mirrors()
        store_cfg.device_mirror_sharded = True
        sharded = answers()
        placed = drop_mirrors()
    finally:
        store_cfg.device_mirror_sharded = was
    check(len(placed) >= 2, f"multi-card: mirrors on {placed} only")
    check(sharded == flat, "multi-card: the engine with sharded mirrors "
          "differs from the one-card engine in some bit")
    total = [Equals("_metric_", "request_total")]
    t_lo, t_hi = int(wends[0]) - RANGE_MS, int(wends[-1])
    got = {}
    for what, devs in (("one card", [dev] * 4),
                       ("distinct cards", [torch.device("cuda", i % n)
                                           for i in range(4)])):
        ex = pmesh.MeshExecutor(ms, "prometheus",
                                pmesh.make_mesh(4, 1, devices=devs))
        pk = ex.lookup_and_pack(total, t_lo, t_hi, by=("_ns_",),
                                fn_name="rate")
        got[what] = ex.run_agg(pk, wends, range_ms=RANGE_MS, fn_name="rate",
                               agg_op="sum")[0].tobytes()
    check(got["one card"] == got["distinct cards"],
          "multi-card: the mesh over distinct cards differs from one card")
    log(f"multi-card checks on {n} cards: mirrors placed on "
        f"{sorted(placed)} (one-card engine: {sorted(flat_devs)}); the 8 "
        f"dashboard panels bit-identical; the mesh over distinct cards "
        f"bit-identical to the one-card mesh")
    return launched(n0)


# ------------------------------------------ cluster-1M and cluster-e2e-4k

CLUSTER_SHARDS = 4
CLUSTER_QUERY = "sum by (_ns_) (rate(request_total[5m]))"
CLUSTER_QUANTILE = "quantile by (_ns_) (0.9, rate(request_total[5m]))"
E2E_SERIES, E2E_T, E2E_NS = 4096, 90, 64      # cluster-e2e-4k's counters
REF_FORM_NODE = "A"     # cluster-e2e-4k's node started without --device


def build_cluster(num_series, seed, dev):
    """make_fanout_cluster's two data nodes "A" and "B" over CLUSTER_SHARDS
    shards, each node a memstore on the card behind its NodeQueryServer
    on loopback TCP, fed dense-1M's counters (the same seed, slab by
    slab) through ingest_columns, each key routed by the shard mapper
    and spread -> (cluster, per-series f64 rates [n, W] on the card, the
    series' shards, wends, seconds)."""
    import torch
    from filodb_tpu_torch.core.partkey import PartKey
    from filodb_tpu_torch.parallel.shardmapper import SpreadProvider
    from filodb_tpu_torch.parallel.testcluster import make_fanout_cluster
    t0 = time.perf_counter()
    c = make_fanout_cluster((), num_shards=CLUSTER_SHARDS, nodes=("A", "B"),
                            device=dev)
    spread = SpreadProvider(default_spread=1)
    rng = np.random.default_rng(seed)
    ts_row = START_MS + np.arange(T, dtype=np.int64) * STEP_MS
    wends = np.arange(START_MS + 600_000, int(ts_row[-1]) + 1, 60_000)
    rates = torch.empty((num_series, len(wends)), dtype=torch.float64,
                        device=dev)
    shard_of = np.empty(num_series, np.int64)
    route_s = ingest_s = 0.0
    for i0 in range(0, num_series, SLAB):
        n = min(SLAB, num_series - i0)
        vals = make_counter_slab(rng, n, 0.0)
        keys = [PartKey.make("request_total", {
            "_ws_": "demo", "_ns_": f"App-{i % NUM_NS}",
            "instance": f"Instance-{i}", "dc": f"DC{i % 2}"})
            for i in range(i0, i0 + n)]
        t1 = time.perf_counter()
        shards = np.asarray([c.mapper.ingestion_shard(
            pk.shard_key_hash(), pk.partition_hash(),
            spread.spread_for(pk.shard_key())) for pk in keys])
        shard_of[i0:i0 + n] = shards
        t2 = time.perf_counter()
        for s in range(CLUSTER_SHARDS):
            rows = np.flatnonzero(shards == s)
            if len(rows):
                c.stores[c.owner[s]].get_shard("prometheus", s).ingest_columns(
                    "prom-counter", [keys[r] for r in rows],
                    np.broadcast_to(ts_row, (len(rows), T)),
                    {"count": vals[rows]})
        t3 = time.perf_counter()
        route_s += t2 - t1
        ingest_s += t3 - t2
        rates[i0:i0 + n] = oracle_rates_t(torch.from_numpy(vals).to(dev),
                                          ts_row, wends)["rate"]
    torch.cuda.synchronize()
    log(f"cluster-1M: built {num_series} series over {CLUSTER_SHARDS} "
        f"shards on nodes {sorted(set(c.owner.values()))} (owner "
        f"{c.owner}; series a shard "
        f"{np.bincount(shard_of, minlength=CLUSTER_SHARDS).tolist()}) in "
        f"{time.perf_counter() - t0:.1f} s (routing {route_s:.1f} s, "
        f"ingest {ingest_s:.1f} s)")
    return c, rates, shard_of, wends, time.perf_counter() - t0


def group_sums(rates, gids, rows=None):
    """The f64 oracle of sum by (_ns_) over `rows` (all when None)."""
    import torch
    acc = GroupOracle(NUM_NS, rates.shape[1])
    if rows is None:
        acc.add(rates, gids)
    else:
        r = torch.from_numpy(rows).to(rates.device)
        acc.add(rates[r], gids[r])
    return acc.result("sum")


def wire_split():
    """A context that times the wire's parts for every query in it, both
    sides summed (the nodes run in this process): serialize (dumps),
    frames (stream split, CRC framing and checks), socket (frame send
    and receive, each side's wait for the other included: the
    coordinator's receive of a reply waits for the node's execution),
    assemble (loads, the stream assembler or fold) -> (the context, the
    seconds dict it fills)."""
    from filodb_tpu_torch.parallel import serialize, streams
    from filodb_tpu_torch.parallel import transport as tr
    spent = {k: [0.0] for k in ("serialize", "frames", "socket",
                                "assemble")}
    stack = contextlib.ExitStack()
    for obj, name, part in (
            (serialize, "dumps", "serialize"),
            (streams, "split_for_stream", "frames"),
            (tr, "_pack_stream_frame", "frames"),
            (tr, "_unpack_stream_frame", "frames"),
            (tr, "_send_frame", "socket"),
            (tr, "_recv_frame", "socket"),
            (serialize, "loads", "assemble"),
            (streams.StreamAssembler, "add", "assemble"),
            (streams.StreamAssembler, "finish", "assemble"),
            (streams.StreamFold, "add", "assemble")):
        stack.enter_context(timed_method(obj, name, spent[part]))
    return stack, spent


def run_cluster_phase(num_series, seed, warm, dev):
    """cluster-1M: the wire and the cluster at full width.  build_cluster's
    two nodes over 4 shards, the coordinator a QueryEngine over an empty
    memstore on the card with RemoteNodeDispatchers.  (1) the panel
    CLUSTER_QUERY over 110 one-minute steps with node-level pushdown on:
    within rtol 2e-4 / atol 1e-3 of the f64 oracle, pushdown_pushed 2,
    K1 once a shard (4 a panel) on the nodes, cold once and `warm` times
    warm (bit-identical), then pushdown off, the same bits; (2) the
    ship-everything panel (ship_raw_series: [S, W] blocks streamed to
    the coordinator, which maps and reduces them), within tolerance;
    (3) CLUSTER_QUANTILE pushed and ship-everything, the same bits,
    within rtol 0.05 of the exact quantile of the f64 rates; (4) a kill
    of the ship-everything query once its stream flows: the structured
    query_canceled; (5) B's server stopped: without partial results the
    typed shard_unavailable, with them a result flagged partial whose
    groups equal the f64 oracle of A's shards.  Wire bytes, frames and
    the wire's split (wire_split) printed -> (launches, rows)."""
    import torch
    from filodb_tpu_torch.ops import kernels
    from filodb_tpu_torch.parallel import transport as tr
    from filodb_tpu_torch.parallel.breaker import breakers
    from filodb_tpu_torch.query.activequeries import active_queries
    kernels.reset_launch_counts()
    c, rates, shard_of, wends, build_s = build_cluster(num_series, seed, dev)
    eng = c.engine
    start_s, end_s = int(wends[0]) // 1000, int(wends[-1]) // 1000
    gids = torch.from_numpy(np.arange(num_series) % NUM_NS).to(dev)
    want = group_sums(rates, gids)
    steps = {"build": build_s}

    def panel(q, what, **kw):
        n0 = dict(kernels.LAUNCHES)
        t = time.perf_counter()
        res = eng.query_range(q, start_s, 60, end_s, scan_params(**kw))
        took = time.perf_counter() - t
        check(res.error is None, f"cluster-1M {what}: {res.error}")
        return res, took, launched(n0)

    def bits(res):
        return {k.labels: np.asarray(v).tobytes()
                for k, _, v in res.series()}
    try:
        stack, split = wire_split()
        ledger0 = k1_ledger(dev)
        with stack:
            on, cold_s, k = panel(CLUSTER_QUERY, "pushed cold")
        ledger_k1 = k1_ledger(dev) - ledger0
        err = compare(on, want, 2e-4, 1e-3, "cluster-1M pushed")[1]
        check(on.stats.pushdown_pushed == 2,
              f"cluster-1M: pushdown_pushed {on.stats.pushdown_pushed}")
        check(k.get("fused_rate_dense", 0) == CLUSTER_SHARDS
              and ledger_k1 == CLUSTER_SHARDS,
              f"cluster-1M: the pushed panel launched {k}, the ledger "
              f"booked {ledger_k1} K1 dispatches")
        pushed_split = {p: v[0] for p, v in split.items()}
        warm_s = []
        for _ in range(warm):
            again, took, k = panel(CLUSTER_QUERY, "pushed warm")
            check(bits(again) == bits(on),
                  "cluster-1M: a warm pushed panel differs in its bits")
            check(k.get("fused_rate_dense", 0) == CLUSTER_SHARDS,
                  f"cluster-1M: a warm pushed panel launched {k}")
            warm_s.append(took)
        off, off_s, _ = panel(CLUSTER_QUERY, "pushdown off",
                              aggregation_pushdown=False)
        check(bits(off) == bits(on),
              "cluster-1M: pushdown off differs in its bits from on")
        steps.update(pushed_cold=cold_s, pushed_warm_p50=float(
            np.median(warm_s)), pushdown_off=off_s)
        log(f"cluster-1M pushed: cold {cold_s:.3f} s, warm p50 "
            f"{np.median(warm_s):.4f} s over {warm} (min {min(warm_s):.4f}, "
            f"max {max(warm_s):.4f}); wire bytes {on.stats.wire_bytes} "
            f"(pushdown off: {off.stats.wire_bytes}, {off_s:.3f} s, the same "
            f"bits); K1 launches a panel {CLUSTER_SHARDS} (the ledger's "
            f"dispatches {ledger_k1}); oracle max abs "
            f"err {err}; wire split of the cold panel "
            + json.dumps({p: round(v, 4) for p, v in pushed_split.items()})
            + f"; stats cpu {on.stats.cpu_seconds:.4f} device "
            f"{on.stats.device_seconds:.4f} transfer "
            f"{on.stats.transfer_s:.4f} s")
        stack, split = wire_split()
        with stack:
            raw, raw_s, _ = panel(CLUSTER_QUERY, "ship-everything",
                                  ship_raw_series=True)
        raw_err = compare(raw, want, 2e-4, 1e-3,
                          "cluster-1M ship-everything")[1]
        check(raw.stats.streamed_frames > 2,
              f"cluster-1M: ship-everything streamed "
              f"{raw.stats.streamed_frames} frames")
        steps["ship_everything"] = raw_s
        log(f"cluster-1M ship-everything: {raw_s:.2f} s, wire bytes "
            f"{raw.stats.wire_bytes} ({raw.stats.wire_bytes / max(on.stats.wire_bytes, 1):.1f}x "
            f"the pushed panel's), streamed frames "
            f"{raw.stats.streamed_frames}, oracle max abs err {raw_err}, "
            f"the same bits as pushed: {bits(raw) == bits(on)}; wire split "
            + json.dumps({p: round(v[0], 3) for p, v in split.items()}))
        # quantile: the sketch, pushed and shipped whole
        qp, qp_s, _ = panel(CLUSTER_QUANTILE, "quantile pushed")
        qr, qr_s, _ = panel(CLUSTER_QUANTILE, "quantile ship-everything",
                            ship_raw_series=True)
        check(bits(qp) == bits(qr) and qp.num_series == NUM_NS,
              "cluster-1M: quantile pushed and ship-everything differ")
        exact = torch.stack([torch.nanquantile(rates[g::NUM_NS], 0.9, dim=0)
                             for g in range(NUM_NS)]).cpu().numpy()
        q_err = compare(qp, exact, 0.05, 0.0, "cluster-1M quantile")[2]
        steps.update(quantile_pushed=qp_s, quantile_ship_everything=qr_s)
        log(f"cluster-1M quantile: pushed {qp_s:.3f} s, ship-everything "
            f"{qr_s:.2f} s, the same bits; max rel err against the exact "
            f"f64 quantile {q_err:.4f} (bound 0.05); wire bytes "
            f"{qp.stats.wire_bytes} and {qr.stats.wire_bytes}")
        # a kill once the ship-everything stream flows
        flowing = threading.Event()
        real_pack = tr._pack_stream_frame

        def pack(seq, body, last):
            if seq >= 4:
                flowing.set()
            return real_pack(seq, body, last)
        box = {}
        tr._pack_stream_frame = pack
        try:
            th = threading.Thread(target=lambda: box.update(res=eng.query_range(
                CLUSTER_QUERY, start_s, 60, end_s,
                scan_params(ship_raw_series=True))), daemon=True)
            th.start()
            check(flowing.wait(300), "cluster-1M: the stream never flowed")
            qids = {e.query_id for e in active_queries.entries()
                    if e.role == "remote"}
            check(len(qids) == 1, f"cluster-1M: remote entries {qids}")
            t = time.perf_counter()
            active_queries.kill(qids.pop(), reason="admin",
                                detail="chip smoke kill mid-stream")
            th.join(300)
            kill_s = time.perf_counter() - t
        finally:
            tr._pack_stream_frame = real_pack
        err_s = (box.get("res").error or "") if "res" in box else ""
        check(err_s.startswith("query_canceled"),
              f"cluster-1M: the killed query answered {err_s!r}")
        steps["kill_to_cancel"] = kill_s
        log(f"cluster-1M kill mid-stream: query_canceled {kill_s:.3f} s "
            f"after the kill ({err_s[:120]})")
        # B dies
        c.servers["B"].stop()
        t = time.perf_counter()
        dead = eng.query_range(CLUSTER_QUERY, start_s, 60, end_s,
                               scan_params())
        dead_s = time.perf_counter() - t
        check(dead.error is not None
              and dead.error.startswith("shard_unavailable"),
              f"cluster-1M: with B dead the panel answered {dead.error!r}")
        part, part_s, _ = panel(CLUSTER_QUERY, "partial",
                                allow_partial_results=True)
        check(part.partial and part.stats.warnings,
              "cluster-1M: the partial answer is not flagged partial")
        a_rows = np.flatnonzero(np.isin(shard_of, [
            s for s, n in c.owner.items() if n == "A"]))
        a_err = compare(part, group_sums(rates, gids, a_rows), 2e-4, 1e-3,
                        "cluster-1M partial (A's shards)")[1]
        steps.update(dead_error=dead_s, partial=part_s)
        log(f"cluster-1M B dead: shard_unavailable in {dead_s:.3f} s; "
            f"partial in {part_s:.3f} s, flagged, {part.num_series} groups "
            f"within tolerance of the oracle of A's "
            f"{len(a_rows)} series (max abs err {a_err}); warnings "
            f"{part.stats.warnings[:1]}")
        launches = dict(kernels.LAUNCHES)
        log("cluster-1M steps' seconds " + json.dumps(
            {k: round(v, 4) for k, v in steps.items()}))
    finally:
        breakers.reset()
        c.stop()
    return launches, [dict(query=CLUSTER_QUERY, kernel="fused_rate_dense",
                           err=err)]


def e2e_lines(vals, ts_row):
    """Influx lines of the counters [n, t] (field `counter`, so the
    gateway lands them in prom-counter)."""
    out = []
    heads = [f"request_total,_ws_=demo,_ns_=App-{i % E2E_NS},"
             f"instance=Instance-{i} counter=" for i in range(vals.shape[0])]
    for t, col in zip(ts_row.tolist(), vals.T.tolist()):
        tail = f" {t * 1_000_000}"
        out.extend(f"{h}{v!r}{tail}" for h, v in zip(heads, col))
    return out


def run_cluster_e2e_phase(seed, dev):
    """cluster-e2e-4k: the cluster as users deploy it.  A ClusterCoordinator
    (4 shards, two nodes' worth, liveness 2.5 s) and a `python -m
    filodb_tpu_torch.persist.netstore` chunk service; three `python -m
    filodb_tpu_torch.parallel.nodeapp --store-url ...` processes on the
    card (two own the shards, one stands by), REF_FORM_NODE started
    without --device as the reference's scripts start it; E2E_SERIES
    counters x E2E_T samples at 10 s as Influx lines fed to every node's
    control socket (each keeps its shards); CLUSTER_QUERY through a
    coordinator engine on the card over RemoteNodeDispatchers, within
    rtol 2e-4 / atol 1e-3 of the f64 oracle; a flush, SIGKILL of one
    owner, the liveness check and the reassignment to the standby, which
    recovers its index from the netstore and pages chunks on demand; the
    answer after failover equal to the one before (rtol 1e-9).  K1
    launches counted from the nodes' stats.devices as they come back
    over the wire, REF_FORM_NODE's alone under a cuda device -> (launches,
    rows): this process launches nothing."""
    import torch
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.parallel.cluster import (ClusterClient,
                                                   ClusterCoordinator, _rpc)
    from filodb_tpu_torch.parallel.shardmanager import ShardManager
    from filodb_tpu_torch.parallel.shardmapper import (ShardEvent,
                                                       ShardMapper,
                                                       SpreadProvider)
    from filodb_tpu_torch.parallel.transport import RemoteNodeDispatcher
    from filodb_tpu_torch.query.engine import QueryEngine
    from filodb_tpu_torch.query.planner import SingleClusterPlanner
    steps = {}
    rng = np.random.default_rng(seed)
    vals = np.cumsum(rng.exponential(10.0, (E2E_SERIES, E2E_T)), axis=1)
    r = rng.integers(E2E_T // 2, E2E_T, size=E2E_SERIES)
    before = vals[np.arange(E2E_SERIES), r - 1][:, None]
    vals = np.where(np.arange(E2E_T)[None, :] >= r[:, None], vals - before,
                    vals)
    ts_row = START_MS + np.arange(E2E_T, dtype=np.int64) * STEP_MS
    wends = np.arange(START_MS + 300_000, int(ts_row[-1]) + 1, 60_000)
    start_s, end_s = int(wends[0]) // 1000, int(wends[-1]) // 1000
    acc = GroupOracle(E2E_NS, len(wends))
    acc.add(oracle_rates_t(torch.from_numpy(vals).to(dev), ts_row,
                           wends)["rate"],
            torch.from_numpy(np.arange(E2E_SERIES) % E2E_NS).to(dev))
    want = acc.result("sum")
    lines = e2e_lines(vals, ts_row)
    tmp = tempfile.mkdtemp(prefix="cluster-e2e-")
    procs = []
    coord = None

    def spawn(cmd, name):
        t = time.perf_counter()
        err = open(os.path.join(tmp, f"{name}.stderr"), "w")
        p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=err,
                             text=True)
        err.close()
        procs.append(p)
        return p, t

    def ready(p, t, name):
        box = {}
        th = threading.Thread(target=lambda: box.update(
            line=p.stdout.readline()), daemon=True)
        th.start()
        th.join(180)
        if not box.get("line"):
            with open(os.path.join(tmp, f"{name}.stderr")) as f:
                tail = f.read()[-3000:]
            raise SmokeFailure(f"cluster-e2e-4k: {name} did not start: "
                               f"{tail}")
        info = json.loads(box["line"])
        check(info.get("ready"), f"cluster-e2e-4k: {name} said {info}")
        if name in ("A", "B", "C"):
            check(isinstance(info.get("replication_port"), int)
                  and info["replication_port"] > 0,
                  f"cluster-e2e-4k: {name} opened no replication door "
                  f"({info})")
        return info, time.perf_counter() - t

    def state_until(cli, pred, timeout_s, what):
        t_end = time.time() + timeout_s
        while time.time() < t_end:
            st = cli.state()
            if pred(st):
                return st
            time.sleep(0.2)
        raise SmokeFailure(f"cluster-e2e-4k: timed out waiting for {what}: "
                           f"{cli.state()}")

    def query(cli):
        """The rate panel against its oracle, and the stored samples'
        sum by (_ns_) -> (rate answer, its err, seconds, K1 launches,
        device calls, the samples' sum)."""
        mapper, addrs = cli.mapper("prometheus")
        planner = SingleClusterPlanner(
            "prometheus", mapper, SpreadProvider(default_spread=1),
            dispatcher_factory=lambda s: RemoteNodeDispatcher(
                *addrs[mapper.node_for_shard(s)]))
        eng = QueryEngine("prometheus", TimeSeriesMemStore(device=dev),
                          mapper, planner=planner, device=dev)
        t = time.perf_counter()
        res = eng.query_range(CLUSTER_QUERY, start_s, 60, end_s)
        took = time.perf_counter() - t
        got, err = compare(res, want, 2e-4, 1e-3, "cluster-e2e-4k")[:2]
        # device_calls: "device|kernel" -> [seconds, launches]
        k1 = sum(v[1] for key, v in res.stats.device_calls.items()
                 if key.split("|")[-1] in OPS_FUSED)
        raw = eng.query_range("sum by (_ns_) (request_total)", start_s, 60,
                              end_s)
        check(raw.error is None, f"cluster-e2e-4k: {raw.error}")
        return got, err, took, k1, res.stats.device_calls, {
            k.labels: np.asarray(v) for k, _, v in raw.series()}

    def node_k1(cli, node):
        """CLUSTER_QUERY over `node`'s shards alone (the planner's mapper
        has only those active) -> {device: K1 launches} from that node's
        stats.devices as they come back over the wire."""
        mapper, addrs = cli.mapper("prometheus")
        mine = ShardMapper(mapper.num_shards)
        for s in mapper.shards_for_node(node):
            mine.register_node([s], node)
            mine.update_from_event(
                ShardEvent("IngestionStarted", "prometheus", s, node))
        check(mine.active_shards(), f"cluster-e2e-4k: {node} owns no shard")
        planner = SingleClusterPlanner(
            "prometheus", mine, SpreadProvider(default_spread=1),
            dispatcher_factory=lambda s: RemoteNodeDispatcher(*addrs[node]))
        eng = QueryEngine("prometheus", TimeSeriesMemStore(device=dev),
                          mine, planner=planner, device=dev)
        res = eng.query_range(CLUSTER_QUERY, start_s, 60, end_s)
        check(res.error is None, f"cluster-e2e-4k: {node}: {res.error}")
        out = {}
        for key, (_, n) in res.stats.device_calls.items():
            device, kern = key.rsplit("|", 1)
            if kern in OPS_FUSED:
                out[device] = out.get(device, 0) + n
        check(any(d.startswith("cuda") and n > 0 for d, n in out.items()),
              f"cluster-e2e-4k: {node}, started without --device, "
              f"launched no K1 on the card: {res.stats.device_calls}")
        return mine.active_shards(), out

    try:
        t0 = time.perf_counter()
        coord = ClusterCoordinator(ShardManager(reassignment_min_interval_s=0),
                                   liveness_timeout_s=2.5,
                                   check_interval_s=0.3).start()
        coord.setup_dataset("prometheus", CLUSTER_SHARDS, min_num_nodes=2)
        svc, ts = spawn([sys.executable, "-m",
                         "filodb_tpu_torch.persist.netstore", "--root",
                         os.path.join(tmp, "central")], "netstore")
        svc_info, steps["netstore_ready"] = ready(svc, ts, "netstore")
        store_url = f"127.0.0.1:{svc_info['port']}"
        nodes = {}
        for name in ("A", "B", "C"):
            where = [] if name == REF_FORM_NODE else ["--device", "cuda"]
            nodes[name] = spawn(
                [sys.executable, "-m", "filodb_tpu_torch.parallel.nodeapp",
                 "--name", name, "--coordinator",
                 f"127.0.0.1:{coord.address[1]}", "--data-dir",
                 os.path.join(tmp, name), *where, "--store-url",
                 store_url, "--heartbeat-interval", "0.3"], name)
        infos = {}
        for name, (p, t) in nodes.items():
            infos[name], steps[f"boot_to_ready_{name}"] = ready(p, t, name)
        cli = ClusterClient(coord.address)
        st = state_until(cli, lambda s: s["datasets"]["prometheus"][
            "statuses"] == ["Active"] * CLUSTER_SHARDS, 120,
            "every shard active")
        owners = sorted(set(st["datasets"]["prometheus"]["nodes"]))
        standby = sorted(set(nodes) - set(owners))
        check(len(owners) == 2 and len(standby) == 1,
              f"cluster-e2e-4k: owners {owners}")
        steps["shards_active"] = time.perf_counter() - t0
        t = time.perf_counter()
        errs = []

        def feed(name):
            try:
                rep = _rpc(("127.0.0.1", infos[name]["control_port"]),
                           {"cmd": "ingest_lines", "lines": lines,
                            "offset": 1}, timeout_s=600)
                check(rep.get("ok"), f"{name} ingest: {rep}")
            except Exception as e:  # noqa: BLE001 — reported below
                errs.append(f"{name}: {e}")
        feeders = [threading.Thread(target=feed, args=(n,)) for n in nodes]
        for th in feeders:
            th.start()
        for th in feeders:
            th.join()
        check(not errs, f"cluster-e2e-4k: feeding failed: {errs}")
        steps["feed"] = time.perf_counter() - t
        got, err, steps["query_cold"], k1_cold, calls, sums = query(cli)
        _, _, steps["query_warm"], k1_warm, _, _ = query(cli)
        ref_form = None
        if REF_FORM_NODE in owners:
            ref_form = ("before failover",) + node_k1(cli, REF_FORM_NODE)
        t = time.perf_counter()
        for name in owners:
            rep = _rpc(("127.0.0.1", infos[name]["control_port"]),
                       {"cmd": "flush"}, timeout_s=600)
            check(rep.get("ok"), f"cluster-e2e-4k: flush on {name}: {rep}")
        steps["flush"] = time.perf_counter() - t
        victim = owners[-1]
        t = time.perf_counter()
        nodes[victim][0].send_signal(signal.SIGKILL)
        nodes[victim][0].wait()
        state_until(cli, lambda s: victim not in s["members"]
                    and set(s["datasets"]["prometheus"]["nodes"])
                    == {owners[0], standby[0]}
                    and s["datasets"]["prometheus"]["statuses"]
                    == ["Active"] * CLUSTER_SHARDS, 120,
                    f"failover of {victim} to {standby[0]}")
        steps["failover"] = time.perf_counter() - t
        got2, err2, steps["query_after_failover"], k1_after, _, sums2 = \
            query(cli)
        if ref_form is None:
            ref_form = ("after failover",) + node_k1(cli, REF_FORM_NODE)
        # the stored samples come back as they were: their sums within
        # rtol 1e-9 (tests/test_cluster_e2e.py's bound); the rate panel,
        # f32 sums over rows the standby's recovered index orders anew,
        # within its oracle's tolerance, its difference printed
        check(sorted(sums) == sorted(sums2) and all(
            np.allclose(sums2[k], sums[k], rtol=1e-9, atol=0.0,
                        equal_nan=True) for k in sums),
              "cluster-e2e-4k: the samples' sums after failover differ "
              "from the ones before the kill")
        m = ~np.isnan(got)
        rel = float(np.max(np.abs(got2[m] - got[m])
                           / np.maximum(np.abs(got[m]), 1e-300))) \
            if m.any() else 0.0
        check(np.array_equal(np.isnan(got), np.isnan(got2)),
              "cluster-e2e-4k: the rate panel's steps after failover differ")
        log(f"cluster-e2e-4k: {E2E_SERIES} counters x {E2E_T} "
            f"({len(lines)} Influx lines a node) on owners {owners} and "
            f"standby {standby}; {victim} SIGKILLed; oracle max abs err "
            f"before {err}, after {err2}; the rate panel after failover "
            f"bit-identical: {np.array_equal(got, got2, equal_nan=True)}, "
            f"max rel difference {rel}; the samples' sums within rtol 1e-9 "
            f"of the ones before; K1 launches by the nodes' "
            f"stats.devices: cold {k1_cold}, warm {k1_warm}, after failover "
            f"{k1_after} (device calls of the cold query "
            f"{json.dumps(calls)}); {REF_FORM_NODE}, started without "
            f"--device, {ref_form[0]} over its shards {ref_form[1]}: K1 "
            f"launches by device {json.dumps(ref_form[2])}; every step's "
            "seconds "
            + json.dumps({k: round(v, 3) for k, v in steps.items()}))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        if coord is not None:
            coord.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    return {}, [dict(query=CLUSTER_QUERY, kernel="fused_rate_dense",
                     err=err)]


# ------------------------------------------ replication-1M and federation-1M

# the cuts, in the order the time limit and the host's memory forced
# them (PERF.md sets out the arithmetic): the catch-up to one missed
# scrape, federation-1M to 524,288 series, replication-1M to 524,288
# series (at 1,048,576 it took 683.7 s alone and 88.8 GiB of host memory
# at its peak), then to 262,144 (at 524,288 its ~38 GiB beside the
# gauge-1M store, serve-1M's node and node-16k put the 101 GiB host at
# 91.4 GiB in use)
REPL_SERIES = 262_144              # replication-1M's series
FED_SERIES = 524_288               # federation-1M's series
REPL_NODES = ("A", "B", "C")
REPL_SLABS = 16                    # replication-1M: history slabs a shard
REPL_MISSED = 1                    # scrapes that land while A is down
REPL_GRACE_S = 3.0                 # cutover to tombstone: polls move over
REPL_LIVE_EVERY_S = 2.0            # live scrapes of the moving shard
# replication.append_timeout_s of the cell: a shard's first slab makes
# every one of its series on both owners, several shards at once, and
# such an append takes far longer than the default 5 s (PERF.md)
REPL_APPEND_TIMEOUT_S = 600.0
FED_REGIONS = ("east", "west")


def routed_counters(num_series, seed, dev, routers, region_of=None):
    """dense-1M's counters (the same seed, slab by slab) with their part
    keys (`region` added when region_of(i) is given), each routed by
    routers[region] = (shard mapper, spread provider), routers[None]
    without regions -> ({(region, shard): [series indices, keys, vals [n, T]
    f64]}, per-series f64 rates [num_series, W] on the card, ts_row,
    wends, the routing's seconds).  The keys are routed first, so each
    part's values land in one array of its final size."""
    import torch
    from filodb_tpu_torch.core.partkey import PartKey
    t = time.perf_counter()
    part_of = np.empty(num_series, np.int64)
    pos = np.empty(num_series, np.int64)
    names, parts = {}, []
    for i in range(num_series):
        labels = {"_ws_": "demo", "_ns_": f"App-{i % NUM_NS}",
                  "instance": f"Instance-{i}", "dc": f"DC{i % 2}"}
        region = region_of(i) if region_of is not None else None
        if region is not None:
            labels["region"] = region
        pk = PartKey.make("request_total", labels)
        mapper, spread = routers[region]
        s = mapper.ingestion_shard(
            pk.shard_key_hash(), pk.partition_hash(),
            spread.spread_for(pk.shard_key()))
        p = names.setdefault((region, s), len(names))
        if p == len(parts):
            parts.append([[], []])
        part_of[i] = p
        pos[i] = len(parts[p][1])
        parts[p][0].append(i)
        parts[p][1].append(pk)
    route_s = time.perf_counter() - t
    for ent in parts:
        ent[0] = np.asarray(ent[0])
        ent.append(np.empty((len(ent[1]), T), np.float64))
    rng = np.random.default_rng(seed)
    ts_row = START_MS + np.arange(T, dtype=np.int64) * STEP_MS
    wends = np.arange(START_MS + 600_000, int(ts_row[-1]) + 1, 60_000)
    rates = torch.empty((num_series, len(wends)), dtype=torch.float64,
                        device=dev)
    for i0 in range(0, num_series, SLAB):
        n = min(SLAB, num_series - i0)
        vals = make_counter_slab(rng, n, 0.0)
        po, ps = part_of[i0:i0 + n], pos[i0:i0 + n]
        for p in np.unique(po):
            m = po == p
            parts[p][2][ps[m]] = vals[m]
        rates[i0:i0 + n] = oracle_rates_t(torch.from_numpy(vals).to(dev),
                                          ts_row, wends)["rate"]
    torch.cuda.synchronize()
    return ({key: parts[p] for key, p in names.items()}, rates, ts_row,
            wends, route_s)


def repl_feed(manager, shards, cols, ts_row, require_primary=True,
              spent=None):
    """One slab a shard through manager.replicate, the shards in threads
    of their own (each shard's slabs stay in order) -> {shard: result};
    spent[s] adds each call's seconds."""
    out, errs = {}, []

    def one(s):
        t = time.perf_counter()
        try:
            _, keys, vals = shards[s]
            k = cols.stop - cols.start
            out[s] = manager.replicate(
                s, "prom-counter", keys,
                np.broadcast_to(ts_row[cols], (len(keys), k)),
                {"count": np.ascontiguousarray(vals[:, cols])},
                require_primary=require_primary)
        except Exception as e:  # noqa: BLE001 — raised below
            errs.append(f"shard {s}: {type(e).__name__}: {e}")
        if spent is not None:
            spent[s] = spent.get(s, 0.0) + time.perf_counter() - t
    th = [threading.Thread(target=one, args=(s,)) for s in shards]
    for t in th:
        t.start()
    for t in th:
        t.join()
    check(not errs, f"replication-1M: fan-out failed: {errs}")
    return out


def extend_scrapes(shards, ts_row, n):
    """Append n scrapes to every shard's history: each value its last
    plus 5 a scrape (no reset), at the next 10 s steps."""
    for ent in shards.values():
        last = ent[2][:, -1:]
        ent[2] = np.concatenate(
            [ent[2], last + 5.0 * np.arange(1, n + 1)[None, :]], axis=1)
    return np.concatenate(
        [ts_row, ts_row[-1] + STEP_MS * np.arange(1, n + 1)])


def run_replication_phase(num_series, seed, warm, dev):
    """replication-1M: dense-1M's counters (the same seed) in 4 shards at
    RF 2 over three data nodes A, B and C in this process
    (testcluster.make_replicated_cluster: a memstore on the card, a WAL
    under TMPDIR, a NodeQueryServer and a ReplicationServer on loopback
    TCP each; quorum acks).  (1) the history through the fan-out,
    REPL_SLABS slabs a shard of [S_shard, 45], the shards in threads;
    (2) one scrape at RF 2 against one into the primaries alone; (3) the
    panel through the coordinator (failover_dispatcher_factory) against
    the f64 oracle, cold and warm; (4) A killed: the panel full (no
    partial, pushdown's per-shard fallback, query_replica_failovers
    risen), the bits of the answer before; (5) REPL_MISSED scrape(s) on
    the survivors, A's servers back over its memstore, catch-up from
    the survivors' WALs filtered by shard, A's shards on A alone
    answering as the survivors; (6) a live handoff of shard 0 to the
    node that does not own it under a polling client and live scrapes,
    as the handoff route runs it (its WAL tail included, each state's
    seconds and the host's RSS): no failed or partial query, the answer after it equal to before,
    the old owner's card memory back after the tombstone -> (launches,
    rows)."""
    import torch
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.ops import kernels
    from filodb_tpu_torch.parallel.breaker import breakers
    from filodb_tpu_torch.parallel.shardmapper import (ShardEvent,
                                                       ShardMapper,
                                                       SpreadProvider)
    from filodb_tpu_torch.parallel.testcluster import make_replicated_cluster
    from filodb_tpu_torch.parallel.transport import (NodeQueryServer,
                                                     RemoteNodeDispatcher)
    from filodb_tpu_torch.query import execbase
    from filodb_tpu_torch.query.engine import QueryEngine
    from filodb_tpu_torch.query.planner import SingleClusterPlanner
    from filodb_tpu_torch.replication import (HandoffCoordinator,
                                              ReplicaClient,
                                              ReplicationManager,
                                              ReplicationServer,
                                              catchup_shards)
    from filodb_tpu_torch.replication import service as rsvc
    from filodb_tpu_torch.utils.devicetelem import telem
    from filodb_tpu_torch.utils.events import journal
    from filodb_tpu_torch.utils.metrics import registry
    kernels.reset_launch_counts()
    ds = "prometheus"
    steps = {}
    wal_dir = tempfile.mkdtemp(prefix="replication-1m-")
    t0 = time.perf_counter()
    c = make_replicated_cluster(nodes=REPL_NODES, num_shards=CLUSTER_SHARDS,
                                replication_factor=2, ack_mode="quorum",
                                wal_root=wal_dir,
                                append_timeout_s=REPL_APPEND_TIMEOUT_S,
                                device=dev)
    try:
        parts, rates, ts_row, wends, route_s = routed_counters(
            num_series, seed, dev,
            {None: (c.mapper, SpreadProvider(default_spread=1))})
        shards = {s: parts[(None, s)] for s in range(CLUSTER_SHARDS)}
        gids = torch.from_numpy(np.arange(num_series) % NUM_NS).to(dev)
        want = group_sums(rates, gids)
        steps["data"] = time.perf_counter() - t0
        owners = {s: c.mapper.owners(s) for s in shards}
        log(f"replication-1M: {num_series} series over {CLUSTER_SHARDS} "
            f"shards at RF 2 on {list(REPL_NODES)}: owners {owners}, "
            f"series a shard {[len(shards[s][1]) for s in shards]}; "
            f"made and routed in {steps['data']:.1f} s (routing "
            f"{route_s:.1f} s)")
        # (1) the history through the fan-out, its split read from the
        # port's own spans: replication_fanout, replica_append a peer,
        # and the doors' wal_append and wal_commit_wait
        width = T // REPL_SLABS

        def span_s(name, **tags):
            return registry.histogram(f"span_{name}_seconds", **tags)
        rtt = {n: span_s("replica_append", peer=n) for n in REPL_NODES}
        fan = span_s("replication_fanout", dataset=ds)
        wal_h = (span_s("wal_append", dataset=ds),
                 span_s("wal_commit_wait", dataset=ds))
        rtt0 = {n: h.sum for n, h in rtt.items()}
        fan0, wal0 = fan.sum, sum(h.sum for h in wal_h)
        rep_s, slab_s = {}, []
        t = time.perf_counter()
        for j in range(REPL_SLABS):
            t1 = time.perf_counter()
            repl_feed(c.manager, shards, slice(j * width, (j + 1) * width),
                      ts_row, spent=rep_s)
            slab_s.append(time.perf_counter() - t1)
        steps["build"] = time.perf_counter() - t
        rt = {n: rtt[n].sum - rtt0[n] for n in REPL_NODES}
        fan_s = fan.sum - fan0
        wal_s = sum(h.sum for h in wal_h) - wal0
        longest = {n: round(rtt[n].max, 3) for n in REPL_NODES}
        steps["longest_append"] = max(longest.values())
        log(f"replication-1M build: {REPL_SLABS} slabs a shard of "
            f"[S_shard, {width}] through ReplicationManager.replicate "
            f"(quorum) in {steps['build']:.1f} s (the first slab "
            f"{slab_s[0]:.1f} s, the others p50 "
            f"{np.median(slab_s[1:]):.2f} s); thread-seconds: replicate "
            f"{sum(rep_s.values()):.1f} (encoding the record "
            f"{sum(rep_s.values()) - fan_s:.1f}, the fan-out {fan_s:.1f}); "
            f"round trips a peer " + json.dumps(
                {n: round(v, 1) for n, v in rt.items()})
            + f" (the longest append a peer {json.dumps(longest)}, "
            f"append_timeout_s {REPL_APPEND_TIMEOUT_S}); the doors' WAL "
            f"{wal_s:.1f} (append and commit wait, the three nodes); the "
            f"rest of the round trips {sum(rt.values()) - wal_s:.1f} "
            f"(decode, ingest and the wire)")
        for s in shards:
            for n in owners[s]:
                sh = c.stores[n].get_shard(ds, s)
                check(sh.num_partitions == len(shards[s][1]),
                      f"replication-1M: shard {s} on {n} holds "
                      f"{sh.num_partitions} series")
        # (2) fan-out cost: one scrape at RF 2, one into the primaries
        # alone (then into the replicas alone, untimed, so every copy
        # holds it)
        total = sum(len(v[1]) for v in shards.values())
        ts_row = extend_scrapes(shards, ts_row, 2)
        t = time.perf_counter()
        repl_feed(c.manager, shards, slice(T, T + 1), ts_row)
        rf2_s = time.perf_counter() - t

        def one_owner_manager(pick):
            m = ShardMapper(CLUSTER_SHARDS)
            for s in shards:
                m.update_from_event(ShardEvent("IngestionStarted", ds, s,
                                               pick(owners[s])))
            return ReplicationManager(ds, m, lambda n: c.repl_clients[n])
        rf1 = one_owner_manager(lambda o: o[0])
        t = time.perf_counter()
        repl_feed(rf1, shards, slice(T + 1, T + 2), ts_row)
        rf1_s = time.perf_counter() - t
        rest = one_owner_manager(lambda o: o[1])
        repl_feed(rest, shards, slice(T + 1, T + 2), ts_row)
        rf1.stop()
        rest.stop()
        pct = 100.0 * (total / rf2_s) / (total / rf1_s)
        steps.update(scrape_rf2=rf2_s, scrape_rf1=rf1_s)
        log(f"replication-1M fan-out: one scrape of {total} series at RF 2 "
            f"{rf2_s:.3f} s ({total / rf2_s:,.0f} samples/s), into the "
            f"primaries alone {rf1_s:.3f} s ({total / rf1_s:,.0f} "
            f"samples/s); replication_rf2_vs_rf1_pct {pct:.1f}")
        # (3) the panel through the failover coordinator
        eng = c.engine
        start_s, end_s = int(wends[0]) // 1000, int(wends[-1]) // 1000

        def panel(what, **kw):
            n0 = dict(kernels.LAUNCHES)
            t1 = time.perf_counter()
            res = eng.query_range(CLUSTER_QUERY, start_s, 60, end_s,
                                  scan_params(**kw))
            took = time.perf_counter() - t1
            check(res.error is None, f"replication-1M {what}: {res.error}")
            check(not res.partial, f"replication-1M {what}: flagged "
                  f"partial ({res.stats.warnings[:2]})")
            return res, took, launched(n0)

        def bits(res):
            return {k.labels: np.asarray(v) for k, _, v in res.series()}
        ledger0 = k1_ledger(dev)
        base, cold_s, k = panel("cold")
        ledger_k1 = k1_ledger(dev) - ledger0
        err = compare(base, want, 2e-4, 1e-3, "replication-1M panel")[1]
        check(k.get("fused_rate_dense", 0) == CLUSTER_SHARDS,
              f"replication-1M: the panel launched {k}")
        warm_s = []
        for _ in range(warm):
            again, took, _ = panel("warm")
            check({a: b.tobytes() for a, b in bits(again).items()}
                  == {a: b.tobytes() for a, b in bits(base).items()},
                  "replication-1M: a warm panel differs in its bits")
            warm_s.append(took)
        steps.update(panel_cold=cold_s,
                     panel_warm_p50=float(np.median(warm_s)))
        log(f"replication-1M panel: cold {cold_s:.3f} s, warm p50 "
            f"{np.median(warm_s):.4f} s over {warm}; K1 {CLUSTER_SHARDS} "
            f"a panel (the ledger's dispatches {ledger_k1}); pushdown "
            f"pushed {base.stats.pushdown_pushed}; oracle max abs err "
            f"{err}")
        # (4) a node dies: the one that is primary of the most shards
        # (the placement is the shard manager's), called A below
        victim = max(REPL_NODES, key=lambda n: (
            sum(o[0] == n for o in owners.values()), n))
        fo = {n: registry.counter("query_replica_failovers", peer=n).value
              for n in REPL_NODES}
        horizon = {n: c.repl_servers[n].wals[ds].writer
                   .snapshot_segments()[1] for n in REPL_NODES
                   if n != victim}
        c.kill(victim)
        dead, dead_s, k = panel("after A's death")
        fo_up = {n: registry.counter("query_replica_failovers",
                                     peer=n).value - fo[n]
                 for n in REPL_NODES}
        check(sum(fo_up.values()) > 0,
              "replication-1M: no query_replica_failovers after A died")
        check(dead.stats.pushdown_fallback >= 1,
              f"replication-1M: after A's death pushdown fell back "
              f"{dead.stats.pushdown_fallback} times")
        check(k.get("fused_rate_dense", 0) == CLUSTER_SHARDS,
              f"replication-1M: after A's death the panel launched {k}")
        err_dead = compare(dead, want, 2e-4, 1e-3,
                           "replication-1M after A's death")[1]
        a, b = bits(dead), bits(base)
        check(a.keys() == b.keys() and len(a) == NUM_NS,
              "replication-1M: groups differ after A's death")
        diff = max(float(np.nanmax(np.abs(a[g] - b[g]))) for g in a)
        steps["first_full_after_kill"] = dead_s
        log(f"replication-1M A = {victim} (primary of "
            f"{[s for s in shards if owners[s][0] == victim]}) killed: the "
            f"first answer full in "
            f"{dead_s:.3f} s ({len(a)} groups, not partial, pushdown "
            f"fallbacks {dead.stats.pushdown_fallback}, failovers "
            f"{fo_up}); oracle max abs err {err_dead}; largest difference "
            f"from the answer before {diff} (bit-identical: "
            f"{all(a[g].tobytes() == b[g].tobytes() for g in a)})")
        # (5) two scrapes on the survivors, A back, catch-up
        ts_row = extend_scrapes(shards, ts_row, REPL_MISSED)
        for j in range(REPL_MISSED):
            res = repl_feed(c.manager, shards,
                            slice(T + 2 + j, T + 3 + j), ts_row)
            check(all(victim not in r.acked for r in res.values()),
                  "replication-1M: a dead node acked")
        old_q, old_r = c.query_servers[victim], c.repl_servers[victim]
        c.query_servers[victim] = NodeQueryServer(
            c.stores[victim], port=old_q.address[1]).start()
        c.repl_servers[victim] = ReplicationServer(
            c.stores[victim], node=victim, wals=old_r.wals,
            port=old_r.address[1]).start()
        # the node is back: its breakers close now instead of after their
        # half-open probes
        breakers.reset()
        a_shards = [s for s in shards if victim in owners[s]]
        peer_of = {s: next(n for n in owners[s] if n != victim)
                   for s in a_shards}
        t = time.perf_counter()
        cstats = []
        for peer in sorted(set(peer_of.values())):
            mine = [s for s in a_shards if peer_of[s] == peer]
            cstats.append(catchup_shards(
                ReplicaClient(*c.repl_servers[peer].address), ds,
                c.stores[victim], shards=mine,
                since={s: horizon[peer] for s in mine}, node=victim))
        catch_s = time.perf_counter() - t
        c.manager.mark_repaired(victim)
        recs = sum(st.records for st in cstats)
        samples = sum(st.samples for st in cstats)
        want_samples = REPL_MISSED * sum(len(shards[s][1]) for s in a_shards)
        check(samples == want_samples,
              f"replication-1M: catch-up replayed {samples} samples, "
              f"{want_samples} were missed")
        end2 = int(ts_row[-1]) // 1000
        start2 = end2 - 60 * (len(wends) - 1)

        def engine_via(route):
            disp = {n: RemoteNodeDispatcher(*c.query_servers[n].address)
                    for n in REPL_NODES}
            planner = SingleClusterPlanner(
                ds, c.mapper, SpreadProvider(default_spread=1),
                dispatcher_factory=lambda s: disp[route(s)])
            return QueryEngine(ds, TimeSeriesMemStore(device=dev), c.mapper,
                               planner=planner, device=dev)

        def other(s):
            return next(n for n in owners[s] if n != victim)
        alone = engine_via(lambda s: victim if s in a_shards else other(s))
        survivors = engine_via(other)
        ra = alone.query_range(CLUSTER_QUERY, start2, 60, end2,
                               scan_params())
        rs = survivors.query_range(CLUSTER_QUERY, start2, 60, end2,
                                   scan_params())
        check(ra.error is None and rs.error is None,
              f"replication-1M after catch-up: {ra.error} {rs.error}")
        xa, xs = bits(ra), bits(rs)
        check(xa.keys() == xs.keys() and len(xa) == NUM_NS,
              "replication-1M: A alone and the survivors differ in groups")
        cdiff = max(float(np.nanmax(np.abs(xa[g] - xs[g]))) for g in xa)
        check(all(np.allclose(xa[g], xs[g], rtol=1e-6, atol=0.0,
                              equal_nan=True) for g in xa),
              f"replication-1M: A alone answers {cdiff} off the survivors")
        steps["catchup"] = catch_s
        log(f"replication-1M catch-up: A's shards {a_shards} from "
            f"{sorted(set(peer_of.values()))} in {catch_s:.3f} s: "
            + "; ".join(f"records {st.records} samples {st.samples} "
                        f"segments {st.segments} {st.samples_per_sec:,.0f} "
                        f"samples/s {st.elapsed_s:.3f} s" for st in cstats)
            + f"; A alone over [{start2}, {end2}] equal to the survivors "
            f"(largest difference {cdiff}, bit-identical "
            f"{all(xa[g].tobytes() == xs[g].tobytes() for g in xa)})")
        # (6) live handoff of shard 0 under a polling client and scrapes
        hs = 0
        src = c.mapper.node_for_shard(hs)
        target = next(n for n in REPL_NODES if n not in owners[hs])
        before, _, _ = panel("before the handoff")
        src_mirror = c.stores[src].get_shard(ds, hs).stores[
            "prom-counter"].device_mirror
        check(src_mirror is not None and src_mirror.booked_bytes > 0,
              "replication-1M: the moving shard has no mirror")
        stop, pause, idle = (threading.Event(), threading.Event(),
                             threading.Event())
        polls, live = [], [0]

        def poll():
            while not stop.is_set():
                if pause.is_set():
                    idle.set()
                    time.sleep(0.01)
                    continue
                idle.clear()
                t1 = time.perf_counter()
                res = eng.query_range(CLUSTER_QUERY, start_s, 60, end_s,
                                      scan_params(
                                          allow_partial_results=True))
                polls.append((res.error, res.partial,
                              time.perf_counter() - t1))
        moving = {hs: shards[hs]}
        live_ts = [ts_row]

        def scrape():
            while not stop.wait(REPL_LIVE_EVERY_S):
                if pause.is_set():
                    continue
                live_ts[0] = extend_scrapes(moving, live_ts[0], 1)
                j = len(live_ts[0]) - 1
                repl_feed(c.manager, moving, slice(j, j + 1), live_ts[0])
                live[0] += 1
        mem = {}
        applied = []

        class _Wrap:
            def __init__(self, cli):
                self.cli = cli

            def __getattr__(self, name):
                return getattr(self.cli, name)

        class _Src(_Wrap):
            def drop_shard(self, dataset, shard):
                pause.set()
                check(idle.wait(300), "replication-1M: the poller never "
                      "paused for the tombstone")
                serial = src_mirror.serial
                mem["fused"] = sum(
                    execbase._vals_nbytes(v) for k2, v in
                    list(execbase._FUSED_VALS_CACHE.items())
                    if k2[0] == serial)
                mem["mirror"] = src_mirror.booked_bytes
                torch.cuda.synchronize()
                mem["alloc0"] = torch.cuda.memory_allocated(dev)
                mem["hot0"] = telem.hbm_booked(dev, "hot")
                out = self.cli.drop_shard(dataset, shard)
                torch.cuda.synchronize()
                mem["alloc1"] = torch.cuda.memory_allocated(dev)
                mem["hot1"] = telem.hbm_booked(dev, "hot")
                pause.clear()
                return out

        class _Dst(_Wrap):
            def end_restore(self, dataset, shard):
                n = self.cli.end_restore(dataset, shard)
                applied.append(n)
                return n

        def client_for(n):
            cli = c.repl_clients[n]
            return _Src(cli) if n == src else _Dst(cli) \
                if n == target else cli
        rss = []

        def sample_rss():
            while not stop.wait(0.25):
                rss.append((time.time(), rss_now()))
        threads = [threading.Thread(target=poll, daemon=True),
                   threading.Thread(target=scrape, daemon=True),
                   threading.Thread(target=sample_rss, daemon=True)]
        for th in threads:
            th.start()
        time.sleep(1.0)
        seq0 = journal.next_seq
        n0 = dict(kernels.LAUNCHES)
        t = time.perf_counter()
        # as POST /admin/shards/<s>/handoff runs it: with the WAL tail
        summary = HandoffCoordinator(ds, c.mapper, client_for,
                                     tombstone_grace_s=REPL_GRACE_S
                                     ).handoff(hs, target)
        hand_s = time.perf_counter() - t
        time.sleep(1.0)
        stop.set()
        for th in threads:
            th.join(600)
        check(summary["states"] == ["register", "stream_snapshot",
                                    "stream_wal_tail", "cutover",
                                    "tombstone", "done"],
              f"replication-1M: handoff ended {summary}")
        evs = [e for e in journal.since(seq0 - 1)
               if e["kind"] in ("shard_handoff_started", "shard_handoff")]
        state_s, at = {}, {}
        for e0, e1 in zip(evs, evs[1:]):
            state_s[e1.get("state")] = round(
                e1["unixSeconds"] - e0["unixSeconds"], 3)
            at[e1.get("state")] = (e0["unixSeconds"], e1["unixSeconds"])
        snap_recs = next((e.get("records") for e in evs
                          if e.get("state") == "stream_snapshot"), None)
        tail_recs = next((e.get("records") for e in evs
                          if e.get("state") == "stream_wal_tail"), None)
        check(tail_recs is not None and tail_recs >= REPL_SLABS,
              f"replication-1M: the WAL tail relayed {tail_recs} records")
        gib = 2.0 ** 30

        def rss_in(state):
            lo, hi = at[state]
            got = [r for when, r in rss if lo <= when <= hi + 0.25]
            return max(got) / gib if got else float("nan")
        rss_line = (f"host RSS at the handoff's start "
                    f"{rss[0][1] / gib:.2f} GiB, highest in the snapshot "
                    f"{rss_in('stream_snapshot'):.2f} GiB and in the WAL "
                    f"tail {rss_in('stream_wal_tail'):.2f} GiB, the "
                    f"process's peak so far {host_rss() / gib:.2f} GiB")
        steps.update(handoff_snapshot=state_s["stream_snapshot"],
                     handoff_wal_tail=state_s["stream_wal_tail"])
        new_sh = c.stores[target].get_shard(ds, hs)
        snap_samples = int(new_sh.stores["prom-counter"].counts[
            :new_sh.stores["prom-counter"].num_series].sum())
        failed = [p for p in polls if p[0] is not None]
        partial = [p for p in polls if p[1]]
        check(polls and not failed and not partial,
              f"replication-1M handoff: {len(polls)} polls, failed "
              f"{[p[0] for p in failed[:2]]}, partial {len(partial)}")
        check(c.mapper.node_for_shard(hs) == target
              and c.stores[src].get_shard(ds, hs) is None,
              "replication-1M: the handoff did not move the shard")
        after, _, k = panel("after the handoff")
        check(new_sh.stores["prom-counter"].device_mirror is not None,
              "replication-1M: the new owner's store has no mirror")
        check(launched(n0).get("fused_rate_dense", 0) > 0
              and k.get("fused_rate_dense", 0) == CLUSTER_SHARDS,
              f"replication-1M: K1 after the handoff {k}")
        xa, xb = bits(after), bits(before)
        hdiff = max(float(np.nanmax(np.abs(xa[g] - xb[g])
                                    / np.maximum(np.abs(xb[g]), 1e-300)))
                    for g in xa)
        identical = all(xa[g].tobytes() == xb[g].tobytes() for g in xa)
        check(xa.keys() == xb.keys() and all(
            np.allclose(xa[g], xb[g], rtol=1e-6, atol=0.0, equal_nan=True)
            for g in xa),
              f"replication-1M: the answer after the handoff is {hdiff} "
              f"rel off the one before")
        fell, hot_fell = (mem["alloc0"] - mem["alloc1"],
                          mem["hot0"] - mem["hot1"])
        check(fell >= mem["mirror"] and hot_fell >= mem["mirror"],
              f"replication-1M: the tombstone gave back {fell} B allocated "
              f"and {hot_fell} B booked, the mirror held {mem['mirror']}")
        steps["handoff"] = hand_s
        log(f"replication-1M handoff of shard {hs} ({len(shards[hs][1])} "
            f"series) {src} -> {target} in {hand_s:.2f} s, states "
            f"{summary['states']}, each state's seconds "
            + json.dumps(state_s) + f"; snapshot records {snap_recs}, "
            f"samples {snap_samples}; WAL tail records {tail_recs}; "
            f"{rss_line}; live scrapes {live[0]}, buffered "
            f"behind the restore window and applied at its end {applied} "
            f"(cap {rsvc.RESTORE_BUFFER_MAX}); polls {len(polls)}, failed "
            f"{len(failed)}, partial {len(partial)}, p50 "
            f"{np.median([p[2] for p in polls]):.3f} s; after the cutover "
            f"bit-identical to before: {identical} (max rel difference "
            f"{hdiff}); tombstone: memory_allocated {mem['alloc0']} -> "
            f"{mem['alloc1']} (-{fell}), booked hot {mem['hot0']} -> "
            f"{mem['hot1']} (-{hot_fell}), the dropped mirror "
            f"{mem['mirror']} B, its padded values {mem['fused']} B")
        launches = dict(kernels.LAUNCHES)
        log("replication-1M steps' seconds " + json.dumps(
            {k2: round(v, 3) for k2, v in steps.items()}))
    finally:
        breakers.reset()
        c.stop()
        for srv in c.repl_servers.values():
            for wal in srv.wals.values():
                wal.close()
        shutil.rmtree(wal_dir, ignore_errors=True)
    return launches, [dict(query=CLUSTER_QUERY, kernel="fused_rate_dense",
                           err=err)]


def run_federation_phase(num_series, seed, warm, dev):
    """federation-1M: two FiloServer clusters on the card, "east" and
    "west" (testcluster.make_federated_pair, booted empty: each a
    memstore of 4 shards, its planner stack under a FederationPlanner,
    its federation door on loopback TCP, `federation.clusters` splitting
    the series by a `region` label).  dense-1M's counters (the same
    seed) with region east for the first half and west for the rest,
    through ingest_columns into each server's memstore: every _ns_ group
    spans both clusters.  (1) sum by (_ns_) (rate(...)) over 110 steps
    at east: west's share one pushed [G, W] partial, against the f64
    oracle of all the series, cold and warm; the same panel in series
    mode (aggregation_pushdown off) within the same tolerance; wire
    bytes and each cluster's K1 launches; (2) the series-mode query
    killed once west's stream flows: a structured cancel on both sides
    of the door; (3) west's door stopped: a flagged partial naming
    cluster:west whose groups equal the oracle of east's series, the
    breaker open after repeated queries, then the door back and the full
    answer; (4) a warm re-poll from the result cache, then one scrape
    into west invalidating it through the federation token, the next
    answer carrying the new sample -> (launches, rows)."""
    import torch
    from filodb_tpu_torch.federation.exec import FederatedDispatcher
    from filodb_tpu_torch.ops import kernels
    from filodb_tpu_torch.parallel import transport as tr
    from filodb_tpu_torch.parallel.breaker import breakers
    from filodb_tpu_torch.parallel.testcluster import make_federated_pair
    from filodb_tpu_torch.query.activequeries import active_queries
    kernels.reset_launch_counts()
    ds = "prometheus"
    steps = {}
    breakers.configure(failure_threshold=3, open_base_s=1.0,
                       open_max_s=2.0, jitter=0.0)
    breakers.reset()
    half = num_series // 2
    t0 = time.perf_counter()
    pair = make_federated_pair(num_series=0, num_shards=CLUSTER_SHARDS,
                               start=False, probe_interval_s=1.0,
                               device=dev)
    try:
        srv = {"east": pair.east, "west": pair.west}
        parts, rates, ts_row, wends, route_s = routed_counters(
            num_series, seed, dev,
            {r: (srv[r].mappers[ds], srv[r].spreads[ds])
             for r in FED_REGIONS},
            region_of=lambda i: "east" if i < half else "west")
        t = time.perf_counter()
        for (region, s), (_, keys, vals) in parts.items():
            srv[region].memstore.get_shard(ds, s).ingest_columns(
                "prom-counter", keys,
                np.broadcast_to(ts_row, (len(keys), T)), {"count": vals})
        ingest_s = time.perf_counter() - t
        gids = torch.from_numpy(np.arange(num_series) % NUM_NS).to(dev)
        want = group_sums(rates, gids)
        want_east = group_sums(rates, gids, np.arange(half))
        steps["build"] = time.perf_counter() - t0
        log(f"federation-1M: {num_series} series, east {half} and west "
            f"{num_series - half} (series a shard "
            + json.dumps({f"{r}/{s}": len(v[1])
                          for (r, s), v in sorted(parts.items())})
            + f") built in {steps['build']:.1f} s (routing {route_s:.1f} "
            f"s, ingest_columns {ingest_s:.1f} s)")
        west_last = {key: (v[1], v[2][:, -1].copy())
                     for key, v in parts.items() if key[0] == "west"}
        del parts
        eng = pair.engine
        start_s, end_s = int(wends[0]) // 1000, int(wends[-1]) // 1000
        west_calls = []

        def west_k1():
            return sum(v[1] for st in west_calls
                       for key, v in st.device_calls.items()
                       if key.split("|")[-1] in OPS_FUSED)

        real_dispatch = FederatedDispatcher.dispatch

        def spy(self, plan, source):
            data, st = real_dispatch(self, plan, source)
            west_calls.append(st)
            return data, st

        def panel(what, q=CLUSTER_QUERY, **kw):
            west_calls.clear()
            n0 = dict(kernels.LAUNCHES)
            t1 = time.perf_counter()
            res = eng.query_range(q, start_s, 60, end_s, scan_params(**kw))
            took = time.perf_counter() - t1
            check(res.error is None, f"federation-1M {what}: {res.error}")
            k1 = launched(n0).get("fused_rate_dense", 0)
            return res, took, k1 - west_k1(), west_k1()

        def bits(res):
            return {k.labels: np.asarray(v) for k, _, v in res.series()}
        FederatedDispatcher.dispatch = spy
        try:
            pair.east.federation_registry.probe_once()
            pushed, cold_s, k_east, k_west = panel("pushed cold")
            err = compare(pushed, want, 2e-4, 1e-3,
                          "federation-1M pushed")[1]
            check(pushed.stats.pushdown_pushed >= 1 and not pushed.partial,
                  f"federation-1M: pushdown_pushed "
                  f"{pushed.stats.pushdown_pushed}")
            check(k_east == CLUSTER_SHARDS and k_west == CLUSTER_SHARDS,
                  f"federation-1M: K1 east {k_east}, west {k_west}")
            warm_s = []
            for _ in range(warm):
                again, took, _, _ = panel("pushed warm")
                check({a: b.tobytes() for a, b in bits(again).items()}
                      == {a: b.tobytes() for a, b in bits(pushed).items()},
                      "federation-1M: a warm pushed panel differs")
                warm_s.append(took)
            series, series_s, ks_east, ks_west = panel(
                "series mode", aggregation_pushdown=False)
            s_err = compare(series, want, 2e-4, 1e-3,
                            "federation-1M series mode")[1]
            s_warm = [panel("series mode warm",
                            aggregation_pushdown=False)[1]
                      for _ in range(max(1, warm // 3))]
        finally:
            FederatedDispatcher.dispatch = real_dispatch
        steps.update(pushed_cold=cold_s,
                     pushed_warm_p50=float(np.median(warm_s)),
                     series_cold=series_s,
                     series_warm_p50=float(np.median(s_warm)))
        log(f"federation-1M pushed: cold {cold_s:.3f} s, warm p50 "
            f"{np.median(warm_s):.4f} s over {warm}; wire bytes "
            f"{pushed.stats.wire_bytes}, pushdown pushed "
            f"{pushed.stats.pushdown_pushed}; K1 east {k_east}, west "
            f"{k_west}; oracle max abs err {err}.  Series mode: cold "
            f"{series_s:.3f} s, warm p50 {np.median(s_warm):.3f} s over "
            f"{len(s_warm)}; wire bytes {series.stats.wire_bytes} "
            f"({series.stats.wire_bytes / max(pushed.stats.wire_bytes, 1):.0f}"
            f"x), streamed frames {series.stats.streamed_frames}, "
            f"fallback {series.stats.pushdown_fallback}; K1 east {ks_east}, "
            f"west {ks_west}; oracle max abs err {s_err}")
        # (2) a kill of the series-mode query once west's stream flows
        # west's door holds its stream at the fifth frame until the kill
        # is sent, so the kill lands mid-stream on both sides
        flowing, release = threading.Event(), threading.Event()
        real_pack = tr._pack_stream_frame

        def pack(seq, body, last):
            if seq >= 4:
                flowing.set()
                release.wait(60)
            return real_pack(seq, body, last)
        box = {}
        tr._pack_stream_frame = pack
        try:
            # through east's frontend, which registers the coordinator's
            # entry; west's door registers its execution under the same id
            th = threading.Thread(target=lambda: box.update(
                res=pair.frontend.query_range(
                    CLUSTER_QUERY, start_s, 60, end_s,
                    planner_params=scan_params(
                        aggregation_pushdown=False))),
                daemon=True)
            th.start()
            check(flowing.wait(300),
                  "federation-1M: west's stream never flowed")
            remote = [e for e in active_queries.entries()
                      if e.role == "remote"]
            check(len({e.query_id for e in remote}) == 1,
                  f"federation-1M: remote entries {remote}")
            qid = remote[0].query_id
            ents = active_queries.get(qid)
            check(len({e.role for e in ents}) == 2,
                  f"federation-1M: entries under {qid}: "
                  f"{[e.role for e in ents]}")
            t = time.perf_counter()
            out = active_queries.kill(qid, reason="admin",
                                      detail="chip smoke kill across "
                                             "the door")
            release.set()
            th.join(300)
            kill_s = time.perf_counter() - t
            t_end = time.time() + 30
            while active_queries.get(qid) and time.time() < t_end:
                time.sleep(0.05)
        finally:
            release.set()
            tr._pack_stream_frame = real_pack
        err_s = (box.get("res").error or "") if "res" in box else ""
        check(err_s.startswith("query_canceled"),
              f"federation-1M: the killed query answered {err_s!r}")
        check(all(e.token.cancelled and e.verdict == "killed"
                  for e in ents) and not active_queries.get(qid),
              f"federation-1M: after the kill "
              f"{[(e.role, e.verdict) for e in ents]}, still registered "
              f"{active_queries.get(qid)}")
        steps["kill_to_cancel"] = kill_s
        log(f"federation-1M kill across the door: query_canceled "
            f"{kill_s:.3f} s after the kill; entries "
            f"{[(e.role, e.verdict) for e in ents]}, kill frames to "
            f"{out['remoteNodes']}")
        # (3) west dies, the breaker opens, west comes back
        pair.kill_west()
        t = time.perf_counter()
        part = eng.query_range(CLUSTER_QUERY, start_s, 60, end_s,
                               scan_params(allow_partial_results=True))
        part_s = time.perf_counter() - t
        check(part.error is None and part.partial and any(
            "cluster:west" in w for w in part.stats.warnings),
              f"federation-1M: with west dead {part.error} "
              f"{part.stats.warnings[:2]}")
        e_err = compare(part, want_east, 2e-4, 1e-3,
                        "federation-1M east alone")[1]
        opened = None
        for i in range(10):
            t = time.perf_counter()
            eng.query_range(CLUSTER_QUERY, start_s, 60, end_s,
                            scan_params(allow_partial_results=True))
            snap = {b["peer"]: b for b in breakers.snapshot()}
            if snap.get("cluster:west", {}).get("state") == "open":
                opened = (i + 1, time.perf_counter() - t)
                break
        check(opened is not None, "federation-1M: the breaker never opened")
        t = time.perf_counter()
        fast = eng.query_range(CLUSTER_QUERY, start_s, 60, end_s,
                               scan_params(allow_partial_results=True))
        fast_s = time.perf_counter() - t
        check(fast.partial, "federation-1M: the fail-fast answer is full")
        pair.revive_west()
        t = time.perf_counter()
        while True:
            back = eng.query_range(CLUSTER_QUERY, start_s, 60, end_s,
                                   scan_params(allow_partial_results=True))
            if back.error is None and not back.partial:
                break
            check(time.perf_counter() - t < 120,
                  "federation-1M: west never came back")
            time.sleep(0.5)
        back_s = time.perf_counter() - t
        compare(back, want, 2e-4, 1e-3, "federation-1M west back")
        steps.update(partial=part_s, fail_fast=fast_s, recovered=back_s)
        log(f"federation-1M west down: flagged partial in {part_s:.3f} s "
            f"naming cluster:west, east's groups within {e_err} of the "
            f"oracle of east's series; breaker open after "
            f"{opened[0] + 1} failed queries, the fail-fast answer in "
            f"{fast_s:.3f} s; west back: the full answer after "
            f"{back_s:.3f} s")
        # (4) the result cache and the federation token
        fe = pair.frontend
        reg = pair.east.federation_registry
        reg.probe_once()
        fe.cache.clear()
        end_x = end_s + 60

        def poll(end):
            t1 = time.perf_counter()
            r = fe.query_range(CLUSTER_QUERY, start_s, 60, end,
                               planner_params=scan_params())
            check(r.error is None and not r.partial,
                  f"federation-1M cache poll: {r.error}")
            return r, time.perf_counter() - t1
        p1, p1_s = poll(end_s)
        p2, p2_s = poll(end_s)
        check(p2.stats.result_cache == "hit",
              f"federation-1M: the warm re-poll was a "
              f"{p2.stats.result_cache!r}")
        x0, _ = poll(end_x)
        t = time.perf_counter()
        # the extended panel's last step: the scrape lands at it
        scrape_ts = end_x * 1000
        check(scrape_ts > int(ts_row[-1]),
              "federation-1M: the scrape would not be new")
        for (_, s), (keys, last) in west_last.items():
            sh = pair.west.memstore.get_shard(ds, s)
            sh.ingest_columns("prom-counter", keys,
                              np.full((len(keys), 1), scrape_ts, np.int64),
                              {"count": (last + 5.0)[:, None]})
        reg.probe_once()
        scrape_s = time.perf_counter() - t
        p3, p3_s = poll(end_s)
        check(p3.stats.result_cache != "hit",
              "federation-1M: a cached answer survived west's scrape")
        x1, _ = poll(end_x)
        a, b = bits(x1), bits(x0)
        check(a.keys() == b.keys() and len(a) == NUM_NS,
              "federation-1M: groups differ after the scrape")
        check(all(a[g][:-1].tobytes() == b[g][:-1].tobytes()
                  and a[g][-1] != b[g][-1] for g in a),
              "federation-1M: the answer after west's scrape does not "
              "carry the new sample in its last step alone")
        steps.update(cache_hit=p2_s, after_scrape=p3_s)
        log(f"federation-1M cache: miss {p1_s:.3f} s, re-poll "
            f"{p2.stats.result_cache} {p2_s:.4f} s; one scrape into west "
            f"({scrape_s:.3f} s with the probe) -> the next poll "
            f"{p3.stats.result_cache} {p3_s:.3f} s, the extended panel's "
            f"last step moved in all {len(a)} groups")
        launches = dict(kernels.LAUNCHES)
        log("federation-1M steps' seconds " + json.dumps(
            {k2: round(v, 3) for k2, v in steps.items()}))
    finally:
        pair.stop()
        breakers.configure()
        breakers.reset()
    return launches, [dict(query=CLUSTER_QUERY, kernel="fused_rate_dense",
                           err=err)]


# ------------------------------------------------ phases in side processes

# Phases that share no store with this process's run in second processes
# on the same card, beside it: the small stores from K8 on, then the
# ragged and raw-counter phases, a few GB each (beside phase 3's build,
# restart-1M and the 1M phases on its store, where the card is idle
# nearly all the time and this process keeps one core busy); the dense
# gauges and the histograms once host-route-1M is done (beside serve-1M
# through live-ingest-1M, whose peaks, 15-33 GB, leave room for theirs);
# the cluster phases from K8 on, beside phase 3's build and restart-1M
# (cluster-1M's two nodes hold ~10 GB on the card; on the main line
# after live-ingest-1M it took the script to 1,131 s on a slow host).
SIDES = {"stores": ("flush-page-16k", "cold-65k", "parity-65k",
                    "compact-16k",
                    "downsample-16k", "broker-16k", "node-16k",
                    "counter ragged",
                    "gauge ragged",
                    "raw-counter dense", "raw-counter ragged"),
         "cluster": ("cluster-e2e-4k", "cluster-1M", "replication-1M",
                     "federation-1M"),
         "gauge-hist": ("gauge dense + general-1M", "hist-classic-1M",
                        "hist-native-1M", "mesh-1M")}


def run_side(which, args, dev, timed):
    """Run the phases of SIDES[which], in order -> their launches each."""
    small_warm = max(3, args.warm // 3)
    got = []
    if which == "stores":
        cold = {}
        for name, fn, a in (
                ("flush-page-16k", run_flush_page_phase, (args.seed + 7, dev)),
                ("cold-65k", run_cold_phase,
                 (args.seed + 8, args.warm, dev, cold)),
                ("parity-65k", run_parity_phase, (cold, args.seed + 16, dev)),
                ("compact-16k", run_compact_phase, (args.seed + 7, dev)),
                ("downsample-16k", run_downsample_phase,
                 (args.seed + 10, dev)),
                ("broker-16k", run_broker_phase, (args.seed + 9, dev)),
                ("node-16k", run_node_phase, (args.seed + 11, dev))):
            got.append(timed(name, fn, *a)[0])
            free_device_memory()
        # phases 4 and 6 to 8: stores of their own, a few GB on the card
        for kind, seed, queries in (
                ("counter", args.seed + 1, COUNTER_QUERIES),
                ("gauge", args.seed + 3, GAUGE_QUERIES)):
            got.append(timed(f"{kind} ragged", run_path, kind,
                             RAGGED_SERIES, seed, 0.01, small_warm, queries,
                             (5e-4, 1e-4))[0])
            free_device_memory()
        for n, seed, hole, warm, tol in (
                (args.series, args.seed + 4, 0.0, args.warm, (2e-4, 1e-3)),
                (RAGGED_SERIES, args.seed + 5, 0.01, small_warm,
                 (5e-4, 1e-4))):
            got.append(timed(
                f"raw-counter {'ragged' if hole else 'dense'}",
                run_raw_counter_path, n, seed, hole, warm, tol, dev)[0])
            free_device_memory()
    elif which == "cluster":
        got.append(timed("cluster-e2e-4k", run_cluster_e2e_phase,
                         args.seed + 12, dev)[0])
        free_device_memory()
        got.append(timed("cluster-1M", run_cluster_phase, args.series,
                         args.seed, small_warm, dev)[0])
        free_device_memory()
        got.append(timed("replication-1M", run_replication_phase,
                         min(args.series, REPL_SERIES), args.seed,
                         small_warm, dev)[0])
        free_device_memory()
        got.append(timed("federation-1M", run_federation_phase,
                         min(args.series, FED_SERIES), args.seed,
                         small_warm, dev)[0])
    else:
        got_path = timed("gauge dense + general-1M", run_path, "gauge",
                         args.series, args.seed + 2, 0.0, args.warm,
                         GAUGE_QUERIES, (2e-4, 1e-3),
                         GENERAL_QUERIES["gauge"], small_warm)
        got += [got_path[0], got_path[2]]
        del got_path
        free_device_memory()
        n = args.series // len(LES)
        launches, _, classic_want = timed(
            "hist-classic-1M", run_hist_path, n, args.seed + 6, small_warm,
            dev)
        got.append(launches)
        got.append(timed("hist-native-1M", run_hist_native_path, n,
                         args.seed + 6, small_warm, dev, classic_want)[0])
        free_device_memory()
        wait_for_host_memory(MESH_HOST_NEED, "mesh-1M", MESH_HOST_WAIT_S)
        got.append(timed("mesh-1M", run_mesh_phase, args.series, args.seed,
                         args.warm, dev))
    return got


def exit_when_orphaned():
    """End this process when its stdin, a pipe from the process that
    started it, closes (that process ended or was killed)."""
    def orphaned():
        while os.read(0, 4096):
            pass
        os._exit(3)
    threading.Thread(target=orphaned, daemon=True).start()


def side_worker(args) -> int:
    """A side process: SIDES[args.side] on the card, with the libraries
    main() built; logs to stdout as main() does, and writes
    {"launches": ..., "phase_s": ..., "peak_rss": bytes} to
    args.side_out.  It ends itself when its stdin, a pipe from the
    process that started it, closes."""
    import torch
    from filodb_tpu_torch.ops import kernels

    exit_when_orphaned()
    warnings.simplefilter("ignore", RuntimeWarning)
    for name in kernels.SOURCES:
        check(kernels.library_path(name).exists(),
              f"side {args.side}: {name} is not built")
        kernels.library(name)
    dev = torch.device("cuda", 0)
    phase_s = {}
    timed = phase_timer(dev, phase_s, {})
    launches = {}
    t_side = time.perf_counter()
    for got in run_side(args.side, args, dev, timed):
        for name, k in got.items():
            launches[name] = launches.get(name, 0) + k
    with open(args.side_out, "w") as f:
        json.dump({"launches": launches, "phase_s": phase_s,
                   "peak_rss": host_rss(),
                   "side_s": time.perf_counter() - t_side}, f)
    return 0


def start_side(which, args, side_dir):
    """Start the side process for SIDES[which] -> (Popen, its result
    file).  It shares this process's stdout and stderr; its stdin is a
    pipe this process holds open until it is joined or killed."""
    out = os.path.join(side_dir, f"{which}.json")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--side", which,
         "--side-out", out, "--seed", str(args.seed), "--series",
         str(args.series), "--warm", str(args.warm)],
        stdin=subprocess.PIPE)
    log(f"side {which}: {', '.join(SIDES[which])} in process {proc.pid}")
    return proc, out


def join_side(which, side, phase_s):
    """Wait for a side process; fail if it failed; add its phases'
    seconds to phase_s -> its launches."""
    proc, out = side
    t0 = time.perf_counter()
    rc = proc.wait()
    check(rc == 0 and os.path.exists(out),
          f"side {which} failed with exit code {rc}")
    with open(out) as f:
        res = json.load(f)
    phase_s.update(res["phase_s"])
    log(f"side {which}: ran {res['side_s']:.1f} s; joined after "
        f"{time.perf_counter() - t0:.1f} s of waiting; peak host RSS "
        f"{res['peak_rss'] / 2.0 ** 30:.2f} GiB; launches {res['launches']}")
    return res["launches"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--series", type=int, default=1_048_576)
    ap.add_argument("--warm", type=int, default=10)
    ap.add_argument("--ab", nargs="+", metavar="CHECKOUT",
                    help="instead of the smoke, time this checkout against "
                    "these on one card, alternately (run_ab)")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--cells", default=",".join(AB_CELLS))
    ap.add_argument("--ab-worker", help=argparse.SUPPRESS)
    ap.add_argument("--side", choices=tuple(SIDES), help=argparse.SUPPRESS)
    ap.add_argument("--side-out", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-worker", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if args.ab_worker:
        return ab_worker(args.ab_worker, args.series, args.seed)
    if args.side:
        return side_worker(args)
    if args.mesh_worker:
        return mesh_worker(args)
    if args.ab:
        cells = args.cells.split(",")
        check(set(cells) <= set(AB_CELLS), f"--cells: one of {AB_CELLS}")
        return run_ab(args.ab, args.rounds, cells, args.series, args.seed,
                      args.warm)
    try:
        from filodb_tpu_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    warnings.simplefilter("ignore", RuntimeWarning)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    # the sources this process compiles (ops-1M finds one compile each
    # in the device telemetry)
    built = [n for n in kernels.SOURCES
             if not kernels.library_path(n).exists()]
    kernels.finish_builds(kernels.start_builds())
    for name in kernels.SOURCES:
        kernels.library(name)
    log(f"build {time.perf_counter() - t0:.2f} s "
        f"({', '.join(kernels.SOURCES)}; compiled here: {built})")
    # the C++ host library (xxhash, NibblePack) every host path of the
    # node loads: on this machine it must build
    from filodb_tpu_torch import native
    check(native.lib is not None,
          f"the native host library did not build: {native.build_error()}")
    log(f"native host library {native.lib.path}")
    log_ptxas(kernels)
    dev = torch.device("cuda", 0)
    own_tmp = keep_temp_files_on_disk()

    phase_s = {"build": time.perf_counter() - t0}
    phase_evictions = {}
    timed = phase_timer(dev, phase_s, phase_evictions)
    small_warm = max(3, args.warm // 3)
    table = timed("kernels K1-K7", run_kernel_checks, args.series, args.seed,
                  dev)
    probe_table, probe_launches = timed("K8", run_probe_phase, dev,
                                        args.seed)

    launches = {name: 0 for name in table}
    side_dir = tempfile.mkdtemp(prefix="chip-smoke-")
    sides = {"stores": start_side("stores", args, side_dir),
             "cluster": start_side("cluster", args, side_dir)}
    watch = HostMemoryWatch(sides)

    def add(got, phase):
        """Count a phase's launches (and log them), give the card back
        the blocks this process's allocator caches but no tensor holds
        (the four processes share the card); stop here if a side process
        failed."""
        torch.cuda.empty_cache()
        for name in launches:
            launches[name] += got.get(name, 0)
        log(f"main-path launches of {phase}: "
            f"{({k: v for k, v in got.items() if v and k in launches})}")
        for which, (proc, _) in sides.items():
            check(proc.poll() in (None, 0),
                  f"side {which} failed with exit code {proc.returncode}")
    try:
        main_phases(args, dev, timed, phase_evictions, built, add, sides,
                    side_dir)
        for which in SIDES:
            add(join_side(which, sides[which], phase_s), f"side {which}")
        watch.report()
    finally:
        watch.stop.set()
        for proc, _ in sides.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdin.close()
        shutil.rmtree(side_dir, ignore_errors=True)
        if own_tmp:
            shutil.rmtree(own_tmp, ignore_errors=True)
    missing = [name for name, k in launches.items() if k == 0]
    check(not missing, f"kernels of the main path never launched: {missing}")
    log("phase seconds: " + json.dumps(
        {k: round(v, 1) for k, v in phase_s.items()})
        + f"; total {time.perf_counter() - t0:.1f} s ("
        + "; ".join(", ".join(p) for p in SIDES.values())
        + ": each group in a process of its own, beside this one); "
        f"this process's peak host RSS {host_rss() / 2.0 ** 30:.2f} GiB")
    # a group-mode entry replaces its variant's branch of _kernel; a
    # per-series one the _epilogue's per-series mode (:661)
    kernels_json = [
        dict(name=name, route="cuda", source=row["source"],
             replaces="filodb_tpu/ops/pallas_fused.py:"
             + str(661 if name.endswith("_series") else REPLACES[name]),
             launches=launches[name],
             max_abs_err=row["max_abs_err"], ms=row["ms"],
             plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
             bound_by=row["bound_by"], library_ms=row["library_ms"],
             yardsticks=row["yardsticks"])
        for name, row in table.items()]
    kernels_json += [
        dict(name=name, route="cuda", source=row["source"],
             replaces=PROBE_REPLACES[name], launches=probe_launches[name],
             max_abs_err=row["max_abs_err"], ms=row["ms"],
             plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
             bound_by=row["bound_by"], library_ms=row["library_ms"],
             yardsticks=row["yardsticks"],
             ab_vs_library=row["ab_vs_library"],
             **({"equal_output": row["equal_output"]}
                if "equal_output" in row else {}))
        for name, row in probe_table.items()]
    log(json.dumps({"kernels": kernels_json}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main_phases(args, dev, timed, phase_evictions, built, add, sides,
                side_dir):
    """Phase 3 and the 1M phases on its store in this process; the
    gauge-hist side starts once host-route-1M, the main line's largest
    device footprint, is done."""
    small_warm = max(3, args.warm // 3)
    n = args.series
    # restart-1M rides dense-1M: its build goes through a WAL, and the
    # node the log boots (a FiloServer) serves every later 1M phase to
    # its oracle through its own API and HTTP server
    wal = open_wal(n)
    root = wal_root(wal)
    node = None
    try:
        got, _, got_general, kept = timed(
            "counter dense + general-1M", run_path, "counter", n,
            args.seed, 0.0, args.warm, COUNTER_QUERIES, (2e-4, 1e-3),
            GENERAL_QUERIES["counter"], small_warm, True, wal,
            functools.partial(timed, "restart-1M", boot_node))
        add(got, "counter dense and restart-1M")
        add(got_general, "general-1M counter")
        # host-route-1M and promql-1M over the same dense counters
        eng, ms, want, wends, node = kept
        got, _, orc = timed("host-route-1M", run_host_route_phase, eng, ms,
                            n, wends, small_warm, dev)
        add(got, "host-route-1M")
        free_device_memory()
        sides["gauge-hist"] = start_side("gauge-hist", args, side_dir)
        got, _ = timed("promql-1M", run_promql_phase, eng,
                       want[COUNTER_QUERIES[0][0]], orc, wends, small_warm,
                       n)
        add(got, "promql-1M")
        api, http = node.api, Http(node.http.port)
        # the coalescer waits only for the clients step (its window
        # delays every request it takes)
        api.frontends["prometheus"].coalescer.window_s = 0.0
        got, _ = timed("serve-1M", run_serve_phase, eng, api, http,
                       want[COUNTER_QUERIES[0][0]], orc, wends, n)
        add(got, "serve-1M")
        got, _ = timed("ops-1M", run_ops_phase, eng, api, http, built,
                       dict(phase_evictions))
        add(got, "ops-1M")
        got, _ = timed("planners-1M", run_planners_phase, eng, http,
                       small_warm)
        add(got, "planners-1M")
        got, _ = timed("write-1M", run_write_phase, eng, ms, api, http,
                       node.wals["prometheus"], n, args.seed, dev)
        add(got, "write-1M")
        got, _ = timed("rules-1M", run_rules_phase, eng, ms, api, http,
                       n, dev, side_dir)
        add(got, "rules-1M")
        node.shutdown()
        node = None
        del want, orc, api, http, kept
        free_device_memory()
        got, _ = timed("live-ingest-1M", run_live_ingest_phase, eng, ms, n,
                       args.seed, dev, WRITE_SCRAPES)
        add(got, "live-ingest-1M")
        del eng, ms
    finally:
        if node is not None:
            node.shutdown()
        wal.close()
        shutil.rmtree(root, ignore_errors=True)
    free_device_memory()
    # last on this line, once its 1M store is gone: two more processes
    # on the card, out of the window where the four processes peak
    add(timed("mesh-2proc-65k", run_mesh_2proc_phase, args.seed + 14, dev),
        "mesh-2proc-65k")
    add(timed("multi-card", run_multicard_checks, args.seed + 15, dev),
        "multi-card")


if __name__ == "__main__":
    sys.exit(main())
