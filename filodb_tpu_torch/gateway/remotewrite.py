"""Prometheus remote_write ingest sink: protobuf series → columnar slabs
(port of filodb_tpu/gateway/remotewrite.py).

The planet-scale ingest protocol (the Cortex / Thanos-receive front
door; FiloDB's gateway+Kafka layer in spirit, PAPER.md §1): snappy-
compressed protobuf WriteRequests arrive at POST /api/v1/write
(http/routes.py), decode via the shared prompb codec table
(http/remotepb.py), and land here.  This sink's job is SHAPE: a request
is a ragged bag of series with per-series sample lists, and the shard
wants rectangular [S, k] grids (`TimeSeriesShard.ingest_columns`) — so
series are grouped by (shard, sample-count) into RecordBatch.from_grid-
shaped slabs and appended as whole matrices, never per-sample Python
loops through the store.

Durability: with a WAL attached (wal/WalManager), every slab is
appended to the log first and the whole request waits for ONE group
commit before any ack — a crash after the 2xx replays the same slabs
through the same ingest_columns path on restart.

Backpressure: the caller (routes.py) admits the request through
usage.admit_ingest BEFORE decode work is spent on slab-building; over
the per-tenant limit the request bounces with 429 + Retry-After, never
a silent drop.

Replication: with a `replicator` (replication/replicator.py) every slab
also ships to the shard's other owners; a shard that is not locally
owned routes entirely through the fan-out (distributor mode), and its
ack needs at least one owner's append.

Differences from the reference: a series that already exists in the shard under another plain-double
schema (a `prom-counter` or `untyped` series) lands in that schema's
store, under its value column; the reference writes it into the gauge
store at the other store's row, where no query reads it.  New series
land in the gauge schema as in the reference.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np

from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.schemas import Schemas, DEFAULT_SCHEMAS
from filodb_tpu_torch.parallel.shardmapper import ShardMapper, SpreadProvider
from filodb_tpu_torch.utils.metrics import registry as metrics_registry
from filodb_tpu_torch.utils.metrics import span as metrics_span

log = logging.getLogger("filodb.remotewrite")

SCHEMA = "gauge"          # remote_write samples are untyped doubles; the
                          # gauge schema is the Prometheus-wire-compatible
                          # landing shape (counters still rate() correctly:
                          # correction happens at query time)


class RemoteWriteSink:
    """series (decoded prompb TimeSeries) → WAL → shard-routed columnar
    ingest.  One instance per dataset, shared across HTTP handler
    threads (stateless apart from counters; shard ingest serializes
    internally)."""

    def __init__(self, memstore, dataset: str,
                 mapper: Optional[ShardMapper] = None,
                 spread_provider: Optional[SpreadProvider] = None,
                 schemas: Schemas = DEFAULT_SCHEMAS, wal=None,
                 replicator=None):
        self.memstore = memstore
        self.dataset = dataset
        self.mapper = mapper
        self.spread = spread_provider or SpreadProvider(0)
        self.schemas = schemas
        self.wal = wal
        # replication fan-out (replication/replicator.py): every slab
        # additionally ships to the shard's other owners; a shard NOT
        # locally owned routes entirely through the fan-out (distributor
        # mode) and the ack requires at least its primary's append
        self.replicator = replicator
        # schema name -> its value column, for the plain-double schemas
        # an existing series may keep (see _landing_schema)
        self._value_col = {
            sc.name: sc.value_column for sc in schemas.by_name.values()
            if len(sc.columns) == 2 and sc.columns[1].col_type == "double"}

    # ------------------------------------------------------------- ingest

    def ingest_series(self, series, stats=None) -> Tuple[int, int]:
        """Ingest decoded remotepb.PromTimeSeries; returns (samples
        ingested, samples dropped by the store — OOO/dup/quota).  Raises
        WalWriteError when durability cannot be claimed (the route turns
        it into a 503: the client must retry, the data was NOT acked).

        `stats` (utils/freshness.IngestStats, optional) is filled with
        the batch's per-stage breakdown — slab build, WAL append,
        group-commit fsync wait, replication fan-out, memstore ingest —
        plus slab/shard counts and per-tenant newest sample timestamps;
        the door feeds it to the ingest slowlog and the freshness
        histograms.  Every stage runs under the caller's trace context,
        so the spans stitch into one write-path trace."""
        import time as _time
        t0 = _time.perf_counter()
        with metrics_span("rw_build_slabs", dataset=self.dataset):
            slabs = self._build_slabs(series, stats=stats)
        t_slabs = _time.perf_counter()
        n = dropped = 0
        # WAL appends go first WITHOUT waiting: the committer thread's
        # flush+fsync overlaps the in-memory ingest below (both release
        # the GIL), and ONE group-commit wait at the end covers every
        # slab — the ack is still strictly after durability, and a crash
        # in between leaves only unacknowledged in-memory samples the
        # client will re-send
        last_seq = -1
        seqs = []
        if self.wal is not None:
            for shard_num, schema, keys, ts, vals in slabs:
                last_seq = self.wal.append_grid(
                    shard_num, schema, keys, ts,
                    {self._value_col[schema]: vals}, wait=False)
                seqs.append(last_seq)
        t_wal = _time.perf_counter()
        repl_s = 0.0
        for i, (shard_num, schema, keys, ts, vals) in enumerate(slabs):
            shard = self.memstore.get_shard(self.dataset, shard_num)
            offset = seqs[i] if self.wal is not None else -1
            cols = {self._value_col[schema]: vals}
            if shard is not None:
                got = shard.ingest_columns(schema, keys, ts, cols,
                                           offset=offset)
                n += got
                dropped += ts.size - got
            elif self.replicator is None:
                raise ConnectionError(
                    f"remote_write: shard {shard_num} of "
                    f"{self.dataset!r} is not locally owned")
            # replication fan-out: the slab ships to every OTHER owner
            # of the shard.  Locally-owned shards ack on local WAL
            # durability (replica failures degrade to lag + catch-up);
            # a shard owned elsewhere must land on at least one owner
            # (require_primary) or the request bounces un-acked
            if self.replicator is not None:
                tr = _time.perf_counter()
                res = self.replicator.replicate(
                    shard_num, schema, keys, ts, cols,
                    seq=offset, require_primary=shard is None)
                repl_s += _time.perf_counter() - tr
                if shard is None:
                    # account what the shard's OWNER actually ingested
                    # (its OOO/dup drops count as drops here, exactly
                    # like the locally-owned path); fall back to any
                    # acking owner when the primary's ack was missing
                    primary = self.mapper.node_for_shard(shard_num) \
                        if self.mapper is not None else None
                    got = res.ingested.get(primary) if primary else None
                    if got is None and res.ingested:
                        got = max(res.ingested.values())
                    got = int(got or 0)
                    n += got
                    dropped += int(ts.size) - got
        t_ingest = _time.perf_counter()
        if last_seq >= 0:
            self.wal.commit(last_seq)
        t_commit = _time.perf_counter()
        metrics_registry.counter("remote_write_samples",
                                 dataset=self.dataset).increment(n)
        if stats is not None:
            stats.dataset = stats.dataset or self.dataset
            stats.slabs = len(slabs)
            stats.shards = sorted({s for s, *_ in slabs})
            stats.ingested += n
            stats.dropped += dropped
            stats.build_slabs_s += t_slabs - t0
            stats.wal_append_s += t_wal - t_slabs
            # the fan-out ran interleaved with the local ingest loop:
            # split the loop's wall into its replication share and the
            # memstore remainder
            stats.replication_s += repl_s
            stats.ingest_s += max(t_ingest - t_wal - repl_s, 0.0)
            stats.wal_commit_wait_s += t_commit - t_ingest
        return n, dropped

    # -------------------------------------------------------- slab build

    def _landing_schema(self, shard, pk: PartKey) -> str:
        """The schema a series' samples land in: an existing partition's
        own schema when it is a plain-double one, else the gauge."""
        if shard is not None:
            pid = shard.part_set.get(pk.to_bytes())
            if pid is not None:
                name = shard.partitions[pid].schema_name
                if name in self._value_col:
                    return name
        return SCHEMA

    def _build_slabs(self, series, stats=None
                     ) -> List[Tuple[int, str, List[PartKey], np.ndarray,
                                     np.ndarray]]:
        """Group the request's series into rectangular (shard, schema,
        keys, ts [S, k], values [S, k]) slabs: one per (shard, schema,
        sample-count), matching RecordBatch.from_grid's grid contract.  A scrape
        push's natural shape — every series carrying the same k samples
        — collapses to one slab per shard.  With `stats`, the per-tenant
        newest sample timestamp is tracked in the same pass (the
        ingest-to-queryable freshness input — zero extra iteration)."""
        part_schema = self.schemas.part
        newest = stats.newest_ts_ms if stats is not None else None
        by_group: Dict[Tuple[int, str, int],
                       List[Tuple[PartKey, list]]] = {}
        shards: Dict[int, object] = {}
        for ts_msg in series:
            if not ts_msg.samples:
                continue
            labels = dict(ts_msg.labels)
            metric = labels.pop("__name__", "") or "_unnamed_"
            if newest is not None:
                ws = labels.get("_ws_", "")
                ts_max = int(max(t for _, t in ts_msg.samples))
                if ts_max > newest.get(ws, -1):
                    newest[ws] = ts_max
            pk = PartKey.make(metric, labels, part_schema)
            if self.mapper is not None:
                shard_num = self.mapper.ingestion_shard(
                    pk.shard_key_hash(), pk.partition_hash(),
                    self.spread.spread_for(pk.shard_key()))
            else:
                shard_num = 0
            if shard_num not in shards:
                shards[shard_num] = self.memstore.get_shard(self.dataset,
                                                            shard_num)
            schema = self._landing_schema(shards[shard_num], pk)
            by_group.setdefault((shard_num, schema, len(ts_msg.samples)),
                                []).append((pk, ts_msg.samples))
        slabs = []
        for (shard_num, schema, k), rows in by_group.items():
            keys = [pk for pk, _ in rows]
            # one [S, k, 2] pass over the decoded tuples, then split —
            # the only per-sample cost is the protobuf decode itself
            mat = np.asarray([samples for _, samples in rows],
                             dtype=np.float64)          # [S, k, 2]
            vals = np.ascontiguousarray(mat[:, :, 0])
            ts = np.ascontiguousarray(mat[:, :, 1]).astype(np.int64)
            slabs.append((shard_num, schema, keys, ts, vals))
        return slabs


def admit_series(series, header_org: Optional[str], limit: int):
    """Per-tenant ingest admission for a WriteRequest — the same ledger
    (`usage.admit_ingest`) every other door runs.

    Returns (admitted_series, retry_after_or_None, rejected_samples).
    With an X-Scope-OrgID header ("ws" or "ws/ns", the Cortex
    convention) the WHOLE request is one tenant.  Otherwise EVERY series
    is admitted under its own `_ws_`/`_ns_` labels — admission keyed off
    one representative series would let an over-limit tenant smuggle
    samples behind a foreign first series.  Mixed requests keep the
    admitted tenants' series; the caller still answers 429 when anything
    was rejected (a resend's admitted-tenant duplicates drop in store
    dedup, so nothing is lost OR double-counted in the store)."""
    from filodb_tpu_torch.utils.usage import usage
    if not limit:
        return list(series), None, 0
    if header_org:
        ws, _, ns = header_org.partition("/")
        n = count_samples(series)
        ra = usage.admit_ingest(ws, ns, n, limit)
        return (list(series), None, 0) if ra is None else ([], ra, n)
    groups: Dict[Tuple[str, str], list] = {}
    for ts_msg in series:
        labels = dict(ts_msg.labels)
        tenant = (labels.get("_ws_", ""), labels.get("_ns_", ""))
        g = groups.setdefault(tenant, [[], 0])
        g[0].append(ts_msg)
        g[1] += len(ts_msg.samples)
    admitted: list = []
    retry_after = None
    rejected = 0
    for (ws, ns), (ser, n) in groups.items():
        ra = usage.admit_ingest(ws, ns, n, limit)
        if ra is None:
            admitted.extend(ser)
        else:
            rejected += n
            retry_after = max(retry_after or 0.0, ra)
    return admitted, retry_after, rejected


def count_samples(series) -> int:
    return sum(len(ts_msg.samples) for ts_msg in series)
