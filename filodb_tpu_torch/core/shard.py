"""TimeSeriesShard — all state for one shard (port of
filodb_tpu/core/shard.py).

Kept: partition creation and the key-table cache, the per-record ingest
(`ingest`: the grid path and the flat path, out-of-order drops,
`ingested_offset`), the columnar grid ingest (`ingest_columns`, which
flattens a slab with duplicate keys into a RecordBatch), index lookup,
the pid->row and pid->key maps, the seqlock snapshot read, flush groups
and their checkpoints (`flush_group`: copy and seal under the write lock,
encode and persist outside it), the compressed resident tier, memory
enforcement, eviction of ended series and demand paging; the admission
pieces (the cardinality tracker's quotas at series creation, the
per-workspace series budget `index.tenant_series_limit`) and per-tenant
usage accounting on every ingest path (`_account_ingest`); traced filters
(`set_traced_filters`: series matching a filter group are logged at
creation, ingest and query lookup) and the fault points `ingest.batch`
and `flush.persist` (utils/faults.py), where the reference fires them.

Recovery: `recover_index` rebuilds the index and the partition registry
from the column store's part keys; queries then page the flushed chunk
frames back through demand paging.  `recover_stream` replays a stream's
batches past each flush group's checkpoint, and `compact_index` prunes
the index's tombstoned postings under the write lock.  The downsampler
hook: a `shard_downsampler` (downsample/shard_downsampler.py) is fed each
flushed chunk inside the flush's persist loop, past a per-partition time
watermark, so emission stays exactly-once across a shift-skipped seal.
The store settings the reference reads from its
config are the constants below, at its defaults; the tenant settings
come from the config (`query.tenant_usage_enabled`,
`index.tenant_series_limit`).  A key whose partition lives in another
schema's store is dropped from a batch of this schema and counted in
`stats.schema_dropped` (the reference writes it into the other store's
row).  Host arrays stay numpy; the device copy is the DeviceMirror's.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import itertools
import logging
import os
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from filodb_tpu_torch.core.blockstore import DenseSeriesStore
from filodb_tpu_torch.core.index import MAX_TIME, ColumnFilter, PartKeyIndex
from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.ratelimit import (QuotaReachedException,
                                             TenantBudgetExceeded)
from filodb_tpu_torch.core.records import RecordBatch
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, Schemas
from filodb_tpu_torch.core.store import (ColumnStore, InMemoryMetaStore,
                                         MetaStore, NullColumnStore,
                                         PartKeyRecord)
from filodb_tpu_torch.memory.chunks import encode_chunkset
from filodb_tpu_torch.memory.histogram import HistogramBuckets
from filodb_tpu_torch.memory.resident import ResidentChunkCache
from filodb_tpu_torch.utils.faults import faults
from filodb_tpu_torch.utils.growable import grow_to as _grow_to
from filodb_tpu_torch.utils.metrics import registry as metrics_registry

_log = logging.getLogger("filodb.shard")

NO_HORIZON_MS = -(1 << 62)               # see append_horizon_ms
_SHARD_KEYS_SERIAL = itertools.count(1)  # see TimeSeriesShard.keys_serial
_KEY_RESOLVE_CACHE_MAX = 4               # live key tables per shard (schemas)
_LOOKUP_CACHE_MAX = 32                   # memoized lookup_partitions results

# the reference's store settings (filodb_tpu/config.py StoreConfig)
GROUPS_PER_SHARD = 60               # flush groups
SHARD_MEM_SIZE = 512 * 1024 * 1024
RESIDENT_CACHE_BYTES = 256 << 20
ACTIVE_TAIL_ROWS = 512
MIN_FLUSH_SAMPLES = 256             # a background flush's write-buffer floor

# shared flush-encode pool: chunk encoding is numpy (releases the GIL), so
# slab-parallel encode overlaps with live ingest on the other cores.  One
# process-wide pool, created at the first large flush
_ENCODE_POOL: Optional[concurrent.futures.ThreadPoolExecutor] = None
_ENCODE_POOL_WORKERS = 0
_ENCODE_POOL_LOCK = threading.Lock()
_ENCODE_MIN_PARALLEL = 16                # serial below this many partitions


def _encode_pool():
    """-> (executor, worker_count)."""
    global _ENCODE_POOL, _ENCODE_POOL_WORKERS
    with _ENCODE_POOL_LOCK:
        if _ENCODE_POOL is None:
            _ENCODE_POOL_WORKERS = max(2, min(4, os.cpu_count() or 1))
            _ENCODE_POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=_ENCODE_POOL_WORKERS,
                thread_name_prefix="filodb-flush-encode")
        return _ENCODE_POOL, _ENCODE_POOL_WORKERS


@dataclasses.dataclass
class PartitionInfo:
    """Lightweight partition record; heavy state lives in the store row."""
    part_id: int
    part_key: PartKey
    schema_name: str
    row: int                      # row in the schema's DenseSeriesStore
    group: int                    # flush group


@dataclasses.dataclass
class ShardStats:
    rows_ingested: int = 0
    partitions_created: int = 0
    rows_dropped: int = 0
    chunks_flushed: int = 0
    flushes: int = 0
    evictions: int = 0
    quota_dropped: int = 0          # series rejected by cardinality quota
    tenant_rejected: int = 0        # series rejected by the per-ws budget
    schema_dropped: int = 0         # samples for a key of another schema


class PagedLimitExceeded(ValueError):
    """Demand paging hit the query's scan limit.  Carries how much paging
    work already happened; that work is kept (paged chunks are valid
    cache, paged_floor/paged_ceil advanced for the completed rows)."""

    def __init__(self, limit: int, samples_paged: int,
                 partitions_paged: int):
        self.limit = limit
        self.samples_paged = samples_paged
        self.partitions_paged = partitions_paged
        super().__init__(
            f"demand paging exceeded the scan limit {limit} after paging "
            f"{samples_paged} samples across {partitions_paged} "
            f"partitions — narrow the filters or time range (the paged "
            f"data is kept warm for a narrower retry)")


@dataclasses.dataclass
class PartLookupResult:
    """Vectorized lookup result: pids per schema.  The hot paths read the
    pid arrays; parts_by_schema materializes PartitionInfo lists for the
    metadata and maintenance readers."""
    shard: int
    part_ids: np.ndarray
    pids_by_schema: Dict[str, np.ndarray]
    first_schema: Optional[str]
    shard_obj: Optional["TimeSeriesShard"] = dataclasses.field(
        default=None, repr=False, compare=False)
    # the leaf's scan estimates over this lookup's rows and time range,
    # memoized with it: (schema, store generation) -> samples
    scan_estimates: Dict = dataclasses.field(default_factory=dict,
                                             repr=False, compare=False)

    @property
    def parts_by_schema(self) -> Dict[str, List["PartitionInfo"]]:
        parts = self.shard_obj.partitions
        return {s: [parts[p] for p in pids.tolist()]
                for s, pids in self.pids_by_schema.items()}


class TimeSeriesShard:

    def __init__(self, dataset: str, shard_num: int,
                 schemas: Schemas = DEFAULT_SCHEMAS, device=None,
                 column_store: Optional[ColumnStore] = None,
                 meta_store: Optional[MetaStore] = None, config=None):
        if config is None:
            from filodb_tpu_torch.config import settings
            config = settings()
        self.dataset = dataset
        self.shard_num = shard_num
        self.schemas = schemas
        # where this shard's DeviceMirror lives (the memstore's device)
        self.device = device
        self.column_store = column_store or NullColumnStore()
        self.meta_store = meta_store or InMemoryMetaStore()
        self.index = PartKeyIndex()
        self.part_set: Dict[bytes, int] = {}       # partKey bytes -> partId
        self.partitions: List[Optional[PartitionInfo]] = []
        # vectorized pid tables: schema code / store row / liveness per pid
        self._schema_code_of: Dict[str, int] = {}
        self._schema_names: List[str] = []
        self._pid_schema_code = np.zeros(0, dtype=np.int16)
        self._pid_row = np.zeros(0, dtype=np.int64)
        self._pid_alive = np.zeros(0, dtype=bool)
        self._rv_keys: List[Optional[object]] = []  # cached RangeVectorKeys
        # identity for downstream per-working-set caches: process-unique
        # serial + an epoch, bumped when a pid's key mapping may change
        # (eviction drops keys, tombstone reclaim can recycle pids)
        self.keys_serial = next(_SHARD_KEYS_SERIAL)
        self.keys_epoch = 0
        # key-table resolution cache: id -> [list ref, pids, epoch, schema,
        # grid_ok]; streaming sources reuse one part_keys list per batch
        self._key_resolve_cache: Dict[int, list] = {}
        self._lookup_cache: Dict[tuple, PartLookupResult] = {}
        self.stores: Dict[str, DenseSeriesStore] = {}
        # compressed resident tier: sealed chunks kept encoded in host RAM
        # so the dense tier holds only the active tail.  Without a column
        # store it is the only copy of sealed history, so it never evicts
        self.resident = ResidentChunkCache(
            RESIDENT_CACHE_BYTES,
            persistent=not isinstance(self.column_store, NullColumnStore))
        self.stats = ShardStats()
        # per-tenant (_ws_/_ns_) ingest attribution (utils/usage.py):
        # pid -> small tenant id resolved once at partition creation, so
        # the ingest paths pay one vectorized bincount per batch
        self._usage_enabled = config.query.tenant_usage_enabled
        # per-workspace alive-series counts behind the
        # index.tenant_series_limit budget (0 = off); internal workspaces
        # and _ws_-less series are exempt from the gate
        self._tenant_series_limit = config.index.tenant_series_limit
        self._ws_series: Dict[str, int] = {}
        self._pid_tenant = np.zeros(0, dtype=np.int32)
        self._tenant_ids: Dict[Tuple[str, str], int] = {}
        self._tenant_names: List[Tuple[str, str]] = []
        # optional streaming downsampler fed at flush (ref:
        # ShardDownsampler.scala:103 populateDownsampleRecords at doFlushSteps)
        self.shard_downsampler = None
        # optional cardinality tracker enforcing quotas at series creation
        # (core/ratelimit.CardinalityTracker)
        self.cardinality_tracker = None
        self.ingested_offset = -1                   # latest ingest offset seen
        self._groups = GROUPS_PER_SHARD
        self._dirty_part_keys: set = set()          # partIds needing pk upsert
        # writer mutex: ingest, flush copy/seal, paging, eviction and mirror
        # refresh serialize here; queries read through snapshot_read's
        # seqlock retry instead
        self.write_lock = threading.RLock()
        # flush-vs-flush mutex only: serializes flush_group calls without
        # holding the write lock across the encode + persist phase
        self._flush_lock = threading.Lock()
        # per-partition newest-downsampled timestamp (flush-thread only,
        # under _flush_lock): dedupes downsample emission when a
        # shift-skipped seal makes a flush re-read an unsealed range
        self._ds_time_wm: Dict[int, int] = {}
        # flush-group membership, maintained at creation
        self._group_pids: List[List[int]] = [[] for _ in range(self._groups)]
        # write-buffer batching state (min_samples): rounds each group
        # skipped small partitions, and the last offset at which the group
        # was FULLY persisted (the only offset its checkpoint may claim)
        self._group_skip_rounds: List[int] = [0] * self._groups
        self._group_ckpt_offset: Dict[int, int] = {}
        # deferred reclamation of evicted partitions: (evicted_at, pid).
        # They keep their PartitionInfo for a grace period so lock-free
        # readers holding the pid still resolve it; flush prunes them
        self._evicted_tombstones: collections.deque = collections.deque()
        # True while an eviction sweep or memory enforcement runs
        self.eviction_in_progress = False
        # append_horizon_ms memo: schema -> (store generation, horizon)
        self._horizon_memo: Dict[str, tuple] = {}
        # trace-filter logging of individual series: partitions whose
        # labels match ALL filters of any filter group get lifecycle log
        # lines at creation, ingest and query lookup (the reference's
        # tracedPartFilters).  Set via set_traced_filters (a list of label
        # maps) or POST /admin/tracedfilters; traced pids are a set, so
        # the ingest and query paths pay one membership test.
        self.traced_part_filters: List[Tuple[str, str]] = []
        self._traced_groups: List[Dict[str, str]] = []
        self._traced_pids: set = set()

    @contextlib.contextmanager
    def _write_locked(self, what: str, warn_after_s: float = 10.0):
        """write_lock with stall logging."""
        if not self.write_lock.acquire(timeout=warn_after_s):
            _log.warning("write_lock stall: %s waited >%.0fs on shard %d",
                         what, warn_after_s, self.shard_num)
            self.write_lock.acquire()
        try:
            yield
        finally:
            self.write_lock.release()

    # ------------------------------------------------------------ ingest

    def group_for(self, part_key: PartKey) -> int:
        """Stable flush-group assignment from the partKey hash."""
        return part_key.partition_hash() % self._groups

    def _store_for(self, schema_name: str) -> DenseSeriesStore:
        store = self.stores.get(schema_name)
        if store is None:
            store = DenseSeriesStore(self.schemas[schema_name])
            self.stores[schema_name] = store
        return store

    def get_or_create_partition(self, part_key: PartKey, schema_name: str,
                                start_time_ms: int) -> PartitionInfo:
        """partId assignment + store row + index add."""
        kb = part_key.to_bytes()
        pid = self.part_set.get(kb)
        if pid is not None:
            return self.partitions[pid]
        if self.cardinality_tracker is not None:
            # raises QuotaReachedException before any state is touched
            self.cardinality_tracker.series_created(
                self._shard_key_tuple(part_key))
        ws = ""
        if self._tenant_series_limit:
            # per-tenant cardinality budget: raises before any state is
            # touched, like the quota above
            from filodb_tpu_torch.utils.usage import INTERNAL_WORKSPACES
            ws = part_key.tags_dict.get("_ws_", "")
            if ws and ws not in INTERNAL_WORKSPACES:
                alive = self._ws_series.get(ws, 0)
                if alive >= self._tenant_series_limit:
                    self.stats.tenant_rejected += 1
                    metrics_registry.counter(
                        "tenant_series_rejected", dataset=self.dataset,
                        ws=ws).increment()
                    raise TenantBudgetExceeded(
                        ws, self._tenant_series_limit, alive)
        pid = len(self.partitions)
        store = self._store_for(schema_name)
        # group from the stable partKey hash, not the partId: replay
        # filtering by group checkpoint must survive a restart
        info = PartitionInfo(pid, part_key, schema_name, store.new_row(),
                             group=self.group_for(part_key))
        self.partitions.append(info)
        code = self._schema_code_of.get(schema_name)
        if code is None:
            code = len(self._schema_names)
            self._schema_code_of[schema_name] = code
            self._schema_names.append(schema_name)
        n = pid + 1
        self._pid_schema_code = _grow_to(self._pid_schema_code, n)
        self._pid_row = _grow_to(self._pid_row, n)
        self._pid_alive = _grow_to(self._pid_alive, n, fill=False)
        self._pid_schema_code[pid] = code
        self._pid_row[pid] = info.row
        self._pid_alive[pid] = True
        self._pid_tenant = _grow_to(self._pid_tenant, n)
        if self._usage_enabled:
            tags = part_key.tags_dict
            tk = (tags.get("_ws_", ""), tags.get("_ns_", ""))
            tid = self._tenant_ids.get(tk)
            if tid is None:
                tid = self._tenant_ids[tk] = len(self._tenant_names)
                self._tenant_names.append(tk)
            self._pid_tenant[pid] = tid
        self._rv_keys.append(None)
        self._group_pids[info.group].append(pid)
        self.part_set[kb] = pid
        self.index.add_partition(pid, part_key, start_time_ms)
        self._dirty_part_keys.add(pid)
        if self._tenant_series_limit:
            if not ws:
                ws = part_key.tags_dict.get("_ws_", "")
            if ws:
                self._ws_series[ws] = self._ws_series.get(ws, 0) + 1
        self.stats.partitions_created += 1
        if self.traced_part_filters or self._traced_groups:
            if self._trace_match(part_key):
                self._traced_pids.add(pid)
                _log.info("TRACED series created: shard=%d partId=%d %s",
                          self.shard_num, pid, part_key)
        return info

    # ------------------------------------------- per-series debug follow

    def _trace_match(self, part_key: PartKey) -> bool:
        labels = {**part_key.tags_dict, "_metric_": part_key.metric}
        if self.traced_part_filters and \
                all(labels.get(k) == v
                    for k, v in self.traced_part_filters):
            return True
        return any(all(labels.get(k) == v for k, v in grp.items())
                   for grp in self._traced_groups)

    def set_traced_filters(self, groups) -> int:
        """groups: list of {label: value} maps; a series matching ALL
        labels of ANY map is debug-followed through creation, ingest and
        query lookup.  [] clears.  Returns the number of currently
        matching partitions.  Takes the write lock: the scan must not
        race partition creation."""
        with self._write_locked("traced_filters"):
            self._traced_groups = [dict(g) for g in groups]
            pids = set()
            if self._traced_groups:
                for info in self.partitions:
                    if info is not None and self._trace_match(info.part_key):
                        pids.add(info.part_id)
                        _log.info("TRACED series matched filter: shard=%d "
                                  "partId=%d %s", self.shard_num,
                                  info.part_id, info.part_key)
            self._traced_pids = pids
            return len(pids)

    def _trace_touch(self, what: str, pids, extra: str = "") -> None:
        if not self._traced_pids:
            return
        hit = self._traced_pids.intersection(
            pids if isinstance(pids, (list, set))
            else np.asarray(pids).tolist())
        for pid in sorted(hit):
            info = self.partitions[pid]
            _log.info("TRACED series %s: shard=%d partId=%d %s%s",
                      what, self.shard_num, pid,
                      info.part_key if info is not None else "?", extra)
            metrics_registry.counter(
                "traced_series_events", dataset=self.dataset,
                event=what).increment()

    def _trace_touch_resolved(self, pids_for_key: np.ndarray,
                              offset: int) -> None:
        touched = pids_for_key[pids_for_key >= 0]
        traced = [int(p) for p in touched.tolist()
                  if int(p) in self._traced_pids]
        if traced:
            self._trace_touch("ingest", traced, extra=f" offset={offset}")

    def ingest(self, batch: RecordBatch, offset: int = -1) -> int:
        """Ingest one record batch.  Returns samples ingested
        (out-of-order samples are dropped).  Serialized with flush,
        eviction and paging by the write lock; concurrent queries read
        through the seqlock (snapshot_read)."""
        faults.fire("ingest.batch")
        with self._write_locked("ingest"):
            return self._ingest(batch, offset)

    def _resolve_key_table(self, pk_list, schema_name: str) -> list:
        """Cached key-table -> pid resolution entry [pk_list, pids, epoch,
        schema, grid_ok] (pid entries -1 until a partition exists).
        Cached per key-table identity: streaming sources reuse one
        part_keys list across batches, so steady-state ingest skips the
        O(K) Python loop.  pids are cached, not rows: compaction remaps
        rows, and _pid_row picks that up per batch; evictions bump
        keys_epoch, invalidating the entry before a dead pid is written."""
        nk = len(pk_list)
        cache = self._key_resolve_cache
        ent = cache.get(id(pk_list))
        if (ent is not None and ent[0] is pk_list
                and ent[2] == self.keys_epoch
                and ent[3] == schema_name and len(ent[1]) == nk):
            cache[id(pk_list)] = cache.pop(id(pk_list))   # LRU touch
            return ent
        ent = [pk_list, np.full(nk, -1, dtype=np.int64), self.keys_epoch,
               schema_name, None]
        cache[id(pk_list)] = ent
        while len(cache) > _KEY_RESOLVE_CACHE_MAX:
            cache.pop(next(iter(cache)))
        return ent

    @staticmethod
    def _grid_rows_ok(ent: list) -> bool:
        """True when the entry's resolved pids are pairwise distinct (the
        append_grid precondition: a duplicate part key would alias two
        rows onto one pid).  A fully resolved table memoizes the verdict;
        a table with quota holes (-1 slots) is checked on the kept keys
        per batch."""
        pids = ent[1]
        if (pids < 0).any():
            kept = pids[pids >= 0]
            return bool(np.unique(kept).size == kept.size)
        if ent[4] is None:
            ent[4] = bool(np.unique(pids).size == pids.size)
        return ent[4]

    def _create_missing(self, pk_list, schema_name: str,
                        pids_for_key: np.ndarray, need: np.ndarray,
                        first_ts) -> None:
        """Create partitions for key indices `need` whose pid slot is -1;
        `first_ts` maps key index -> first sample time (dict or array).
        A quota-rejected key keeps its -1 slot (its records drop and
        count) and is retried with the next batch."""
        for k in need.tolist():
            try:
                info = self.get_or_create_partition(
                    pk_list[k], schema_name, int(first_ts[k]))
            except QuotaReachedException:
                self.stats.quota_dropped += 1
                continue
            pids_for_key[k] = info.part_id

    def _keep_keys(self, pids_for_key: np.ndarray,
                   schema_name: str) -> Tuple[np.ndarray, np.ndarray]:
        """-> (keep, other) masks over a key table: `keep` the keys with a
        partition in this schema's store, `other` the keys whose partition
        lives in another schema's store (their samples are dropped: the
        store rows of one schema mean nothing in another's)."""
        resolved = pids_for_key >= 0
        if not self._pid_schema_code.size:
            return resolved, resolved
        same = self._pid_schema_code[np.where(resolved, pids_for_key, 0)] \
            == self._schema_code_of.get(schema_name, -1)
        return resolved & same, resolved & ~same

    @staticmethod
    def _grid_samples(batch: RecordBatch) -> int:
        """k if the batch is GRID-shaped — part_idx == repeat(arange(nk),
        k) — else 0."""
        nk = len(batch.part_keys)
        n = batch.num_records
        if nk == 0 or n % nk:
            return 0
        k = n // nk
        pi = batch.part_idx
        if k == 0 or pi[0] != 0 or pi[-1] != nk - 1:
            return 0
        pm = pi.reshape(nk, k)
        if not np.array_equal(pm[:, 0], np.arange(nk, dtype=pm.dtype)):
            return 0
        if k > 1 and not (pm[:, 1:] == pm[:, :1]).all():
            return 0
        return k

    def _ingest(self, batch: RecordBatch, offset: int = -1) -> int:
        if batch.num_records == 0:
            return 0
        store = self._store_for(batch.schema.name)
        # only keys actually referenced by records get partitions
        pk_list = batch.part_keys
        ent = self._resolve_key_table(pk_list, batch.schema.name)
        pids_for_key = ent[1]
        grid_k = self._grid_samples(batch)
        if grid_k:
            # grid batch: every key is referenced exactly k times in order,
            # so the store write is a rectangular scatter (append_grid)
            ts2d = batch.timestamps.reshape(-1, grid_k)
            unresolved = np.flatnonzero(pids_for_key < 0)
            if unresolved.size:
                # first_ts is indexed by key index: hand over the full
                # first-sample column (quota holes are a non-prefix subset)
                self._create_missing(pk_list, batch.schema.name,
                                     pids_for_key, unresolved, ts2d[:, 0])
                ent[4] = None
            if not self._grid_rows_ok(ent):
                grid_k = 0             # duplicate keys: flat path below
        if grid_k:
            if self._traced_pids:
                self._trace_touch_resolved(pids_for_key, offset)
            keep, other = self._keep_keys(pids_for_key, batch.schema.name)
            cols2d = {c: v.reshape((len(pk_list), grid_k) + v.shape[1:])
                      for c, v in batch.columns.items()}
            if keep.all():
                rows = self._pid_row[pids_for_key]
            else:
                self.stats.rows_dropped += int((~keep).sum()) * grid_k
                self.stats.schema_dropped += int(other.sum()) * grid_k
                rows = self._pid_row[pids_for_key[keep]]
                ts2d = ts2d[keep]
                cols2d = {c: v[keep] for c, v in cols2d.items()}
            n = store.append_grid(rows, ts2d, cols2d, batch.bucket_les)
            self.stats.rows_ingested += n
            self.stats.rows_dropped += ts2d.size - n
            self._account_ingest(pids_for_key[keep], grid_k)
            if offset >= 0:
                self.ingested_offset = offset
            return n
        uniq, first = np.unique(batch.part_idx, return_index=True)
        unresolved = uniq[pids_for_key[uniq] < 0]
        if unresolved.size:
            first_ts = dict(zip(uniq.tolist(),
                                batch.timestamps[first].tolist()))
            self._create_missing(pk_list, batch.schema.name, pids_for_key,
                                 unresolved, first_ts)
            ent[4] = None
        if self._traced_pids:
            touched = pids_for_key[uniq]
            traced_touched = [int(p) for p in touched[touched >= 0].tolist()
                              if int(p) in self._traced_pids]
            if traced_touched:
                self._trace_touch("ingest", traced_touched,
                                  extra=f" offset={offset}")
        keep_key, other = self._keep_keys(pids_for_key, batch.schema.name)
        pid_sel = pids_for_key[batch.part_idx]
        keep = keep_key[batch.part_idx]
        if not keep.all():
            self.stats.rows_dropped += int((~keep).sum())
            if other.any():
                self.stats.schema_dropped += int(other[batch.part_idx].sum())
            pid_sel = pid_sel[keep]
            batch = RecordBatch(batch.schema, batch.part_keys,
                                batch.part_idx[keep], batch.timestamps[keep],
                                {k: v[keep] for k, v in batch.columns.items()},
                                batch.bucket_les)
        rows = self._pid_row[pid_sel]
        n = store.append_batch(rows, batch.timestamps, batch.columns,
                               batch.bucket_les)
        self.stats.rows_ingested += n
        self.stats.rows_dropped += batch.num_records - n
        self._account_ingest(pid_sel, 1)
        if offset >= 0:
            self.ingested_offset = offset
        return n

    def _account_ingest(self, pids: np.ndarray, samples_per_key) -> None:
        """Per-tenant ingest attribution: one bincount over the batch's
        tenant ids.  `samples_per_key` is a scalar (grid paths: every key
        gained k cells) or a per-entry weight array.  Counts OFFERED
        samples on the kept keys: the tenant asked for that ingest work
        whether or not out-of-order rows were dropped."""
        if not self._usage_enabled or pids.size == 0 \
                or not self._tenant_names:
            return
        from filodb_tpu_torch.utils.usage import usage
        tids = self._pid_tenant[pids]
        n_t = len(self._tenant_names)
        if np.ndim(samples_per_key) == 0:
            cnt = np.bincount(tids, minlength=n_t) * samples_per_key
        else:
            cnt = np.bincount(tids, weights=samples_per_key, minlength=n_t)
        for tid in np.flatnonzero(cnt):
            ws, ns = self._tenant_names[tid]
            usage.record_ingest(ws, ns, int(cnt[tid]), dataset=self.dataset)

    def ingest_columns(self, schema_name: str, part_keys,
                       ts: np.ndarray, columns: Dict[str, np.ndarray],
                       offset: int = -1,
                       bucket_les: Optional[np.ndarray] = None) -> int:
        """Columnar ingest: `ts` [S, k] and each column [S, k] (or [S, k,
        B]) where row i belongs to part_keys[i] — every series gains the
        same k samples, written as rectangular slices of the per-schema
        store.  The same as ingest() of the equivalent flat batch: a slab
        with duplicate keys is flattened into one.  Returns samples
        ingested (out-of-order samples are dropped)."""
        ts = np.asarray(ts)
        if ts.ndim != 2 or len(part_keys) != ts.shape[0]:
            raise ValueError("ingest_columns: ts must be [num_keys, k]")
        faults.fire("ingest.batch")
        with self._write_locked("ingest"):
            if ts.size == 0:
                return 0
            store = self._store_for(schema_name)
            ent = self._resolve_key_table(part_keys, schema_name)
            pids_for_key = ent[1]
            unresolved = np.flatnonzero(pids_for_key < 0)
            if unresolved.size:
                self._create_missing(part_keys, schema_name, pids_for_key,
                                     unresolved, ts[:, 0])
                ent[4] = None
            if not self._grid_rows_ok(ent):
                # duplicate part keys: flatten to the per-record path,
                # which cumcounts duplicate rows correctly
                flat = RecordBatch.from_grid(self.schemas[schema_name],
                                             list(part_keys), ts, columns,
                                             bucket_les)
                return self._ingest(flat, offset)
            if self._traced_pids:
                self._trace_touch_resolved(pids_for_key, offset)
            keep, other = self._keep_keys(pids_for_key, schema_name)
            if keep.all():
                rows = self._pid_row[pids_for_key]
            else:
                self.stats.rows_dropped += int((~keep).sum()) * ts.shape[1]
                self.stats.schema_dropped += int(other.sum()) * ts.shape[1]
                rows = self._pid_row[pids_for_key[keep]]
                ts = ts[keep]
                columns = {c: v[keep] for c, v in columns.items()}
            n = store.append_grid(rows, ts, columns, bucket_les)
            self.stats.rows_ingested += n
            self.stats.rows_dropped += ts.size - n
            self._account_ingest(pids_for_key[keep], ts.shape[1])
            if offset >= 0:
                self.ingested_offset = offset
            return n

    # ------------------------------------------------------------- flush

    def flush_group(self, group: int, ingestion_time_ms: Optional[int] = None,
                    min_samples: int = 0) -> int:
        """Seal + persist unsealed samples for one flush group, then commit
        the group checkpoint.  Returns chunks written.

        min_samples > 0 batches like write buffers: partitions with fewer
        unsealed samples are left to accumulate; the group's checkpoint
        then only advances on fully-persisted rounds, and the group
        force-seals after 8 consecutive skipping rounds.  Direct calls
        (final flush, memory enforcement) seal everything."""
        ingestion_time_ms = ingestion_time_ms or int(time.time() * 1000)
        # flushes serialize against EACH OTHER here; the shard write lock
        # is held only for the brief copy and seal phases
        with self._flush_lock:
            return self._do_flush_group(group, ingestion_time_ms,
                                        min_samples)

    def _prune_tombstones(self, grace_s: float = 60.0,
                          max_prune: int = 8192) -> int:
        """Reclaim evicted partitions past the grace window (caller holds
        the write lock): their PartitionInfo, cached key and group
        membership are freed.  At most `max_prune` per call; the next
        flush continues the drain."""
        if not self._evicted_tombstones:
            return 0
        cutoff = time.time() - grace_s
        pruned = []
        while (self._evicted_tombstones
               and self._evicted_tombstones[0][0] <= cutoff
               and len(pruned) < max_prune):
            _, pid = self._evicted_tombstones.popleft()
            info = self.partitions[pid]
            if info is not None:
                glist = self._group_pids[info.group]
                if pid in glist:
                    glist.remove(pid)
            self.partitions[pid] = None
            self._rv_keys[pid] = None
            pruned.append(pid)
        if pruned:
            # pids may be recycled from here on
            self.keys_epoch += 1
            self._key_resolve_cache.clear()
        return len(pruned)

    def _encode_one(self, info: PartitionInfo, ts, cols, les,
                    ingestion_time_ms: int):
        schema = self.schemas[info.schema_name]
        col_types = {c.name: c.col_type for c in schema.data_columns}
        scheme = HistogramBuckets.custom(les) if les is not None else None
        return encode_chunkset(ts, cols, col_types, ingestion_time_ms,
                               scheme)

    def _encode_pending(self, pending, ingestion_time_ms: int) -> list:
        """Encode the copied flush slices into ChunkSets, in `pending`
        order.  Large groups split into per-worker slabs on the shared
        pool (numpy codec work drops the GIL); persist stays on the
        flush thread, whose ordering is part of the checkpoint
        contract."""
        if len(pending) < _ENCODE_MIN_PARALLEL:
            return [self._encode_one(info, ts, cols, les, ingestion_time_ms)
                    for _, info, _, ts, cols, les in pending]
        pool, workers = _encode_pool()

        def encode_slab(slab):
            return [self._encode_one(info, ts, cols, les, ingestion_time_ms)
                    for _, info, _, ts, cols, les in slab]

        step = (len(pending) + workers - 1) // workers
        slabs = [pending[i:i + step] for i in range(0, len(pending), step)]
        out: list = []
        for fut in [pool.submit(encode_slab, s) for s in slabs]:
            out.extend(fut.result())
        return out

    def _do_flush_group(self, group: int, ingestion_time_ms: int,
                        min_samples: int = 0) -> int:
        """Three phases: (1) under the write lock, copy every partition's
        unsealed slice; (2) without it, encode + persist; (3) under the
        write lock, advance the sealed watermarks and commit the
        checkpoint.  Sealing happens only after chunks are persisted, so
        eviction never reclaims samples whose stored copy does not exist
        yet.  If an eviction shifted a store's rows during phase 2
        (shift_version moved), its seals are skipped: the next flush
        re-reads and re-writes those slices (chunk writes are
        idempotent)."""
        pending = []
        with self._write_locked("flush_copy"):
            self._prune_tombstones()
            # the replay watermark BEFORE reading any data: the checkpoint
            # must never claim offsets whose samples this flush missed
            offset_snapshot = self.ingested_offset
            shift_snapshot = {name: st.shift_version
                              for name, st in self.stores.items()}
            seal_all = (min_samples <= 0
                        or self._group_skip_rounds[group] >= 7)
            skipped_any = False
            snap = [pid for pid in self._group_pids[group]
                    if self.partitions[pid] is not None
                    and self._pid_alive[pid]]
            for schema_name, store in self.stores.items():
                pids = [p for p in snap
                        if self.partitions[p].schema_name == schema_name]
                if not pids:
                    continue
                pids = np.asarray(pids, dtype=np.int64)
                rows = self._pid_row[pids]
                lo = store.sealed[rows].astype(np.int64)
                hi = store.counts[rows].astype(np.int64)
                sel = hi > lo
                if not seal_all:
                    big = sel & (hi - lo >= min_samples)
                    skipped_any = skipped_any or bool((sel & ~big).any())
                    sel = big
                if not sel.any():
                    continue
                pids, rows, lo, hi = pids[sel], rows[sel], lo[sel], hi[sel]
                les = store.bucket_les
                # batch gathers, one padded [R, Lmax] fancy-index per block
                # of rows; the padded matrices ARE the snapshot.  Blocks
                # keep R * Lmax * buckets under ~64 MB a column
                lens = hi - lo
                widest = max([1] + [store.num_buckets or 1
                                    for c in store.schema.data_columns
                                    if c.col_type == "hist"])
                max_cells = max(1, (1 << 23) // widest)
                start = 0
                R = len(pids)
                while start < R:
                    end = start + 1
                    lmax = int(lens[start])
                    while end < R:
                        nl = max(lmax, int(lens[end]))
                        if nl * (end - start + 1) > max_cells:
                            break
                        lmax = nl
                        end += 1
                    rs = rows[start:end]
                    posm = lo[start:end, None] + np.arange(lmax,
                                                           dtype=np.int64)
                    posc = np.minimum(posm, store.ts.shape[1] - 1)
                    ts_pad = store.ts[rs[:, None], posc]
                    col_pads = {}
                    for c in store.schema.data_columns:
                        arr = store.cols[c.name]
                        if arr is None:
                            col_pads[c.name] = None
                        elif arr.ndim == 3:
                            col_pads[c.name] = arr[rs[:, None], posc, :]
                        else:
                            col_pads[c.name] = arr[rs[:, None], posc]
                    for i in range(start, end):
                        pending.append((int(pids[i]),
                                        self.partitions[int(pids[i])],
                                        int(hi[i]), ts_pad, col_pads,
                                        les, i - start, int(lens[i])))
                    start = end
        # cut per-partition views from the padded snapshots (lock-free)
        pending = [
            (pid, info, hi_i,
             ts_pad[r, :ln],
             {name: (np.zeros((ln, 0)) if pad is None else pad[r, :ln])
              for name, pad in col_pads_.items()},
             les)
            for pid, info, hi_i, ts_pad, col_pads_, les, r, ln in pending]
        chunksets = self._encode_pending(pending, ingestion_time_ms)
        if pending:
            faults.fire("flush.persist")
        encoded = []
        for (pid, info, hi, ts, cols, les), cs in zip(pending, chunksets):
            self.column_store.write_chunks(
                self.dataset, self.shard_num, info.part_key, [cs],
                info.schema_name)
            if self.shard_downsampler is not None and len(ts):
                # downsample only samples past the per-partition TIME
                # watermark: a shift-skipped seal makes the next flush
                # re-read the same range, and chunk rewrites are idempotent
                # but downsample emission is NOT — without the watermark
                # those samples would double-count downstream
                wm = self._ds_time_wm.get(pid)
                if wm is None or ts[-1] > wm:
                    cut = int(np.searchsorted(ts, wm, side="right")) \
                        if wm is not None else 0
                    self.shard_downsampler.downsample(
                        info.part_key, self.schemas[info.schema_name],
                        ts[cut:], {k: v[cut:] for k, v in cols.items()},
                        bucket_les=les)
                    self._ds_time_wm[pid] = int(ts[-1])
            encoded.append((pid, info, hi, cs))
        dirty_pids: set = set()
        with self._write_locked("flush_seal"):
            for pid, info, hi, cs in encoded:
                store = self.stores[info.schema_name]
                if store.shift_version != shift_snapshot[info.schema_name]:
                    # rows shifted mid-flush: positions are stale — leave
                    # the watermark; the next flush re-covers this data
                    continue
                store.mark_sealed(info.row, hi)
                # the same encoded chunk stays resident in RAM: the dense
                # tier may drop these samples and re-page without disk
                self.resident.add(info.part_id, cs)
                dirty_pids.add(info.part_id)
            # partitions created in this group get their part key persisted
            # even before any data flush
            for pid in self._dirty_part_keys:
                info = self.partitions[pid]
                if info is not None and info.group == group:
                    dirty_pids.add(pid)
            self._dirty_part_keys -= dirty_pids
            dirty = [PartKeyRecord(self.partitions[pid].part_key,
                                   self.partitions[pid].schema_name,
                                   self.index.start_time(pid),
                                   self.index.end_time(pid))
                     for pid in sorted(dirty_pids)]
        if dirty:
            self.column_store.write_part_keys(self.dataset, self.shard_num,
                                              dirty)
        if skipped_any:
            # small partitions kept accumulating: their samples are not
            # persisted, so the checkpoint may only claim the last fully
            # persisted offset
            self._group_skip_rounds[group] += 1
            ckpt = self._group_ckpt_offset.get(group)
            if ckpt is not None:
                self.meta_store.write_checkpoint(
                    self.dataset, self.shard_num, group, ckpt)
        else:
            self._group_skip_rounds[group] = 0
            self._group_ckpt_offset[group] = offset_snapshot
            self.meta_store.write_checkpoint(
                self.dataset, self.shard_num, group, offset_snapshot)
        if self.cardinality_tracker is not None:
            # buffered cardinality updates persist with the checkpoint
            self.cardinality_tracker.flush()
        self.stats.chunks_flushed += len(encoded)
        self.stats.flushes += 1
        return len(encoded)

    def flush_all_groups(self) -> int:
        """Seal + persist everything (no write-buffer batching): the
        final-flush and memory-enforcement path."""
        return sum(self.flush_group(g) for g in range(self._groups))

    # ------------------------------------------------------------- query

    def snapshot_read(self, store: DenseSeriesStore, fn: Callable,
                      retries: int = 8):
        """Run fn() — a host read copying out of `store` — against a
        consistent snapshot: lock-free seqlock retry on the store's
        generation, then the write lock after `retries` torn reads."""
        for _ in range(retries):
            g0 = store.generation
            if g0 % 2:                      # mutation in progress
                time.sleep(0.0002)
                continue
            out = fn()
            if store.generation == g0:
                return out
        with self._write_locked("query_snapshot_fallback"):
            return fn()

    def lookup_partitions(self, filters: Sequence[ColumnFilter],
                          start_time_ms: int, end_time_ms: int,
                          limit: Optional[int] = None) -> PartLookupResult:
        """Index query + schema split, memoized per (filters, range,
        index.mutations, keys_epoch)."""
        try:
            ck = (tuple(filters), start_time_ms, end_time_ms, limit,
                  self.index.mutations, self.keys_epoch)
            hash(ck)
        except TypeError:             # filters with unhashable fields
            ck = None
        if ck is not None:
            hit = self._lookup_cache.pop(ck, None)
            if hit is not None:
                self._lookup_cache[ck] = hit          # LRU touch
                if self._traced_pids and hit.part_ids.size:
                    self._trace_touch("query_lookup", hit.part_ids)
                return hit
        ids = self.index.part_ids_from_filters(
            filters, start_time_ms, end_time_ms, limit)
        if ids.size:
            ids = ids[self._pid_alive[ids]]
        by_schema: Dict[str, np.ndarray] = {}
        first = None
        if ids.size:
            codes = self._pid_schema_code[ids]
            first = self._schema_names[int(codes[0])]
            for c in np.unique(codes):
                name = self._schema_names[int(c)]
                by_schema[name] = ids[codes == c]
        if self._traced_pids and ids.size:
            self._trace_touch("query_lookup", ids)
        res = PartLookupResult(self.shard_num, ids, by_schema, first, self)
        if ck is not None:
            # the memo hands the SAME arrays to every hit: freeze them
            ids.setflags(write=False)
            for arr in by_schema.values():
                arr.setflags(write=False)
            self._lookup_cache[ck] = res
            while len(self._lookup_cache) > _LOOKUP_CACHE_MAX:
                self._lookup_cache.pop(next(iter(self._lookup_cache)), None)
        return res

    def rows_for(self, pids: np.ndarray) -> np.ndarray:
        """Store rows for a pid array — vectorized pid->row map."""
        return self._pid_row[pids]

    def keys_for(self, pids: np.ndarray) -> List:
        """RangeVectorKeys for a pid array, built once per partition."""
        from filodb_tpu_torch.query.rangevector import RangeVectorKey
        rk = self._rv_keys
        parts = self.partitions
        out = []
        for pid in pids.tolist():
            k = rk[pid]
            if k is None:
                p = parts[pid]
                if p is None:
                    # pruned tombstone hit by a query older than the grace
                    # window: keep shape alignment with a sentinel key
                    k = RangeVectorKey((("_evicted_", str(pid)),))
                else:
                    k = RangeVectorKey.make(
                        {**p.part_key.tags_dict, "_metric_": p.part_key.metric})
                    rk[pid] = k
            out.append(k)
        return out

    # ------------------------------------------------------ demand paging

    def _decode_paged_chunks(self, store: DenseSeriesStore, chunks,
                             lo_excl: int, hi_incl: int,
                             max_samples: Optional[int] = None):
        """Decode + concatenate chunk data with ts in (lo_excl, hi_incl],
        dropping overlaps; histogram chunks of another bucket scheme widen
        the store to the union and are re-bucketed onto it.  Raises once
        more than max_samples decode — chunk-granular, so one partition
        with unbounded history cannot exhaust memory."""
        from filodb_tpu_torch.memory.chunks import decode_chunkset
        from filodb_tpu_torch.memory.histogram import rebucket
        hist_cols = {c.name for c in store.schema.data_columns
                     if c.col_type == "hist"}
        ts_parts, col_parts, part_les = [], [], []
        decoded_total = 0
        for cs in sorted(chunks, key=lambda c: c.info.start_time_ms):
            if max_samples is not None and decoded_total > max_samples:
                raise PagedLimitExceeded(max_samples, decoded_total, 1)
            decoded_total += cs.info.num_rows
            chunk_les = None
            if cs.bucket_scheme is not None:
                chunk_les = cs.bucket_scheme.as_array()
                try:
                    store.ensure_scheme(cs.bucket_scheme.num_buckets,
                                        chunk_les)
                except ValueError:
                    # a boundary-less store of another width: no mapping
                    # exists — skip this chunk, not the whole query
                    self.stats.rows_dropped += cs.info.num_rows
                    continue
            decoded = decode_chunkset(cs)
            ts = decoded.pop("timestamp")
            keep = (ts > lo_excl) & (ts <= hi_incl)
            if ts_parts:
                keep &= ts > ts_parts[-1][-1]     # chunks must not overlap
            if not keep.any():
                continue
            ts_parts.append(ts[keep])
            col_parts.append({k: v[keep] for k, v in decoded.items()})
            part_les.append(chunk_les)
        if not ts_parts:
            return None, None
        final_les = store.bucket_les
        if final_les is not None:
            for i, les in enumerate(part_les):
                if les is not None and not np.array_equal(les, final_les):
                    col_parts[i] = {k: (rebucket(v, les, final_les)
                                        if k in hist_cols else v)
                                    for k, v in col_parts[i].items()}
        return (np.concatenate(ts_parts),
                {k: np.concatenate([cp[k] for cp in col_parts])
                 for k in col_parts[0]})

    def _read_sealed_chunks(self, info: PartitionInfo, start_time_ms: int,
                            end_time_ms: int,
                            disk_chunks: Optional[list] = None) -> list:
        """Sealed chunks overlapping the range: the compressed RAM tier
        first, the column store only for history older than RAM retains.
        Duplicates are harmless: _decode_paged_chunks drops overlap.
        `disk_chunks`: a batched read_chunks_multi prefetch for this
        range, used instead of a per-partition store read."""
        chunks = self.resident.read(info.part_id, start_time_ms, end_time_ms)
        floor = self.resident.coverage_floor(info.part_id)
        ram_covers = (floor is not None and floor <= start_time_ms
                      and bool(chunks))
        if not ram_covers and not isinstance(self.column_store,
                                             NullColumnStore):
            if disk_chunks is None:
                disk_chunks = list(self.column_store.read_chunks(
                    self.dataset, self.shard_num, info.part_key,
                    start_time_ms, end_time_ms))
            chunks = list(disk_chunks) + chunks
        return chunks

    def ensure_paged_pids(self, schema_name: str, pids: np.ndarray,
                          start_time_ms: int, end_time_ms: int,
                          max_samples: Optional[int] = None) -> int:
        """Vectorized ensure_paged precheck: numpy over the whole pid
        array finds which pids need paging, and the per-partition paging
        loop runs only on that (usually empty) subset."""
        if ((isinstance(self.column_store, NullColumnStore)
                and self.resident.num_chunks == 0) or pids.size == 0):
            return 0
        store = self.stores[schema_name]
        rows = self._pid_row[pids]
        cnt = store.counts[rows]
        if store.ts.shape[1] == 0:
            first_mem = np.full(rows.shape, MAX_TIME, dtype=np.int64)
            last_mem = np.zeros(rows.shape, dtype=np.int64)
        else:
            first_mem = np.where(cnt > 0, store.ts[rows, 0], MAX_TIME)
            last_mem = np.where(
                cnt > 0, store.ts[rows, np.maximum(cnt - 1, 0)], 0)
        covered = np.minimum(store.paged_floor[rows], first_mem)
        need = start_time_ms < covered
        page_only = store.page_only[rows]
        need |= (page_only & (cnt > 0)
                 & (end_time_ms > np.maximum(store.paged_ceil[rows], last_mem)))
        if not need.any():
            return 0
        parts = [self.partitions[p] for p in np.asarray(pids)[need].tolist()]
        with self._write_locked("demand_paging"):
            return self.ensure_paged(parts, start_time_ms, end_time_ms,
                                     max_samples=max_samples)

    def ensure_paged(self, parts: Sequence[PartitionInfo],
                     start_time_ms: int, end_time_ms: int,
                     max_samples: Optional[int] = None) -> int:
        """On-demand paging: load sealed chunks not in the dense tier so
        the query sees full history.  Coverage bookkeeping lives in the
        store (per-row paged_floor/paged_ceil), so eviction invalidates
        it.  Two directions: below the in-memory data (prepend) and, for
        page-only rows (no live appends), above it too.  Returns samples
        paged."""
        if (isinstance(self.column_store, NullColumnStore)
                and self.resident.num_chunks == 0):
            return 0
        # one read_chunks_multi for every partition whose below-floor range
        # needs the column store, not a round trip per partition
        prefetch: Dict[int, list] = {}
        if not isinstance(self.column_store, NullColumnStore):
            reqs, req_pids = [], []
            for info in parts:
                store = self.stores[info.schema_name]
                row = info.row
                cnt = int(store.counts[row])
                first_mem = int(store.ts[row, 0]) if cnt else MAX_TIME
                covered = min(int(store.paged_floor[row]), first_mem)
                if start_time_ms >= covered:
                    continue
                hi = end_time_ms if cnt == 0 else first_mem - 1
                if hi < start_time_ms:
                    continue
                floor = self.resident.coverage_floor(info.part_id)
                if floor is not None and floor <= start_time_ms:
                    continue            # the RAM tier likely covers it
                reqs.append((info.part_key, start_time_ms, hi))
                req_pids.append(info.part_id)
            if reqs:
                for pid, chunks in zip(req_pids,
                                       self.column_store.read_chunks_multi(
                                           self.dataset, self.shard_num,
                                           reqs)):
                    prefetch[pid] = chunks
        paged = 0
        parts_paged = 0
        for info in parts:
            # abort BEFORE materializing more history than the query may
            # scan; work already done is kept as valid cache
            if max_samples is not None and paged > max_samples:
                raise PagedLimitExceeded(max_samples, paged, parts_paged)
            store = self.stores[info.schema_name]
            row = info.row
            cnt = int(store.counts[row])
            floor = int(store.paged_floor[row])
            first_mem = int(store.ts[row, 0]) if cnt else MAX_TIME
            if start_time_ms < min(floor, first_mem):
                # non-empty rows page all the way up to the in-memory
                # floor, so the resident region stays contiguous; empty
                # rows clamp to the query range
                hi = end_time_ms if cnt == 0 else first_mem - 1
                if hi >= start_time_ms:
                    chunks = self._read_sealed_chunks(
                        info, start_time_ms, hi,
                        disk_chunks=prefetch.get(info.part_id))
                    try:
                        ts_all, cols_all = self._decode_paged_chunks(
                            store, chunks, start_time_ms - 1, hi,
                            max_samples=(None if max_samples is None
                                         else max_samples - paged))
                    except PagedLimitExceeded as e:
                        raise PagedLimitExceeded(
                            max_samples, paged + e.samples_paged,
                            parts_paged) from None
                    if ts_all is not None:
                        n = store.prepend_row(row, ts_all, cols_all)
                        paged += n
                        if n:
                            parts_paged += 1
                        # a trimmed page-in must not claim full coverage
                        if n == len(ts_all):
                            store.paged_floor[row] = start_time_ms
                        elif n > 0:
                            store.paged_floor[row] = int(store.ts[row, 0])
                    else:
                        store.paged_floor[row] = start_time_ms
                    if cnt == 0 and store.page_only[row]:
                        store.paged_ceil[row] = max(
                            int(store.paged_ceil[row]), hi)
            # upper paging: only for rows that never saw live ingest
            if store.page_only[row] and int(store.counts[row]) > 0:
                last_mem = int(store.ts[row, int(store.counts[row]) - 1])
                ceil = max(int(store.paged_ceil[row]), last_mem)
                if end_time_ms > ceil:
                    chunks = self._read_sealed_chunks(info, ceil + 1,
                                                      end_time_ms)
                    try:
                        ts_all, cols_all = self._decode_paged_chunks(
                            store, chunks, last_mem, end_time_ms,
                            max_samples=(None if max_samples is None
                                         else max_samples - paged))
                    except PagedLimitExceeded as e:
                        raise PagedLimitExceeded(
                            max_samples, paged + e.samples_paged,
                            parts_paged) from None
                    if ts_all is not None:
                        n = store.append_row(row, ts_all, cols_all)
                        paged += n
                        if n:
                            parts_paged += 1
                        if n == len(ts_all):
                            store.paged_ceil[row] = end_time_ms
                        elif n > 0:
                            store.paged_ceil[row] = int(
                                store.ts[row, int(store.counts[row]) - 1])
                    else:
                        store.paged_ceil[row] = end_time_ms
        return paged

    # ---------------------------------------------------------- recovery

    def recover_index(self) -> int:
        """Rebuild the tag index and the partition registry from the
        persisted part keys; returns the partitions recovered.  Their
        samples stay in the column store until a query pages them in."""
        n = 0
        for rec in self.column_store.read_part_keys(self.dataset,
                                                    self.shard_num):
            try:
                info = self.get_or_create_partition(
                    rec.part_key, rec.schema_name, rec.start_time_ms)
            except QuotaReachedException:
                self.stats.quota_dropped += 1
                continue
            if rec.end_time_ms < MAX_TIME:
                self.index.update_end_time(info.part_id, rec.end_time_ms)
            n += 1
        return n

    def recover_stream(self, batches: Iterable[Tuple[RecordBatch, int]]
                       ) -> int:
        """Replay (batch, offset) pairs, skipping each record whose flush
        group's checkpoint is at or past the offset; returns samples
        ingested."""
        checkpoints = self.meta_store.read_checkpoints(self.dataset,
                                                       self.shard_num)
        n = 0
        for batch, offset in batches:
            if not checkpoints:
                n += self.ingest(batch, offset)
                continue
            # the group is a pure function of the part key's hash, so the
            # filter holds for partitions not yet recreated too
            group_by_key = np.asarray(
                [self.group_for(pk) for pk in batch.part_keys],
                dtype=np.int64)
            wm = np.full(self._groups, -1, dtype=np.int64)
            for g, off in checkpoints.items():
                wm[g] = off
            keep = wm[group_by_key[batch.part_idx]] < offset
            if keep.all():
                n += self.ingest(batch, offset)
            elif keep.any():
                sub = RecordBatch(
                    batch.schema, batch.part_keys, batch.part_idx[keep],
                    batch.timestamps[keep],
                    {k: v[keep] for k, v in batch.columns.items()},
                    batch.bucket_les)
                n += self.ingest(sub, offset)
        return n

    def compact_index(self, tombstone_threshold: int = 0) -> bool:
        """Prune the tag index's tombstoned postings under the shard write
        lock (compaction swaps the index's state and rewrites posting
        containers, so it must not race ingest or eviction).  With a
        threshold it compacts only once the backlog crossed it; returns
        whether a compaction ran."""
        with self._write_locked("index_compaction"):
            if tombstone_threshold:
                return self.index.maybe_compact(tombstone_threshold)
            if self.index.tombstone_count == 0:
                return False
            self.index.compact()
            return True

    # ------------------------------------------------------------ memory

    def memory_usage(self) -> Dict[str, int]:
        """Byte accounting across the dense and resident tiers."""
        dense = sum(s.nbytes for s in self.stores.values())
        return {"dense_bytes": dense,
                "resident_bytes": self.resident.bytes_used,
                "total_bytes": dense + self.resident.bytes_used}

    def enforce_memory(self, budget_bytes: Optional[int] = None,
                       active_tail_rows: Optional[int] = None) -> int:
        """Headroom enforcement: when the dense tier exceeds its budget,
        seal everything via flush, then truncate each series to the
        active tail and release the freed time capacity.  Sealed history
        stays queryable from the resident tier (RAM) or the column store
        through ensure_paged.  Returns bytes released."""
        budget = (budget_bytes if budget_bytes is not None
                  else SHARD_MEM_SIZE)
        tail = (active_tail_rows if active_tail_rows is not None
                else ACTIVE_TAIL_ROWS)
        return self._enforce_memory(budget, tail)

    def _enforce_memory(self, budget: int, tail: int) -> int:
        if sum(s.nbytes for s in self.stores.values()) <= budget:
            return 0
        self.eviction_in_progress = True
        try:
            # seal everything OUTSIDE the write lock (flush manages its own
            # lock phases); racing ingest between flush and truncation is
            # safe: evict_oldest only drops SEALED samples
            self.flush_all_groups()
            released = 0
            with self._write_locked("enforce_memory"):
                for store in self.stores.values():
                    if store.num_series == 0:
                        continue
                    excess = np.maximum(store.counts - tail, 0)
                    if excess.any():
                        store.evict_oldest(excess)
                    released += store.compact_time(slack=max(8, tail // 4))
            self.stats.evictions += 1
            return released
        finally:
            self.eviction_in_progress = False

    def evict_ended_partitions(self, before_ms: int,
                               max_per_lock: int = 2048) -> int:
        """Evict partitions whose series ended before `before_ms`.
        Candidates come from one vectorized index sweep; the teardown runs
        in increments of `max_per_lock`, releasing the write lock between
        them so a mass expiry cannot stall ingest and queries.  Evicted
        pids join the tombstone queue; _prune_tombstones reclaims them
        after the reader grace period."""
        self.eviction_in_progress = True
        try:
            total = 0
            while True:
                with self._write_locked("evict_ended"):
                    cand = self.index.ended_pids(before_ms)
                    evicted = 0
                    for pid in cand[:max_per_lock].tolist():
                        info = self.partitions[pid]
                        if info is None or not self._pid_alive[pid]:
                            continue
                        self.index.remove_partition(pid)
                        self.part_set.pop(info.part_key.to_bytes(), None)
                        # the PartitionInfo stays as a tombstone: lock-free
                        # readers that passed the _pid_alive filter may
                        # still deref partitions[pid]
                        self._pid_alive[pid] = False
                        self._evicted_tombstones.append((time.time(), pid))
                        self.resident.drop_part(pid)
                        self._series_stopped(info.part_key)
                        evicted += 1
                        self.stats.evictions += 1
                    if evicted:
                        # evicted keys left part_set: cached key->pid
                        # resolutions must not outlive them
                        self.keys_epoch += 1
                        self._key_resolve_cache.clear()
                    total += evicted
                    if cand.size <= max_per_lock:
                        return total
        finally:
            self.eviction_in_progress = False

    def _shard_key_tuple(self, part_key: PartKey) -> Tuple[str, ...]:
        """The tracker's key: the shard-key columns' values in order."""
        sk = part_key.shard_key(self.schemas.part)
        return tuple(sk.get(c, "")
                     for c in self.schemas.part.options.shard_key_columns)

    def _series_stopped(self, part_key: PartKey) -> None:
        """An evicted series leaves the tracker's active counts and its
        workspace's series budget."""
        if self.cardinality_tracker is not None:
            self.cardinality_tracker.series_stopped(
                self._shard_key_tuple(part_key))
        if self._tenant_series_limit:
            ws = part_key.tags_dict.get("_ws_", "")
            if ws:
                n = self._ws_series.get(ws, 0) - 1
                if n > 0:
                    self._ws_series[ws] = n
                else:
                    self._ws_series.pop(ws, None)

    def append_horizon_ms(self) -> int:
        """Largest timestamp T such that every FUTURE append lands strictly
        after T: the min over rows of each row's newest sample (ingest
        drops out-of-order samples against last_ts, so appends only move
        forward).  The query frontend's result cache treats windows ending
        at or before T as immutable.  A registered row with no samples
        accepts any timestamp, so its presence collapses the horizon to
        NO_HORIZON_MS (series-set changes are tracked separately through
        keys_epoch and index.mutations).  Memoized per store generation;
        a scan torn by a concurrent mutation still lower-bounds each row's
        future appends, and the memo heals on the next generation."""
        horizon = None
        # list(): lock-free on query threads while ingest may add a store
        for name, store in list(self.stores.items()):
            s = store.num_series
            if s == 0:
                continue
            gen = store.generation
            memo = self._horizon_memo.get(name)
            if memo is not None and memo[0] == gen:
                h = memo[1]
            else:
                h = (NO_HORIZON_MS if (store.counts[:s] == 0).any()
                     else int(store.last_ts[:s].min()))
                self._horizon_memo[name] = (gen, h)
            horizon = h if horizon is None else min(horizon, h)
        return horizon if horizon is not None else NO_HORIZON_MS

    @property
    def num_partitions(self) -> int:
        return int(self._pid_alive[:len(self.partitions)].sum())
