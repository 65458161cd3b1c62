"""TimeSeriesShard, trimmed to what the query slice needs (port of
filodb_tpu/core/shard.py).

Kept: partition creation and the key-table cache, the columnar grid
ingest (`ingest_columns`), index lookup, the pid->row and pid->key maps,
and the seqlock snapshot read.  Left out: flush and persistence, demand
paging, eviction, quotas and tenant budgets, per-series tracing and
fault injection.  Host arrays stay numpy; the device copy is the
DeviceMirror's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from filodb_tpu_torch.core.blockstore import DenseSeriesStore
from filodb_tpu_torch.core.index import ColumnFilter, PartKeyIndex
from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, Schemas
from filodb_tpu_torch.utils.growable import grow_to as _grow_to

_log = logging.getLogger("filodb.shard")

_SHARD_KEYS_SERIAL = itertools.count(1)  # see TimeSeriesShard.keys_serial
_KEY_RESOLVE_CACHE_MAX = 4               # live key tables per shard (schemas)
_LOOKUP_CACHE_MAX = 32                   # memoized lookup_partitions results


@dataclasses.dataclass
class PartitionInfo:
    """Lightweight partition record; heavy state lives in the store row."""
    part_id: int
    part_key: PartKey
    schema_name: str
    row: int                      # row in the schema's DenseSeriesStore


@dataclasses.dataclass
class ShardStats:
    rows_ingested: int = 0
    partitions_created: int = 0
    rows_dropped: int = 0


@dataclasses.dataclass
class PartLookupResult:
    """Vectorized lookup result: pids per schema."""
    shard: int
    part_ids: np.ndarray
    pids_by_schema: Dict[str, np.ndarray]
    first_schema: Optional[str]
    # the leaf's scan estimates over this lookup's rows and time range,
    # memoized with it: (schema, store generation) -> samples
    scan_estimates: Dict = dataclasses.field(default_factory=dict,
                                             repr=False, compare=False)


class TimeSeriesShard:

    def __init__(self, dataset: str, shard_num: int,
                 schemas: Schemas = DEFAULT_SCHEMAS, device=None):
        self.dataset = dataset
        self.shard_num = shard_num
        self.schemas = schemas
        # where this shard's DeviceMirror lives (the memstore's device)
        self.device = device
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
        # serial + an epoch (bumped if a pid's key mapping could change)
        self.keys_serial = next(_SHARD_KEYS_SERIAL)
        self.keys_epoch = 0
        # key-table resolution cache: id -> [list ref, pids, epoch, schema,
        # grid_ok]; streaming sources reuse one part_keys list per slab
        self._key_resolve_cache: Dict[int, list] = {}
        self._lookup_cache: Dict[tuple, PartLookupResult] = {}
        self.stores: Dict[str, DenseSeriesStore] = {}
        self.stats = ShardStats()
        # writer mutex: ingest and mirror refresh serialize here; queries
        # read through snapshot_read's seqlock retry instead
        self.write_lock = threading.RLock()

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
        pid = len(self.partitions)
        store = self._store_for(schema_name)
        info = PartitionInfo(pid, part_key, schema_name, store.new_row())
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
        self._rv_keys.append(None)
        self.part_set[kb] = pid
        self.index.add_partition(pid, part_key, start_time_ms)
        self.stats.partitions_created += 1
        return info

    def _resolve_key_table(self, pk_list, schema_name: str) -> list:
        """Cached key-table -> pid resolution entry [pk_list, pids, epoch,
        schema, grid_ok] (pid entries -1 until a partition exists)."""
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
        """True when the entry's resolved pids are pairwise distinct."""
        if ent[4] is None:
            pids = ent[1]
            ent[4] = bool(np.unique(pids).size == pids.size)
        return ent[4]

    def _create_missing(self, pk_list, schema_name: str,
                        pids_for_key: np.ndarray, need: np.ndarray,
                        first_ts) -> None:
        """Create partitions for key indices `need` whose pid slot is -1."""
        for k in need.tolist():
            info = self.get_or_create_partition(
                pk_list[k], schema_name, int(first_ts[k]))
            pids_for_key[k] = info.part_id

    def ingest_columns(self, schema_name: str, part_keys,
                       ts: np.ndarray, columns: Dict[str, np.ndarray],
                       offset: int = -1,
                       bucket_les: Optional[np.ndarray] = None) -> int:
        """Columnar ingest: `ts` [S, k] and each column [S, k] where row i
        belongs to part_keys[i] — every series gains the same k samples,
        written as rectangular slices of the per-schema store.  Returns
        samples ingested (out-of-order samples are dropped)."""
        del offset
        ts = np.asarray(ts)
        if ts.ndim != 2 or len(part_keys) != ts.shape[0]:
            raise ValueError("ingest_columns: ts must be [num_keys, k]")
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
                raise ValueError(
                    "not_ported: duplicate part keys in one columnar slab "
                    "(the per-record ingest path)")
            rows = self._pid_row[pids_for_key]
            n = store.append_grid(rows, ts, columns, bucket_les)
            self.stats.rows_ingested += n
            self.stats.rows_dropped += ts.size - n
            return n

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
        res = PartLookupResult(self.shard_num, ids, by_schema, first)
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
                k = RangeVectorKey.make(
                    {**p.part_key.tags_dict, "_metric_": p.part_key.metric})
                rk[pid] = k
            out.append(k)
        return out
