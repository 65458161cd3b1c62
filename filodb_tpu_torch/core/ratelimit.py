"""Cardinality tracking + quota enforcement
(port of filodb_tpu/core/ratelimit.py).

Mirrors the reference's ratelimit package (ref:
core/.../memstore/ratelimit/CardinalityTracker.scala:191 area,
RocksDbCardinalityStore.scala:256 area, QuotaSource.scala):

  - per-shard series counts are tracked at every shard-key-prefix depth:
    () , (ws,) , (ws,ns) , (ws,ns,metric)
  - each prefix carries a quota; creating a series that would push any
    prefix past its quota raises QuotaReachedException, which the ingest
    path turns into a dropped record + counter
  - topk children by count at any depth answers the `topkcard` CLI and
    cardinality API

The RocksDB JNI store maps to sqlite3 (stdlib embedded KV) for durability,
with a dict-backed store for tests/benchmarks.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

Prefix = Tuple[str, ...]


@dataclasses.dataclass
class CardinalityRecord:
    """ref: ratelimit/CardinalityStore CardinalityRecord."""
    prefix: Prefix
    ts_count: int = 0               # total series ever tracked under prefix
    active_ts_count: int = 0        # currently-ingesting series
    children_count: int = 0         # distinct child prefixes
    children_quota: int = 0


class QuotaReachedException(Exception):
    def __init__(self, prefix: Prefix, quota: int):
        super().__init__(f"cardinality quota {quota} reached at prefix "
                         f"{prefix!r}")
        self.prefix = prefix
        self.quota = quota


class TenantBudgetExceeded(QuotaReachedException):
    """A workspace hit `index.tenant_series_limit` alive series on one
    shard.  Subclasses QuotaReachedException so every existing drop site
    (ingest _create_missing, WAL/index recovery) handles the structured
    rejection unchanged — the series' records are dropped and counted,
    never half-created."""

    def __init__(self, ws: str, limit: int, alive: int):
        # deliberately skip QuotaReachedException.__init__: the budget is
        # per-workspace, not per shard-key prefix
        Exception.__init__(
            self, f"tenant_series_budget_exceeded: ws={ws!r} holds "
                  f"{alive} alive series on this shard, over the "
                  f"index.tenant_series_limit {limit}")
        self.prefix = (ws,)
        self.quota = limit
        self.ws = ws
        self.alive = alive


class QuotaSource:
    """Default + override quotas per prefix (ref: QuotaSource.scala)."""

    def __init__(self, default_quota: int = 2_000_000_000):
        self.default_quota = default_quota
        self._overrides: Dict[Prefix, int] = {}

    def set_quota(self, prefix: Prefix, quota: int) -> None:
        self._overrides[tuple(prefix)] = quota

    def quota_for(self, prefix: Prefix) -> int:
        return self._overrides.get(tuple(prefix), self.default_quota)


class CardinalityStore:
    """ref: ratelimit/CardinalityStore trait."""

    def read(self, prefix: Prefix) -> Optional[CardinalityRecord]:
        raise NotImplementedError

    def write(self, record: CardinalityRecord) -> None:
        raise NotImplementedError

    def scan_children(self, prefix: Prefix) -> List[CardinalityRecord]:
        raise NotImplementedError

    def flush(self) -> None:
        """Persist buffered writes (no-op for unbuffered stores)."""

    def close(self) -> None:
        pass


class InMemoryCardinalityStore(CardinalityStore):

    def __init__(self):
        self._recs: Dict[Prefix, CardinalityRecord] = {}

    def read(self, prefix):
        return self._recs.get(tuple(prefix))

    def write(self, record):
        self._recs[tuple(record.prefix)] = record

    def scan_children(self, prefix):
        prefix = tuple(prefix)
        d = len(prefix) + 1
        return [r for p, r in self._recs.items()
                if len(p) == d and p[:len(prefix)] == prefix]


class SqliteCardinalityStore(CardinalityStore):
    """Durable store on stdlib sqlite3 (the RocksDB-JNI stand-in,
    ref: RocksDbCardinalityStore.scala:256 area — RocksDB batches through
    its memtable + WAL; a commit-per-write here serialized every series
    creation on fsync).

    Writes land in a write-back buffer (the memtable analogue) and flush
    to SQLite in ONE transaction every `flush_every` dirty prefixes, on
    `flush()`, and on close; the database runs in WAL mode so the flush
    itself doesn't block readers.  Durability contract: records buffered
    since the last flush are lost on a crash — the shard flush cycle
    flushes this store alongside its chunk checkpoints, and recovery
    rebuilds cardinality from the index bootstrap anyway."""

    _SEP = "\x1e"

    def __init__(self, path: str, flush_every: int = 1024):
        import sqlite3
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        self.flush_every = flush_every
        self._dirty: Dict[Prefix, CardinalityRecord] = {}
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS card (prefix TEXT PRIMARY KEY, "
            "depth INTEGER, ts INTEGER, active INTEGER, children INTEGER, "
            "quota INTEGER)")
        self._conn.commit()

    def _key(self, prefix: Prefix) -> str:
        # depth prefixes the key: () and ("",) must not collide
        return f"{len(prefix)}{self._SEP}{self._SEP.join(prefix)}"

    def read(self, prefix):
        prefix = tuple(prefix)
        with self._lock:
            rec = self._dirty.get(prefix)
            if rec is not None:
                return dataclasses.replace(rec)
            row = self._conn.execute(
                "SELECT ts, active, children, quota FROM card "
                "WHERE prefix = ?", (self._key(prefix),)).fetchone()
        if row is None:
            return None
        return CardinalityRecord(prefix, *row)

    def write(self, record):
        with self._lock:
            self._dirty[tuple(record.prefix)] = dataclasses.replace(record)
            if len(self._dirty) >= self.flush_every:
                self._flush_locked()

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._dirty:
            return
        self._conn.executemany(
            "INSERT OR REPLACE INTO card VALUES (?,?,?,?,?,?)",
            [(self._key(r.prefix), len(r.prefix), r.ts_count,
              r.active_ts_count, r.children_count, r.children_quota)
             for r in self._dirty.values()])
        self._conn.commit()
        self._dirty.clear()

    def scan_children(self, prefix):
        prefix = tuple(prefix)
        # PK range scan: child keys sort contiguously under
        # "<depth+1><SEP><prefix...><SEP>" because SEP (0x1e) orders below
        # 0x1f — O(children) via the primary-key index instead of scanning
        # every same-depth row (millions at the quota-metering scale)
        base = f"{len(prefix) + 1}{self._SEP}"
        if prefix:
            base += self._SEP.join(prefix) + self._SEP
        with self._lock:
            self._flush_locked()         # scans must see buffered writes
            # upper bound: bump the trailing SEP to SEP+1 so EVERY
            # continuation of `base` (any child name, any codepoint)
            # sorts inside the range
            rows = self._conn.execute(
                "SELECT prefix, ts, active, children, quota FROM card "
                "WHERE prefix >= ? AND prefix < ?",
                (base, base[:-1] + "\x1f")).fetchall()
        out = []
        for key, ts, active, children, quota in rows:
            parts = key.split(self._SEP)
            p = tuple(parts[1:]) if len(parts) > 1 else ()
            if len(p) == len(prefix) + 1 and p[:len(prefix)] == prefix:
                out.append(CardinalityRecord(p, ts, active, children, quota))
        return out

    def close(self):
        self.flush()
        self._conn.close()


class CardinalityTracker:
    """Tracks counts at every prefix depth and enforces quotas
    (ref: CardinalityTracker.scala:191 area)."""

    def __init__(self, shard_key_len: int = 3,
                 store: Optional[CardinalityStore] = None,
                 quota_source: Optional[QuotaSource] = None):
        self.shard_key_len = shard_key_len
        self.store = store or InMemoryCardinalityStore()
        self.quotas = quota_source or QuotaSource()
        self._lock = threading.Lock()

    # ---------------------------------------------------------- mutation

    def series_created(self, shard_key: Sequence[str]) -> None:
        """Called when a new series appears; raises QuotaReachedException
        BEFORE recording if any prefix level would exceed its quota
        (ref: CardinalityTracker.modifyCount)."""
        shard_key = tuple(shard_key)[:self.shard_key_len]
        with self._lock:
            recs = []
            for d in range(len(shard_key) + 1):
                prefix = shard_key[:d]
                rec = self.store.read(prefix) or CardinalityRecord(
                    prefix, children_quota=self.quotas.quota_for(prefix))
                quota = self.quotas.quota_for(prefix)
                if rec.ts_count + 1 > quota:
                    raise QuotaReachedException(prefix, quota)
                recs.append(rec)
            for d, rec in enumerate(recs):
                if d < len(recs) - 1 and recs[d + 1].ts_count == 0:
                    # child prefix transitions 0 -> 1: one more child
                    rec.children_count += 1
                rec.ts_count += 1
                rec.active_ts_count += 1
                self.store.write(rec)

    def series_stopped(self, shard_key: Sequence[str]) -> None:
        """Decrement on eviction: the series left the shard, so both counts
        drop — re-ingestion of the same series re-increments, keeping quota
        accounting churn-proof (ref: CardinalityTracker.modifyCount with
        negative deltas on partKey removal)."""
        shard_key = tuple(shard_key)[:self.shard_key_len]
        with self._lock:
            recs = [self.store.read(shard_key[:d])
                    for d in range(len(shard_key) + 1)]
            for d, rec in enumerate(recs):
                if rec is None:
                    continue
                child = recs[d + 1] if d < len(recs) - 1 else None
                if child is not None and child.ts_count == 1:
                    # child prefix transitions 1 -> 0: one fewer child
                    rec.children_count = max(rec.children_count - 1, 0)
                rec.ts_count = max(rec.ts_count - 1, 0)
                rec.active_ts_count = max(rec.active_ts_count - 1, 0)
                self.store.write(rec)

    def set_quota(self, prefix: Sequence[str], quota: int) -> None:
        self.quotas.set_quota(tuple(prefix), quota)
        rec = self.store.read(tuple(prefix))
        if rec is not None:
            rec.children_quota = quota
            self.store.write(rec)

    # ------------------------------------------------------------- queries

    def cardinality(self, prefix: Sequence[str]) -> Optional[CardinalityRecord]:
        return self.store.read(tuple(prefix))

    def children(self, prefix: Sequence[str]) -> List[CardinalityRecord]:
        """ALL child prefixes — cross-shard aggregation must merge full
        lists, not per-shard top-k truncations."""
        return self.store.scan_children(tuple(prefix))

    def flush(self) -> None:
        """Persist buffered cardinality updates — called by the shard's
        flush cycle next to the chunk checkpoint commit."""
        self.store.flush()

    def top_k(self, prefix: Sequence[str], k: int = 10,
              by_active: bool = False) -> List[CardinalityRecord]:
        """Largest child prefixes under `prefix`
        (ref: CardinalityTracker.topk, CliMain topkcard)."""
        kids = self.children(prefix)
        key = (lambda r: r.active_ts_count) if by_active \
            else (lambda r: r.ts_count)
        return sorted(kids, key=key, reverse=True)[:k]
