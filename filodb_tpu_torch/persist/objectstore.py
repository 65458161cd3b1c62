"""Shared object-store segment tier, the disaggregated cold layer (port
of filodb_tpu/persist/objectstore.py; keys, objects and manifests are
the reference's to the byte, so either package reads a bucket the other
wrote).

The reference persists chunks to Cassandra behind `ColumnStore` precisely
so a node is disposable (PAPER.md §1); the segment tier
(persist/segments.py) lives on node-local disk, which makes a dead disk
silently lose every closed window the node owned.  This module adds the
shared tier:

    LocalObjectStore      put/get/list over a shared directory (the
                          S3/GCS stand-in every node can mount), with
                          `objectstore.*` fault points and a per-store
                          circuit breaker so a dead store fails fast
    content addressing    segment objects keyed by sha256 of the payload
                          — immutable, dedupable (RF-2 peers uploading
                          the same window write ONE copy), and get()
                          verifies the hash so corruption can never be
                          served as data
    ShardManifest         the compacted per-(dataset, shard) catalog of
                          uploaded windows: CRC-framed, atomically
                          swapped with a `.prev` generation kept for
                          torn-write recovery
    SegmentUploader       the `segment_upload` job: sweeps the local
                          SegmentStore, uploads windows missing/stale in
                          the manifest with exponential backoff +
                          jitter, dedupes across replicas through the
                          shard mapper (only the shard's first live
                          owner uploads), and gates raw-chunk retention
                          on upload acks (durability ordering)
    restore_from_objectstore
                          manifest-driven node rebuild: a replacement
                          node refetches every manifested segment it
                          does not hold, then the ordinary WAL tail
                          (replication/catchup.py) covers the raw edge
    RemoteSegmentStore    the SegmentStore-shaped read view for
                          STATELESS query-only nodes: manifests mounted
                          with a TTL, segments paged straight from the
                          object store through the same PersistedTier /
                          ColdSegmentCache machinery — zero owned
                          shards, elastic read capacity

Degrade, not hang: every store operation either succeeds, raises a typed
`ObjectStoreUnavailable` (breaker open / IO failure), or raises
`ObjectStoreCorruption` (hash/CRC mismatch).  The cold leaf exec maps
these to the typed `shard_unavailable` QueryError, so a dead object
store degrades cold scans to FLAGGED partials through the partial-result
gate.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import random
import socket
import struct
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from filodb_tpu_torch.utils.faults import InjectedFault, faults

_log = logging.getLogger("filodb.objectstore")

_MAGIC_MANIFEST = 0xF1D03A2F
_MANIFEST_VERSION = 1


class ObjectStoreError(RuntimeError):
    """Base of the typed object-store failure surface."""


class ObjectStoreUnavailable(ObjectStoreError):
    """The store cannot be reached (IO failure, injected fault, or the
    per-store circuit breaker failing fast)."""


class ObjectStoreCorruption(ObjectStoreError):
    """Fetched bytes failed content-hash / CRC verification — never
    served as data."""


# ------------------------------------------------------------------- keys

def content_key(payload: bytes) -> str:
    """Content address of one immutable segment object."""
    h = hashlib.sha256(payload).hexdigest()
    return f"objects/{h[:2]}/{h}"


def manifest_key(dataset: str, shard: int) -> str:
    return f"manifests/{dataset}/shard-{shard}"


# --------------------------------------------------------------- manifest

@dataclasses.dataclass(frozen=True)
class ManifestEntry:
    """One uploaded (schema, window) of a shard — enough metadata to
    plan/page the segment without touching the object itself."""
    schema_name: str
    start_ms: int
    end_ms: int
    object_key: str              # content address of the payload
    num_series: int
    num_steps: int
    num_cols: int
    num_samples: int
    source_chunks: int           # staleness signal (compactor drift)
    size_bytes: int              # unframed payload length

    @property
    def window(self) -> Tuple[str, int]:
        return (self.schema_name, self.start_ms)


@dataclasses.dataclass
class ShardManifest:
    """The compacted catalog of one shard's uploaded windows."""
    dataset: str
    shard: int
    generation: int = 0
    entries: Dict[Tuple[str, int], ManifestEntry] = \
        dataclasses.field(default_factory=dict)

    def encode(self) -> bytes:
        body = json.dumps({
            "dataset": self.dataset, "shard": self.shard,
            "generation": self.generation,
            "entries": [dataclasses.asdict(e)
                        for e in sorted(self.entries.values(),
                                        key=lambda e: (e.schema_name,
                                                       e.start_ms))],
        }, separators=(",", ":")).encode()
        head = struct.pack("<IHHIi", _MAGIC_MANIFEST, _MANIFEST_VERSION,
                           0, len(body), zlib.crc32(body) & 0x7FFFFFFF)
        return head + body

    @classmethod
    def decode(cls, data: bytes) -> "ShardManifest":
        if len(data) < 16:
            raise ValueError("truncated manifest frame")
        magic, version, _, length, crc = struct.unpack_from("<IHHIi",
                                                            data, 0)
        if magic != _MAGIC_MANIFEST or version != _MANIFEST_VERSION:
            raise ValueError("bad manifest frame magic/version")
        body = data[16: 16 + length]
        if len(body) < length or (zlib.crc32(body) & 0x7FFFFFFF) != crc:
            raise ValueError("corrupt manifest frame (CRC mismatch)")
        raw = json.loads(body.decode())
        out = cls(raw["dataset"], int(raw["shard"]),
                  generation=int(raw["generation"]))
        for ent in raw["entries"]:
            e = ManifestEntry(**ent)
            out.entries[e.window] = e
        return out


# ------------------------------------------------------------------ store

class LocalObjectStore:
    """Shared-directory object store — the S3/GCS stand-in every node
    mounts.  Keys are slash paths under `root`; objects are immutable
    (content-addressed puts dedupe by existence); manifest writes swap
    atomically keeping one `.prev` generation for torn-write recovery.

    All three verbs ride the `objectstore.put/get/list` fault points and
    a per-store circuit breaker (parallel/breaker.py, registered as peer
    `objectstore:<name>` so /admin/breakers and the peers verdict see
    it): a dead store answers in microseconds with a typed
    `ObjectStoreUnavailable`, never a hang."""

    def __init__(self, root: str, name: Optional[str] = None,
                 breaker=None):
        self.root = os.path.abspath(root)
        self.name = name or self.root
        os.makedirs(self.root, exist_ok=True)
        if breaker is None:
            from filodb_tpu_torch.parallel.breaker import breakers
            breaker = breakers.get(f"objectstore:{self.name}")
        self.breaker = breaker

    # ----------------------------------------------------------- plumbing

    def _path(self, key: str) -> str:
        parts = [p for p in key.split("/") if p]
        if not parts or any(p == ".." for p in parts):
            raise ValueError(f"bad object key {key!r}")
        return os.path.join(self.root, *parts)

    def _admit(self) -> None:
        if not self.breaker.allow():
            raise ObjectStoreUnavailable(
                f"object store {self.name!r} circuit open")

    def _fail(self, op: str, err: Exception) -> "ObjectStoreUnavailable":
        self.breaker.on_failure()
        from filodb_tpu_torch.utils.metrics import registry
        registry.counter("objectstore_errors", op=op).increment()
        return ObjectStoreUnavailable(f"objectstore.{op} failed: {err}")

    # -------------------------------------------------------------- verbs

    def put(self, key: str, data: bytes) -> bool:
        """Write one object (atomic tmp+rename).  Returns False when the
        key already exists — immutable objects make that a dedup hit,
        not an error."""
        self._admit()
        path = self._path(key)
        try:
            payload = faults.fire("objectstore.put", data)
            if os.path.exists(path):
                self.breaker.on_success()
                return False
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except (OSError, InjectedFault, socket.timeout) as e:
            raise self._fail("put", e)
        self.breaker.on_success()
        return True

    def get(self, key: str) -> bytes:
        self._admit()
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                data = f.read()
            data = faults.fire("objectstore.get", data)
        except FileNotFoundError as e:
            # a missing key is a caller-level condition, not store death
            self.breaker.on_success()
            raise KeyError(key) from e
        except (OSError, InjectedFault, socket.timeout) as e:
            raise self._fail("get", e)
        self.breaker.on_success()
        return data

    def list(self, prefix: str = "") -> List[str]:
        """Keys under `prefix`, sorted.  Skips in-flight `.tmp.` and
        `.prev` artifacts — they are the swap machinery, not objects."""
        self._admit()
        try:
            faults.fire("objectstore.list")
            base = self._path(prefix) if prefix else self.root
            out: List[str] = []
            if not os.path.isdir(base):
                self.breaker.on_success()
                return []
            for dirpath, _dirs, files in os.walk(base):
                rel = os.path.relpath(dirpath, self.root)
                for fn in files:
                    if ".tmp." in fn or fn.endswith(".prev"):
                        continue
                    key = fn if rel == "." else \
                        "/".join(rel.split(os.sep) + [fn])
                    out.append(key)
        except (OSError, InjectedFault, socket.timeout) as e:
            raise self._fail("list", e)
        self.breaker.on_success()
        return sorted(out)

    def exists(self, key: str) -> bool:
        self._admit()
        try:
            ok = os.path.exists(self._path(key))
        except OSError as e:
            raise self._fail("list", e)
        self.breaker.on_success()
        return ok

    def delete(self, key: str) -> None:
        self._admit()
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass
        except OSError as e:
            raise self._fail("put", e)
        self.breaker.on_success()

    # ------------------------------------------- content-addressed layer

    def put_object(self, payload: bytes) -> Tuple[str, bool]:
        """-> (content key, wrote).  wrote=False = dedup hit (the object
        already exists under its hash — RF peers racing the same window
        converge on one copy)."""
        key = content_key(payload)
        wrote = self.put(key, payload)
        from filodb_tpu_torch.utils.metrics import registry
        if not wrote:
            registry.counter("objectstore_dedup_hits").increment()
        return key, wrote

    def get_object(self, key: str) -> bytes:
        """Fetch + verify: the content hash IS the key, so a corrupt
        store (or a `corrupt` fault plan) can never serve bad bytes."""
        data = self.get(key)
        if content_key(data) != key:
            from filodb_tpu_torch.utils.metrics import registry
            registry.counter("objectstore_corruptions").increment()
            raise ObjectStoreCorruption(
                f"object {key} failed content-hash verification")
        return data

    # ------------------------------------------------- manifest swapping

    def put_manifest(self, manifest: ShardManifest) -> None:
        """CRC-framed atomic swap: tmp + fsync, current demoted to
        `.prev`, tmp promoted.  A crash at any point leaves either the
        new generation, the old one, or old-as-`.prev` — never silence."""
        self._admit()
        key = manifest_key(manifest.dataset, manifest.shard)
        path = self._path(key)
        try:
            data = faults.fire("objectstore.put", manifest.encode())
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(path):
                os.replace(path, path + ".prev")
            os.replace(tmp, path)
        except (OSError, InjectedFault, socket.timeout) as e:
            raise self._fail("put", e)
        self.breaker.on_success()
        from filodb_tpu_torch.utils.metrics import registry
        registry.counter("objectstore_manifest_swaps",
                         dataset=manifest.dataset).increment()

    def load_manifest(self, dataset: str, shard: int) -> ShardManifest:
        """Current generation, falling back to `.prev` on a torn/corrupt
        current (journaled — an operator must know a swap tore)."""
        self._admit()
        key = manifest_key(dataset, shard)
        path = self._path(key)
        for candidate, recovered in ((path, False), (path + ".prev", True)):
            try:
                with open(candidate, "rb") as f:
                    data = f.read()
                data = faults.fire("objectstore.get", data)
            except FileNotFoundError:
                continue
            except (OSError, InjectedFault, socket.timeout) as e:
                raise self._fail("get", e)
            try:
                man = ShardManifest.decode(data)
            except ValueError as e:
                _log.warning("manifest %s unreadable (%s) — falling back",
                             candidate, e)
                continue
            self.breaker.on_success()
            if recovered:
                from filodb_tpu_torch.utils.events import journal
                from filodb_tpu_torch.utils.metrics import registry
                registry.counter("objectstore_manifest_recovered",
                                 dataset=dataset).increment()
                journal.emit("manifest_recovered", subsystem="persistence",
                             dataset=dataset, shard=shard,
                             generation=man.generation)
            return man
        self.breaker.on_success()
        return ShardManifest(dataset, shard)


# ------------------------------------------------------------ retry layer

def _retry(fn: Callable[[], object], attempts: int, base_s: float,
           max_s: float, rng: random.Random,
           on_retry: Optional[Callable[[int], None]] = None):
    """Exponential backoff + jitter around one store operation; the last
    attempt's `ObjectStoreUnavailable` propagates."""
    for i in range(max(attempts, 1)):
        try:
            return fn()
        except ObjectStoreUnavailable:
            if i + 1 >= max(attempts, 1):
                raise
            if on_retry is not None:
                on_retry(i)
            # full jitter on a doubling base, capped — uncoordinated
            # uploaders must not thunder the store in lockstep
            time.sleep(min(max_s, base_s * (2 ** i)) * rng.random())


# --------------------------------------------------------------- uploader

class SegmentUploader:
    """The `segment_upload` job: local segments -> shared tier.

    Each pass sweeps the local SegmentStore per shard, uploads every
    window missing or stale (source_chunks drift) in the shard manifest,
    and swaps one compacted manifest per changed shard.  Replica dedup:
    with a shard mapper attached, only the shard's FIRST LIVE owner
    uploads (the RF group converges on one writer; content addressing
    makes even a race harmless).  Upload acks feed the durability gate:
    retention may only prune raw chunks of windows whose manifest entry
    is acked (`allowed_prune_cutoff`)."""

    def __init__(self, store: LocalObjectStore, segment_store,
                 dataset: str, num_shards: int, node: str = "local",
                 mapper=None, retry_base_s: float = 0.05,
                 retry_max_s: float = 2.0, max_attempts: int = 6,
                 seed: int = 0):
        from filodb_tpu_torch.utils.jobs import jobs
        self.store = store
        self.segment_store = segment_store
        self.dataset = dataset
        self.num_shards = num_shards
        self.node = node
        self.mapper = mapper
        self.retry_base_s = retry_base_s
        self.retry_max_s = retry_max_s
        self.max_attempts = max_attempts
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._manifests: Dict[int, ShardManifest] = {}
        self.mounted = False
        self.uploads = 0
        self.upload_bytes = 0
        self.dedup_skips = 0
        self.retries = 0
        self.failures = 0
        self.retention_blocks = 0
        # True while the MOST RECENT pass left segments behind — the
        # probe degrades immediately instead of waiting for the backlog
        # to age past the warn threshold
        self.last_pass_failed = False
        # oldest unacked local segment's mtime (unix s); None = no backlog
        self._backlog_oldest_unix_s: Optional[float] = None
        self.job = jobs.register("segment_upload", dataset=dataset)

    # ------------------------------------------------------------- mount

    def mount(self) -> int:
        """Load every shard's manifest (the ack baseline).  Raises
        `ObjectStoreUnavailable` when the store is down — the caller's
        readiness gate keeps /ready at 503 until a mount succeeds."""
        loaded = {}
        for s in range(self.num_shards):
            loaded[s] = _retry(
                lambda s=s: self.store.load_manifest(self.dataset, s),
                self.max_attempts, self.retry_base_s, self.retry_max_s,
                self._rng, self._note_retry)
        with self._lock:
            self._manifests.update(loaded)
            self.mounted = True
        return sum(len(m.entries) for m in loaded.values())

    def _manifest(self, shard: int) -> ShardManifest:
        with self._lock:
            man = self._manifests.get(shard)
        if man is None:
            man = _retry(
                lambda: self.store.load_manifest(self.dataset, shard),
                self.max_attempts, self.retry_base_s, self.retry_max_s,
                self._rng, self._note_retry)
            with self._lock:
                man = self._manifests.setdefault(shard, man)
        return man

    def _note_retry(self, _attempt: int) -> None:
        self.retries += 1
        from filodb_tpu_torch.utils.metrics import registry
        registry.counter("objectstore_upload_retries",
                         dataset=self.dataset).increment()

    # ----------------------------------------------------- replica dedup

    def should_upload(self, shard: int) -> bool:
        """One uploader per RF group: the shard's first live owner.  A
        node not owning the shard at all (e.g. query-only) never
        uploads."""
        m = self.mapper
        if m is None:
            return True
        try:
            owners = m.owners(shard)
        except (AttributeError, IndexError):
            return True
        if self.node not in owners:
            return False
        if hasattr(m, "live_owners"):
            live = m.live_owners(shard)
            if live:
                return live[0] == self.node
        return bool(owners) and owners[0] == self.node

    # -------------------------------------------------------------- sync

    def _stale(self, man: ShardManifest, meta) -> bool:
        ent = man.entries.get((meta.schema_name, meta.start_ms))
        return ent is None or ent.source_chunks != meta.source_chunks \
            or ent.num_samples != meta.num_samples

    def sync_shard(self, shard: int) -> int:
        """Upload this shard's missing/stale windows; returns segments
        uploaded.  Store failures past the retry budget count one job
        error and leave the window unacked (retention stays blocked —
        durability ordering holds by construction)."""
        from filodb_tpu_torch.persist.segments import _read_framed
        from filodb_tpu_torch.utils.metrics import registry
        man = self._manifest(shard)
        uploaded = 0
        changed = False
        for meta in self.segment_store.list(self.dataset, shard):
            if not self._stale(man, meta):
                continue
            try:
                payload = _read_framed(meta.path)
            except (OSError, ValueError):
                continue            # torn local write: compactor's problem
            try:
                key, wrote = _retry(
                    lambda p=payload: self.store.put_object(p),
                    self.max_attempts, self.retry_base_s,
                    self.retry_max_s, self._rng, self._note_retry)
            except ObjectStoreUnavailable as e:
                self.failures += 1
                registry.counter("objectstore_upload_failures",
                                 dataset=self.dataset).increment()
                raise e
            if not wrote:
                self.dedup_skips += 1
            man.entries[(meta.schema_name, meta.start_ms)] = ManifestEntry(
                schema_name=meta.schema_name, start_ms=meta.start_ms,
                end_ms=meta.end_ms, object_key=key,
                num_series=meta.num_series, num_steps=meta.num_steps,
                num_cols=meta.num_cols, num_samples=meta.num_samples,
                source_chunks=meta.source_chunks,
                size_bytes=len(payload))
            self.uploads += 1
            self.upload_bytes += len(payload)
            uploaded += 1
            changed = True
            registry.counter("objectstore_segments_uploaded",
                             dataset=self.dataset).increment()
            registry.counter("objectstore_upload_bytes",
                             dataset=self.dataset).increment(len(payload))
        if changed:
            man.generation += 1
            _retry(lambda: self.store.put_manifest(man),
                   self.max_attempts, self.retry_base_s, self.retry_max_s,
                   self._rng, self._note_retry)
        return uploaded

    def run_once(self) -> int:
        """One `segment_upload` pass over the shards this node uploads
        for.  Errors land on the job handle (streaks feed the health
        verdict); the pass keeps going across shards."""
        from filodb_tpu_torch.utils.metrics import registry
        total = 0
        failed: List[str] = []
        with self.job.tick() as tick:
            for s in range(self.num_shards):
                if not self.should_upload(s):
                    continue
                self.job.set_progress(f"shard {s}")
                try:
                    total += self.sync_shard(s)
                except ObjectStoreUnavailable as e:
                    failed.append(f"shard {s}: {e}")
            self._refresh_backlog()
            self.last_pass_failed = bool(failed)
            if failed:
                tick.handle.note_error("; ".join(failed)[:300])
            self.job.set_progress(
                f"{total} segment(s) uploaded, backlog "
                f"{self.backlog_segments()}")
        if total:
            from filodb_tpu_torch.utils.events import journal
            journal.emit("segments_uploaded", subsystem="persistence",
                         dataset=self.dataset, node=self.node,
                         segments=total)
        registry.gauge("objectstore_upload_backlog",
                       dataset=self.dataset).update(
            self.backlog_segments())
        registry.gauge("objectstore_backlog_age_seconds",
                       dataset=self.dataset).update(self.backlog_age_s())
        return total

    # ------------------------------------------------------- backlog view

    def _unacked(self, shard: int) -> List:
        with self._lock:
            man = self._manifests.get(shard)
        if man is None:
            man = ShardManifest(self.dataset, shard)
        return [m for m in self.segment_store.list(self.dataset, shard)
                if self._stale(man, m)]

    def _refresh_backlog(self) -> None:
        oldest: Optional[float] = None
        n = 0
        for s in range(self.num_shards):
            for m in self._unacked(s):
                n += 1
                t = m.mtime_ns / 1e9
                oldest = t if oldest is None else min(oldest, t)
        with self._lock:
            self._backlog_oldest_unix_s = oldest
            self._backlog_n = n

    def backlog_segments(self) -> int:
        return getattr(self, "_backlog_n", 0)

    def backlog_age_s(self, now: Optional[float] = None) -> float:
        with self._lock:
            oldest = self._backlog_oldest_unix_s
        if oldest is None:
            return 0.0
        return max(0.0, (now if now is not None else time.time()) - oldest)

    # -------------------------------------------------- durability gate

    def allowed_prune_cutoff(self, shard: int, cutoff_ms: int) -> int:
        """Durability ordering: clamp a retention cutoff so no window
        with an UNACKED covering segment is pruned — a crash between
        prune and a future upload would otherwise lose the window.
        Journals `retention_blocked_on_upload` when it holds back."""
        with self._lock:
            man = self._manifests.get(shard)
        if man is None:
            man = ShardManifest(self.dataset, shard)
        allowed = cutoff_ms
        for meta in self.segment_store.list(self.dataset, shard):
            if meta.start_ms < allowed and self._stale(man, meta):
                allowed = min(allowed, meta.start_ms)
        if allowed < cutoff_ms:
            self.retention_blocks += 1
            from filodb_tpu_torch.utils.events import journal
            from filodb_tpu_torch.utils.metrics import registry
            registry.counter("objectstore_retention_blocked",
                             dataset=self.dataset).increment()
            journal.emit("retention_blocked_on_upload",
                         subsystem="persistence", dataset=self.dataset,
                         shard=shard, requested_cutoff_ms=cutoff_ms,
                         allowed_cutoff_ms=allowed)
        return allowed

    def install_prune_guard(self, column_store) -> None:
        """Register the durability gate on a LocalDiskColumnStore: every
        prune for this dataset clamps through `allowed_prune_cutoff`,
        whatever code path asked for it."""
        guards = getattr(column_store, "prune_guards", None)
        if guards is not None:
            guards[self.dataset] = self.allowed_prune_cutoff

    # ------------------------------------------------------------- health

    def probe(self, backlog_warn_s: float = 600.0) -> dict:
        """The `persistence` sub-verdict for this dataset's uploads."""
        age = self.backlog_age_s()
        breaker = self.store.breaker.state
        status = "ok"
        if breaker != "closed" or age > backlog_warn_s \
                or self.last_pass_failed:
            status = "degraded"
        if not self.mounted:
            status = "degraded"
        return {"status": status, "mounted": self.mounted,
                "uploadBacklog": self.backlog_segments(),
                "backlogAgeSeconds": round(age, 1),
                "breaker": breaker, "uploads": self.uploads,
                "dedupSkips": self.dedup_skips,
                "retries": self.retries}


# ---------------------------------------------------------------- restore

@dataclasses.dataclass
class RestoreStats:
    shards: int = 0
    segments_fetched: int = 0
    segments_present: int = 0
    bytes_fetched: int = 0
    elapsed_s: float = 0.0


def restore_from_objectstore(store: LocalObjectStore, segment_store,
                             dataset: str, num_shards: int,
                             retry_base_s: float = 0.05,
                             retry_max_s: float = 2.0,
                             max_attempts: int = 6,
                             node: str = "local") -> RestoreStats:
    """Manifest-driven node rebuild: refetch every manifested segment the
    local SegmentStore does not already hold (hash-verified), so a
    replacement node recovers its whole cold tier from the shared store;
    the WAL tail (replication/catchup.py) then covers the raw edge.
    Raises `ObjectStoreUnavailable` past the retry budget — the caller's
    readiness gate holds /ready at 503."""
    from filodb_tpu_torch.persist.segments import write_segment_file
    from filodb_tpu_torch.utils.events import journal
    from filodb_tpu_torch.utils.metrics import registry
    t0 = time.perf_counter()
    rng = random.Random(1)
    stats = RestoreStats()
    for shard in range(num_shards):
        man = _retry(lambda s=shard: store.load_manifest(dataset, s),
                     max_attempts, retry_base_s, retry_max_s, rng)
        if not man.entries:
            continue
        stats.shards += 1
        local = {(m.schema_name, m.start_ms): m
                 for m in segment_store.list(dataset, shard)}
        for ent in man.entries.values():
            have = local.get(ent.window)
            if have is not None \
                    and have.source_chunks == ent.source_chunks \
                    and have.num_samples == ent.num_samples:
                stats.segments_present += 1
                continue
            payload = _retry(
                lambda k=ent.object_key: store.get_object(k),
                max_attempts, retry_base_s, retry_max_s, rng)
            path = os.path.join(
                segment_store.seg_dir(dataset, shard),
                segment_store.seg_name(ent.schema_name, ent.start_ms,
                                       ent.end_ms))
            write_segment_file(path, payload)
            stats.segments_fetched += 1
            stats.bytes_fetched += len(payload)
            registry.counter("objectstore_segments_restored",
                             dataset=dataset).increment()
    stats.elapsed_s = time.perf_counter() - t0
    journal.emit("node_restored_from_objectstore",
                 subsystem="persistence", dataset=dataset, node=node,
                 segments_fetched=stats.segments_fetched,
                 segments_present=stats.segments_present,
                 bytes_fetched=stats.bytes_fetched,
                 elapsed_s=round(stats.elapsed_s, 3))
    return stats


# ----------------------------------------------------- query-only reading

class RemoteSegmentStore:
    """SegmentStore-shaped READ view straight over the object store —
    the storage face of a stateless query-only node.  `list()` serves
    SegmentMeta rows from TTL-cached manifests (`path` holds the content
    key; content addresses make (key, 0) an exact cache identity for the
    ColdSegmentCache); `load()` pages + hash-verifies the object and
    decodes it with the ordinary segment codec.  No local disk anywhere:
    kill the node and nothing is lost."""

    def __init__(self, store: LocalObjectStore, dataset: str,
                 num_shards: int, ttl_s: float = 5.0,
                 retry_base_s: float = 0.05, retry_max_s: float = 2.0,
                 max_attempts: int = 3):
        self.store = store
        self.dataset = dataset
        self.num_shards = num_shards
        self.ttl_s = ttl_s
        self.retry_base_s = retry_base_s
        self.retry_max_s = retry_max_s
        self.max_attempts = max_attempts
        self.root = ""               # no local directory backs this store
        self._rng = random.Random(2)
        self._lock = threading.Lock()
        # shard -> (monotonic fetch time, unix fetch time, metas)
        self._cache: Dict[int, Tuple[float, float, List]] = {}
        self.mounted = False
        # True while the latest manifest refresh failed and a stale
        # snapshot is being served instead — the probe degrades on it
        self.last_refresh_failed = False
        self.stale_serves = 0

    def mount(self) -> int:
        """Fetch every shard's manifest once — query-only readiness."""
        n = 0
        for s in range(self.num_shards):
            n += len(self._refresh(s))
        self.mounted = True
        return n

    def _refresh(self, shard: int) -> List:
        from filodb_tpu_torch.persist.segments import SegmentMeta
        man = _retry(
            lambda: self.store.load_manifest(self.dataset, shard),
            self.max_attempts, self.retry_base_s, self.retry_max_s,
            self._rng)
        metas = [SegmentMeta(
            path=e.object_key, dataset=self.dataset, shard=shard,
            schema_name=e.schema_name, start_ms=e.start_ms,
            end_ms=e.end_ms, num_series=e.num_series,
            num_steps=e.num_steps, num_cols=e.num_cols,
            num_samples=e.num_samples, source_chunks=e.source_chunks,
            file_bytes=e.size_bytes, mtime_ns=0)
            for e in man.entries.values()]
        metas.sort(key=lambda m: m.start_ms)
        with self._lock:
            self._cache[shard] = (time.monotonic(), time.time(), metas)
        self.last_refresh_failed = False
        return metas

    def list(self, dataset: str, shard: int) -> List:
        if dataset != self.dataset:
            return []
        with self._lock:
            ent = self._cache.get(shard)
        if ent is not None and time.monotonic() - ent[0] < self.ttl_s:
            return ent[2]
        try:
            return self._refresh(shard)
        except ObjectStoreUnavailable:
            if ent is not None:
                # stale manifest beats no answer; staleness_s() and the
                # probe keep the health verdict honest about it
                self.last_refresh_failed = True
                self.stale_serves += 1
                return ent[2]
            raise

    def covering(self, dataset: str, shard: int, start_ms: int,
                 end_ms: int, schema_name: Optional[str] = None) -> List:
        return [m for m in self.list(dataset, shard)
                if m.start_ms <= end_ms and m.end_ms > start_ms
                and (schema_name is None or m.schema_name == schema_name)]

    def load(self, meta):
        from filodb_tpu_torch.persist.segments import decode_segment
        payload = _retry(
            lambda: self.store.get_object(meta.path),
            self.max_attempts, self.retry_base_s, self.retry_max_s,
            self._rng)
        return decode_segment(payload)

    def remove(self, meta) -> None:
        raise ObjectStoreError("RemoteSegmentStore is read-only")

    def staleness_s(self, now: Optional[float] = None) -> float:
        """Age of the OLDEST mounted manifest snapshot — the health
        verdict's manifest-staleness input on query-only nodes."""
        with self._lock:
            times = [ent[1] for ent in self._cache.values()]
        if not times:
            return 0.0
        return max(0.0, (now if now is not None else time.time())
                   - min(times))

    def probe(self, stale_warn_s: float = 600.0) -> dict:
        stale = self.staleness_s()
        breaker = self.store.breaker.state
        status = "ok"
        if breaker != "closed" or stale > stale_warn_s \
                or not self.mounted or self.last_refresh_failed:
            status = "degraded"
        return {"status": status, "mounted": self.mounted,
                "manifestStalenessSeconds": round(stale, 1),
                "staleServes": self.stale_serves,
                "breaker": breaker}


def make_query_tier(store: LocalObjectStore, dataset: str,
                    num_shards: int, cold_cache=None,
                    cold_limit_bytes: int = 256 << 20, schemas=None,
                    ttl_s: float = 5.0, device="cuda"):
    """Wire a stateless query-only node's cold tier: RemoteSegmentStore
    (mounted) + ColdSegmentCache + PersistedTier.  Without a
    `cold_cache`, one of `cold_limit_bytes` is made on `device` (default
    "cuda"; without a card it raises unless given device="cpu").
    Returns (tier, remote_store)."""
    from filodb_tpu_torch.core.devicecache import ColdSegmentCache
    from filodb_tpu_torch.persist.segments import PersistedTier
    remote = RemoteSegmentStore(store, dataset, num_shards, ttl_s=ttl_s)
    remote.mount()
    if cold_cache is None:
        cold_cache = ColdSegmentCache(cold_limit_bytes, device=device)
    tier = PersistedTier(remote, dataset, num_shards, cold_cache,
                         schemas=schemas)
    return tier, remote


def persistence_probe(uploaders: Dict[str, SegmentUploader],
                      remote_stores: Optional[Dict[str,
                                                   RemoteSegmentStore]]
                      = None,
                      backlog_warn_s: float = 600.0
                      ) -> Callable[[], dict]:
    """Build the health evaluator's `persistence` subsystem probe:
    per-dataset upload backlog age + manifest staleness + breaker state,
    worst-wins."""
    rank = {"ok": 0, "degraded": 1, "failed": 2}

    def _probe() -> dict:
        datasets: Dict[str, dict] = {}
        worst = "ok"
        for ds, up in (uploaders or {}).items():
            v = up.probe(backlog_warn_s)
            datasets[ds] = v
            if rank[v["status"]] > rank[worst]:
                worst = v["status"]
        for ds, rs in (remote_stores or {}).items():
            v = rs.probe(backlog_warn_s)
            ent = datasets.setdefault(ds, {"status": "ok"})
            merged = {k: val for k, val in v.items() if k != "status"}
            ent.update(merged)
            if rank[v["status"]] > rank[ent["status"]]:
                ent["status"] = v["status"]
            if rank[ent["status"]] > rank[worst]:
                worst = ent["status"]
        return {"status": worst, "datasets": datasets}

    return _probe
