"""Device-resident mirror of a shard's dense series store (port of
filodb_tpu/core/devicecache.py: the full upload, the incremental tail
upload, the pad-only growth and the background rebuild).

The mirror uploads a store's live arrays once and revalidates by the
store's generation counter: unchanged generation -> queries gather rows
on the device from the cached copy; appended samples -> only the new
cells are uploaded (`_refresh_incremental`); cells rearranged (eviction,
paging, a bucket-scheme change: the store's shift_version moved) -> one
full re-upload, which the leaf moves off the query's path onto a
background thread (`request_background_refresh`).

Timestamps become int32 offsets from the mirror's base, and value
columns are reset-corrected (counters) and rebased per series in f64
before the f32 downcast.  Unlike the reference, the full upload's f64
work runs on the mirror's device in row chunks (ops/counter.rebase_rows_t),
not on the host, and the columns are kept in f32, the type the fused
kernels read.  The full upload also keeps, per counter column, each
row's correction state at its last finite sample (raw value and
cumulative drop), computed from the same corrected values; the
incremental path continues the correction from it on the host, over the
new cells only.  A histogram column [S, T, B] is corrected and rebased
per bucket along time, with a base per (series, bucket).

As in the reference, each incremental refresh builds new device arrays
of exactly [S, t_used]: the old ones are copied on the device, padded,
and the new cells scattered in.  A published snapshot is never written,
so a query reading it on another thread sees it whole.

Over the HBM cap the mirror journals `mirror_over_cap`, drops its
snapshot and raises MirrorCapExceeded.  A query is served from the host
gather only while a background rebuild is in flight: a rebuild that
would exceed the cap is never started, and after a failed one the next
query refreshes inline and meets its error.  The background rebuild is
the `mirror_rebuild` job of utils/jobs.py.

Observability, as in the reference: the `device.upload` fault point at
the top of a full refresh (before anything is allocated), each upload
a `transfer` entry of the kernel ledger and a transfer of the exec tally
(note_transfer, note_mirror_refresh), and the snapshot's device bytes
booked in the HBM occupancy model under region `hot`
(utils/devicetelem.hbm_book), released when the mirror is collected.

ColdSegmentCache is the mirror's cold region: persisted-segment blocks
(persist/segments.ColdBlock) uploaded on demand under a byte budget and
evicted whole, least recently used first, booked under region `cold`.

The sharded mirror mode (store.device_mirror_sharded, with two cards or
more): MirrorPlacer spreads a memstore's per-shard mirrors, and the
cold region's blocks, over the cards, HBM-aware, so a multi-shard query
runs each shard's kernel on its own card.  A placed mirror books its
bytes with the placer (which feeds the HBM model).  The per-mirror cap
(store.device_mirror_hbm_limit) stays each mirror's own, as without the
placer; the placer reads it per card only to choose where a mirror goes.
Before each upload, full or incremental, a placed mirror checks that the
mirrors booked on its card fit the card's memory (MirrorPlacer.capacity),
so a store that fits on one card also fits spread over several.
"""
from __future__ import annotations

import dataclasses
import itertools
import logging
import threading
import time
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from filodb_tpu_torch.ops.counter import host_counter_correct, rebase_rows_t
from filodb_tpu_torch.ops.hist import bucket_rows, from_bucket_rows
from filodb_tpu_torch.ops.timewindow import PAD_TS, series_value_base
from filodb_tpu_torch.utils.counters import counters
from filodb_tpu_torch.utils.device import resolve_device
from filodb_tpu_torch.utils.devicetelem import telem
from filodb_tpu_torch.utils.faults import faults
from filodb_tpu_torch.utils.metrics import (note_mirror_refresh,
                                            note_transfer, registry)

_log = logging.getLogger("filodb.mirror")

DEFAULT_HBM_LIMIT_BYTES = 8 << 30
"""Default cap on one mirror's device bytes (ts offsets + value columns +
per-series bases)."""

UPLOAD_CHUNK_ROWS = 65_536
"""Rows per host->device chunk of a full upload (bounds the f64 scratch
on the device to a few hundred MB at 720 samples)."""


class MirrorCapExceeded(RuntimeError):
    """The store's mirror would exceed its device-memory cap."""


@dataclasses.dataclass(frozen=True)
class _MirrorSnapshot:
    """One immutable upload generation, published with a single attribute
    assignment so a gather racing a refresh sees one snapshot in full."""
    gen: int
    base_ms: int
    t_used: int
    ts_off: torch.Tensor                 # int32 [S, T_used]
    cols: Dict[str, torch.Tensor]        # f32 [S, T_used] (or [S, T_used,
                                         # B] histograms) rebased values
    vbases: Dict[str, torch.Tensor]      # f64 [S] (or [S, B]) value bases
    counts: Optional[np.ndarray] = None  # int32 [S] at upload
    # per column: bool [S] (or [S, B]) some finite value, i.e. vbase real
    vbase_valid: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)
    # fused-kernel eligibility: every row shares one scrape grid
    uniform_grid: bool = False
    ts_row0: Optional[np.ndarray] = None     # int32 [T] row-0 offsets
    # per column: no NaN/Inf anywhere in the counted region
    col_finite: Dict[str, bool] = dataclasses.field(default_factory=dict)
    # --- incremental-update bookkeeping ---
    shift_version: int = -1              # store.shift_version at upload
    host_vbases: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)            # f64 [S(, B)], vbases on the host
    # per counter column: correction state at each row's last finite
    # sample, so an appended tail is corrected without re-reading the row:
    # corrected_tail = correct(last_raw ++ tail) + cum_drop
    tail_last_raw: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)            # f64 [S(, B)]
    tail_cum_drop: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)            # f64 [S(, B)]


def _tail_state(raw: torch.Tensor, corrected: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(last_raw, cum_drop) of [R, T] f64 rows on their own device: the raw
    value at each row's last finite sample and the cumulative reset
    correction there (NaN / 0 when a row has no finite sample)."""
    finite = torch.isfinite(raw)
    any_f = finite.any(dim=1)
    last = raw.shape[1] - 1 - finite.flip(1).to(torch.uint8).argmax(dim=1)
    lr = raw.gather(1, last[:, None])[:, 0]
    cd = corrected.gather(1, last[:, None])[:, 0] - lr
    nan = torch.full_like(lr, float("nan"))
    return torch.where(any_f, lr, nan), torch.where(any_f, cd,
                                                    torch.zeros_like(cd))


def _cells(arr: np.ndarray, idx_r: np.ndarray, idx_p: np.ndarray
           ) -> np.ndarray:
    """arr[idx_r, idx_p] ([N], or [N, B] of a histogram column) through
    one flat take: at a million cells a few times cheaper than numpy's
    index by two arrays."""
    return np.take(arr.reshape((-1,) + arr.shape[2:]),
                   idx_r * arr.shape[1] + idx_p, axis=0)


def _tails_matrix(col: np.ndarray, idx_r: np.ndarray, idx_p: np.ndarray,
                  valid: np.ndarray) -> np.ndarray:
    """Compact [R, L(, B)] f64 matrix of the changed rows' new samples,
    NaN-padded: the cells (idx_r, idx_p) of `col`, in row-major order
    over the structural validity mask valid [R, L] (which tells padding
    from NaN samples)."""
    tails = np.full(valid.shape + col.shape[2:], np.nan)
    tails[valid] = _cells(col, idx_r, idx_p)
    return tails


_mirror_serial = itertools.count(1)


def store_nbytes(store) -> int:
    """Device bytes of a store's mirror at its used extent: int32
    offsets, f32 values and an f64 base per series (per series and
    bucket for a histogram column) for each value column."""
    s, t = store.num_series, max(store.time_used, 1)
    n = s * t * 4
    for arr in store.cols.values():
        if arr is not None:
            b = arr.shape[2] if arr.ndim == 3 else 1
            n += (s * t * 4 + s * 8) * b
    return n


def snapshot_nbytes(snap: Optional[_MirrorSnapshot]) -> int:
    """Device bytes a snapshot holds: its offsets, value columns and
    per-series bases (what the HBM model books as `hot`)."""
    if snap is None:
        return 0
    n = snap.ts_off.numel() * snap.ts_off.element_size()
    for t in list(snap.cols.values()) + list(snap.vbases.values()):
        n += t.numel() * t.element_size()
    return int(n)


def local_cards() -> list:
    """The cards this process sees, as torch devices (none without
    CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class MirrorPlacer:
    """HBM-aware placement of shard mirrors across the local devices (the
    sharded DeviceMirror mode): each card holds its shards' columns, so a
    multi-shard node spreads its working set over every card's memory
    instead of piling every mirror onto one, and the fused kernels of a
    multi-shard query run each shard's launch on its own card.

    A shard prefers its round-robin home (shard_num % n_devices); when the
    home's booked bytes plus the incoming estimate would exceed the limit,
    the least-booked device that fits takes it; when none fits, the
    least-booked device takes it anyway (device_mirror_placement_overflow)
    and serves it: the limit chooses placement and caps each mirror on its
    own, not a card's total.  What a card's mirrors may book together is
    its memory (capacity), which each placed mirror checks before an
    upload (over it, MirrorCapExceeded, as a mirror over its own cap).
    assign()
    books the estimate on the chosen device inside the same lock, so
    concurrent first queries see each other's bookings; the caller hands
    it to DeviceMirror(reserved_bytes=), whose _book later adjusts it to
    the upload's size.  Every booking is fed, with the same delta, to the
    device telemetry's HBM model (utils/devicetelem.hbm_book).

    `devices` is the device list placed over: None means the cards this
    process sees (local_cards), or for a memstore on the host (`like` a
    cpu device) that device alone; a test may set a list, e.g. of
    torch.device("cuda", i), which needs no card for the bookkeeping."""

    def __init__(self, devices=None):
        self._lock = threading.Lock()
        self._booked: Dict[torch.device, int] = {}
        self.devices = devices

    def device_list(self, like=None) -> list:
        if self.devices is not None:
            return list(self.devices)
        if like is not None and torch.device(like).type == "cpu":
            return [torch.device(like)]
        devs = local_cards()
        if not devs:
            raise RuntimeError("MirrorPlacer: no card to place on")
        return devs

    def assign(self, shard_num: int, est_bytes: int, limit_bytes: int,
               region: str = "hot", like=None) -> torch.device:
        devs = self.device_list(like)
        home = devs[shard_num % len(devs)]
        overflow = False
        with self._lock:
            if self._booked.get(home, 0) + est_bytes <= limit_bytes:
                chosen = home
            else:
                fits = [d for d in devs
                        if self._booked.get(d, 0) + est_bytes <= limit_bytes]
                chosen = min(fits or devs,
                             key=lambda d: (self._booked.get(d, 0), str(d)))
                overflow = not fits
            self._booked[chosen] = self._booked.get(chosen, 0) + est_bytes
            used = sum(1 for v in self._booked.values() if v > 0)
        if overflow:
            registry.counter("device_mirror_placement_overflow").increment()
        registry.gauge("device_mirror_devices_used").update(used)
        telem.hbm_book(chosen, region, est_bytes)
        return chosen

    def book(self, device, delta: int, region: str = "hot") -> None:
        if device is None or not delta:
            return
        with self._lock:
            self._booked[device] = max(self._booked.get(device, 0) + delta,
                                       0)
            used = sum(1 for v in self._booked.values() if v > 0)
        registry.gauge("device_mirror_devices_used").update(used)
        # every placer mutation feeds the HBM model the same delta, so the
        # gauges and the placer's table reconcile by construction
        telem.hbm_book(device, region, delta)

    def booked(self, device) -> int:
        with self._lock:
            return self._booked.get(device, 0)

    def capacity(self, device) -> Optional[int]:
        """The bytes that mirrors may book on `device` together: a card's
        memory, or None on the host (no device memory to overfill)."""
        device = torch.device(device)
        if device.type != "cuda":
            return None
        return int(torch.cuda.get_device_properties(device).total_memory)

    def over_capacity(self, device) -> bool:
        cap = self.capacity(device)
        return cap is not None and self.booked(device) > cap


placer = MirrorPlacer()

# serializes mirror creation (the check-then-set on store.device_mirror):
# two concurrent first queries would otherwise each placer.assign, and the
# loser's reservation would stay booked until its orphan mirror is
# collected
mirror_create_lock = threading.Lock()


def _book_delta(device, delta: int, placed: bool,
                region: str = "hot") -> None:
    """Book device bytes: with the placer for a placed mirror or block
    (the placer feeds the HBM model), in the HBM model directly for the
    others."""
    if placed:
        placer.book(device, delta, region=region)
    else:
        telem.hbm_book(device, region, delta)


def _release_booking(cell) -> None:
    """weakref.finalize target: give a collected mirror's booked bytes
    back (module-level, so it does not pin the mirror)."""
    device, nbytes, placed = cell
    if nbytes:
        _book_delta(device, -nbytes, placed)


def sharded_mirrors_enabled(config_store, device=None) -> bool:
    """Sharded placement engages when configured (device_mirror_sharded)
    and the memstore's `device` is a card with at least one other card
    beside it.  FILODB_TPU_FORCE_SHARDED_MIRROR=1 forces it for a memstore
    on the host: the placer then places over its own device list (the
    CPU tests' bookkeeping and equivalence runs)."""
    import os
    if not getattr(config_store, "device_mirror_sharded", True):
        return False
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cpu":
        return os.environ.get("FILODB_TPU_FORCE_SHARDED_MIRROR") == "1"
    return len(placer.devices if placer.devices is not None
               else local_cards()) >= 2


class ColdSegmentCache:
    """The LRU-paged cold region: whole persisted-segment blocks
    uploaded on demand under a byte budget
    (`store.device_mirror_cold_limit_bytes`), evicted at segment
    granularity.

    - Booked bytes never exceed the budget: eviction runs before the
      upload, on the caller's size estimate, not after; a page-in whose
      reservation does not fit while other page-ins are still building
      (their blocks not yet evictable) waits for them, where the
      reference books past the budget.
    - A single block larger than the whole budget is built on the host
      (`build("host")`): served, not cached, never an error and never an
      out-of-memory (device_mirror_cold_over_budget).
    - Every resident block's bytes are booked in the device telemetry's
      HBM model under region `cold`, and given back on eviction and by
      clear().

    Blocks go to `device` (default "cuda"; without a card it raises
    unless the caller passes device="cpu"), or, with the placer on
    (`use_placer`; None: on when `device` is a card beside another),
    HBM-aware to a card the MirrorPlacer picks for the block's shard,
    booked there under region `cold`."""

    def __init__(self, limit_bytes: int, device="cuda",
                 use_placer: Optional[bool] = None):
        self.limit_bytes = int(limit_bytes)
        self.device = resolve_device(device)
        self._lock = threading.Condition()
        # key -> (block, placed), least recently used first
        self._entries: Dict[tuple, tuple] = {}
        self._bytes = 0
        self._use_placer = use_placer

    def _placer_on(self) -> bool:
        if self._use_placer is not None:
            return self._use_placer
        return self.device.type == "cuda" and len(local_cards()) > 1

    @property
    def bytes_booked(self) -> int:
        with self._lock:
            return self._bytes

    def blocks(self) -> list:
        """The resident blocks, least recently used first."""
        with self._lock:
            return [b for b, _ in self._entries.values()]

    def _evict_until(self, need: int) -> None:
        """Caller holds the lock.  Evict LRU entries until `need` more
        bytes fit under the budget."""
        while self._entries and self._bytes + need > self.limit_bytes:
            block, placed = self._entries.pop(next(iter(self._entries)))
            nb = getattr(block, "nbytes", 0)
            self._bytes -= nb
            _book_delta(getattr(block, "device", self.device), -nb, placed,
                        "cold")
            registry.counter("device_mirror_cold_evictions").increment()

    def get(self, key: tuple, est_bytes: int, shard_num: int,
            build) -> Tuple[object, str]:
        """-> (block, verdict).  `build(device)` decodes and uploads the
        block to the torch device it is given, or keeps it on the host
        when given the string "host" (the over-budget degrade)."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                self._entries[key] = self._entries.pop(key)   # LRU touch
                registry.counter("device_mirror_cold_hits").increment()
                return ent[0], "cold_hit"
        if est_bytes > self.limit_bytes:
            # one block alone blows the budget: host-side segment scan,
            # uncached (the next query decodes again rather than pinning
            # an over-budget block)
            registry.counter("device_mirror_cold_over_budget").increment()
            return build("host"), "cold_paged"
        with self._lock:
            # reserve before the upload, so concurrent page-ins see each
            # other's bookings; a reservation that does not fit once every
            # resident block is evicted waits for the builds in flight
            self._evict_until(est_bytes)
            while self._bytes + est_bytes > self.limit_bytes:
                self._lock.wait()
                self._evict_until(est_bytes)
            self._bytes += est_bytes
        placed = self._placer_on()
        device = self.device
        b0 = time.perf_counter()
        try:
            if placed:
                device = placer.assign(shard_num, est_bytes, self.limit_bytes,
                                       region="cold", like=self.device)
            else:
                _book_delta(device, est_bytes, False, "cold")
            block = build(device)
        except Exception:
            with self._lock:
                self._bytes -= est_bytes
                self._lock.notify_all()
            _book_delta(device, -est_bytes, placed, "cold")
            raise
        actual = getattr(block, "nbytes", est_bytes)
        telem.record_dispatch("cold_page_in", device=device,
                              shape=f"seg{est_bytes >> 10}k",
                              seconds=time.perf_counter() - b0,
                              bytes_in=actual, kind="transfer", note=False)
        with self._lock:
            self._lock.notify_all()
            existing = self._entries.get(key)
            if existing is not None:
                # a concurrent page-in won the race: keep theirs, give
                # this build's reservation back
                self._bytes -= est_bytes
                self._entries[key] = self._entries.pop(key)
                won = existing[0]
            else:
                # the reservation becomes the measured size (actual <=
                # est: the estimate counts every column)
                self._bytes += actual - est_bytes
                self._evict_until(0)
                self._entries[key] = (block, placed)
                won = None
        if won is not None:
            _book_delta(device, -est_bytes, placed, "cold")
            return won, "cold_hit"
        _book_delta(device, actual - est_bytes, placed, "cold")
        registry.counter("device_mirror_cold_misses").increment()
        registry.gauge("device_mirror_cold_bytes").update(self.bytes_booked)
        registry.gauge("device_mirror_cold_limit_bytes").update(
            self.limit_bytes)
        return block, "cold_paged"

    def clear(self) -> None:
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
            self._bytes = 0
        for block, placed in entries:
            _book_delta(getattr(block, "device", self.device),
                        -getattr(block, "nbytes", 0), placed, "cold")


class DeviceMirror:
    """One mirror per DenseSeriesStore (attached lazily by the leaf).

    `placed`: the device came from MirrorPlacer.assign (the sharded
    mode), which booked `reserved_bytes` on it; the mirror's bookings then
    go through the placer, and every upload first books its size and
    checks that the mirrors on its card fit the card's memory
    (MirrorPlacer.capacity).  `hbm_limit_bytes` caps this mirror alone,
    placed or not."""

    def __init__(self, hbm_limit_bytes: int = DEFAULT_HBM_LIMIT_BYTES,
                 device="cuda", shard_num: Optional[int] = None,
                 reserved_bytes: int = 0, placed: bool = False):
        self.hbm_limit_bytes = hbm_limit_bytes
        self.device = resolve_device(device)
        self.shard_num = shard_num
        self.placed = placed
        self._snap: Optional[_MirrorSnapshot] = None
        # process-unique identity for external caches (id() is reused)
        self.serial = next(_mirror_serial)
        # the last refresh: "full", "incremental", "pad" or "bookkeeping",
        # its seconds (publication included) and the bytes it uploaded
        self.last_refresh_kind = ""
        self.last_refresh_s = 0.0
        self.last_upload_bytes = 0
        self.last_upload_s = 0.0             # the last full upload's seconds
        # background full rebuild (after cells were rearranged): at most
        # one thread at a time; the last one's error until a refresh
        # publishes
        self._bg_lock = threading.Lock()
        self._bg_thread: Optional[threading.Thread] = None
        self._bg_error: Optional[BaseException] = None
        # the device bytes booked (a placed mirror starts with the
        # placer's reservation); the finalizer releases them when the
        # mirror is collected
        self._booking = [self.device, reserved_bytes if placed else 0,
                         placed]
        weakref.finalize(self, _release_booking, self._booking)

    def _book(self, nbytes: int) -> None:
        """Book this mirror's device bytes (region `hot`) as a delta
        against what it booked before."""
        delta = nbytes - self._booking[1]
        if delta:
            _book_delta(self.device, delta, self.placed)
            self._booking[1] = nbytes

    @property
    def booked_bytes(self) -> int:
        return self._booking[1]

    def _publish(self, snap: _MirrorSnapshot, kind: str, t0: float,
                 nbytes: int) -> None:
        """Make `snap` the current snapshot once its uploads are complete:
        a query reading it from another thread or stream must never see a
        cell before its upload landed.  Then its bytes are booked and the
        upload (`nbytes` moved, the refresh's seconds) goes to the exec
        tally and the kernel ledger (a `transfer` entry, note=False: the
        tally has it already)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self._snap = snap
        self._bg_error = None
        self.last_refresh_kind = kind
        self.last_refresh_s = time.perf_counter() - t0
        self.last_upload_bytes = nbytes
        self._book(snapshot_nbytes(snap))
        if kind == "bookkeeping":
            return
        full = kind == "full"
        note_transfer(nbytes, self.last_refresh_s)
        note_mirror_refresh("full" if full else "incremental")
        telem.record_dispatch(
            "mirror_upload_full" if full else "mirror_upload_incr",
            device=self.device,
            shape=f"S{snap.ts_off.shape[0]}xT{snap.t_used}",
            seconds=self.last_refresh_s, bytes_in=nbytes,
            kind="transfer", note=False)

    def _refresh(self, store) -> bool:
        # the fault point fires before anything is allocated: a failed
        # upload leaves no half-built device arrays
        faults.fire("device.upload")
        # capture the version BEFORE copying host arrays: a mutation
        # landing mid-copy leaves the recorded generation stale, so the
        # next is_fresh check re-uploads (seqlock protocol)
        gen0 = store.generation
        nbytes = store_nbytes(store)
        if nbytes > self.hbm_limit_bytes:
            from filodb_tpu_torch.utils.events import journal
            registry.counter("device_mirror_over_cap").increment()
            journal.emit("mirror_over_cap", subsystem="mirror",
                         scope="store", nbytes=nbytes,
                         limit=self.hbm_limit_bytes)
            # a stale snapshot would keep its device memory: drop it
            self._snap = None
            self._book(0)
            raise MirrorCapExceeded(
                f"device mirror needs {nbytes} bytes, over its cap of "
                f"{self.hbm_limit_bytes} (shard {self.shard_num})")
        if self.placed:
            # the mirrors booked on the placed card against its memory:
            # reserve this upload first, then read the card's total, so
            # two concurrent refreshes of co-located mirrors cannot both
            # pass and together overfill the card.  Release and refuse
            # over it.
            self._book(nbytes)
            if placer.over_capacity(self.device):
                from filodb_tpu_torch.utils.events import journal
                booked = placer.booked(self.device)
                cap = placer.capacity(self.device)
                registry.counter("device_mirror_device_over_cap").increment()
                journal.emit("mirror_over_cap", subsystem="mirror",
                             scope="device", nbytes=nbytes, limit=cap)
                self._snap = None
                self._book(0)
                raise MirrorCapExceeded(
                    f"device {self.device} would hold {booked} mirror "
                    f"bytes, over its memory of {cap} (shard "
                    f"{self.shard_num})")
        t0 = time.perf_counter()
        dev = self.device
        s, t = store.num_series, max(store.time_used, 1)
        counts = store.counts[:s].astype(np.int32).copy()
        ts_host = store.ts[:s, :t]
        pos = torch.arange(t, device=dev)[None, :]

        def chunks(rows=UPLOAD_CHUNK_ROWS):
            return [slice(i, min(i + rows, s)) for i in range(0, s, rows)]

        def counted(sl):
            c = torch.from_numpy(counts[sl]).to(dev)
            return pos < c[:, None]

        # base_ms: the smallest live timestamp
        base_ms = None
        for sl in chunks():
            ts = torch.from_numpy(ts_host[sl]).to(dev)
            live = ts[ts > 0]
            if live.numel():
                m = int(live.min())
                base_ms = m if base_ms is None else min(base_ms, m)
        base_ms = base_ms or 0
        ts_off = torch.empty((s, t), dtype=torch.int32, device=dev)
        uniform = s > 0 and bool((counts == counts[0]).all())
        row0 = None
        for sl in chunks():
            ts = torch.from_numpy(ts_host[sl]).to(dev)
            off = torch.clamp(ts - base_ms, -(1 << 30), 1 << 30).to(torch.int32)
            off = torch.where(counted(sl), off,
                              torch.full_like(off, int(PAD_TS)))
            ts_off[sl] = off
            if row0 is None:
                row0 = off[:1]
            if uniform:
                uniform = bool((off == row0).all())
        counter_cols = {c.name for c in store.schema.data_columns
                        if c.detect_drops or c.counter}
        cols: Dict[str, torch.Tensor] = {}
        vbases: Dict[str, torch.Tensor] = {}
        vbase_valid: Dict[str, np.ndarray] = {}
        col_finite: Dict[str, bool] = {}
        host_vbases: Dict[str, np.ndarray] = {}
        last_raw: Dict[str, np.ndarray] = {}
        cum_drop: Dict[str, np.ndarray] = {}
        for name, arr in store.cols.items():
            if arr is None:
                continue
            bkt = arr.shape[2:]                  # (B,) for a histogram
            nb = bkt[0] if bkt else 1
            is_counter = name in counter_cols
            col = torch.empty((s, t) + bkt, dtype=torch.float32, device=dev)
            vb_all = torch.empty((s,) + bkt, dtype=torch.float64, device=dev)
            vb_ok = np.empty((s,) + bkt, dtype=bool)
            if is_counter:
                lr_all = torch.empty((s,) + bkt, dtype=torch.float64,
                                     device=dev)
                cd_all = torch.empty_like(lr_all)
            finite_ok = True
            for sl in chunks(max(1, UPLOAD_CHUNK_ROWS // nb)):
                v = torch.from_numpy(
                    np.ascontiguousarray(arr[sl, :t], np.float64)).to(dev)
                if bkt:
                    v = bucket_rows(v)     # each bucket a row along time
                rebased, vb, corrected = rebase_rows_t(v, is_counter)
                fin = torch.isfinite(corrected)
                ok = fin.any(dim=1)
                if is_counter:
                    # the incremental path continues the correction from
                    # the state of these same corrected values
                    lr, cd = _tail_state(v, corrected)
                    lr_all[sl] = lr.reshape(-1, nb) if bkt else lr
                    cd_all[sl] = cd.reshape(-1, nb) if bkt else cd
                if bkt:
                    rebased = from_bucket_rows(rebased, nb)
                    fin = from_bucket_rows(fin, nb)
                    vb, ok = vb.reshape(-1, nb), ok.reshape(-1, nb)
                col[sl] = rebased.to(torch.float32)
                vb_all[sl] = vb
                vb_ok[sl] = ok.cpu().numpy()
                # counted region fully finite (padding beyond counts is
                # NaN by construction and does not disqualify)
                if finite_ok:
                    pad = ~counted(sl)
                    finite_ok = bool(
                        (fin | (pad[..., None] if bkt else pad)).all())
            cols[name] = col
            vbases[name] = vb_all
            vbase_valid[name] = vb_ok
            col_finite[name] = finite_ok
            host_vbases[name] = vb_all.cpu().numpy()
            if is_counter:
                last_raw[name] = lr_all.cpu().numpy()
                cum_drop[name] = cd_all.cpu().numpy()
        ts_row0 = None
        if uniform:
            ts_row0 = ts_off[0].cpu().numpy().copy()
        snap = _MirrorSnapshot(
            gen0, base_ms, t, ts_off, cols, vbases, counts=counts,
            vbase_valid=vbase_valid, uniform_grid=uniform, ts_row0=ts_row0,
            col_finite=col_finite, shift_version=store.shift_version,
            host_vbases=host_vbases, tail_last_raw=last_raw,
            tail_cum_drop=cum_drop)
        self._publish(snap, "full", t0, nbytes)
        self.last_upload_s = self.last_refresh_s
        return True

    def is_fresh(self, store) -> bool:
        snap = self._snap
        return snap is not None and store.generation == snap.gen

    def ensure_fresh(self, store) -> bool:
        """Bring the mirror up to the store.  Callers exclude writers (hold
        the shard write lock): a refresh copies host arrays and must not
        race a mutation.  Append-only changes take the incremental path
        (transfer O(new samples)); anything that rearranged cells takes a
        full upload.  A failure of the incremental path is counted
        (device_mirror_incremental_errors), logged with its traceback and
        answered by a full upload.  Raises MirrorCapExceeded over the
        cap."""
        if self.is_fresh(store):
            return True
        snap = self._snap
        if snap is not None and snap.shift_version == store.shift_version \
                and snap.counts is not None:
            try:
                if self._refresh_incremental(store, snap):
                    return True
            except Exception:  # noqa: BLE001 — the full upload below
                # answers it; the counter and the log make it visible
                counters.inc("device_mirror_incremental_errors")
                _log.exception("incremental mirror refresh failed "
                               "(shard %s); re-uploading in full",
                               self.shard_num)
        return self._refresh(store)

    # ------------------------------------------------- background rebuild

    def can_update_inline(self, store) -> bool:
        """True when freshness is restorable without a full re-upload: the
        first build (nothing to serve from anyway) and append-only growth.
        False exactly when cells were rearranged (shift_version moved)."""
        snap = self._snap
        return snap is None or snap.shift_version == store.shift_version

    def may_rebuild_in_background(self, store) -> bool:
        """False when a full upload of the store would exceed the cap, or
        the last background rebuild failed and no refresh has published
        since: the query then refreshes inline, so MirrorCapExceeded or
        the rebuild's error reaches it instead of every later query
        falling back to the host."""
        return (self._bg_error is None
                and store_nbytes(store) <= self.hbm_limit_bytes)

    @property
    def rebuild_in_progress(self) -> bool:
        t = self._bg_thread
        return t is not None and t.is_alive()

    def request_background_refresh(self, shard, store) -> bool:
        """Start (at most one) background full rebuild; True if this call
        started it.  Queries keep serving through the leaf's host gather
        until the new snapshot publishes; the rebuild holds the shard
        write lock for its host copy and upload, as an inline refresh
        would, but on no query's path."""
        with self._bg_lock:
            if self._bg_thread is not None and self._bg_thread.is_alive():
                return False
            t = threading.Thread(target=self._bg_refresh,
                                 args=(shard, store), daemon=True,
                                 name=f"mirror-rebuild-{self.serial}")
            self._bg_thread = t
            t.start()
            return True

    def release(self) -> int:
        """Drop the snapshot and its `hot` booking now (a tombstoned
        shard's copy), after any background rebuild in flight has
        published.  A query still reading the old snapshot keeps its
        tensors until it ends.  Returns the bytes unbooked."""
        self.join_rebuild()
        freed = self._booking[1]
        self._snap = None
        self._book(0)
        return freed

    def join_rebuild(self, timeout: Optional[float] = None) -> bool:
        """Wait for a background rebuild in flight; True when none is
        running afterwards."""
        t = self._bg_thread
        if t is not None:
            t.join(timeout)
        return not self.rebuild_in_progress

    def _bg_refresh(self, shard, store) -> None:
        """The background rebuild: one tick of the shard's
        `mirror_rebuild` job (utils/jobs.py), journaled from start to
        done or failed."""
        from filodb_tpu_torch.utils.events import journal
        from filodb_tpu_torch.utils.jobs import jobs
        from filodb_tpu_torch.utils.metrics import span
        sn = getattr(shard, "shard_num", -1)
        job = jobs.register(
            "mirror_rebuild",
            dataset=f"{getattr(shard, 'dataset', '')}/{sn}")
        journal.emit("mirror_rebuild_started", subsystem="mirror",
                     shard=sn)
        try:
            with job.tick():
                job.set_progress(f"shard {sn}")
                with span("mirror_bg_rebuild"):
                    with shard._write_locked("mirror_bg_rebuild"):
                        ok = self.ensure_fresh(store)
            if ok:
                counters.inc("device_mirror_bg_rebuilds")
            journal.emit("mirror_rebuild_done", subsystem="mirror",
                         shard=sn, ok=ok)
        except Exception as e:  # noqa: BLE001 — kept for the next query,
            # which refreshes inline and meets it
            self._bg_error = e
            counters.inc("device_mirror_bg_rebuild_errors")
            _log.exception("background mirror rebuild failed (shard %s)",
                           self.shard_num)
            journal.emit("mirror_rebuild_failed", subsystem="mirror",
                         shard=sn, error=f"{type(e).__name__}: {e}")

    # ------------------------------------------------- incremental update

    def _grown(self, snap: _MirrorSnapshot, s_new: int, t_new: int
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """New device arrays of [s_new, t_new] holding the snapshot's cells,
        the others PAD_TS / NaN.  Always new: the snapshot itself is never
        written, as a query may be reading it on another thread."""
        s_old, t_old = snap.counts.shape[0], snap.t_used

        def grown(old, fill):
            new = torch.full((s_new, t_new) + tuple(old.shape[2:]), fill,
                             dtype=old.dtype, device=self.device)
            new[:s_old, :t_old] = old
            return new

        return (grown(snap.ts_off, int(PAD_TS)),
                {n: grown(c, float("nan")) for n, c in snap.cols.items()})

    def _refresh_incremental(self, store, snap: _MirrorSnapshot) -> bool:
        """Upload only the appended cells.  Sound exactly when nothing
        rearranged existing cells (shift_version unchanged) and counts
        only grew; returns False to request a full refresh otherwise."""
        t0 = time.perf_counter()
        gen0 = store.generation
        s_old = snap.counts.shape[0]
        s_new = store.num_series
        t_new = max(store.time_used, 1)
        if s_new < s_old or t_new < snap.t_used:
            return False
        if set(n for n, a in store.cols.items() if a is not None) \
                != set(snap.cols):
            return False                 # a column appeared (hist alloc)
        need = store_nbytes(store)
        if need > self.hbm_limit_bytes:
            return False                 # the full path raises
        if self.placed:
            # reserve the grown size before the upload (co-located
            # mirrors appending at once must see each other); over the
            # card's memory the full path refuses
            self._book(need)
            if placer.over_capacity(self.device):
                return False
        counts_new = store.counts[:s_new].astype(np.int32).copy()
        counts_old = np.zeros(s_new, dtype=np.int32)
        counts_old[:s_old] = snap.counts
        delta = counts_new - counts_old
        if (delta < 0).any():
            return False
        total_new = int(delta.sum())
        if total_new == 0 and s_new == s_old and t_new == snap.t_used:
            # bookkeeping-only generation bump
            self._publish(dataclasses.replace(snap, gen=gen0),
                          "bookkeeping", t0, 0)
            return True
        if total_new == 0:
            # series grew but no new cells (rows whose samples were all
            # dropped as out-of-order): pad-only, nothing to scatter
            return self._refresh_pad_only(store, snap, gen0, s_new, t_new,
                                          t0)
        if total_new > 0.5 * s_new * t_new:
            return False                 # a full upload is cheaper
        rows = np.flatnonzero(delta > 0)
        # the new cells, row-major over [rows, ascending positions]: the
        # validity mask [R, L] of each changed row's L slots and the
        # (row, position) of each new cell
        n_new = delta[rows]
        L = int(n_new.max())
        valid = np.arange(L)[None, :] < n_new[:, None]
        idx_p = (counts_old[rows][:, None] + np.arange(L)[None, :])[valid]
        idx_r = np.repeat(rows, n_new)
        off = _cells(store.ts, idx_r, idx_p) - snap.base_ms
        if off.size and (off.min() <= -(1 << 30) or off.max() >= (1 << 30)):
            return False                 # out of int32 offset range: re-base
        off = off.astype(np.int32)

        # uniform-grid preservation: every row appended the same offsets
        uniform = (snap.uniform_grid and s_new == s_old
                   and rows.size == s_new and bool((n_new == n_new[0]).all()))
        ts_row0 = None
        if uniform:
            off2 = off.reshape(s_new, -1)
            uniform = bool((off2 == off2[0:1]).all())
            if uniform:
                ts_row0 = np.full(t_new, PAD_TS, np.int32)
                ts_row0[:snap.t_used] = snap.ts_row0
                p0 = int(counts_old[0])
                ts_row0[p0:p0 + off2.shape[1]] = off2[0]

        counter_cols = {c.name for c in store.schema.data_columns
                        if c.detect_drops or c.counter}
        host_vbases = dict(snap.host_vbases)
        last_raw = dict(snap.tail_last_raw)
        cum_drop = dict(snap.tail_cum_drop)
        vbase_valid = dict(snap.vbase_valid)
        col_finite = dict(snap.col_finite)
        new_vals: Dict[str, np.ndarray] = {}     # f32 cells to scatter
        vb_changed: Dict[str, bool] = {}
        for name in snap.cols:
            tails = _tails_matrix(store.cols[name], idx_r, idx_p, valid)
            vb = host_vbases[name]
            vb_new = np.zeros((s_new,) + vb.shape[1:], np.float64)
            vb_new[:s_old] = vb
            if name in counter_cols:
                lr = np.full((s_new,) + vb.shape[1:], np.nan)
                lr[:s_old] = last_raw[name]
                cd = np.zeros((s_new,) + vb.shape[1:], np.float64)
                cd[:s_old] = cum_drop[name]
                seeded = np.concatenate([lr[rows][:, None], tails], axis=1)
                corr_seeded = host_counter_correct(seeded)
                vals = corr_seeded[:, 1:] + cd[rows][:, None]
                # the tail state of the seeded rows, each bucket a row
                n_lr, n_cd = (x.numpy().reshape(lr[rows].shape)
                              for x in _tail_state(
                                  *(bucket_rows(torch.from_numpy(a))
                                    if a.ndim == 3 else torch.from_numpy(a)
                                    for a in (seeded, corr_seeded))))
                upd = np.isfinite(n_lr)
                lr[rows] = np.where(upd, n_lr, lr[rows])
                cd[rows] = np.where(upd, cd[rows] + n_cd, cd[rows])
                last_raw[name] = lr
                cum_drop[name] = cd
            else:
                vals = tails
            # (re)establish vbase for any row/bucket whose base never came
            # from a finite sample: the first finite appended value becomes
            # the base — without this, large counters appended to an
            # all-NaN row land on the device un-rebased and their f32
            # deltas vanish
            vv = np.zeros((s_new,) + vb.shape[1:], dtype=bool)
            vv[:s_old] = vbase_valid[name]
            tail_fin = np.isfinite(vals).any(axis=1)       # [R(, B)]
            upd_vb = (~vv[rows]) & tail_fin
            vb_changed[name] = bool(upd_vb.any())
            if vb_changed[name]:
                vb_new[rows] = np.where(upd_vb, series_value_base(vals),
                                        vb_new[rows])
            vv[rows] = vv[rows] | tail_fin
            vbase_valid[name] = vv
            host_vbases[name] = vb_new
            # rebased cells in idx_r/idx_p's order
            cells = (vals - vb_new[rows][:, None])[valid]
            col_finite[name] = bool(col_finite.get(name, False)
                                    and np.isfinite(cells).all())
            new_vals[name] = cells.astype(np.float32)

        dev = self.device
        ts_dev, cols_dev = self._grown(snap, s_new, t_new)
        # one flat index into the new [s_new, t_new] arrays
        flat = idx_r * t_new + idx_p
        at = torch.from_numpy(flat).to(dev)
        ts_dev.view(-1)[at] = torch.from_numpy(off).to(dev)
        nbytes = flat.nbytes + off.nbytes
        for name, cells in new_vals.items():
            col = cols_dev[name]
            col.view((-1,) + col.shape[2:])[at] = \
                torch.from_numpy(cells).to(dev)
            nbytes += cells.nbytes
        new_vbases: Dict[str, torch.Tensor] = {}
        for name in snap.cols:
            if s_new != s_old or vb_changed[name]:
                new_vbases[name] = torch.from_numpy(
                    host_vbases[name]).to(dev)
                nbytes += host_vbases[name].nbytes
            else:
                new_vbases[name] = snap.vbases[name]
        counters.inc("device_mirror_incremental")
        self._publish(_MirrorSnapshot(
            gen0, snap.base_ms, t_new, ts_dev, cols_dev, new_vbases,
            counts=counts_new, vbase_valid=vbase_valid, uniform_grid=uniform,
            ts_row0=ts_row0, col_finite=col_finite,
            shift_version=store.shift_version, host_vbases=host_vbases,
            tail_last_raw=last_raw, tail_cum_drop=cum_drop),
            "incremental", t0, nbytes)
        return True

    def _refresh_pad_only(self, store, snap, gen0: int, s_new: int,
                          t_new: int, t0: float) -> bool:
        """Grow the snapshot to [s_new, t_new] when no cell value changed
        (new rows registered but all their samples dropped).  New rows
        start empty: PAD_TS offsets, NaN values, invalid vbase."""
        s_old = snap.counts.shape[0]
        ts_dev, cols_dev = self._grown(snap, s_new, t_new)

        def grow(a, fill):
            out = np.full((s_new,) + a.shape[1:], fill, a.dtype)
            out[:s_old] = a
            return out

        host_vbases, vbase_valid = {}, {}
        last_raw, cum_drop = dict(snap.tail_last_raw), dict(snap.tail_cum_drop)
        new_vbases = {}
        nbytes = 0
        for name in snap.cols:
            host_vbases[name] = grow(snap.host_vbases[name], 0.0)
            vbase_valid[name] = grow(snap.vbase_valid[name], False)
            if name in last_raw:
                last_raw[name] = grow(last_raw[name], np.nan)
                cum_drop[name] = grow(cum_drop[name], 0.0)
            if s_new != s_old:
                new_vbases[name] = torch.from_numpy(
                    host_vbases[name]).to(self.device)
                nbytes += host_vbases[name].nbytes
            else:
                new_vbases[name] = snap.vbases[name]
        counts_new = np.zeros(s_new, dtype=np.int32)
        counts_new[:s_old] = snap.counts
        counters.inc("device_mirror_incremental")
        # reachable only with new (empty) rows, which break grid uniformity
        self._publish(_MirrorSnapshot(
            gen0, snap.base_ms, t_new, ts_dev, cols_dev, new_vbases,
            counts=counts_new, vbase_valid=vbase_valid, uniform_grid=False,
            ts_row0=None, col_finite=dict(snap.col_finite),
            shift_version=store.shift_version, host_vbases=host_vbases,
            tail_last_raw=last_raw, tail_cum_drop=cum_drop), "pad", t0,
            nbytes)
        return True

    # ------------------------------------------------------------ reads

    def snapshot(self) -> Optional[_MirrorSnapshot]:
        """The current immutable snapshot (None before the first refresh).
        Callers pairing gather_cached with fused_eligible read it once
        and pass it to both."""
        return self._snap

    def fused_eligible(self, col_name: str, snap=None,
                       allow_ragged: bool = False) -> Optional[np.ndarray]:
        """Row-0 ts offsets (int32 [T], PAD_TS beyond counts) when the
        snapshot meets the fused preconditions for this column — one
        shared scrape grid and (unless allow_ragged) a fully-finite
        counted region — else None."""
        snap = snap if snap is not None else self._snap
        if snap is None or not snap.uniform_grid or snap.ts_row0 is None:
            return None
        if not snap.col_finite.get(col_name, False) and not allow_ragged:
            return None
        return snap.ts_row0

    def col_dense(self, col_name: str, snap=None) -> bool:
        """True when the column's counted region has no NaN holes."""
        snap = snap if snap is not None else self._snap
        return bool(snap is not None
                    and snap.col_finite.get(col_name, False))

    def gather_cached(self, rows: np.ndarray, snap=None
                      ) -> Optional[Tuple[torch.Tensor,
                                          Dict[str, torch.Tensor],
                                          Dict[str, torch.Tensor], int]]:
        """(ts_off [R, T], cols, vbases, base_ms) on the device for the
        requested rows of a snapshot — no host reads, no freshness check.
        Offsets are relative to base_ms; values rebased by vbases.  A
        histogram column comes back [R, T, B] with vbases [R, B]."""
        snap = snap if snap is not None else self._snap
        if snap is None:
            return None
        idx = torch.from_numpy(np.asarray(rows, np.int64)).to(self.device)
        ts_off = snap.ts_off.index_select(0, idx)
        cols = {name: arr.index_select(0, idx)
                for name, arr in snap.cols.items()}
        vbases = {name: vb.index_select(0, idx)
                  for name, vb in snap.vbases.items()}
        return ts_off, cols, vbases, snap.base_ms
