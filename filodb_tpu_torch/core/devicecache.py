"""Device-resident mirror of a shard's dense series store (port of
filodb_tpu/core/devicecache.py: the full upload only).

The mirror uploads a store's live arrays once and revalidates by the
store's generation counter: unchanged generation -> queries gather rows
on the device from the cached copy; changed generation -> one full
re-upload.  Timestamps become int32 offsets from the mirror's base, and
value columns are reset-corrected (counters) and rebased per series in
f64 before the f32 downcast.  Unlike the reference, that f64 work runs on
the mirror's device in row chunks (ops/counter.rebase_rows_t), not on the
host, and the columns are kept in f32, the type the fused kernels read.
A histogram column [S, T, B] is corrected and rebased per bucket along
time, with a base per (series, bucket).

Over the HBM cap the mirror raises MirrorCapExceeded; it never serves
from the host.  Incremental refresh, background rebuild, the cold
segment cache and multi-device placement are not ported.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from filodb_tpu_torch.ops.counter import rebase_rows_t
from filodb_tpu_torch.ops.hist import bucket_rows, from_bucket_rows
from filodb_tpu_torch.ops.timewindow import PAD_TS
from filodb_tpu_torch.utils.device import resolve_device

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


_mirror_serial = itertools.count(1)


def store_nbytes(store) -> int:
    """Device bytes of a store's mirror: int32 offsets, f32 values and an
    f64 base per series (per series and bucket for a histogram column)
    for each value column."""
    s, t = store.num_series, max(store.time_used, 1)
    n = s * t * 4
    for arr in store.cols.values():
        if arr is not None:
            b = arr.shape[2] if arr.ndim == 3 else 1
            n += (s * t * 4 + s * 8) * b
    return n


class DeviceMirror:
    """One mirror per DenseSeriesStore (attached lazily by the leaf)."""

    def __init__(self, hbm_limit_bytes: int = DEFAULT_HBM_LIMIT_BYTES,
                 device="cuda", shard_num: Optional[int] = None):
        self.hbm_limit_bytes = hbm_limit_bytes
        self.device = resolve_device(device)
        self.shard_num = shard_num
        self._snap: Optional[_MirrorSnapshot] = None
        # process-unique identity for external caches (id() is reused)
        self.serial = next(_mirror_serial)
        self.last_upload_s = 0.0

    def _refresh(self, store) -> bool:
        import time as _time
        # capture the version BEFORE copying host arrays: a mutation
        # landing mid-copy leaves the recorded generation stale, so the
        # next is_fresh check re-uploads (seqlock protocol)
        gen0 = store.generation
        nbytes = store_nbytes(store)
        if nbytes > self.hbm_limit_bytes:
            self._snap = None
            raise MirrorCapExceeded(
                f"device mirror needs {nbytes} bytes, over its cap of "
                f"{self.hbm_limit_bytes} (shard {self.shard_num})")
        t0 = _time.perf_counter()
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
        for name, arr in store.cols.items():
            if arr is None:
                continue
            bkt = arr.shape[2:]                  # (B,) for a histogram
            nb = bkt[0] if bkt else 1
            col = torch.empty((s, t) + bkt, dtype=torch.float32, device=dev)
            vb_all = torch.empty((s,) + bkt, dtype=torch.float64, device=dev)
            vb_ok = np.empty((s,) + bkt, dtype=bool)
            finite_ok = True
            for sl in chunks(max(1, UPLOAD_CHUNK_ROWS // nb)):
                v = torch.from_numpy(
                    np.ascontiguousarray(arr[sl, :t], np.float64)).to(dev)
                if bkt:
                    v = bucket_rows(v)     # each bucket a row along time
                rebased, vb, corrected = rebase_rows_t(v, name in counter_cols)
                fin = torch.isfinite(corrected)
                ok = fin.any(dim=1)
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
        ts_row0 = None
        if uniform:
            ts_row0 = ts_off[0].cpu().numpy().copy()
        self._snap = _MirrorSnapshot(gen0, base_ms, t, ts_off, cols, vbases,
                                     counts=counts, vbase_valid=vbase_valid,
                                     uniform_grid=uniform, ts_row0=ts_row0,
                                     col_finite=col_finite)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.last_upload_s = _time.perf_counter() - t0
        return True

    def is_fresh(self, store) -> bool:
        snap = self._snap
        return snap is not None and store.generation == snap.gen

    def ensure_fresh(self, store) -> bool:
        """Re-upload if the store moved on.  Callers exclude writers (hold
        the shard write lock): the refresh copies host arrays and must not
        race a mutation.  Raises MirrorCapExceeded over the cap."""
        if self.is_fresh(store):
            return True
        return self._refresh(store)

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
