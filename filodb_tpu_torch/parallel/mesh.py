"""Distributed query execution over a mesh of torch devices (port of
filodb_tpu/parallel/mesh.py).

The reference lays FiloDB's per-shard dense series arrays out on a JAX
device mesh and lets XLA collectives do the cross-shard reduce, in place
of FiloDB's serialized ExecPlan subtrees and ReduceAggregateExec:

  mesh axes:  ('shard', 'time')
    - 'shard': data parallelism over series: slot row s holds the series
      of one FiloDB shard (1 shard = 1 node, doc/sharding.md).
    - 'time':  the output window grid cut into n_time contiguous slices:
      slot (s, t) evaluates slice t over shard s's series.

Here a mesh is a [n_shard, n_time] grid of torch devices (Mesh).  One
device may fill several slots: a mesh over one card, `make_mesh(4, 2,
devices=[cuda:0] * 8)`, runs the same per-slot dispatch and merge as a
mesh over eight cards, and the CPU tests run `[cpu] * 8`.  A placed pack
(device_put_packed) holds shard row s's block once on each distinct
device of that row's slots.

The 3-phase aggregate contract (map / reduce / present) maps onto it as
  the map phase on each slot's device  ->  the merge of the slots'
  [G, W] partials in ascending shard order (merge_device_partials)  ->
  present on the host.

- sum/avg/count over the rate family and sum/avg/count/last_over_time on
  one shared scrape grid run the port's fused kernels (ops/fused.
  run_kernel: K1 dense rate family, K3 ragged rate, K4 last_over_time,
  K5 sum/avg/count_over_time) once per slot over the slot's block with
  time slice t's plan (_device_fused_call); every slot's launch is
  issued before the first readback, and only the partials merge.
- everything else takes the general path (distributed_window_agg): the
  port's ops/rangefns.evaluate_range_function and ops/agg.map_phase on
  each slot, then the merge with each component's combiner.

The merge: within one process the slots' partials are reduced in f64 in
ascending shard order, on the first slot's card when every slot is on a
card (the reference's psum over ICI) or on the host otherwise; the two
give the same bits.  A mesh that spans processes (parallel/multihost.py)
then all-reduces each process's merged partials over torch.distributed.

Pad rows of a shard block carry NaN values (PAD_TS timestamps), which the
map phase masks out, as the reference's static-shape packs do.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from filodb_tpu_torch.ops import agg as agg_ops
from filodb_tpu_torch.ops import fused
from filodb_tpu_torch.ops.rangefns import evaluate_range_function
from filodb_tpu_torch.ops.timewindow import PAD_TS
from filodb_tpu_torch.query.execbase import _lru_touch
from filodb_tpu_torch.utils.counters import counters
from filodb_tpu_torch.utils.device import resolve_device
from filodb_tpu_torch.utils.devicetelem import telem
from filodb_tpu_torch.utils.metrics import log_error_once, registry


PACK_WORKERS = 3
"""Shard rows lookup_and_pack gathers, corrects and places at once: each
holds ~7 GB of host arrays at ~262,144 series x 720 samples."""

GATHER_ROWS = 65_536
"""Rows of a shard read, corrected and rebased at a time while packing."""

PACK_CACHE_MAX = 8
"""Packs a MeshExecutor keeps on its devices, least recently used out (a
1M-series pack holds ~6.7 GB)."""


# --------------------------------------------------------------------- mesh

class Mesh:
    """A ('shard', 'time') grid of torch devices.

    devices: [n_shard, n_time] object array of torch.device (None for a
    slot another process owns).  owner: the rank that owns each slot
    (all 0 in one process); rank: this process's rank."""

    axis_names = ("shard", "time")

    def __init__(self, devices: np.ndarray, owner: Optional[np.ndarray] = None,
                 rank: int = 0):
        self.devices = devices
        n_shard, n_time = devices.shape
        self.shape = {"shard": n_shard, "time": n_time}
        self.owner = (np.zeros((n_shard, n_time), np.int64) if owner is None
                      else np.asarray(owner, np.int64))
        self.rank = rank
        self.world = int(self.owner.max()) + 1

    def is_local(self, s: int, t: int) -> bool:
        return int(self.owner[s, t]) == self.rank

    def local_slots(self) -> List[Tuple[int, int]]:
        """This process's slots, shard-major (ascending shard order)."""
        n_shard, n_time = self.devices.shape
        return [(s, t) for s in range(n_shard) for t in range(n_time)
                if self.is_local(s, t)]

    def local_shard_rows(self) -> List[int]:
        return sorted({s for s, _ in self.local_slots()})

    @property
    def addressable(self) -> bool:
        """Every slot is this process's."""
        return bool((self.owner == self.rank).all())

    def local_devices(self) -> List[torch.device]:
        return [self.devices[s, t] for s, t in self.local_slots()]

    def __repr__(self) -> str:
        return (f"Mesh(shard={self.shape['shard']}, time={self.shape['time']},"
                f" devices={sorted({str(d) for d in self.local_devices()})},"
                f" rank={self.rank}/{self.world})")


def _dev_key(device: torch.device) -> str:
    return str(device)


def make_mesh(n_shard: int, n_time: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ('shard', 'time') mesh from the first n_shard * n_time
    devices: the cards (torch.cuda.device_count()) when `devices` is None,
    else the given devices, where one device may repeat (a mesh over one
    card, or the CPU tests' `[cpu] * 8`).  Raises when there are fewer
    devices than slots.  Devices beyond n_shard * n_time are left out,
    logged once (an operator sizing 8-way scaling for a 6-shard dataset
    would otherwise idle 2 cards unknowingly); the shape is exposed as the
    gauges mesh_shard_axis / mesh_time_axis / mesh_unused_devices."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [resolve_device(d) for d in devices]
    need = n_shard * n_time
    if len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)}")
    if len(devs) > need:
        log_error_once(
            "mesh_unused_devices",
            RuntimeWarning(
                f"mesh ({n_shard} shard x {n_time} time) uses {need} of "
                f"{len(devs)} devices; {len(devs) - need} idle: resize "
                f"the mesh axes to cover the devices"))
    registry.gauge("mesh_shard_axis").update(n_shard)
    registry.gauge("mesh_time_axis").update(n_time)
    registry.gauge("mesh_unused_devices").update(len(devs) - need)
    grid = np.empty((n_shard, n_time), dtype=object)
    for i, d in enumerate(devs[:need]):
        grid[i // n_time, i % n_time] = d
    return Mesh(grid)


# ---------------------------------------------------------------- packing

@dataclasses.dataclass
class PackedShards:
    """Uniform pack of per-shard series blocks.

    ts_off  [D, S, T] int32 window-offset timestamps (PAD_TS past each row)
    values  [D, S, T] float  (NaN for padded rows)
    group_ids [D, S] int32   global aggregation-group slot per series row
    num_groups               group count (for segment reductions)
    group_labels             slot -> label dict (for presenting results)
    base_ms                  common timestamp base
    n_series                 true (unpadded) series count per shard

    On the host (pack_shards) the arrays are numpy; device_put_packed
    turns ts_off, values, group_ids and vbase into SlotArrays (tensors on
    the mesh's devices) and keeps the host group ids in host_group_ids.
    """
    ts_off: object
    values: object
    group_ids: object
    num_groups: int
    group_labels: List[Dict[str, str]]
    base_ms: int
    n_series: np.ndarray
    # per-series value base subtracted on the host in f64 (ops/counter.
    # rebase_values) so counter deltas survive the f32 device downcast
    vbase: Optional[object] = None          # [D, S]
    precorrected: bool = False
    # fused-kernel eligibility: when every real row of every shard shares
    # ONE scrape grid, the shared row (int32 [T], PAD_TS tail), else None
    shared_ts_row: Optional[np.ndarray] = None
    # series per aggregation group over REAL rows (present-count math)
    gsize: Optional[np.ndarray] = None
    # False when any counted cell is non-finite: the rate family then runs
    # its valid-boundary variant (the ragged kernel K3); computed once at
    # pack time on the host arrays
    dense: bool = True
    # host per-shard pid arrays in pack-row order (None for empty shards):
    # run_agg_batch recomputes OTHER groupings over the SAME rows
    pids_by_shard: Optional[List[np.ndarray]] = None
    # host views kept by device_put_packed for a dense pack whose slots
    # are not all on cards: the host fused route (ops/hostleaf) reads them
    host_values: Optional[np.ndarray] = None
    host_vbase: Optional[np.ndarray] = None
    host_group_ids: Optional[np.ndarray] = None

    @property
    def n_shards(self) -> int:
        return self.ts_off.shape[0]


class SlotArrays:
    """One array of a placed pack: shard row s's block as a tensor on each
    distinct device of row s's slots (the reference's replication over
    'time'; a device named in several slots holds one copy).  `shape` is
    the pack's [D, S(, T)]; `padded` blocks are the kernels' [Sp, Tp]
    (values) or [Sp] (bases) layout, whose leading [S, T] view is the
    array itself."""

    def __init__(self, shape: Tuple[int, ...],
                 parts: Dict[Tuple[int, str], torch.Tensor],
                 padded: bool = False):
        self.shape = tuple(shape)
        self.parts = parts
        self.padded = padded

    def block(self, s: int, device) -> torch.Tensor:
        """Shard row s's [S(, T)] block on `device`."""
        x = self.parts[(s, _dev_key(device))]
        if not self.padded:
            return x
        return x[:self.shape[1], :self.shape[2]] if x.ndim == 2 \
            else x[:self.shape[1]]

    def kernel_block(self, s: int, device) -> torch.Tensor:
        """The padded block as the kernels read it."""
        return self.parts[(s, _dev_key(device))]

    @property
    def nbytes(self) -> int:
        return sum(int(t.numel()) * t.element_size()
                   for t in self.parts.values())


class GroupRegistry:
    """Global aggregation-group slot assignment shared across shards (and
    across queries, when cached by MeshExecutor): group key -> stable slot.
    Group identity follows by/without label semantics (ref:
    exec/AggrOverRangeVectors.scala AggregateMapReduce grouping)."""

    def __init__(self, by: Sequence[str] = (), without: Sequence[str] = ()):
        self.by = frozenset(by) if by else None
        self.drop = (set(without) | {"_metric_", "__name__"}) if without else None
        self.slot_of: Dict[Tuple[Tuple[str, str], ...], int] = {}
        self.labels: List[Dict[str, str]] = []

    def slot_for(self, items: Tuple[Tuple[str, str], ...]) -> int:
        """items: the series' sorted (label, value) tuple."""
        if self.by is not None:
            key = tuple((k, v) for k, v in items if k in self.by)
        elif self.drop is not None:
            key = tuple((k, v) for k, v in items if k not in self.drop)
        else:
            key = ()
        slot = self.slot_of.get(key)
        if slot is None:
            slot = len(self.labels)
            self.slot_of[key] = slot
            self.labels.append(dict(key))
        return slot


def pack_shards(blocks: Sequence[Tuple],
                by: Sequence[str] = (), without: Sequence[str] = (),
                base_ms: int = 0,
                pad_series_to: Optional[int] = None,
                pad_time_to: Optional[int] = None,
                precorrected: bool = False,
                group_labels: Optional[List[Dict[str, str]]] = None
                ) -> PackedShards:
    """Pack per-shard (ts_off [S,T], vals [S,T], series label dicts[,
    vbase [S]]) into the uniform [D, S, T] layout, assigning
    globally-consistent group slots.

    Group identity follows the reference's by/without label semantics:
    group key = labels restricted to `by` (or all minus `without`).

    Each block's third element is either a per-series label sequence
    (dicts or sorted (k, v) tuples) grouped here, or a precomputed int32
    gid array already compacted to [0, len(group_labels)): the cached
    fast path that avoids per-series Python work entirely (see
    MeshExecutor._gids_for, which also does the per-query compaction).
    """
    D = len(blocks)
    S = pad_series_to or max((b[0].shape[0] for b in blocks), default=1)
    T = pad_time_to or max((b[0].shape[1] for b in blocks), default=1)
    S, T = max(S, 1), max(T, 1)

    reg = GroupRegistry(by, without)

    ts = np.full((D, S, T), PAD_TS, dtype=np.int32)
    vals = np.full((D, S, T), np.nan, dtype=np.float64)
    gids = np.zeros((D, S), dtype=np.int32)
    nser = np.zeros(D, dtype=np.int32)
    vbase = np.zeros((D, S), dtype=np.float64)
    any_vbase = False

    for d, blk in enumerate(blocks):
        t, v, labels = blk[0], blk[1], blk[2]
        if len(blk) > 3 and blk[3] is not None:
            vbase[d, :len(blk[3])] = blk[3]
            any_vbase = True
        s, tt = t.shape
        ts[d, :s, :tt] = t
        vals[d, :s, :tt] = v
        # real series = labeled rows; an empty shard's placeholder block
        # carries a single all-PAD row with NO labels: that row is
        # padding, not data (no group size, no grid uniformity)
        if isinstance(labels, np.ndarray):
            nser[d] = labels.shape[0]
            gids[d, :labels.shape[0]] = labels
        else:
            nser[d] = min(s, len(labels))
            for i, lab in enumerate(labels):
                items = (lab if isinstance(lab, tuple)
                         else tuple(sorted(lab.items())))
                gids[d, i] = reg.slot_for(items)

    labels_out = group_labels if group_labels is not None else list(reg.labels)
    num_groups = max(len(labels_out), 1)
    # fused-kernel eligibility: one shared grid across every real row
    shared_row = None
    ref = None
    for d in range(D):
        n = nser[d]
        if n == 0:
            continue
        if ref is None:
            ref = ts[d, 0]
        rows = ts[d, :n]
        if not (rows == ref[None, :]).all():
            ref = None
            break
    if ref is not None:
        shared_row = ref.copy()
    gsize = np.zeros(num_groups, dtype=np.int64)
    for d in range(D):
        if nser[d]:
            gsize += np.bincount(gids[d, :nser[d]],
                                 minlength=num_groups)[:num_groups]
    # dense = every counted cell finite (tracked apart from grid sharing:
    # a uniform-grid pack with NaN holes keeps its shared_ts_row and runs
    # the ragged kernel).  isfinite, not isnan: an inf sample would be
    # zeroed by the dense block's fill
    dense = all(
        nser[d] == 0
        or bool((np.isfinite(vals[d, :nser[d]])
                 | (ts[d, :nser[d]] >= PAD_TS)).all())
        for d in range(D))
    return PackedShards(ts, vals, gids, num_groups,
                        labels_out, base_ms, nser,
                        vbase=vbase if any_vbase else None,
                        precorrected=precorrected,
                        shared_ts_row=shared_row, gsize=gsize,
                        dense=dense)


def _row_devices(mesh: Mesh, s: int) -> List[torch.device]:
    """The distinct devices of shard row s's local slots."""
    seen: Dict[str, torch.device] = {}
    for t in range(mesh.shape["time"]):
        if mesh.is_local(s, t):
            d = mesh.devices[s, t]
            seen.setdefault(_dev_key(d), d)
    return list(seen.values())


def _pad_block(v: np.ndarray, ragged: bool, Sp: int, Tp: int,
               device) -> torch.Tensor:
    """One shard's [S, T] values as the kernels' f32 [Sp, Tp] block:
    ragged packs keep their NaNs (absent samples) and pad with NaN;
    dense packs are zero-filled, their NaN cells being exactly pad rows
    and columns past the count, which then contribute +0 (pallas mesh
    path, mesh.py:307-319)."""
    S, T = v.shape
    x = torch.from_numpy(np.ascontiguousarray(v, np.float32))
    if not ragged:
        x = torch.nan_to_num(x)
    out = torch.full((Sp, Tp), float("nan") if ragged else 0.0,
                     dtype=torch.float32, device=device)
    out[:S, :T] = x.to(device)
    return out


def device_put_packed(packed: PackedShards, mesh: Mesh,
                      rows: Optional[Sequence[int]] = None) -> PackedShards:
    """Place packed arrays on the mesh: shard row s's block on each
    distinct device of its slots (every time slice needs the full series:
    windows reach back `range` into the data).  Values go as the kernels'
    padded f32 block; vbase as f64 [S]; ts_off int32 and group ids int32
    for the general path.  `rows[i]` is the mesh row of the pack's block i
    (default: the same index; parallel/multihost places a process's own
    rows this way).  The host arrays are dropped, except the group ids
    (host_group_ids) and, for a dense pack with slots off the cards, the
    host views the host fused route reads (host_values, host_vbase)."""
    D, S, T = packed.ts_off.shape
    n_shard = mesh.shape["shard"]
    rows = list(range(D)) if rows is None else list(rows)
    Sp, Tp = fused.pad_series_count(S), fused._pad_to(T, fused._LANE)
    ragged = not packed.dense
    ts_p, v_p, g_p, vb_p = {}, {}, {}, {}
    for i, s in enumerate(rows):
        for dev in _row_devices(mesh, s):
            k = (s, _dev_key(dev))
            ts_p[k] = torch.from_numpy(
                np.ascontiguousarray(packed.ts_off[i])).to(dev)
            v_p[k] = _pad_block(packed.values[i], ragged, Sp, Tp, dev)
            g_p[k] = torch.from_numpy(
                np.ascontiguousarray(packed.group_ids[i])).to(dev)
            vb = (np.zeros(S) if packed.vbase is None
                  else packed.vbase[i])
            vb_p[k] = torch.from_numpy(
                np.ascontiguousarray(vb, np.float64)).to(dev)
    keep_host = packed.dense and any(
        d.type != "cuda" for d in mesh.local_devices())
    host_vals = np.asarray(packed.values) if keep_host else None
    return dataclasses.replace(
        packed,
        ts_off=SlotArrays((n_shard, S, T), ts_p),
        values=SlotArrays((n_shard, S, T), v_p, padded=True),
        group_ids=SlotArrays((n_shard, S), g_p),
        vbase=SlotArrays((n_shard, S), vb_p),
        host_values=host_vals,
        host_vbase=(np.asarray(packed.vbase)
                    if keep_host and packed.vbase is not None else None),
        host_group_ids=np.asarray(packed.group_ids))


def _slot_input(x, mesh: Mesh, s: int, t: int) -> torch.Tensor:
    """Shard row s's block of x on slot (s, t)'s device: a SlotArrays
    block, or row s of a host array ([D, ...] numpy or tensor) moved
    there."""
    dev = mesh.devices[s, t]
    if isinstance(x, SlotArrays):
        return x.block(s, dev)
    return torch.as_tensor(np.asarray(x[s]) if not isinstance(
        x, torch.Tensor) else x[s]).to(dev)


# ------------------------------------------------------- per-slot dispatch
#
# Slot (s, t) runs the single-card kernel over shard row s's block with
# time slice t's plan, and only the [G, W] group partials leave the slot:
# the reference's per-device fused dispatch (_device_fused_call), which
# never put the kernel under shard_map.

def _slot_csr(gids: np.ndarray, G: int, device) -> fused.GroupCSR:
    """The kernels' CSR (rows by group, ascending row order) over one
    slot's real rows; rows with a negative id are in no group."""
    g = np.asarray(gids, np.int32)
    keep = np.flatnonzero(g >= 0)
    gk = g[keep]
    order = keep[np.argsort(gk, kind="stable")].astype(np.int32)
    sizes = np.bincount(gk, minlength=G)[:G]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    return fused.GroupCSR(torch.from_numpy(order).to(device), offsets)


def _merged_csr(gids_cols: Sequence[np.ndarray], Gs: Sequence[int],
                device) -> fused.GroupCSR:
    """P panels' groupings of one slot's rows as ONE CSR over disjoint
    group-id ranges (ops/fused.merge_groups)."""
    csrs = [fused.PaddedGroups(None, None, _slot_csr(g, G, device))
            for g, G in zip(gids_cols, Gs)]
    csr, _, _ = fused.merge_groups(csrs, Gs)
    return csr


def _pad_run_single(vals_p, vb, csr, rows: fused.PlanRows, *, G: int,
                    is_counter: bool, is_rate: bool,
                    kind: str = "rate_family", ragged: bool = False):
    """ONE slot's kernel call, on the device of its block.  The values
    are the kernels' padded f32 [Sp, Tp] block as device_put_packed placed
    it (dense: zero fill, ragged: NaN fill); the [S] f64 bases are padded
    here, on that device, to f32 [Sp].  Then the single-card kernel (K1/K3
    rate family, K4 last_over_time, K5 sum/avg/count_over_time) runs with
    the slot's time slice plan rows -> the [G, W] group partials (and
    presence when ragged).  with_drops is always False: counter functions
    require a precorrected pack."""
    vbase_p = torch.zeros(vals_p.shape[0], dtype=torch.float32,
                          device=vals_p.device)
    vbase_p[:vb.shape[0]] = vb.to(torch.float32)
    res = fused.run_kernel(vals_p, vbase_p, csr, rows,
                           num_groups=fused.pad_group_count(G),
                           is_counter=is_counter, is_rate=is_rate,
                           with_drops=False, kind=kind, ragged=ragged,
                           gather=fused.gather_default(kind))
    if ragged:
        return res[0][:G], res[1][:G]
    return res[:G]


def _device_fused_call(packed: PackedShards, s: int, device, csr,
                       rows: fused.PlanRows, *, G: int, is_counter: bool,
                       is_rate: bool, kind: str = "rate_family",
                       ragged: bool = False):
    """Slot (s, t)'s share of the fused mesh scan: shard row s's blocks
    of a placed pack on the slot's device through _pad_run_single.  Only
    the partials it returns leave the slot."""
    return _pad_run_single(packed.values.kernel_block(s, device),
                           packed.vbase.block(s, device), csr, rows, G=G,
                           is_counter=is_counter, is_rate=is_rate,
                           kind=kind, ragged=ragged)


def _mesh_fused_call(mesh: Mesh, packed: PackedShards, csrs, plans, *,
                     G: int, is_counter: bool, is_rate: bool,
                     kind: str = "rate_family", ragged: bool = False):
    """The fused mesh scan over a placed pack: _device_fused_call on
    every local slot (time slice t with plans[t], the slot device's CSR
    csrs[(s, device key)]), every launch issued before the merge reads
    any back, then merge_device_partials -> [G, n_time * W] f64 sums (and
    presence when ragged).  The reference keeps this entry to trace its
    kernel inside shard_map for A/B tooling; the port traces nothing, and
    the executor's fused route runs through it.  Each slot dispatch is
    one `mesh_fused` ledger entry (its issue wall), the merge one
    `mesh_merge` entry (the wait for the slots and the reduce)."""
    D, S, T = packed.ts_off.shape
    sig = f"S{S}xT{T}xG{G}:{kind}" + (":ragged" if ragged else "")
    sums: Dict[Tuple[int, int], torch.Tensor] = {}
    cnts: Dict[Tuple[int, int], torch.Tensor] = {}
    for s, t in mesh.local_slots():
        dev = mesh.devices[s, t]
        d0 = time.perf_counter()
        res = _device_fused_call(
            packed, s, dev, csrs[(s, _dev_key(dev))],
            plans[t].device_rows(dev), G=G, is_counter=is_counter,
            is_rate=is_rate, kind=kind, ragged=ragged)
        telem.record_dispatch(
            "mesh_fused", device=dev, shape=sig,
            seconds=time.perf_counter() - d0,
            bytes_in=int(packed.values.kernel_block(s, dev).numel()) * 4)
        if ragged:
            sums[(s, t)], cnts[(s, t)] = res
        else:
            sums[(s, t)] = res
    m0 = time.perf_counter()
    out = merge_device_partials(sums, mesh, "sum")
    cnt = merge_device_partials(cnts, mesh, "sum") if ragged else None
    telem.record_dispatch(
        "mesh_merge", device=mesh.devices[mesh.local_slots()[0]],
        shape=f"D{D}xG{G}", seconds=time.perf_counter() - m0,
        bytes_out=int(out.nbytes))
    return (out, cnt) if ragged else out


def _combine(combs, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Combine two partials with one combiner (sum, min, max), or one per
    trailing component."""
    if not isinstance(combs, str):
        if len(set(combs)) > 1:
            return torch.stack([_combine(c, a[..., i], b[..., i])
                                for i, c in enumerate(combs)], -1)
        combs = combs[0]
    if combs == "sum":
        return a + b
    return torch.minimum(a, b) if combs == "min" else torch.maximum(a, b)


def _reduce_slots(parts, mesh: Mesh, combs, device) -> torch.Tensor:
    """The local slots' partials reduced on `device` in f64, in ascending
    shard order, each time slice's beside the last -> [G, n_time * W,
    ...]."""
    slots = mesh.local_slots()
    cols = []
    for t in sorted({t for _, t in slots}):
        acc = None
        for s in sorted(s for s, tt in slots if tt == t):
            x = torch.as_tensor(parts[(s, t)]).to(device, torch.float64)
            acc = x if acc is None else _combine(combs, acc, x)
        cols.append(acc)
    return torch.cat(cols, dim=1)


def _merge_partials_collective(mesh: Mesh, parts, combs) -> torch.Tensor:
    """The in-process cross-slot reduce on the card: every local slot's
    partial copied to the first slot's device and reduced there (the
    reference's psum over ICI).  The partials are KBs, so the copies cost
    nothing next to the kernels, and the f64 adds in the host merge's
    order give the host merge's bits."""
    return _reduce_slots(parts, mesh, combs,
                         mesh.devices[mesh.local_slots()[0]])


def _merge_slots(parts, mesh: Mesh, combs,
                 collective: Optional[bool] = None) -> np.ndarray:
    """Merge the local slots' partials (any trailing shape, [G, W, ...])
    -> [G, n_time * W, ...] float64, then across processes when the mesh
    spans them (multihost.all_reduce_partials)."""
    if collective is None:
        collective = all(mesh.devices[st].type == "cuda"
                         for st in mesh.local_slots())
    if collective and mesh.shape["shard"] > 1:
        counters.inc("mesh_partials_collective_merge")
        out = _merge_partials_collective(mesh, parts, combs)
    else:
        counters.inc("mesh_partials_host_merge")
        out = _reduce_slots(parts, mesh, combs, torch.device("cpu"))
    if mesh.world > 1:
        from filodb_tpu_torch.parallel import multihost
        return multihost.all_reduce_partials(out, combs)
    return out.cpu().numpy()


def merge_device_partials(parts: Dict[Tuple[int, int], torch.Tensor],
                          mesh: Mesh, comb: str = "sum",
                          collective: Optional[bool] = None) -> np.ndarray:
    """Merge per-slot [G, W] partials -> [G, n_time * W] float64.

    parts[(s, t)] is slot (s, t)'s partial (shard s, time slice t), for
    this process's slots.  In one process the partials are reduced in
    f64 in ascending shard order with `comb` (sum, min or max, the
    combiners of ops/agg.reduce_phase): on the first slot's card when
    `collective` (default: every slot on a card and more than one shard
    row; the reference's rule is "the backend has ICI"), else on the host.
    Both give the same bits.  A mesh that spans processes then
    all-reduces the processes' merged partials (parallel/multihost)."""
    return _merge_slots(parts, mesh, comb, collective)


# ----------------------------------------------------- the general path

def distributed_window_agg(mesh: Mesh, ts_off, values, group_ids, wends, *,
                           range_ms, fn_name, params=(), agg_op="sum",
                           num_groups=1, base_ms=0, vbase=None,
                           precorrected=False, dense=True) -> torch.Tensor:
    """The general distributed query step: windowed range function +
    cross-shard aggregate over the ('shard', 'time') mesh.

    ts_off / values [D, S, T], group_ids / vbase [D, S]: a placed pack's
    SlotArrays or host arrays (each slot then uploads its row); wends
    [W] int32 offsets, W a multiple of n_time, slot (s, t) evaluating
    slice t.  Each slot runs ops/rangefns.evaluate_range_function and
    ops/agg.map_phase on its device; the partials merge with each
    component's combiner (merge_device_partials).  Returns the partial
    components [G, W, C] f64 on the host: ops/agg.present finishes it."""
    n_time = mesh.shape["time"]
    wends = np.asarray(wends, np.int32)
    Wl = wends.shape[0] // n_time
    parts = {}
    ncomp = None
    for s, t in mesh.local_slots():
        dev = mesh.devices[s, t]
        ts = _slot_input(ts_off, mesh, s, t)
        v = _slot_input(values, mesh, s, t)
        g = _slot_input(group_ids, mesh, s, t)
        vb = (torch.zeros(v.shape[0], dtype=torch.float64, device=dev)
              if vbase is None else _slot_input(vbase, mesh, s, t))
        w = torch.from_numpy(np.ascontiguousarray(
            wends[t * Wl:(t + 1) * Wl])).to(dev)
        res = evaluate_range_function(ts, v, w, range_ms, fn_name, params,
                                      float(base_ms), vbase=vb,
                                      precorrected=precorrected,
                                      dense=dense)
        gh = g.cpu().numpy()
        csr = _slot_csr(gh, num_groups, dev)
        part = agg_ops.map_phase(agg_op, res, g, num_groups, csr=csr)
        parts[(s, t)] = part
        ncomp = part.shape[-1]
    combs = agg_ops.combiners_for(agg_op, ncomp or 1)
    return torch.from_numpy(np.ascontiguousarray(
        _merge_slots(parts, mesh, tuple(combs))))


def distributed_window_raw(mesh: Mesh, ts_off, values, wends, *, range_ms,
                           fn_name, params=(), base_ms=0, vbase=None,
                           precorrected=False, dense=True) -> torch.Tensor:
    """Un-aggregated distributed evaluation -> [D, S, W] on the host (the
    DistConcatExec analogue): each slot evaluates its shard row's series
    over its window slice.  Rows of another process's slots stay NaN."""
    n_time = mesh.shape["time"]
    wends = np.asarray(wends, np.int32)
    Wl = wends.shape[0] // n_time
    D, S = ts_off.shape[0], ts_off.shape[1]
    out = torch.full((D, S, wends.shape[0]), float("nan"))
    for s, t in mesh.local_slots():
        dev = mesh.devices[s, t]
        ts = _slot_input(ts_off, mesh, s, t)
        v = _slot_input(values, mesh, s, t)
        vb = (torch.zeros(v.shape[0], dtype=torch.float64, device=dev)
              if vbase is None else _slot_input(vbase, mesh, s, t))
        w = torch.from_numpy(np.ascontiguousarray(
            wends[t * Wl:(t + 1) * Wl])).to(dev)
        res = evaluate_range_function(ts, v, w, range_ms, fn_name, params,
                                      float(base_ms), vbase=vb,
                                      precorrected=precorrected,
                                      dense=dense)
        out[s, :, t * Wl:(t + 1) * Wl] = res.to(out.dtype).cpu()
    return out


def _host_counts(gsize: np.ndarray, wvalid: np.ndarray) -> np.ndarray:
    """Dense-pack present counts: every REAL series emits a value exactly
    where the shared window is valid: counts[g, w] = |group g| * valid[w].
    The single home of the formula for both the kernel-route epilogue and
    the dense count panels (_finish_count_panels)."""
    return gsize[:, None] * wvalid[None, :].astype(np.float64)


def _join_rows(parts: Sequence[PackedShards],
               precorrected: bool) -> PackedShards:
    """One placed pack from placed one-row packs
    (device_put_packed(rows=[r]) each, in row order, all packed with the
    same group labels, S and T): their devices' blocks together, the
    group sizes summed, the shared grid where every row with series has
    the same one, dense where every row is."""
    first = parts[0]

    def joined(name):
        x = getattr(first, name)
        return SlotArrays(x.shape, {k: v for p in parts
                                    for k, v in getattr(p, name).parts.items()},
                          padded=x.padded)
    grids = [p.shared_ts_row for p in parts if int(p.n_series.sum())]
    shared = grids[0] if grids and all(
        g is not None and np.array_equal(g, grids[0]) for g in grids) \
        else None
    hv = [p.host_values for p in parts]
    S = first.host_group_ids.shape[1]
    return dataclasses.replace(
        first, ts_off=joined("ts_off"), values=joined("values"),
        group_ids=joined("group_ids"), vbase=joined("vbase"),
        n_series=np.concatenate([p.n_series for p in parts]),
        gsize=np.sum([p.gsize for p in parts], axis=0),
        shared_ts_row=shared, dense=all(p.dense for p in parts),
        precorrected=precorrected,
        host_group_ids=np.concatenate([p.host_group_ids for p in parts]),
        host_values=(np.concatenate(hv) if all(h is not None for h in hv)
                     else None),
        host_vbase=(np.concatenate([
            p.host_vbase if p.host_vbase is not None else np.zeros((1, S))
            for p in parts]) if all(h is not None for h in hv) else None))


# ----------------------------------------------------------- executor glue

class MeshExecutor:
    """Bridges a multi-shard TimeSeriesMemStore to the mesh path.

    The moral equivalent of the reference's QueryActor + dispatcher
    wiring, minus the actors: shard lookup happens on the host per shard,
    data ships to the mesh's devices once (the pack cache), and the
    aggregate runs as one dispatch per slot plus a merge of partials.

    A mesh that spans processes (parallel/multihost.global_mesh): each
    process's memstore holds its own shard rows, in mesh-row order; the
    processes agree on the group slots, the grid and the flags at every
    pack (multihost.agree_pack, a collective), so they skip the pack
    cache and the layout memo, and run_agg_batch runs its panels one at a
    time.  Every process must make the same calls in the same order."""

    def __init__(self, memstore, dataset: str, mesh: Mesh):
        self.memstore = memstore
        self.dataset = dataset
        self.mesh = mesh
        self.n_shard = mesh.shape["shard"]
        # (by, without) -> (GroupRegistry, per-shard pid->slot arrays):
        # slots are assigned once per series lifetime; repeat queries map
        # pids to group slots with one numpy gather
        self._group_caches: Dict[Tuple, Tuple[GroupRegistry, Dict[int, np.ndarray]]] = {}
        # device-resident pack cache, revalidated by every shard's
        # (partition count, store generations) signature
        self._pack_cache: Dict[Tuple, Dict] = {}
        # packing-LAYOUT memo, validated against the actual per-shard pid
        # sets the index lookup returns: survives value-level
        # invalidations of _pack_cache (mesh_pack_memo_hits)
        self._pack_layout_memo: Dict[Tuple, Dict] = {}
        # (shared_ts_row, wends, range) -> (per-slice plans, wvalid,
        # wvalid1); the plans keep their rows per device
        self._fused_plan_cache: Dict[Tuple, Tuple] = {}
        # run_agg_batch: merged per-slot CSRs, and the panel groupings
        self._batch_gid_cache: Dict[Tuple, Dict] = {}
        self._panel_group_cache: Dict[Tuple, Dict] = {}
        # the pack's own grouping per slot: (id(pack), s, device) -> CSR
        self._csr_cache: Dict[Tuple, Dict] = {}
        # queries can reach the executor from HTTP worker threads: every
        # cache read-modify-write holds this lock; device work runs
        # outside it
        self._cache_lock = threading.Lock()

    @property
    def _multi(self) -> bool:
        return self.mesh.world > 1

    def _cluster_sig(self) -> Tuple:
        return tuple(
            (sh.shard_num, len(sh.partitions),
             tuple((name, st.generation)
                   for name, st in sorted(sh.stores.items())))
            for sh in self.memstore.shards_for(self.dataset))

    def _gids_for(self, shard, pids: np.ndarray,
                  by: Sequence[str], without: Sequence[str]
                  ) -> Tuple[np.ndarray, GroupRegistry]:
        ck = (tuple(by), tuple(without))
        # the whole resolve runs under the lock: GroupRegistry.slot_for is
        # check-then-insert and the per-shard array is read-modify-written
        with self._cache_lock:
            entry = self._group_caches.get(ck)
            if entry is None:
                entry = (GroupRegistry(by, without), {})
                self._group_caches[ck] = entry
            reg, per_shard = entry
            arr = per_shard.get(shard.shard_num)
            n = len(shard.partitions)
            if arr is None:
                arr = np.full(n, -1, dtype=np.int32)
            elif arr.shape[0] < n:
                arr = np.concatenate(
                    [arr, np.full(n - arr.shape[0], -1, dtype=np.int32)])
            need = arr[pids] < 0
            if need.any():
                new_pids = pids[need]
                keys = shard.keys_for(new_pids)
                for pid, key in zip(new_pids.tolist(), keys):
                    arr[pid] = reg.slot_for(key.labels)
            per_shard[shard.shard_num] = arr
            return arr[pids], reg

    def lookup_and_pack(self, filters, start_ms: int, end_ms: int,
                        by: Sequence[str] = (),
                        without: Sequence[str] = (),
                        fn_name: Optional[str] = None
                        ) -> Optional[PackedShards]:
        """fn_name (the range function the pack will feed) selects counter
        semantics: counter columns are reset-corrected on the host in f64
        so f32 deltas on the device are exact, as the leaf does.

        Packs are cached on the devices: a repeat query over unchanged
        data (validated by per-shard generation signatures) reuses the
        resident blocks; run_agg rebases any window grid onto the pack's
        base, so the cache serves rolling windows too, as long as the
        requested range lies inside the one the pack was gathered for."""
        from filodb_tpu_torch.ops.counter import rebase_values
        from filodb_tpu_torch.ops.rangefns import RANGE_FUNCTIONS
        from filodb_tpu_torch.ops.timewindow import to_offsets
        ck = (tuple(str(f) for f in filters), tuple(by), tuple(without),
              fn_name)
        sig = self._cluster_sig()
        if not self._multi:
            with self._cache_lock:
                # stale entries pin device memory for nothing
                for k in [k for k, e in self._pack_cache.items()
                          if e["sig"] != sig]:
                    del self._pack_cache[k]
                ent = self._pack_cache.get(ck)
                if ent is not None and ent["start_ms"] <= start_ms \
                        and ent["end_ms"] >= end_ms:
                    counters.inc("mesh_pack_cache_hits")
                    self._pack_cache[ck] = self._pack_cache.pop(ck)
                    return ent["packed"]
        spec = RANGE_FUNCTIONS.get(fn_name or "")
        fn_is_counter = spec.is_counter if spec else False
        shards = list(self.memstore.shards_for(self.dataset))
        if not shards and not self._multi:
            return None

        def gather_block(shard, pids, schema_name, T):
            """One shard's rows over the pack's T slots -> (offsets,
            rebased values, bases, whether they were corrected), read in
            GATHER_ROWS row blocks inside one seqlock snapshot (so the
            host holds the raw int64 / f64 copies of a block, not of the
            shard)."""
            shard.ensure_paged_pids(schema_name, pids, start_ms, end_ms)
            store = shard.stores[schema_name]
            rows = shard.rows_for(pids)
            schema = shard.schemas[schema_name]
            col_def = next((c for c in schema.data_columns
                            if c.name == schema.value_column), None)
            counter_col = col_def is not None and (col_def.detect_drops
                                                   or col_def.counter)
            correct = counter_col and fn_is_counter
            n = len(rows)

            def read():
                # a store narrower than T leaves its tail columns padding
                ts_off = np.full((n, T), PAD_TS, np.int32)
                vals = np.full((n, T), np.nan)
                vbase = np.empty(n, np.float64)
                for i in range(0, n, GATHER_ROWS):
                    blk = rows[i:i + GATHER_ROWS]
                    ts, cols, counts = store.gather_rows(
                        blk, positions=(0, T),
                        columns=(schema.value_column,))
                    v, vb = rebase_values(cols[schema.value_column], correct)
                    j, w = slice(i, i + len(blk)), ts.shape[1]
                    ts_off[j, :w] = to_offsets(ts, counts, start_ms)
                    vals[j, :w] = v
                    vbase[j] = vb
                return ts_off, vals, vbase
            return shard.snapshot_read(store, read) + (correct,)

        # the layout memo: row order, group slots, labels and schema
        # routing depend only on the per-shard pid SETS the lookup
        # returns; validity is checked against the actual lookup result
        lookups: List[Tuple[Optional[np.ndarray], Optional[str]]] = []
        for shard in shards:
            lookup = shard.lookup_partitions(filters, start_ms, end_ms)
            schema_name = lookup.first_schema
            pids = (lookup.pids_by_schema.get(schema_name)
                    if schema_name else None)
            if pids is None or pids.size == 0:
                lookups.append((None, None))
            else:
                lookups.append((np.asarray(pids), schema_name))

        def _memo_valid(memo):
            if len(memo["pids"]) != len(lookups):
                return False
            return all(
                sch == msch and ((pids is None and mp is None)
                                 or (pids is not None and mp is not None
                                     and np.array_equal(pids, mp)))
                for (pids, sch), mp, msch in zip(lookups, memo["pids"],
                                                 memo["schemas"]))

        memo = None
        if not self._multi:
            with self._cache_lock:
                memo = self._pack_layout_memo.get(ck)
                if memo is not None and _memo_valid(memo):
                    self._pack_layout_memo[ck] = \
                        self._pack_layout_memo.pop(ck)
                else:
                    memo = None
        pids_by_shard = [p for p, _ in lookups]
        if memo is not None:
            counters.inc("mesh_pack_memo_hits")
            gids_list, labels = memo["gids"], memo["labels"]
        else:
            counters.inc("mesh_pack_memo_misses")
            reg = None
            gids_list = []
            for shard, (pids, _) in zip(shards, lookups):
                if pids is None:
                    gids_list.append(None)
                    continue
                gids, reg = self._gids_for(shard, pids, by, without)
                gids_list.append(gids)
            # compact the registry's slots to this query's groups, so a
            # narrow filter never emits phantom groups from earlier
            # queries
            labels = None
            if reg is not None:
                arrs = [g for g in gids_list if g is not None]
                uniq = np.unique(np.concatenate(arrs))
                labels = [reg.labels[int(g)] for g in uniq]
                gids_list = [None if g is None else
                             np.searchsorted(uniq, g).astype(np.int32)
                             for g in gids_list]
            if not self._multi:
                with self._cache_lock:
                    self._pack_layout_memo[ck] = {
                        "pids": list(pids_by_shard), "gids": gids_list,
                        "schemas": [sch for _, sch in lookups],
                        "labels": labels}
                    while len(self._pack_layout_memo) > 8:
                        self._pack_layout_memo.pop(
                            next(iter(self._pack_layout_memo)))
        rows = self.mesh.local_shard_rows()
        if len(shards) > len(rows):
            raise ValueError(
                f"memstore has {len(shards)} shards but this process's "
                f"mesh shard rows are {len(rows)}; data would be silently "
                f"dropped")
        # the values, shard by shard: each row is gathered, corrected,
        # packed and placed on its slots' devices on its own (a few rows
        # at a time on a thread pool), so the host holds a few shards'
        # arrays at once, never the whole [D, S, T] pack
        live = [i for i, (p, _) in enumerate(lookups) if p is not None]
        S = max([lookups[i][0].size for i in live] or [1])
        T = max([max(shards[i].stores[lookups[i][1]].time_used, 1)
                 for i in live] or [1])
        corrected = []

        def place_row(i):
            blk = (np.full((1, 1), PAD_TS, np.int32),
                   np.full((1, 1), np.nan), [])
            if i in live:
                ts_off, vals, vbase, correct = gather_block(
                    shards[i], lookups[i][0], lookups[i][1], T)
                corrected.append(correct)
                blk = (ts_off, vals, gids_list[i], vbase)
            pk = pack_shards([blk], by=by, without=without,
                             base_ms=start_ms, pad_series_to=S,
                             pad_time_to=T, group_labels=labels)
            del blk
            return device_put_packed(pk, self.mesh, rows=[rows[i]])
        workers = max(1, min(PACK_WORKERS, len(rows)))
        if workers == 1:
            placed = [place_row(i) for i in range(len(rows))]
        else:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                placed = list(pool.map(place_row, range(len(rows))))
        packed = _join_rows(placed, all(corrected))
        packed.pids_by_shard = pids_by_shard + [None] * (len(rows)
                                                        - len(shards))
        if self._multi:
            from filodb_tpu_torch.parallel import multihost
            return multihost.agree_pack(packed)
        # cache under the PRE-gather signature: a concurrent ingest landing
        # mid-gather then invalidates the entry (over-invalidation is safe)
        with self._cache_lock:
            self._pack_cache[ck] = {"sig": sig,
                                    "start_ms": start_ms, "end_ms": end_ms,
                                    "packed": packed}
            while len(self._pack_cache) > PACK_CACHE_MAX:
                self._pack_cache.pop(next(iter(self._pack_cache)))
        counters.inc("mesh_pack_cache_misses")
        return packed

    def _prep_wends(self, packed: PackedShards, wends: np.ndarray
                    ) -> Tuple[np.ndarray, int]:
        """Rebase absolute window ends onto the pack's offset base and pad
        the grid to a multiple of the time axis; padded windows end before
        all data (-PAD_TS) so they are empty, not garbage."""
        wends = np.asarray(wends, np.int64) - packed.base_ms
        if wends.size and (wends.max() >= (1 << 30) or
                           wends.min() <= -(1 << 30)):
            raise ValueError("window ends more than ~12 days from the packed "
                             "base; split the query by time range")
        wends = wends.astype(np.int32)
        W = wends.shape[0]
        n_time = self.mesh.shape["time"]
        Wp = -(-W // n_time) * n_time
        if Wp != W:
            wends = np.concatenate(
                [wends, np.full(Wp - W, -PAD_TS, np.int32)])
        return wends, W

    def run_agg_batch(self, filters, start_ms: int, end_ms: int,
                      wends: np.ndarray, *, range_ms: int,
                      fn_name: Optional[str],
                      panels) -> List[Tuple[np.ndarray, List[Dict[str, str]]]]:
        """A dashboard's panels over one packed working set: panels is
        [(by, without, agg_op)]; returns [(values [G, W], labels)] in
        panel order.

        The values are packed ONCE (grouping recomputed per panel over the
        same rows via pids_by_shard), and every fused-eligible panel
        merges into ONE launch per slot over disjoint group-id ranges.
        Ineligible panels, and all panels when the shared fused gate
        rejects, run run_agg per panel, where the pack cache still dedups
        the gather for repeated groupings."""
        by0, wo0, _ = panels[0]
        results: List = [None] * len(panels)
        packed = None
        if not self._multi:
            packed = self.lookup_and_pack(filters, start_ms, end_ms, by=by0,
                                          without=wo0, fn_name=fn_name)
            if packed is None:
                empty = np.zeros((0, np.asarray(wends).shape[0]))
                return [(empty, []) for _ in panels]
            panels_key = tuple((tuple(by), tuple(wo), op)
                               for by, wo, op in panels)
            merged_key = (id(packed), panels_key, fn_name)
            with self._cache_lock:
                cached = self._panel_group_cache.get(merged_key)
            if cached is not None and cached["packed"] is packed:
                kpanels, kmap, klabels = cached["kpanels"], cached["kmap"], \
                    cached["klabels"]
            else:
                kpanels, kmap, klabels = self._panel_groupings(packed, panels)
                with self._cache_lock:
                    self._panel_group_cache[merged_key] = {
                        "packed": packed, "kpanels": kpanels, "kmap": kmap,
                        "klabels": klabels}
                    while len(self._panel_group_cache) > 8:
                        self._panel_group_cache.pop(
                            next(iter(self._panel_group_cache)))
            if kpanels:
                wends_p, W = self._prep_wends(packed, wends)
                fused_out = self._run_agg_fused_multi(
                    packed, wends_p, W, range_ms, fn_name, kpanels,
                    merged_key=merged_key)
                if fused_out is not None:
                    for arr, idx, labels in zip(fused_out, kmap, klabels):
                        results[idx] = (arr, labels)
        for idx, (by, wo, op) in enumerate(panels):
            if results[idx] is None:
                pk = self.lookup_and_pack(filters, start_ms, end_ms,
                                          by=by, without=wo,
                                          fn_name=fn_name)
                results[idx] = self.run_agg(pk, np.asarray(wends),
                                            range_ms=range_ms,
                                            fn_name=fn_name, agg_op=op)
        return results

    def run_binop_agg(self, filters_l, filters_r, start_ms: int,
                      end_ms: int, wends: np.ndarray, *, range_ms: int,
                      fn_name: Optional[str], op: str,
                      agg_op_l: str = "sum", agg_op_r: str = "sum",
                      by=(), without=(), bool_modifier: bool = False
                      ) -> Tuple[np.ndarray, List[Dict[str, str]]]:
        """Mesh-wide vector-matching binary op between two aggregated
        expressions: ``aggL by(...)(fnL(selL)) <op> aggR by(...)(selR)``
        matched on the (shared) group labels -> (values [P, W], per-pair
        label dicts).

        When both sides select the SAME working set the two panels ride
        ONE run_agg_batch (one pack, one merged launch per slot);
        otherwise each side runs its own.  Either way only the two sides'
        [G, W] partials cross slots; the label match resolves on the host
        into index maps and the op itself is one gather + binop on the
        first slot's device (ops/select.gather_binop)."""
        from filodb_tpu_torch.ops.select import gather_binop
        by, without = tuple(by), tuple(without)
        if list(filters_l) == list(filters_r):
            (lv, ll), (rv, rl) = self.run_agg_batch(
                filters_l, start_ms, end_ms, wends, range_ms=range_ms,
                fn_name=fn_name,
                panels=[(by, without, agg_op_l), (by, without, agg_op_r)])
        else:
            pl = self.lookup_and_pack(filters_l, start_ms, end_ms, by=by,
                                      without=without, fn_name=fn_name)
            pr = self.lookup_and_pack(filters_r, start_ms, end_ms, by=by,
                                      without=without, fn_name=fn_name)
            W = np.asarray(wends).shape[0]
            lv, ll = ((np.zeros((0, W)), []) if pl is None else
                      self.run_agg(pl, np.asarray(wends), range_ms=range_ms,
                                   fn_name=fn_name, agg_op=agg_op_l))
            rv, rl = ((np.zeros((0, W)), []) if pr is None else
                      self.run_agg(pr, np.asarray(wends), range_ms=range_ms,
                                   fn_name=fn_name, agg_op=agg_op_r))
        # group labels are unique per side: one-to-one match on the
        # label dict (both sides grouped by the same by/without)
        rindex = {tuple(sorted(d.items())): j for j, d in enumerate(rl)}
        pairs = [(i, rindex[tuple(sorted(d.items()))])
                 for i, d in enumerate(ll)
                 if tuple(sorted(d.items())) in rindex]
        W = lv.shape[1] if lv.ndim == 2 else np.asarray(wends).shape[0]
        if not pairs:
            return np.zeros((0, W)), []
        dev = self.mesh.devices[self.mesh.local_slots()[0]]
        mi = torch.tensor([p[0] for p in pairs], dtype=torch.int64)
        oi = torch.tensor([p[1] for p in pairs], dtype=torch.int64)
        b0 = time.perf_counter()
        out = gather_binop(
            torch.from_numpy(np.asarray(lv, np.float64)).to(dev),
            torch.from_numpy(np.asarray(rv, np.float64)).to(dev),
            mi.to(dev), oi.to(dev), op=op, bool_modifier=bool_modifier,
            keep_side="lhs").cpu().numpy()
        telem.record_dispatch(
            "gather_binop", device=dev, shape=f"P{len(pairs)}xW{W}:{op}",
            seconds=time.perf_counter() - b0, bytes_out=int(out.nbytes))
        return out, [ll[i] for i, _ in pairs]

    def _panel_groupings(self, packed: PackedShards, panels):
        """Per-panel (gids, G, op, gsize) + labels over the pack's rows:
        the host remap work run_agg_batch caches per (pack, panels)."""
        kpanels, kmap, klabels = [], [], []
        shards = list(self.memstore.shards_for(self.dataset))
        D, S = packed.ts_off.shape[0], packed.ts_off.shape[1]
        for idx, (by, wo, op) in enumerate(panels):
            if op not in ("sum", "avg", "count"):
                continue
            if idx == 0:
                kpanels.append((None, packed.num_groups, op, packed.gsize))
                kmap.append(idx)
                klabels.append(packed.group_labels)
                continue
            if packed.pids_by_shard is None:
                continue          # pack built outside lookup_and_pack
            garrs, reg = [], None
            for shard, pids in zip(shards, packed.pids_by_shard):
                if pids is None:
                    garrs.append(None)
                    continue
                g, reg = self._gids_for(shard, pids, tuple(by), tuple(wo))
                garrs.append(np.asarray(g, np.int64))
            real = [g for g in garrs if g is not None]
            uniq = (np.unique(np.concatenate(real)) if real
                    else np.zeros(0, np.int64))
            labels = ([reg.labels[int(x)] for x in uniq]
                      if reg is not None else [])
            G = max(len(labels), 1)
            gids = np.full((D, S), -1, np.int32)
            gsize = np.zeros(G, np.int64)
            for d, g in enumerate(garrs):
                if g is None:
                    continue
                cg = np.searchsorted(uniq, g).astype(np.int32)
                gids[d, :len(cg)] = cg
                gsize += np.bincount(cg, minlength=G)[:G]
            kpanels.append((gids, G, op, gsize))
            kmap.append(idx)
            klabels.append(labels)
        return kpanels, kmap, klabels

    def run_agg(self, packed: PackedShards, wends: np.ndarray, *,
                range_ms: int, fn_name: Optional[str], agg_op: str,
                params: Tuple[float, ...] = ()) -> Tuple[np.ndarray, List[Dict[str, str]]]:
        """Returns (final [G, W] values, group label dicts).

        wends are ABSOLUTE ms (the clock of lookup_and_pack's time range);
        they are rebased onto the pack's offset base here.  sum/avg/count
        take the fused per-slot dispatch where the reference's gate lets
        them (_run_agg_fused_multi); a failure there raises, it never
        falls back to the general path.  Everything else runs the general
        path (distributed_window_agg)."""
        wends, W = self._prep_wends(packed, wends)
        if agg_op in ("sum", "avg", "count") and not params:
            out = self._run_agg_fused(packed, wends, W, range_ms, fn_name,
                                      agg_op)
            if out is not None:
                return out, packed.group_labels
        partials = distributed_window_agg(
            self.mesh, packed.ts_off, packed.values, packed.group_ids,
            wends, range_ms=range_ms, fn_name=fn_name, params=params,
            agg_op=agg_op, num_groups=packed.num_groups,
            base_ms=packed.base_ms, vbase=packed.vbase,
            precorrected=packed.precorrected,
            dense=(packed.dense
                   if fn_name in ("rate", "increase", "delta",
                                  "irate", "idelta") else True))
        out = agg_ops.present(agg_op, partials)
        return out.numpy()[:, :W], packed.group_labels

    def _run_agg_fused(self, packed: PackedShards, wends_p: np.ndarray,
                       W: int, range_ms: int, fn_name: Optional[str],
                       agg_op: str = "sum") -> Optional[np.ndarray]:
        """Single-panel form of _run_agg_fused_multi (see below)."""
        res = self._run_agg_fused_multi(
            packed, wends_p, W, range_ms, fn_name,
            [(None, packed.num_groups, agg_op, packed.gsize)])
        return None if res is None else res[0]

    def _fused_plans(self, packed: PackedShards, wends_p: np.ndarray,
                     range_ms: int):
        """(per-time-slice plans, wvalid, wvalid1), cached by the grid."""
        n_time = self.mesh.shape["time"]
        Wl = wends_p.shape[0] // n_time
        plan_key = (packed.shared_ts_row.tobytes(), wends_p.tobytes(),
                    range_ms)
        with self._cache_lock:
            ent = _lru_touch(self._fused_plan_cache, plan_key)
        if ent is None:
            ts_row = packed.shared_ts_row.astype(np.int64)
            plans = [fused.build_plan(
                ts_row, wends_p[i * Wl:(i + 1) * Wl].astype(np.int64),
                range_ms) for i in range(n_time)]
            ent = (plans,
                   np.concatenate([p.wvalid for p in plans]),
                   np.concatenate([p.wvalid1 for p in plans]))
            with self._cache_lock:
                self._fused_plan_cache[plan_key] = ent
                while len(self._fused_plan_cache) > 4:
                    self._fused_plan_cache.pop(
                        next(iter(self._fused_plan_cache)))
        return ent

    def _slot_csrs(self, packed: PackedShards, kpanels, kidx,
                   merged_key) -> Dict[Tuple[int, str], fused.GroupCSR]:
        """Each slot device's CSR of the launch's grouping, built once per
        (shard row, device): the pack's own (cached with the pack) or the
        panels' merged one (cached per run_agg_batch key)."""
        own = len(kidx) == 1 and kpanels[kidx[0]][0] is None
        key = (id(packed), "own") if own else merged_key
        with self._cache_lock:
            ent = self._csr_cache.get(key) if key is not None else None
        if ent is not None and ent["packed"] is packed:
            return ent["csrs"]
        host_g = packed.host_group_ids
        rows = self.mesh.local_shard_rows()
        csrs = {}
        for i, s in enumerate(rows):
            n = int(packed.n_series[i])
            cols, Gs = [], []
            for j in kidx:
                g = kpanels[j][0]
                g = host_g[i] if g is None else np.asarray(g[i])
                g = np.where(np.arange(g.shape[0]) < n, g, -1)
                cols.append(g)
                Gs.append(kpanels[j][1])
            for dev in _row_devices(self.mesh, s):
                csrs[(s, _dev_key(dev))] = (
                    _slot_csr(cols[0], Gs[0], dev) if len(cols) == 1
                    else _merged_csr(cols, Gs, dev))
        if key is not None:
            with self._cache_lock:
                self._csr_cache[key] = {"packed": packed, "csrs": csrs}
                while len(self._csr_cache) > 8:
                    self._csr_cache.pop(next(iter(self._csr_cache)))
        return csrs

    def _run_agg_fused_multi(self, packed: PackedShards,
                             wends_p: np.ndarray, W: int, range_ms: int,
                             fn_name: Optional[str],
                             kpanels,
                             merged_key: Optional[Tuple] = None
                             ) -> Optional[List[np.ndarray]]:
        """sum/avg/count(rate|increase|delta|*_over_time) over a
        uniform-grid pack by PER-SLOT dispatch of the single-card kernels:
        slot (s, t) launches the kernel over shard row s's block with time
        slice t's plan, and only the [G] group partials merge
        (merge_device_partials).  Every slot's launch is issued before the
        merge reads any of them back.  NaN-holed (ragged) packs run K3 /
        the ragged K5, with per-cell presence merged as a second partial.
        On a dense pack count needs NO device work (identical per-window
        counts); avg divides sums by counts.  Slots off the cards run the
        kernels' plain versions (the wrappers pick them by the tensors'
        device); under FILODB_TPU_FORCE_HOST_ROUTE a pack that kept host
        views runs ops/hostleaf per shard instead (the single-card
        router's host route).

        kpanels: [(gids [D, S] int32 or None for the pack's own grouping,
        G, agg_op, gsize [G])]: several panels (run_agg_batch) merge into
        ONE launch per slot over disjoint group-id ranges.  Returns the
        finished [G, W] arrays in panel order, or None where the
        reference's gate sends the query to the general path."""
        shared = packed.shared_ts_row is not None and packed.gsize is not None
        dense = packed.dense
        for _, _, op, _ in kpanels:
            if not fused.can_fuse(fn_name or "", op, shared, dense):
                return None
        if fn_name in fused.MINMAX_FNS:
            # windowed min/max run the general path; the kernels have no
            # min/max kind
            return None
        ragged = not dense
        if ragged and fn_name in ("last_over_time", "count_over_time"):
            # slot-semantics kinds: the general path (the reference's
            # gate, mesh.py:1137-1141)
            return None
        minsamp = 2 if fn_name in ("rate", "increase", "delta") else 1
        over_time = fn_name in fused.OVER_TIME_FNS

        out: List[Optional[np.ndarray]] = [None] * len(kpanels)
        kidx = [i for i, (_, _, op, _) in enumerate(kpanels)
                if not (op == "count" and dense)]
        if kidx:
            if fn_name in ("rate", "increase") and not packed.precorrected:
                return None
            n_time = self.mesh.shape["time"]
            Wp = wends_p.shape[0]
            Wl = Wp // n_time
            _, S, T = packed.ts_off.shape
            offsets, Gtot = [], 0
            for i in kidx:
                offsets.append(Gtot)
                Gtot += kpanels[i][1]
            kind_k = fn_name if over_time else "rate_family"
            fused.check_kernel_shape(
                S, fused._pad_to(T, fused._LANE), max(Wl, 1),
                fused.pad_group_count(Gtot), panels=len(kidx))
            if os.environ.get("FILODB_TPU_FORCE_HOST_ROUTE") \
                    and packed.host_values is not None:
                host_out = self._run_agg_fused_host(
                    packed, wends_p, W, range_ms, fn_name, kpanels, kidx)
                if host_out is None:
                    return None
                for i, arr in zip(kidx, host_out):
                    out[i] = arr
                return self._finish_count_panels(packed, wends_p, W,
                                                 range_ms, kpanels, out,
                                                 minsamp)
            plans, wvalid, wvalid1 = self._fused_plans(packed, wends_p,
                                                       range_ms)
            csrs = self._slot_csrs(packed, kpanels, kidx, merged_key)
            is_counter = fn_name in ("rate", "increase")
            if not self.mesh.addressable:
                # some slots are another process's: their partials arrive
                # through the all-reduce of the merge
                counters.inc("mesh_fused_unaddressable")
            res = _mesh_fused_call(
                self.mesh, packed, csrs, plans, G=Gtot,
                is_counter=is_counter, is_rate=(fn_name == "rate"),
                kind=kind_k, ragged=ragged)
            all_out, all_counts = res if ragged else (res, None)
            all_out = all_out[:, :W]
            if ragged:
                all_counts = all_counts[:, :W]
            counters.inc("mesh_fused_kernel")
            counters.inc("mesh_fused_perdevice_dispatches",
                         len(self.mesh.local_slots()))
            if len(kidx) > 1:
                counters.inc("mesh_fused_batch_panels", len(kidx))
            for j, i in enumerate(kidx):
                _, G, op, gsize = kpanels[i]
                lo = offsets[j]
                pout = all_out[lo:lo + G]
                counts = (all_counts[lo:lo + G] if ragged
                          else _host_counts(gsize,
                                            wvalid1 if over_time
                                            else wvalid)[:, :W])
                if op == "count":             # ragged: kernel presence
                    out[i] = np.where(counts > 0,
                                      counts.astype(np.float64), np.nan)
                    continue
                if op == "avg":
                    with np.errstate(invalid="ignore", divide="ignore"):
                        pout = np.asarray(pout, np.float64) \
                            / np.maximum(counts, 1.0)
                out[i] = fused.present_sum(pout, counts)
        return self._finish_count_panels(packed, wends_p, W, range_ms,
                                         kpanels, out, minsamp)

    def _finish_count_panels(self, packed: PackedShards,
                             wends_p: np.ndarray, W: int, range_ms: int,
                             kpanels, out: List[Optional[np.ndarray]],
                             minsamp: int) -> List[np.ndarray]:
        """Dense count panels: every REAL series emits a value exactly
        where the shared window is valid: host math, no device work
        (shared epilogue of the kernel and host dispatch routes)."""
        valid = None                          # panel-independent; lazy
        for i, (_, _, op, gsize) in enumerate(kpanels):
            if out[i] is None:                # dense count: host math
                if valid is None:
                    n = fused.window_counts(
                        packed.shared_ts_row.astype(np.int64),
                        wends_p[:W].astype(np.int64), range_ms)
                    valid = (n >= minsamp).astype(np.float64)
                counts = _host_counts(gsize, valid)
                counters.inc("mesh_fused_count_host")
                out[i] = np.where(counts > 0, counts, np.nan)
        return out

    def _host_plan(self, packed: PackedShards, wends_p: np.ndarray,
                   W: int, range_ms: int):
        """Full-grid FusedPlan for the host dispatch route, cached next
        to the per-slice device plans."""
        plan_key = ("host", packed.shared_ts_row.tobytes(),
                    wends_p[:W].tobytes(), range_ms)
        with self._cache_lock:
            plan = _lru_touch(self._fused_plan_cache, plan_key)
        if plan is None:
            plan = fused.build_plan(packed.shared_ts_row.astype(np.int64),
                                    wends_p[:W].astype(np.int64), range_ms)
            with self._cache_lock:
                self._fused_plan_cache[plan_key] = plan
                while len(self._fused_plan_cache) > 4:
                    self._fused_plan_cache.pop(
                        next(iter(self._fused_plan_cache)))
        return plan

    def _run_agg_fused_host(self, packed: PackedShards,
                            wends_p: np.ndarray, W: int, range_ms: int,
                            fn_name: Optional[str], kpanels, kidx
                            ) -> Optional[List[np.ndarray]]:
        """Per-shard HOST fused evaluation (ops/hostleaf) with the same
        dispatch + partial-merge shape as the per-slot kernel path (the
        single-card router's host route scaled out over shards).  Dense
        shared-grid packs only (hostleaf has no ragged variant); partials
        merge in ascending shard order via the sum combiner.  Returns
        finished [G, W] arrays in kidx order, or None to divert to the
        general path."""
        if not packed.dense or packed.host_values is None:
            return None
        from filodb_tpu_torch.ops import hostleaf
        plan = self._host_plan(packed, wends_p, W, range_ms)
        if plan.idx1 is None:
            return None
        hv = packed.host_values
        hvb = packed.host_vbase
        hg = packed.host_group_ids
        outs: List[np.ndarray] = []
        for i in kidx:
            g, G, op, _ = kpanels[i]
            comp = None
            for d in range(hv.shape[0]):
                nser = int(packed.n_series[d])
                if nser == 0:
                    continue
                gids_d = (hg[d, :nser] if g is None
                          else np.asarray(g[d, :nser]))
                vb_d = None if hvb is None else hvb[d, :nser]
                c = hostleaf.host_leaf_agg(plan, hv[d, :nser], vb_d,
                                           gids_d, G, fn_name, op)
                comp = c if comp is None else comp + c
            if comp is None:
                comp = np.zeros((G, W, 2))
            s, cnt = comp[..., 0], comp[..., 1]
            vals = s / np.maximum(cnt, 1.0) if op == "avg" else s
            outs.append(np.where(cnt > 0, vals, np.nan))
        counters.inc("mesh_fused_host")
        counters.inc("mesh_partials_host_merge")
        return outs
