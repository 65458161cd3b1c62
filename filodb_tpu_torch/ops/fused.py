"""Fused windowed range functions + cross-series aggregation over one
shared scrape grid.

Port of filodb_tpu/ops/pallas_fused.py: the rate family (rate/increase/
delta, over reset-corrected values or raw counters), last_over_time
(instant selectors too) and sum/avg/count_over_time, each under
sum/avg/count/min/max, through the leaf's entry (fused_leaf_agg_batch)
and the kernel-level API (fused_rate_groupsum, fused_leaf_agg,
run_kernel, pad_inputs, warmup_compile).  A host-built plan
holds the window boundaries once (one shared grid, so one row of slot
indices serves every series); one kernel launch computes each series'
value per window and either sums it into its group or writes it out per
series.

The kernels (csrc/fused_rate.cu, csrc/fused_over_time.cu; ops/kernels.py
builds and binds them) each have a plain torch version here that
computes the same function in the same f32 operation order:

- K1 rate family, dense: the boundary values are read at the plan's
  idx1/idx2 slots directly.
- K2 rate family over raw counters (csrc/fused_drops.cu): each row's
  resets are corrected inside the launch (v + the prefix sum of the
  drops, in a fixed lane-blocked association, _drop_corrected), then K1
  (dense) or K3 (ragged) on the corrected row.
- K3 rate family, ragged: NaN holes are absent samples; each (series,
  window) finds its first and last VALID sample inside the window, and a
  second output sums the presence (valid count >= 2) per group.
- K4 last_over_time: the slot at idx2; ragged keeps slot semantics (a
  NaN there is a staleness marker: the series is absent).
- K5 sum/avg/count_over_time: each window's slots idx1..idx2 summed in
  ascending slot order; ragged zeroes NaN slots and counts the valid
  ones.
- K6, the per-series output mode of all four: [S, W] values (+ presence
  when ragged) instead of group sums, finished by ops/agg.map_phase —
  the min/max aggregates, whose semiring is not a sum.

The group sum is deterministic: rows are visited in a stable CSR order
(rows by group id, ascending row within a group), cut into chunks of
CHUNK_ROWS rows; each chunk is summed in row order and a group's chunk
partials are summed in chunk order.  The plain versions sum in the same
order, so kernel and plain agree to f32 rounding of identical operations.

What the TPU kernel needed and this port drops: the one-hot selection
and band matrices (o1/o2/l1/l2 — K5's band matmul becomes an ordered
slot loop), the VMEM block-size model (replaced by check_kernel_shape)
and the MXU precision split.  K7, the reference's one-hot/step matmul
selections (gather=False, FILODB_FUSED_GATHER=0), selects the same slots
as its gathers; here `gather` is accepted and both values launch the
same kernels (K1-K4), whose selections are plain indexed loads.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

_LANE = 128
_BS = 256
CHUNK_ROWS = 256
"""Rows one block sums before its partial is written (the fixed partition
that keeps the group sum's order independent of scheduling)."""


def _pad_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _bucket_up(n: int, quantum: int, exact_below: int) -> int:
    """Round n up to a {8/8, 9/8, ..., 16/8} x 2^k geometric ladder of
    quantum multiples (adjacent rungs <= 1.125x, so padding <= 12.5%), so
    near-identical working sets share one padded shape.  Below
    `exact_below` the plain quantum pad is kept."""
    if n <= exact_below:
        return _pad_to(max(n, 1), quantum)
    k = 1
    while quantum * 16 * k < n:
        k *= 2
    for m in range(8, 17):
        cand = quantum * k * m
        if cand >= n:
            return cand
    raise AssertionError("unreachable: the loop exits with 16*k*quantum >= n")


def pad_series_count(S: int) -> int:
    """Canonical padded series count: a multiple of 256 on the ladder."""
    return _bucket_up(S, _BS, 8 * _BS)


def pad_group_count(G: int) -> int:
    """Canonical padded group count (multiple of 8, ladder above 64)."""
    return _bucket_up(max(G, 8), 8, 64)


class PlanRows(NamedTuple):
    """A plan's per-window rows as tensors on one device."""
    idx1: torch.Tensor       # [W] int32 first slot of each window
    idx2: torch.Tensor       # [W] int32 last slot
    t1: torch.Tensor         # [W] f32 ts at idx1
    t2: torch.Tensor         # [W] f32 ts at idx2
    n: torch.Tensor          # [W] f32 max(samples, 2)
    ws: torch.Tensor         # [W] f32 window start boundary (wend - range)
    we: torch.Tensor         # [W] f32 window end
    tsrow: torch.Tensor      # [Tp] f32 shared-grid ts offsets (0 pad tail)
    n1: torch.Tensor         # [W] f32 true samples in window (0 empty)
    span: int                # slots 0..span-1 hold every window (K2 reads)
    stage_lo: int            # K3 stages slots [stage_lo, stage_hi) of a
    stage_hi: int            #   row (multiples of 4; see ragged_stage)
    width: int               # most slots one window of >= 2 slots spans


@dataclasses.dataclass(frozen=True, eq=False)
class FusedPlan:
    """Host-built window plan over one shared grid (all rows f32 unless
    noted; empty windows carry slot 0 and ts 0, masked by wvalid)."""
    t1: np.ndarray           # [W] ts at first[w]
    t2: np.ndarray           # [W] ts at last[w]
    n: np.ndarray            # [W] samples in window, at least 2
    wstart_x: np.ndarray     # [W] window start boundary (exclusive - 1)
    wend_x: np.ndarray       # [W]
    wvalid: np.ndarray       # [W] bool  n >= 2 (rate family)
    wvalid1: np.ndarray      # [W] bool  n >= 1 (*_over_time family)
    n1: np.ndarray           # [W] TRUE samples in window (0 empty)
    W: int
    Tp: int
    tsrow: np.ndarray        # [Tp] raw shared-grid ts offsets (0 pad tail)
    idx1: np.ndarray         # [W] int32 first[w] (0 for empty windows)
    idx2: np.ndarray         # [W] int32 last[w]
    _rows: Dict[str, PlanRows] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def span(self) -> int:
        """Slots from column 0 through the last slot any window selects:
        what the in-kernel reset correction (K2) reads of each row."""
        return int(self.idx2.max()) + 1 if self.idx2.size else 1

    @property
    def ragged_stage(self):
        """(lo, hi, width) of the windows that span two slots or more —
        the others are absent in the ragged kernels and read nothing: the
        smallest idx1 rounded down to 4, the largest idx2 + 1 rounded up
        to 4 (the slots K3 stages of each row) and the most slots one of
        them spans; (0, 0, 0) when there is none."""
        live = self.idx2 > self.idx1
        if not live.any():
            return 0, 0, 0
        lo = int(self.idx1[live].min()) // 4 * 4
        hi = _pad_to(int(self.idx2[live].max()) + 1, 4)
        return lo, hi, int((self.idx2 - self.idx1)[live].max()) + 1

    def device_rows(self, device) -> PlanRows:
        """The plan's rows on `device`, uploaded once per (plan, device)."""
        key = str(device)
        rows = self._rows.get(key)
        if rows is None:
            def put(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(device)
            rows = PlanRows(put(self.idx1), put(self.idx2), put(self.t1),
                            put(self.t2), put(self.n), put(self.wstart_x),
                            put(self.wend_x), put(self.tsrow), put(self.n1),
                            self.span, *self.ragged_stage)
            self._rows[key] = rows
        return rows


def build_plan(ts_row: np.ndarray, wends: np.ndarray,
               range_ms: int) -> FusedPlan:
    """Window boundary math once, host-side (shared grid: one ts row)."""
    ts_row = np.asarray(ts_row, dtype=np.int64)
    wend = np.asarray(wends, dtype=np.int64)
    wstart = wend - int(range_ms) + 1
    first = np.searchsorted(ts_row, wstart, side="left")
    last = np.searchsorted(ts_row, wend, side="right") - 1
    n = window_counts(ts_row, wend, range_ms)
    W, T = len(wend), len(ts_row)
    Tp = _pad_to(max(T, 1), _LANE)
    valid = n >= 1
    fi = np.clip(first, 0, T - 1)
    la = np.clip(last, 0, T - 1)
    tsr = np.zeros(Tp, np.float32)
    tsr[:T] = ts_row

    def row(v):
        return np.asarray(v, np.float32).reshape(W)

    return FusedPlan(
        t1=row(np.where(valid, ts_row[fi], 0)),
        t2=row(np.where(valid, ts_row[la], 0)),
        n=row(np.maximum(n, 2)),           # safe: invalid windows masked out
        wstart_x=row(wstart - 1), wend_x=row(wend),
        wvalid=(n >= 2), wvalid1=(n >= 1), n1=row(n), W=W, Tp=Tp,
        tsrow=tsr,
        idx1=np.where(valid, fi, 0).astype(np.int32),
        idx2=np.where(valid, la, 0).astype(np.int32))


def window_counts(ts_row: np.ndarray, wends: np.ndarray,
                  range_ms: int) -> np.ndarray:
    """Per-window sample counts over one shared grid — the single source
    of the window-inclusion convention ((wend-range, wend])."""
    ts_row = np.asarray(ts_row, dtype=np.int64)
    wend = np.asarray(wends, dtype=np.int64)
    first = np.searchsorted(ts_row, wend - int(range_ms) + 1, side="left")
    last = np.searchsorted(ts_row, wend, side="right") - 1
    return np.maximum(last - first + 1, 0)


# the reference's eligibility sets (pallas_fused.py:836-846)
FUSABLE_FNS = ("rate", "increase", "delta", "sum_over_time",
               "avg_over_time", "last_over_time", "count_over_time",
               "min_over_time", "max_over_time")
OVER_TIME_FNS = ("sum_over_time", "avg_over_time", "last_over_time",
                 "count_over_time")
# kinds whose validity-weighted variant handles NaN-holed (ragged) rows
RAGGED_FNS = ("sum_over_time", "avg_over_time", "count_over_time")
# kinds served by the windowed min/max path (ops/minmax.py), not a kernel
MINMAX_FNS = ("min_over_time", "max_over_time")
FUSABLE_AGGS = ("sum", "avg", "count", "min", "max")
RATE_FNS = ("rate", "increase", "delta")

def can_fuse(fn_name: str, agg_op: str, shared_grid: bool,
             dense: bool) -> bool:
    """Leaf fused-path eligibility: a fusable function under a fusable
    aggregate on one shared scrape grid.  Every kind takes ragged rows;
    `dense` gates nothing and stays in the signature as the contract
    callers route on (kernel variant selection)."""
    del dense
    return (shared_grid and agg_op in FUSABLE_AGGS
            and fn_name in FUSABLE_FNS)


def check_kernel_shape(num_rows: int, Tp: int, W: int, Gp: int,
                       panels: int = 1) -> None:
    """Raise ValueError for a shape the CUDA kernels do not take.

    The TPU kernel sized its series block to the core's VMEM; these
    kernels stage nothing in fast memory, so their limits are their index
    spaces: int32 column slots, int32 CSR entries (rows x panels) and
    int32 group ids."""
    if W < 1:
        raise ValueError("fused kernel needs at least one window")
    if not 1 <= Tp < (1 << 31):
        raise ValueError(f"fused kernel row width Tp={Tp} outside int32")
    if num_rows * max(panels, 1) >= (1 << 31):
        raise ValueError(
            f"fused kernel CSR of {num_rows} rows x {panels} panels "
            f"exceeds int32 entries")
    if Gp >= (1 << 31):
        raise ValueError(f"fused kernel group count {Gp} exceeds int32")


class PaddedValues(NamedTuple):
    """The grouping-independent (and byte-dominant) kernel input, built
    once per (working set, column)."""
    vals_p: torch.Tensor     # [Sp, Tp] f32
    vbase_p: torch.Tensor    # [Sp] f32


class GroupCSR(NamedTuple):
    """Rows by group: order[offsets[g]:offsets[g + 1]] are group g's rows
    in ascending row order (a stable sort by group id)."""
    order: torch.Tensor      # [N] int32 row ids
    offsets: np.ndarray      # [G + 1] int64


class PaddedGroups(NamedTuple):
    """The small grouping-dependent input — one per (by, without) variant,
    with its CSR order built once beside it."""
    gids_p: torch.Tensor     # [Sp] int32 (-1 pad rows)
    gsize: np.ndarray        # [num_groups]
    csr: GroupCSR


class ChunkPlan(NamedTuple):
    """The fixed partition of a CSR into row chunks (ops/kernels.py)."""
    lo: torch.Tensor         # [C] int32 first CSR entry of each chunk
    hi: torch.Tensor         # [C] int32 one past its last entry
    gco: torch.Tensor        # [Gp + 1] int32 chunks of group g: gco[g]..gco[g+1]
    max_len: int             # longest chunk (<= CHUNK_ROWS)
    max_chunks: int          # most chunks in one group


def pad_values(vals, vbase, plan: FusedPlan, device=None) -> PaddedValues:
    """Zero-padded [Sp, Tp] f32 copy of the working set (pad rows are in
    no group; pad columns are never selected).  `device` follows the
    device rule: an explicit device, else the tensor's, else the card
    (numpy values without `device=` raise without one)."""
    if device is None:
        device = _input_device(vals, None)
    v = torch.as_tensor(vals, device=device)
    S, T = v.shape
    Sp = pad_series_count(S)
    vals_p = torch.zeros((Sp, plan.Tp), dtype=torch.float32, device=device)
    vals_p[:S, :T] = v
    vbase_p = torch.zeros(Sp, dtype=torch.float32, device=device)
    vbase_p[:S] = torch.as_tensor(vbase, device=device).reshape(S)
    return PaddedValues(vals_p, vbase_p)


def pad_groups(gids, S: int, num_groups: int, *, device) -> PaddedGroups:
    Sp = pad_series_count(S)
    gids_np = np.asarray(gids, np.int32)
    gids_p = torch.full((Sp,), -1, dtype=torch.int32, device=device)
    gids_p[:S] = torch.from_numpy(gids_np).to(device)
    gsize = np.bincount(gids_np, minlength=num_groups)[:num_groups]
    order = np.argsort(gids_np, kind="stable").astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(gsize)]).astype(np.int64)
    return PaddedGroups(gids_p, gsize,
                        GroupCSR(torch.from_numpy(order).to(device), offsets))


def merge_groups(groups_list: Sequence[PaddedGroups],
                 num_groups_list: Sequence[int]):
    """Stack P panel groupings into one CSR over DISJOINT group-id ranges
    (panel p's ids are offset by the earlier panels' group counts), so P
    groupings cost one launch.  Returns (csr, offsets, total_groups)."""
    orders, starts, offsets = [], [], []
    goff = eoff = 0
    for g, n in zip(groups_list, num_groups_list):
        o = g.csr.offsets
        if len(o) != int(n) + 1:
            raise ValueError(f"panel CSR has {len(o) - 1} groups, not {n}")
        orders.append(g.csr.order)
        starts.append(o[:-1] + eoff)
        offsets.append(goff)
        goff += int(n)
        eoff += int(o[-1])
    order = orders[0] if len(orders) == 1 else torch.cat(orders)
    merged = GroupCSR(order, np.concatenate(starts + [[eoff]]).astype(np.int64))
    return merged, offsets, goff


def chunk_plan(offsets: np.ndarray, Gp: int, device,
               chunk_rows: int = CHUNK_ROWS) -> ChunkPlan:
    """Cut each group's CSR range into chunks of at most `chunk_rows`
    entries; groups G..Gp-1 (padding) own no chunks."""
    sizes = np.diff(np.asarray(offsets, np.int64))
    G = sizes.size
    nch = -(-sizes // chunk_rows)
    gco = np.zeros(Gp + 1, np.int64)
    gco[1:G + 1] = np.cumsum(nch)
    gco[G + 1:] = gco[G]
    C = int(gco[G])
    g_of = np.repeat(np.arange(G), nch)
    k = np.arange(C) - np.repeat(gco[:G], nch)
    lo = offsets[:-1][g_of] + k * chunk_rows
    hi = np.minimum(lo + chunk_rows, offsets[1:][g_of])

    def put(a):
        return torch.from_numpy(a.astype(np.int32)).to(device)

    return ChunkPlan(put(lo), put(hi), put(gco),
                     int((hi - lo).max()) if C else 0,
                     int(nch.max()) if G else 0)


# ------------------------------------------------------- plain versions

def _consts(dev):
    """f32 constants as tensors on `dev`: a CUDA divide by a host scalar
    is computed as a multiply by its reciprocal, which the kernels do not
    do."""
    def c(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)
    return c


def _extrapolate(v1, v2, t1, t2, n, ws, we, vb, is_counter: bool,
                 is_rate: bool) -> torch.Tensor:
    """Prometheus extrapolated rate/increase/delta in f32, in the
    reference kernel's operation order (ref: RateFunctions.scala:37-76)."""
    c = _consts(v1.device)
    k1000, ms_to_s = c(1000.0), c(0.001)
    # milliseconds to seconds as a multiply by the f32 reciprocal: the
    # reference compiles its `/ 1000.0` to exactly that (XLA rewrites a
    # division by a constant), so the extrapolation threshold's ties
    # land on the same side
    dur_start = (t1 - ws) * ms_to_s
    dur_end = (we - t2) * ms_to_s
    sampled = torch.maximum((t2 - t1) * ms_to_s, c(1e-9))
    avg_between = sampled / (n - c(1.0))
    delta = v2 - v1
    if is_counter:
        va = v1 + vb                                  # absolute first value
        den = torch.where(delta == 0.0, c(float("inf")), delta)
        dur_zero = sampled * (va / den)
        take_zero = (delta > 0) & (va >= 0) & (dur_zero < dur_start)
        dur_start = torch.where(take_zero, dur_zero, dur_start)
    threshold = avg_between * c(1.1)
    half = avg_between / c(2.0)
    extrap = sampled + torch.where(dur_start < threshold, dur_start, half)
    extrap = extrap + torch.where(dur_end < threshold, dur_end, half)
    out = delta * (extrap / sampled)
    if is_rate:
        out = out / torch.maximum(we - ws, c(1.0)) * k1000
    return out


def _chunked_group_sum(planes: List[torch.Tensor], chunks: ChunkPlan,
                       Gp: int) -> List[torch.Tensor]:
    """planes: [N, W] per-entry values in CSR order -> [Gp, W] group sums
    (in the planes' dtype), in the kernels' order: each chunk in entry
    order, then each group's chunks in chunk order."""
    N, W = planes[0].shape
    dev = planes[0].device
    C = chunks.lo.numel()
    outs = []
    for x in planes:
        out = torch.zeros((Gp, W), dtype=x.dtype, device=dev)
        if C == 0:
            outs.append(out)
            continue
        lo, hi, gco = chunks.lo.long(), chunks.hi.long(), chunks.gco.long()
        part = torch.zeros((C, W), dtype=x.dtype, device=dev)
        zero = torch.zeros((), dtype=x.dtype, device=dev)
        for j in range(chunks.max_len):
            e = lo + j
            part = part + torch.where((e < hi)[:, None],
                                      x[e.clamp(max=N - 1)], zero)
        for k in range(chunks.max_chunks):
            cix = gco[:-1] + k
            out = out + torch.where((cix < gco[1:])[:, None],
                                    part[cix.clamp(max=C - 1)], zero)
        outs.append(out)
    return outs


def segment_sum(x: torch.Tensor, csr: GroupCSR,
                num_groups: int) -> torch.Tensor:
    """[S, W] -> [G, W] group sums in the fixed CSR chunk order (the same
    deterministic order as the kernels' group sums, in x's dtype)."""
    chunks = chunk_plan(csr.offsets, num_groups, x.device)
    return _chunked_group_sum([x[csr.order.long()]], chunks, num_groups)[0]


def _at(vals_p: torch.Tensor, ridx: torch.Tensor,
        j: torch.Tensor) -> torch.Tensor:
    """vals_p[ridx[r], j[w]] -> [R, W] without copying whole rows."""
    return vals_p[ridx[:, None], j[None, :]]


def _rate_dense_cells(vals_p, vbase_p, ridx, rows: PlanRows,
                      is_counter: bool, is_rate: bool) -> torch.Tensor:
    """K1's per-(row, window) rates for the rows ridx."""
    v1 = _at(vals_p, ridx, rows.idx1.long())
    v2 = _at(vals_p, ridx, rows.idx2.long())
    return _extrapolate(v1, v2, rows.t1, rows.t2, rows.n, rows.ws, rows.we,
                        vbase_p[ridx][:, None], is_counter, is_rate)


def _ragged_rates(v: torch.Tensor, vb: torch.Tensor, rows: PlanRows,
                  is_counter: bool, is_rate: bool):
    """Per-(row, window) rates over each row's first and last VALID
    sample in the window -> (rates with 0 where absent, presence)."""
    N, Tp = v.shape
    m = ~torch.isnan(v)
    pos = torch.arange(Tp, device=v.device).expand(N, Tp)
    i1, i2 = rows.idx1.long(), rows.idx2.long()
    cs = torch.cumsum(m.to(torch.int32), dim=1)
    nv = cs[:, i2] - cs[:, i1] + m[:, i1].to(torch.int32)
    # first valid slot at or after each position, last valid at or before
    nxt = torch.where(m, pos, torch.full_like(pos, Tp))
    nxt = torch.flip(torch.cummin(torch.flip(nxt, [1]), dim=1).values, [1])
    prv = torch.cummax(torch.where(m, pos, torch.full_like(pos, -1)),
                       dim=1).values
    j1 = nxt[:, i1].clamp(max=Tp - 1)
    j2 = prv[:, i2].clamp(min=0)
    v1, v2 = v.gather(1, j1), v.gather(1, j2)
    t1, t2 = rows.tsrow[j1], rows.tsrow[j2]
    pres = nv >= 2
    n = nv.clamp(min=2).to(torch.float32)
    r = _extrapolate(v1, v2, t1, t2, n, rows.ws, rows.we, vb[:, None],
                     is_counter, is_rate)
    r = torch.where(pres, r, torch.zeros((), dtype=r.dtype, device=r.device))
    return r, pres.to(torch.float32)


def _rate_ragged_cells(vals_p, vbase_p, ridx, rows: PlanRows,
                       is_counter: bool, is_rate: bool,
                       block_rows: int = 131_072):
    """K3's per-(row, window) (rates, presence) for the rows ridx, in row
    blocks (each row is independent), so the scan temporaries stay a few
    GB at a million series."""
    parts = [_ragged_rates(vals_p[blk], vbase_p[blk], rows, is_counter,
                           is_rate)
             for blk in torch.split(ridx, block_rows)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


LANES = 32
"""Lanes of the warp that corrects one row in K2: lane l owns the slots
[l*L, (l+1)*L), L = ceil(span / LANES) — the association of the drops'
prefix sum, which kernel and plain version share."""


def _drop_corrected(v: torch.Tensor, vb: torch.Tensor, span: int,
                    ragged: bool) -> torch.Tensor:
    """K2's reset correction: rows v [R, >= span] f32 with bases vb [R] ->
    the corrected rows [R, span], c[j] = v[j] + (d[0] + ... + d[j]).

    d[j] = prev + vb where v[j] < prev, the previous sample (ragged: the
    previous VALID one, carried across NaN holes), else 0; 0 where no
    previous sample exists (pallas_fused.py:598-605, :554-562).  The prefix
    sum is taken in the kernel's association (csrc/fused_drops.cu): each
    lane's drops in slot order from +0, the lanes' exclusive prefix in
    lane order, then each slot's running sum from its lane's prefix.
    NaN samples stay NaN."""
    x = v[:, :span]
    R = x.shape[0]
    dev = x.device
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    if ragged:
        pos = torch.arange(span, device=dev).expand(R, span)
        last = torch.cummax(torch.where(x == x, pos, torch.full_like(pos, -1)),
                            dim=1).values
        pidx = torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]],
                         dim=1)
        has = pidx >= 0
        prev = x.gather(1, pidx.clamp(min=0))
    else:
        prev = torch.cat([x[:, :1], x[:, :-1]], dim=1)
        has = torch.ones_like(x, dtype=torch.bool)
        has[:, 0] = False
    d = torch.where(has & (x < prev), prev + vb[:, None], zero)
    L = -(-span // LANES)
    dp = torch.zeros((R, LANES * L), dtype=x.dtype, device=dev)
    dp[:, :span] = d
    dp = dp.view(R, LANES, L)
    total = torch.zeros((R, LANES), dtype=x.dtype, device=dev)
    for k in range(L):
        total = total + dp[:, :, k]
    run = torch.zeros_like(total)
    acc = torch.zeros((R,), dtype=x.dtype, device=dev)
    for lane in range(1, LANES):
        acc = acc + total[:, lane - 1]
        run[:, lane] = acc
    cum = torch.empty_like(dp)
    for k in range(L):
        run = run + dp[:, :, k]
        cum[:, :, k] = run
    return x + cum.view(R, LANES * L)[:, :span]


def _rate_drops_cells(vals_p, vbase_p, ridx, rows: PlanRows,
                      is_counter: bool, is_rate: bool, ragged: bool,
                      block_rows: int = 131_072):
    """K2's per-(row, window) rates for the rows ridx over their
    reset-corrected values -> (rates, presence or None); in row blocks,
    like K3's, so the temporaries stay a few GB at a million series."""
    outs, pres = [], []
    for blk in torch.split(ridx, block_rows):
        vb = vbase_p[blk]
        c = _drop_corrected(vals_p[blk], vb, rows.span, ragged)
        if ragged:
            r, p = _ragged_rates(c, vb, rows, is_counter, is_rate)
            outs.append(r)
            pres.append(p)
        else:
            outs.append(_extrapolate(
                c[:, rows.idx1.long()], c[:, rows.idx2.long()], rows.t1,
                rows.t2, rows.n, rows.ws, rows.we, vb[:, None], is_counter,
                is_rate))
    return torch.cat(outs), (torch.cat(pres) if ragged else None)


def _last_cells(vals_p, vbase_p, ridx, rows: PlanRows, ragged: bool):
    """K4's per-(row, window) value at idx2 -> (out, presence or None).
    Dense: v*m + vb*m with m = min(n1, 1).  Ragged keeps slot semantics:
    (valid ? v : 0) + vb, times presence valid(v) * m."""
    c = _consts(vals_p.device)
    x = _at(vals_p, ridx, rows.idx2.long())
    vb = vbase_p[ridx][:, None]
    m = torch.minimum(rows.n1, c(1.0))
    if not ragged:
        return x * m + vb * m, None
    ok = x == x
    sel = torch.where(ok, x, c(0.0))
    pres = ok.to(torch.float32) * m
    return (sel + vb) * pres, pres


def _over_time_cells(vals_p, vbase_p, ridx, rows: PlanRows, kind: str,
                     ragged: bool):
    """K5's per-(row, window) sum/avg/count_over_time -> (out, presence or
    None).  Each window's slots idx1..idx2 are added in ascending slot
    order, one slot column at a time; slots past idx2 (and every slot of
    an empty window) add +0.0, which leaves the sum's bits unchanged — the
    kernel's loop, not a cumsum difference (that rounds differently)."""
    c = _consts(vals_p.device)
    i1, i2 = rows.idx1.long(), rows.idx2.long()
    live = rows.n1 > 0
    width = int(((i2 - i1 + 1) * live).max().item()) if live.numel() else 0
    Tp = vals_p.shape[1]
    zero = c(0.0)
    s = torch.zeros((ridx.numel(), i1.numel()), dtype=torch.float32,
                    device=vals_p.device)
    cnt = torch.zeros_like(s) if ragged else None
    for k in range(width):
        j = i1 + k
        take = live & (j <= i2)
        x = _at(vals_p, ridx, j.clamp(max=Tp - 1))
        if ragged:
            ok = take[None, :] & (x == x)
            s = s + torch.where(ok, x, zero)
            cnt = cnt + ok.to(torch.float32)
        else:
            s = s + torch.where(take[None, :], x, zero)
    vb = vbase_p[ridx][:, None]
    n = cnt if ragged else rows.n1
    if kind == "sum_over_time":
        out = s + vb * n
    elif kind == "avg_over_time":
        out = s / torch.maximum(n, c(1.0)) + vb
    elif kind == "count_over_time":
        out = n * torch.ones_like(s)
    else:
        raise ValueError(f"not an over_time band kind: {kind}")
    if not ragged:
        return out, None
    if kind == "count_over_time":
        # count's presence is SLOT-based: a window whose grid slots exist
        # but hold only NaN emits 0, not absent (pallas_fused.py:533-539)
        pres = (rows.n1 > 0).to(torch.float32) * torch.ones_like(s)
    else:
        pres = (cnt > 0).to(torch.float32)
        if kind == "avg_over_time":
            out = out * pres          # no vbase leak into absent cells
    return out, pres


def _cells(kind: str, ragged: bool, vals_p, vbase_p, ridx, rows,
           is_counter=False, is_rate=False, with_drops=False):
    """Per-(row, window) (values, presence or None) of any kernel kind."""
    if with_drops:
        if kind != "rate_family":
            raise ValueError(f"in-kernel drops apply to the rate family, "
                             f"not {kind}")
        return _rate_drops_cells(vals_p, vbase_p, ridx, rows, is_counter,
                                 is_rate, ragged)
    if kind == "rate_family":
        if ragged:
            return _rate_ragged_cells(vals_p, vbase_p, ridx, rows,
                                      is_counter, is_rate)
        return _rate_dense_cells(vals_p, vbase_p, ridx, rows, is_counter,
                                 is_rate), None
    if kind == "last_over_time":
        return _last_cells(vals_p, vbase_p, ridx, rows, ragged)
    return _over_time_cells(vals_p, vbase_p, ridx, rows, kind, ragged)


def group_plain(kind, ragged, vals_p, vbase_p, csr, chunks, rows, Gp,
                is_counter=False, is_rate=False, with_drops=False):
    """The plain version of any kind's group-mode kernel -> sums [Gp, W]
    (dense) or (sums, presence) (ragged)."""
    out, pres = _cells(kind, ragged, vals_p, vbase_p, csr.order.long(),
                       rows, is_counter, is_rate, with_drops)
    planes = [out] if pres is None else [out, pres]
    sums = _chunked_group_sum(planes, chunks, Gp)
    return sums[0] if pres is None else tuple(sums)


def fused_rate_dense_plain(vals_p: torch.Tensor, vbase_p: torch.Tensor,
                           csr: GroupCSR, chunks: ChunkPlan, rows: PlanRows,
                           Gp: int, is_counter: bool,
                           is_rate: bool) -> torch.Tensor:
    """K1's function in torch ops -> sums [Gp, W]."""
    return group_plain("rate_family", False, vals_p, vbase_p, csr, chunks,
                       rows, Gp, is_counter, is_rate)


def fused_rate_ragged_plain(vals_p: torch.Tensor, vbase_p: torch.Tensor,
                            csr: GroupCSR, chunks: ChunkPlan,
                            rows: PlanRows, Gp: int, is_counter: bool,
                            is_rate: bool):
    """K3's function in torch ops -> (sums [Gp, W], presence [Gp, W])."""
    return group_plain("rate_family", True, vals_p, vbase_p, csr, chunks,
                       rows, Gp, is_counter, is_rate)


def fused_rate_drops_plain(vals_p, vbase_p, csr, chunks, rows, Gp,
                           is_counter: bool, is_rate: bool, ragged: bool):
    """K2's function in torch ops -> sums [Gp, W] (dense) or (sums,
    presence) (ragged)."""
    return group_plain("rate_family", ragged, vals_p, vbase_p, csr, chunks,
                       rows, Gp, is_counter, is_rate, with_drops=True)


def fused_over_time_plain(vals_p, vbase_p, csr, chunks, rows, Gp,
                          kind: str, ragged: bool):
    """K4's (kind last_over_time) or K5's (sum/avg/count_over_time)
    function in torch ops -> sums [Gp, W] (dense) or (sums, presence)
    (ragged)."""
    return group_plain(kind, ragged, vals_p, vbase_p, csr, chunks, rows, Gp)


def fused_per_series_plain(vals_p, vbase_p, rows, num_rows: int, kind: str,
                           ragged: bool, is_counter: bool = False,
                           is_rate: bool = False, with_drops: bool = False):
    """K6's function in torch ops: rows 0..num_rows-1 of any kind ->
    (values [num_rows, W], presence [num_rows, W] or None when dense)."""
    ridx = torch.arange(num_rows, device=vals_p.device)
    return _cells(kind, ragged, vals_p, vbase_p, ridx, rows, is_counter,
                  is_rate, with_drops)


# ------------------------------------------------------------ wrappers
# A CPU tensor takes the plain version; a CUDA tensor launches the kernel
# or raises.

def fused_rate_dense(vals_p, vbase_p, csr, chunks, rows, Gp, is_counter,
                     is_rate) -> torch.Tensor:
    """K1 -> sums [Gp, W]."""
    if vals_p.device.type == "cpu":
        return fused_rate_dense_plain(vals_p, vbase_p, csr, chunks, rows, Gp,
                                      is_counter, is_rate)
    from filodb_tpu_torch.ops import kernels
    return kernels.fused_rate_dense_cuda(vals_p, vbase_p, csr.order, chunks,
                                         rows, Gp, is_counter, is_rate)


def fused_rate_ragged(vals_p, vbase_p, csr, chunks, rows, Gp, is_counter,
                      is_rate):
    """K3 -> (sums, presence) [Gp, W]."""
    if vals_p.device.type == "cpu":
        return fused_rate_ragged_plain(vals_p, vbase_p, csr, chunks, rows,
                                       Gp, is_counter, is_rate)
    from filodb_tpu_torch.ops import kernels
    return kernels.fused_rate_ragged_cuda(vals_p, vbase_p, csr.order, chunks,
                                          rows, Gp, is_counter, is_rate)


def fused_rate_drops(vals_p, vbase_p, csr, chunks, rows, Gp, is_counter,
                     is_rate, ragged: bool):
    """K2 -> sums [Gp, W] (dense) or (sums, presence) (ragged)."""
    if vals_p.device.type == "cpu":
        return fused_rate_drops_plain(vals_p, vbase_p, csr, chunks, rows, Gp,
                                      is_counter, is_rate, ragged)
    from filodb_tpu_torch.ops import kernels
    return kernels.fused_rate_drops_cuda(vals_p, vbase_p, csr.order, chunks,
                                         rows, Gp, is_counter, is_rate,
                                         ragged)


def fused_over_time(vals_p, vbase_p, csr, chunks, rows, Gp, kind: str,
                    ragged: bool):
    """K4 (kind last_over_time) or K5 (sum/avg/count_over_time) -> sums
    [Gp, W] (dense) or (sums, presence) (ragged)."""
    if vals_p.device.type == "cpu":
        return fused_over_time_plain(vals_p, vbase_p, csr, chunks, rows, Gp,
                                     kind, ragged)
    from filodb_tpu_torch.ops import kernels
    return kernels.fused_over_time_cuda(vals_p, vbase_p, csr.order, chunks,
                                        rows, Gp, kind, ragged)


def fused_per_series(vals_p, vbase_p, rows, num_rows: int, kind: str,
                     ragged: bool, is_counter: bool = False,
                     is_rate: bool = False, with_drops: bool = False):
    """K6 (over K2 when with_drops) -> (values [num_rows, W], presence or
    None)."""
    if vals_p.device.type == "cpu":
        return fused_per_series_plain(vals_p, vbase_p, rows, num_rows, kind,
                                      ragged, is_counter, is_rate, with_drops)
    from filodb_tpu_torch.ops import kernels
    return kernels.fused_per_series_cuda(vals_p, vbase_p, rows, num_rows,
                                         kind, ragged, is_counter, is_rate,
                                         with_drops)


def group_launch(kind: str, ragged: bool, vals_p, vbase_p, csr, chunks,
                 rows, Gp, is_counter=False, is_rate=False, with_drops=False):
    """The group-mode wrapper of a kind -> (sums,) or (sums, presence)."""
    if with_drops:
        if kind != "rate_family":
            raise ValueError(f"in-kernel drops apply to the rate family, "
                             f"not {kind}")
        res = fused_rate_drops(vals_p, vbase_p, csr, chunks, rows, Gp,
                               is_counter, is_rate, ragged)
    elif kind == "rate_family":
        res = (fused_rate_ragged if ragged else fused_rate_dense)(
            vals_p, vbase_p, csr, chunks, rows, Gp, is_counter, is_rate)
    else:
        res = fused_over_time(vals_p, vbase_p, csr, chunks, rows, Gp, kind,
                              ragged)
    return res if isinstance(res, tuple) else (res,)


# ---------------------------------------------------------- leaf entry

def fused_leaf_agg_batch(plan: FusedPlan, values: PaddedValues, panels,
                         fn_name: str, precorrected: bool = False,
                         ragged: bool = False,
                         num_series: Optional[int] = None,
                         lazy: bool = False):
    """Evaluate P aggregation panels over ONE working set in at most two
    kernel launches — the dashboard case (same metric + window grid,
    different `by (...)` groupings / agg ops).

    panels: [(PaddedGroups, num_groups, agg_op)].  sum/avg panels (and
    count panels on ragged data) merge into one group-mode launch over
    disjoint group ranges; min/max panels share one per-series launch
    (K6) finished by a map_phase each; dense count panels are host math.
    rate/increase over values that are not precorrected run K2 (the
    reset correction inside the launch).
    Returns per-panel [G, W, C] float64 components in input order
    (ops/agg.AGGREGATORS layout).  lazy=True returns a zero-arg finisher:
    every launch is issued before returning and the synchronizing
    readback waits for the call."""
    from filodb_tpu_torch.ops import agg as agg_ops
    if fn_name in MINMAX_FNS or fn_name not in FUSABLE_FNS:
        raise ValueError(f"unsupported fused kernel kind {fn_name}")
    is_counter = fn_name in ("rate", "increase")
    is_rate = fn_name == "rate"
    # delta never corrects (pallas_fused.py:966-968)
    with_drops = is_counter and not precorrected
    bad = [op for _, _, op in panels if op not in FUSABLE_AGGS]
    if bad:
        raise ValueError(f"unsupported fused agg {bad[0]}")
    over_time = fn_name in OVER_TIME_FNS
    kind = fn_name if over_time else "rate_family"
    wvalid = plan.wvalid1 if over_time else plan.wvalid
    vals_p, vbase_p = values
    dev = vals_p.device
    rows = plan.device_rows(dev)
    mm_idx = [i for i, (_, _, op) in enumerate(panels)
              if op in ("sum", "avg") or (op == "count" and ragged)]
    ps_idx = [i for i, (_, _, op) in enumerate(panels)
              if op in ("min", "max")]
    out: list = [None] * len(panels)
    res = offsets = None
    if mm_idx:
        csr, offsets, total = merge_groups(
            [panels[i][0] for i in mm_idx], [panels[i][1] for i in mm_idx])
        Gp = pad_group_count(total)
        check_kernel_shape(vals_p.shape[0], plan.Tp, plan.W, Gp,
                           panels=len(mm_idx))
        chunks = chunk_plan(csr.offsets, Gp, dev)
        res = group_launch(kind, ragged, vals_p, vbase_p, csr, chunks, rows,
                           Gp, is_counter, is_rate, with_drops)
    ps_comps: dict = {}
    if ps_idx:
        S = num_series
        if S is None:
            S = int((panels[ps_idx[0]][0].gids_p >= 0).sum())
        check_kernel_shape(S, plan.Tp, plan.W, 8)
        # one shared per-series run: the [S, W] output is group-agnostic
        vals, pres = fused_per_series(vals_p, vbase_p, rows, S, kind, ragged,
                                      is_counter, is_rate, with_drops)
        nan = torch.full((), float("nan"), dtype=vals.dtype, device=dev)
        if ragged:
            per = torch.where(pres > 0, vals, nan)
        else:
            keep = torch.from_numpy(np.asarray(wvalid, bool)).to(dev)
            per = torch.where(keep[None, :], vals, nan)
        for i in ps_idx:
            groups, G, op = panels[i]
            ps_comps[i] = agg_ops.map_phase(op, per, groups.gids_p[:S], G)

    def dense_counts(groups):
        return groups.gsize[:, None].astype(np.float64) * \
            wvalid[None, :].astype(np.float64)

    def finish():
        if mm_idx:
            sums_all = res[0].double().cpu().numpy()
            cnts_all = res[1].double().cpu().numpy() if ragged else None
            for j, i in enumerate(mm_idx):
                groups, G, op = panels[i]
                lo = offsets[j]
                sums = sums_all[lo:lo + G, :plan.W]
                counts = (cnts_all[lo:lo + G, :plan.W] if ragged
                          else dense_counts(groups))
                if op == "count":
                    out[i] = counts[..., None]
                else:
                    out[i] = np.stack([sums * (counts > 0), counts], axis=-1)
        for i in ps_idx:
            out[i] = ps_comps[i].cpu().numpy()
        for i, (groups, G, op) in enumerate(panels):
            if out[i] is None:          # dense count: pure host math
                out[i] = dense_counts(groups)[..., None]
        return out

    return finish if lazy else finish()


def fused_leaf_agg(plan: FusedPlan, prepared: "PreparedInputs",
                   gids, num_groups: int, fn_name: str, agg_op: str,
                   precorrected: bool = False,
                   ragged: bool = False) -> np.ndarray:
    """One fused leaf evaluation -> partial components [G, W, C] float64
    (ops/agg.AGGREGATORS layout) for any fusable (fn, agg) pair: the
    single-panel form of fused_leaf_agg_batch (pallas_fused.py:1171)."""
    return fused_leaf_agg_batch(
        plan, prepared.values, [(prepared.groups, num_groups, agg_op)],
        fn_name, precorrected=precorrected, ragged=ragged,
        num_series=len(gids))[0]


# ----------------------------------------------------- kernel-level API
# The entry points of pallas_fused.py that callers outside the leaf use
# (its tests and benches, the mesh's per-device unit): raw or corrected
# counters straight in, one launch out.

def gather_default(kind: str) -> bool:
    """Whether the reference selects window boundaries by gather (True) or
    by one-hot matmul (False, K7) for a kernel kind (pallas_fused.py:73).
    The reference reads FILODB_FUSED_GATHER here; the port does not: on
    the card both selections are the same indexed loads of the same
    kernels, so the knob's default is fixed."""
    return kind in ("rate_family", "last_over_time")


def run_kernel(vals_p, vbase_p, groups, rows: PlanRows, *, num_groups: int,
               is_counter: bool = False, is_rate: bool = False,
               with_drops: bool = False, kind: str = "rate_family",
               ragged: bool = False, per_series: bool = False,
               gather: bool = False, num_rows: Optional[int] = None):
    """The one dispatch by variant flags (pallas_fused.run_kernel :869),
    taking the plan's rows where the reference takes its o1/o2/l1/l2
    selection matrices.

    groups: a PaddedGroups or its GroupCSR (group mode; ignored per
    series).  num_groups: the padded group count Gp of the output.
    gather: the reference's choice between gathered and one-hot matmul
    selections (K7); both values launch the same kernel here, the
    selections being plain indexed loads either way.  Returns, in group
    mode, sums [Gp, W] (dense) or (sums, presence) (ragged); per series,
    values [num_rows, W] (dense) or (values, presence) (ragged)."""
    del gather
    if per_series:
        n = vals_p.shape[0] if num_rows is None else num_rows
        vals, pres = fused_per_series(vals_p, vbase_p, rows, n, kind, ragged,
                                      is_counter, is_rate, with_drops)
        return vals if pres is None else (vals, pres)
    csr = groups.csr if isinstance(groups, PaddedGroups) else groups
    chunks = chunk_plan(csr.offsets, num_groups, vals_p.device)
    res = group_launch(kind, ragged, vals_p, vbase_p, csr, chunks, rows,
                       num_groups, is_counter, is_rate, with_drops)
    return res[0] if len(res) == 1 else res


class PreparedInputs(NamedTuple):
    """Padded device-resident query inputs, built once per working set
    (the pad is a full [S, T] device copy; never pay it per query)."""
    vals_p: torch.Tensor     # [Sp, Tp] f32
    vbase_p: torch.Tensor    # [Sp] f32
    gids_p: torch.Tensor     # [Sp] int32 (-1 pad rows)
    gsize: np.ndarray        # [num_groups] series per group
    csr: GroupCSR            # rows by group (the kernels' sum order)

    @property
    def values(self) -> PaddedValues:
        return PaddedValues(self.vals_p, self.vbase_p)

    @property
    def groups(self) -> PaddedGroups:
        return PaddedGroups(self.gids_p, self.gsize, self.csr)


def _input_device(vals, device) -> torch.device:
    """The device rule for the kernel-level entry points: an explicit
    `device`, else the device of a tensor argument, else the card (which
    raises without one)."""
    from filodb_tpu_torch.utils.device import resolve_device
    if device is not None:
        return resolve_device(device)
    if isinstance(vals, torch.Tensor):
        return vals.device
    return resolve_device("cuda")


def pad_inputs(vals, vbase, gids, plan: FusedPlan, num_groups: int,
               device=None) -> PreparedInputs:
    """pad_values + pad_groups in one (pallas_fused.py:935)."""
    dev = _input_device(vals, device)
    v = pad_values(vals, vbase, plan, device=dev)
    g = pad_groups(gids, int(vals.shape[0]), num_groups, device=dev)
    return PreparedInputs(v.vals_p, v.vbase_p, g.gids_p, g.gsize, g.csr)


def fused_rate_groupsum(vals, vbase, gids, plan: FusedPlan, num_groups: int,
                        fn_name: str = "rate", precorrected: bool = False,
                        prepared: Optional[PreparedInputs] = None,
                        ragged: bool = False, gather: Optional[bool] = None,
                        device=None):
    """-> (sums [G, W] f32 tensor, counts [G, W] float64 numpy), the
    reference's contract (pallas_fused.py:942-1001).

    vals: [S, T] f32 rebased values on one shared grid (ignored when
    `prepared` is given); vbase [S] the per-series base (absolute = rebased
    + vbase).  rate/increase over values that are not `precorrected` run
    K2, which corrects counter resets inside the launch; delta never
    corrects.  Dense counts are |group| x 1{window valid}; ragged=True
    runs the NaN-aware variant and counts come from its presence output.
    `device` follows the device rule (an explicit device, else the
    tensor's, else the card); with `prepared` it must match the inputs'."""
    if fn_name in MINMAX_FNS or fn_name not in FUSABLE_FNS:
        raise ValueError(f"unsupported fused kernel kind {fn_name}")
    is_counter = fn_name in ("rate", "increase")
    is_rate = fn_name == "rate"
    over_time = fn_name in OVER_TIME_FNS
    kind = fn_name if over_time else "rate_family"
    if prepared is None:
        prepared = pad_inputs(vals, vbase, gids, plan, num_groups,
                              device=device)
    elif device is not None and \
            _input_device(None, device) != prepared.vals_p.device:
        raise ValueError(f"prepared inputs are on {prepared.vals_p.device}, "
                         f"not {device}")
    dev = prepared.vals_p.device
    Gp = pad_group_count(num_groups)
    check_kernel_shape(prepared.vals_p.shape[0], plan.Tp, plan.W, Gp)
    res = run_kernel(prepared.vals_p, prepared.vbase_p, prepared.csr,
                     plan.device_rows(dev), num_groups=Gp,
                     is_counter=is_counter, is_rate=is_rate,
                     with_drops=is_counter and not precorrected, kind=kind,
                     ragged=ragged,
                     gather=gather_default(kind) if gather is None else gather)
    if ragged:
        sums, cnts = res
        counts = cnts[:num_groups].double().cpu().numpy()
    else:
        sums = res
        wvalid = plan.wvalid1 if over_time else plan.wvalid
        counts = prepared.gsize[:, None].astype(np.float64) * \
            wvalid[None, :].astype(np.float64)
    return sums[:num_groups], counts


def warmup_compile(S: int, T: int, W: int, G: int, fn_name: str = "rate",
                   device=None) -> float:
    """Build every CUDA library (on the card), make one fused launch at
    the canonical padded shape of (S series, T samples, W windows, G
    groups) over zeros, and run the general path (ops/rangefns.py then
    ops/agg.py) once at the same shape -> wall seconds
    (pallas_fused.py:1004).  The port compiles nothing at query time, so
    this warms the libraries' loading and the allocator's pools, which
    the first query over such a working set would otherwise pay."""
    import time
    from filodb_tpu_torch.ops import agg as agg_ops
    from filodb_tpu_torch.ops.rangefns import evaluate_range_function
    from filodb_tpu_torch.ops.timewindow import to_offsets
    t0 = time.perf_counter()
    dev = _input_device(None, device)
    if dev.type == "cuda":
        from filodb_tpu_torch.ops import kernels
        kernels.finish_builds(kernels.start_builds())
        for name in kernels.SOURCES:
            kernels.library(name)
    step = 10_000
    W = max(min(W, T), 1)
    G = max(G, 1)
    ts_row = np.arange(T, dtype=np.int64) * step
    wends = ts_row[-1] - np.arange(W, dtype=np.int64)[::-1] * step
    plan = build_plan(ts_row, wends, 300_000)
    vals = torch.zeros((S, T), dtype=torch.float32, device=dev)
    vbase = torch.zeros((S,), dtype=torch.float32, device=dev)
    gids = (np.arange(S) % G).astype(np.int32)
    fused_rate_groupsum(vals, vbase, gids, plan, G, fn_name,
                        precorrected=True)
    # the general path at the same shape: any query the fused leaf does
    # not take over such a working set runs these ops
    ts_off = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        to_offsets(ts_row[None, :], np.full(1, T), 0), (S, T)))).to(dev)
    per = evaluate_range_function(
        ts_off, vals, torch.from_numpy(wends.astype(np.int32)).to(dev),
        300_000, fn_name, shared_grid=True, vbase=vbase.double(),
        precorrected=True)
    groups = pad_groups(gids, S, G, device=dev)
    agg_ops.aggregate("sum", per, groups.gids_p[:S], G, csr=groups.csr)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def present_sum(sums, counts) -> np.ndarray:
    """Finish the 3-phase contract host-side: NaN where no contributors."""
    if isinstance(sums, torch.Tensor):
        sums = sums.double().cpu().numpy()
    s = np.asarray(sums, np.float64)
    return np.where(counts > 0, s, np.nan)
