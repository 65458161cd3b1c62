"""Chunk downsampling algorithms + period markers (port of
filodb_tpu/downsample/downsamplers.py; host numpy, as there).

Mirrors the reference's downsample runtime (ref:
core/.../downsample/ChunkDownsampler.scala — dMin/dMax/dSum/dCount/dAvg/
dLast/hLast/tTime subtypes; DownsamplePeriodMarker.scala — time- and
counter-dip-driven period boundaries).

Departure from the Scala reference: it walks each chunk row-by-row through
per-period accumulators.  Here a chunk's samples are segmented once into
period slices (vectorized boundary detection) and every algorithm reduces
whole segments with `np.ufunc.reduceat` — one fused pass per column, no
per-row dispatch.  Counter periods additionally break at drops so the
emitted dLast sequence preserves resets for query-time rate correction
(ref: doc/downsampling.md, DownsamplePeriodMarker.scala counter marker).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_SPEC_RE = re.compile(r"([a-zA-Z]+)\((\d+)\)")


@dataclasses.dataclass(frozen=True)
class DownsamplerSpec:
    """Parsed 'dMin(1)'-style spec: algorithm + source column index
    (ref: ChunkDownsampler.downsamplers config parsing)."""
    algo: str
    col_index: int

    @staticmethod
    def parse(spec: str) -> "DownsamplerSpec":
        m = _SPEC_RE.fullmatch(spec.strip())
        if not m:
            raise ValueError(f"bad downsampler spec {spec!r}")
        return DownsamplerSpec(m.group(1), int(m.group(2)))


def parse_period_marker(spec: str) -> Tuple[str, int]:
    """'time(0)' | 'counter(1)' → (kind, column index)
    (ref: DownsamplePeriodMarker.downsamplePeriodMarker)."""
    m = _SPEC_RE.fullmatch(spec.strip())
    if not m or m.group(1) not in ("time", "counter"):
        raise ValueError(f"bad period marker spec {spec!r}")
    return m.group(1), int(m.group(2))


def period_boundaries(ts: np.ndarray, resolution_ms: int,
                      counter_vals: Optional[np.ndarray] = None) -> np.ndarray:
    """Segment start indices for one series chunk (sorted ts [T]).

    A new period starts whenever the sample crosses a resolution boundary
    (period of t = which (k*res, (k+1)*res] bucket it falls in), and — when
    `counter_vals` is given — additionally right after any counter drop, so
    resets survive downsampling (ref: DownsamplePeriodMarker.scala counter
    marker via chunk drop positions).
    Returns int64 [P] segment start indices (first always 0).
    """
    if len(ts) == 0:
        return np.empty(0, dtype=np.int64)
    pid = (ts - 1) // resolution_ms
    new_period = np.empty(len(ts), dtype=bool)
    new_period[0] = True
    np.not_equal(pid[1:], pid[:-1], out=new_period[1:])
    if counter_vals is not None and len(counter_vals) > 1:
        drops = counter_vals[1:] < counter_vals[:-1]
        new_period[1:] |= drops
    return np.flatnonzero(new_period).astype(np.int64)


def _seg_last(vals: np.ndarray, starts: np.ndarray) -> np.ndarray:
    ends = np.empty_like(starts)
    ends[:-1] = starts[1:] - 1
    ends[-1] = len(vals) - 1
    return vals[ends]


def downsample_column(algo: str, ts: np.ndarray, vals: np.ndarray,
                      starts: np.ndarray) -> np.ndarray:
    """Reduce one column over period segments (ref: ChunkDownsampler
    subtypes).  `vals` is [T] (or [T, B] for hLast); returns [P] (or [P, B]).
    NaNs inside a segment propagate like the reference (ingest never stores
    NaN gauges; counters are NaN-free by construction)."""
    if algo == "tTime":
        return _seg_last(ts, starts)
    if algo == "dLast" or algo == "hLast":
        return _seg_last(vals, starts)
    if algo == "dMin":
        return np.minimum.reduceat(vals, starts)
    if algo == "dMax":
        return np.maximum.reduceat(vals, starts)
    if algo == "dSum":
        return np.add.reduceat(vals, starts)
    if algo == "dCount":
        return np.add.reduceat(np.isfinite(vals).astype(np.float64), starts)
    if algo == "dAvg":
        s = np.add.reduceat(vals, starts)
        c = np.add.reduceat(np.isfinite(vals).astype(np.float64), starts)
        with np.errstate(invalid="ignore", divide="ignore"):
            return s / c
    raise ValueError(f"unknown downsampler algo {algo!r}")


def downsample_chunk(schema, ts: np.ndarray, cols: Dict[str, np.ndarray],
                     resolution_ms: int) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Downsample one series chunk under `schema`'s declared downsamplers.

    Returns (out_ts [P], out_cols) laid out for the schema's downsample
    target schema: gauge → ds-gauge (min/max/sum/count/avg), prom-counter →
    prom-counter (count), prom-histogram → prom-histogram (sum/count/h)
    (ref: ShardDownsampler.populateDownsampleRecords, filodb-defaults.conf
    schema `downsamplers` lists).
    """
    marker_kind, marker_col = parse_period_marker(schema.downsample_period_marker)
    data_cols = schema.data_columns
    all_cols = (schema.ts_column,) + data_cols
    counter_vals = None
    if marker_kind == "counter":
        counter_vals = cols[all_cols[marker_col].name]
    starts = period_boundaries(ts, resolution_ms, counter_vals)
    if len(starts) == 0:
        return np.empty(0, dtype=np.int64), {}
    out_ts: Optional[np.ndarray] = None
    out_cols: Dict[str, np.ndarray] = {}
    for spec_s in schema.downsamplers:
        spec = DownsamplerSpec.parse(spec_s)
        src = all_cols[spec.col_index]
        src_vals = ts if src.col_type == "ts" else cols[src.name]
        out = downsample_column(spec.algo, ts, src_vals, starts)
        if spec.algo == "tTime":
            out_ts = out
        else:
            out_cols[_target_col_name(spec.algo, src.name)] = out
    assert out_ts is not None, "schema downsamplers must include tTime"
    return out_ts, out_cols


def _target_col_name(algo: str, src_name: str) -> str:
    """Column name in the downsample target schema: ds-gauge gets one column
    per algorithm; last-value algos keep the source column name
    (ref: DS_GAUGE schema columns; Schemas.downsample mapping)."""
    return {"dMin": "min", "dMax": "max", "dSum": "sum", "dCount": "count",
            "dAvg": "avg"}.get(algo, src_name)
