"""Histogram bucket schemes and the bucket-matrix encoding (port of
filodb_tpu/memory/histogram.py).

Buckets are CUMULATIVE counts with `le` (less-than-or-equal) upper
bounds, the last one +Inf: the Prometheus scheme.  A store keeps them as
a dense [series, time, buckets] matrix; a flushed chunk encodes a
series' [time, buckets] matrix with encode_hist_matrix.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from filodb_tpu_torch.memory import nibblepack


@dataclasses.dataclass(frozen=True)
class HistogramBuckets:
    """A bucket scheme: the array of `le` upper bounds (ascending, last may
    be +Inf)."""
    les: Tuple[float, ...]

    @property
    def num_buckets(self) -> int:
        return len(self.les)

    def as_array(self) -> np.ndarray:
        return np.asarray(self.les, dtype=np.float64)

    @staticmethod
    def geometric(first: float, multiplier: float, num: int,
                  inf_bucket: bool = True) -> "HistogramBuckets":
        """le[i] = first * multiplier^i, optionally closed by +Inf."""
        les = [first * (multiplier ** i)
               for i in range(num - (1 if inf_bucket else 0))]
        if inf_bucket:
            les.append(float("inf"))
        return HistogramBuckets(tuple(les))

    @staticmethod
    def custom(les: Sequence[float]) -> "HistogramBuckets":
        return HistogramBuckets(tuple(float(x) for x in les))


def default_buckets(num: int = 8) -> HistogramBuckets:
    """The canonical test scheme: `num` geometric buckets from 2, x2."""
    return HistogramBuckets.geometric(2.0, 2.0, num, inf_bucket=False)


def union_les(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Union of two bucket schemes: the sorted unique le boundaries, the
    widened scheme both can be mapped onto (a query spanning a scheme
    change evaluates on it instead of failing)."""
    return np.union1d(np.asarray(a, np.float64), np.asarray(b, np.float64))


def rebucket(mat: np.ndarray, src_les: np.ndarray,
             dst_les: np.ndarray) -> np.ndarray:
    """Map cumulative bucket counts [..., B_src] onto dst_les [..., B_dst].

    The value at a destination boundary is the source CDF at the smallest
    source le >= that boundary: exact where boundaries coincide, the
    tightest monotone upper bound where the source never measured.  A
    dst le above every source le takes the topmost bucket (the +Inf
    total)."""
    src = np.asarray(src_les, np.float64)
    dst = np.asarray(dst_les, np.float64)
    idx = np.searchsorted(src, dst, side="left")
    idx = np.minimum(idx, len(src) - 1)
    return np.asarray(mat)[..., idx]


def encode_hist_matrix(mat: np.ndarray) -> bytes:
    """Encode a [time, buckets] cumulative-count matrix.

    2D-delta: each row is delta'd against the previous row (time-delta),
    and within a row buckets are delta'd against the previous bucket —
    increasing cumulative buckets make both deltas small and
    NibblePack-friendly.
    """
    m = np.asarray(mat, dtype=np.int64)
    if m.ndim != 2:
        raise ValueError("hist matrix must be [time, buckets]")
    bucket_delta = np.diff(m, axis=1, prepend=0)       # within-row
    time_delta = np.diff(bucket_delta, axis=0, prepend=0)  # across rows
    return nibblepack.pack_i64(time_delta.ravel())


def decode_hist_matrix(data: bytes, num_rows: int,
                       num_buckets: int) -> np.ndarray:
    flat = nibblepack.unpack_i64(data, num_rows * num_buckets)
    time_delta = flat.reshape(num_rows, num_buckets)
    bucket_delta = np.cumsum(time_delta, axis=0)
    return np.cumsum(bucket_delta, axis=1)
