"""BinaryHistogram wire blobs + section-based appendable histogram storage
(port of filodb_tpu/memory/binhist.py).

Wire-format parity with the reference's ingest blob (ref:
memory/src/main/scala/filodb.memory/format/vectors/HistogramVector.scala:17-34
BinaryHistogram):

    +0000  u16  total length of this BinaryHistogram (excluding these 2B)
    +0002  u8   format code:
                  0x00 empty  0x03 geometric+NP-delta-long
                  0x04 geometric_1+NP-delta-long  0x05 custom+NP-delta-long
                  0x08 geometric+NP-XOR-double    0x0a custom+NP-XOR-double
    +0003  u16  bucket-definition length
    +0005  [u8] bucket definition (first u16 = numBuckets; geometric adds
                f64 firstBucket + f64 multiplier; custom adds NP-XOR les)
    +...   NibblePacked values (zigzag deltas of increasing cumulative
                counts for the long formats; XOR stream for the doubles)

All integers little-endian (the reference's buffers are native-order on
x86; the explicit LITTLE_ENDIAN puts in GeometricBuckets.serialize:457).

The section-based appendable vector mirrors AppendableSectDeltaHistVector
(ref: HistogramVector.scala:427): histograms append as blobs; each
SECTION starts with an absolute histogram and subsequent entries are
NibblePacked deltas AGAINST THE SECTION START, so random access within a
section costs one unpack + one add, and counter drops reset sections.
The dense [T, B] matrix codec in memory/histogram.py remains the
query-side layout; this is the ingest/storage-side parity component.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from filodb_tpu_torch.memory import nibblepack

HIST_FORMAT_NULL = 0x00
HIST_FORMAT_GEOMETRIC_DELTA = 0x03
HIST_FORMAT_GEOMETRIC1_DELTA = 0x04
HIST_FORMAT_CUSTOM_DELTA = 0x05
HIST_FORMAT_GEOMETRIC_XOR = 0x08
HIST_FORMAT_CUSTOM_XOR = 0x0A


@dataclasses.dataclass(frozen=True)
class GeometricScheme:
    """le[i] = first * multiplier^i (+ adjustment -1 when minus_one;
    ref: Histogram.scala:448 GeometricBuckets)."""
    first: float
    multiplier: float
    num_buckets: int
    minus_one: bool = False

    def les(self) -> np.ndarray:
        tops = self.first * self.multiplier ** np.arange(self.num_buckets)
        return tops - (1.0 if self.minus_one else 0.0)

    def serialize(self) -> bytes:
        return struct.pack("<HHdd", 2 + 8 + 8, self.num_buckets,
                           self.first, self.multiplier)


@dataclasses.dataclass(frozen=True)
class CustomScheme:
    """Explicit le bounds, NibblePack-XOR packed on the wire
    (ref: Histogram.scala:480 CustomBuckets.serialize)."""
    les_arr: Tuple[float, ...]

    def les(self) -> np.ndarray:
        return np.asarray(self.les_arr, np.float64)

    @property
    def num_buckets(self) -> int:
        return len(self.les_arr)

    def serialize(self) -> bytes:
        packed = nibblepack.pack_f64_xor(self.les())
        return struct.pack("<HH", 2 + len(packed), self.num_buckets) + packed


Scheme = Union[GeometricScheme, CustomScheme]


def detect_scheme(les: np.ndarray) -> Scheme:
    """Prefer the 20-byte geometric definition when the les really are a
    geometric series (the reference's preferred prom scheme); otherwise a
    custom scheme (handles +Inf tops)."""
    les = np.asarray(les, np.float64)
    if len(les) >= 2 and np.isfinite(les).all() and (les > 0).all():
        mult = les[1] / les[0]
        if mult > 1 and np.allclose(les, les[0] * mult **
                                    np.arange(len(les)), rtol=1e-9):
            return GeometricScheme(float(les[0]), float(mult), len(les))
    return CustomScheme(tuple(float(x) for x in les))


def _parse_scheme(code: int, defn: bytes) -> Scheme:
    # defn = [u16 def-length][u16 numBuckets][scheme details...]
    num = struct.unpack_from("<H", defn, 2)[0]
    if code in (HIST_FORMAT_GEOMETRIC_DELTA, HIST_FORMAT_GEOMETRIC1_DELTA,
                HIST_FORMAT_GEOMETRIC_XOR):
        first, mult = struct.unpack_from("<dd", defn, 4)
        return GeometricScheme(first, mult, num,
                               code == HIST_FORMAT_GEOMETRIC1_DELTA)
    les = nibblepack.unpack_f64_xor(defn[4:], num)
    return CustomScheme(tuple(les.tolist()))


def encode_blob(values: np.ndarray,
                scheme: Optional[Scheme] = None,
                les: Optional[np.ndarray] = None) -> bytes:
    """One histogram sample -> BinaryHistogram wire bytes.

    Integral cumulative counts take the NibblePack-delta-long formats;
    non-integral values fall back to the XOR-double formats (the
    reference's HistFormat_*_XOR pair)."""
    values = np.asarray(values, np.float64)
    if scheme is None:
        scheme = detect_scheme(les)
    geometric = isinstance(scheme, GeometricScheme)
    integral = bool(np.isfinite(values).all()
                    and (values == np.rint(values)).all()
                    and (np.abs(values) < 2 ** 62).all())
    if integral:
        # zigzag'd bucket-axis deltas: non-negative for cumulative-le rows
        # (the reference packs unsigned deltas there), and still correct
        # for section-delta blobs whose bucket deltas may dip negative
        longs = np.rint(values).astype(np.int64)
        payload = nibblepack.pack_i64(np.diff(longs, prepend=0))
        if geometric:
            code = (HIST_FORMAT_GEOMETRIC1_DELTA if scheme.minus_one
                    else HIST_FORMAT_GEOMETRIC_DELTA)
        else:
            code = HIST_FORMAT_CUSTOM_DELTA
    else:
        payload = nibblepack.pack_f64_xor(values)
        if geometric and not scheme.minus_one:
            code = HIST_FORMAT_GEOMETRIC_XOR
        else:
            # no geometric_1 XOR format exists (matching the reference's
            # code table) — widen a minus_one scheme to explicit les so
            # the bucket bounds survive the round trip
            if geometric:
                scheme = CustomScheme(tuple(scheme.les().tolist()))
                geometric = False
            code = HIST_FORMAT_CUSTOM_XOR
    defn = scheme.serialize()
    body = struct.pack("<BH", code, len(defn)) + defn + payload
    if len(body) > 0xFFFF:
        raise ValueError(f"histogram blob too large: {len(body)} bytes")
    return struct.pack("<H", len(body)) + body


def decode_blob(data: bytes, offset: int = 0
                ) -> Tuple[np.ndarray, Scheme, int]:
    """-> (values f64 [B], scheme, bytes consumed incl. length prefix)."""
    total, = struct.unpack_from("<H", data, offset)
    code, def_len = struct.unpack_from("<BH", data, offset + 2)
    if code == HIST_FORMAT_NULL:
        return np.zeros(0), CustomScheme(()), total + 2
    defn = data[offset + 5:offset + 5 + def_len]
    scheme = _parse_scheme(code, defn)
    payload = data[offset + 5 + def_len:offset + 2 + total]
    B = scheme.num_buckets
    if code in (HIST_FORMAT_GEOMETRIC_XOR, HIST_FORMAT_CUSTOM_XOR):
        values = nibblepack.unpack_f64_xor(payload, B)
    else:
        values = np.cumsum(
            nibblepack.unpack_i64(payload, B)).astype(np.float64)
    return values, scheme, total + 2


def encode_blob_column(mat: np.ndarray, les: np.ndarray) -> bytes:
    """[n, B] histogram samples -> concatenated BinaryHistogram blobs
    (the RecordContainer hist-column wire form)."""
    scheme = detect_scheme(les)
    return b"".join(encode_blob(row, scheme=scheme) for row in
                    np.asarray(mat, np.float64))


def decode_blob_column(data: bytes, n: int
                       ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Concatenated blobs -> ([n, B] f64 matrix, les array)."""
    rows: List[np.ndarray] = []
    scheme: Optional[Scheme] = None
    off = 0
    for _ in range(n):
        values, s, used = decode_blob(data, off)
        off += used
        rows.append(values)
        scheme = scheme or s
    if not rows:
        return np.zeros((0, 0)), None
    B = max(len(r) for r in rows)
    mat = np.zeros((n, B))
    for i, r in enumerate(rows):
        mat[i, :len(r)] = r
    return mat, (scheme.les() if scheme is not None else None)


# ------------------------------------------------- section-based storage

_SECT_HEADER = struct.Struct("<HH")     # (num entries, section byte length)


class AppendableSectHistVector:
    """Appendable histogram column storing NibblePacked blobs in sections
    (ref: HistogramVector.scala:427 AppendableSectDeltaHistVector).

    Section layout: [u16 num_entries, u16 section_bytes, abs blob,
    delta blob, delta blob, ...].  The first histogram of a section is
    absolute; later ones are stored as (hist - section_start) — random
    access inside a section is two unpacks, and a counter DROP (any
    bucket lower than the section start) closes the section and starts a
    new one, exactly the reference's drop-triggered section roll."""

    def __init__(self, les: np.ndarray, section_limit: int = 16):
        self.scheme = detect_scheme(np.asarray(les, np.float64))
        self.section_limit = section_limit
        self._sections: List[bytearray] = []
        self._counts: List[int] = []
        self._section_start: Optional[np.ndarray] = None
        self.num_histograms = 0

    def append(self, values: np.ndarray) -> None:
        values = np.asarray(values, np.float64)
        # roll on: first append, entry cap, counter drop, or the u16
        # section length would overflow (wide custom-bucket XOR blobs)
        start_new = (not self._sections
                     or self._counts[-1] >= self.section_limit
                     or (self._section_start is not None
                         and (values < self._section_start).any())
                     or len(self._sections[-1]) > 0xC000)
        if start_new:
            blob = encode_blob(values, scheme=self.scheme)
            sect = bytearray(_SECT_HEADER.pack(1, len(blob)))
            sect += blob
            self._sections.append(sect)
            self._counts.append(1)
            self._section_start = values
        else:
            delta = values - self._section_start
            blob = encode_blob(delta, scheme=self.scheme)
            sect = self._sections[-1]
            if len(sect) + len(blob) - _SECT_HEADER.size > 0xFFFF:
                # blob would overflow the u16 section length: roll instead
                abs_blob = encode_blob(values, scheme=self.scheme)
                sect = bytearray(_SECT_HEADER.pack(1, len(abs_blob)))
                sect += abs_blob
                self._sections.append(sect)
                self._counts.append(1)
                self._section_start = values
                self.num_histograms += 1
                return
            sect += blob
            self._counts[-1] += 1
            n, _ = _SECT_HEADER.unpack_from(sect, 0)
            _SECT_HEADER.pack_into(sect, 0, n + 1,
                                   len(sect) - _SECT_HEADER.size)
        self.num_histograms += 1

    def to_bytes(self) -> bytes:
        head = struct.pack("<IH", self.num_histograms, len(self._sections))
        return head + b"".join(bytes(s) for s in self._sections)

    @property
    def num_bytes(self) -> int:
        return len(self.to_bytes())

    @staticmethod
    def decode(data: bytes) -> np.ndarray:
        """-> [n, B] absolute cumulative-count matrix."""
        n, num_sections = struct.unpack_from("<IH", data, 0)
        off = struct.calcsize("<IH")
        rows: List[np.ndarray] = []
        for _ in range(num_sections):
            entries, sect_bytes = _SECT_HEADER.unpack_from(data, off)
            off += _SECT_HEADER.size
            end = off + sect_bytes
            start: Optional[np.ndarray] = None
            for i in range(entries):
                values, _, used = decode_blob(data, off)
                off += used
                if i == 0:
                    start = values
                    rows.append(values)
                else:
                    rows.append(start + values)
            off = end
        if not rows:
            return np.zeros((0, 0))
        return np.stack(rows)
