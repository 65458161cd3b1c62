"""Prometheus remote read/write protobuf messages, hand-coded wire format
(port of filodb_tpu/http/remotepb.py).

Implements exactly the prompb subset the remote-read AND remote-write
endpoints need (ref: prometheus/src/main/java/remote/RemoteStorage.java —
ReadRequest / ReadResponse and friends; http/.../PrometheusApiRoute.scala:
37-62 drives remote-read; the write half is the Cortex / Thanos-receive
front-door contract).  The wire format is standard protobuf encoding
(varint keys, length-delimited submessages); coding it directly keeps the
dependency surface at zero and the schema auditable in one file.

Message numbering matches prompb/remote.proto + prompb/types.proto:

  ReadRequest  { repeated Query queries = 1; }
  Query        { int64 start_timestamp_ms = 1; int64 end_timestamp_ms = 2;
                 repeated LabelMatcher matchers = 3; }
  LabelMatcher { enum Type { EQ=0; NEQ=1; RE=2; NRE=3; } Type type = 1;
                 string name = 2; string value = 3; }
  ReadResponse { repeated QueryResult results = 1; }
  QueryResult  { repeated TimeSeries timeseries = 1; }
  WriteRequest { repeated TimeSeries timeseries = 1; }
  TimeSeries   { repeated Label labels = 1; repeated Sample samples = 2; }
  Label        { string name = 1; string value = 2; }
  Sample       { double value = 1; int64 timestamp = 2; }

Label / Sample / TimeSeries appear on BOTH directions of BOTH protocols
(read responses carry them out, write requests carry them in), so their
encoders/decoders live in one codec table (CODECS) that the request/
response-level functions compose — one wire implementation per message,
never a read-side and a write-side copy drifting apart (see
tests/test_remote_write.py::test_codec_table_parity for the enforced
encode/decode parity against hand-built wire fixtures).
"""
from __future__ import annotations

import dataclasses
import struct
from typing import List, Tuple

EQ, NEQ, RE, NRE = 0, 1, 2, 3


@dataclasses.dataclass
class LabelMatcher:
    type: int
    name: str
    value: str


@dataclasses.dataclass
class PromQuery:
    start_timestamp_ms: int
    end_timestamp_ms: int
    matchers: List[LabelMatcher]


@dataclasses.dataclass
class PromTimeSeries:
    labels: List[Tuple[str, str]]
    samples: List[Tuple[float, int]]        # (value, timestamp_ms)


# ------------------------------------------------------------ primitives

from filodb_tpu_torch.utils.varint import (read_uvarint as _read_uvarint,  # noqa: E402
                                     write_uvarint as _uvarint)


def _varint64(n: int) -> bytes:
    """int64 as protobuf varint (negatives use 64-bit two's complement)."""
    return _uvarint(n & 0xFFFFFFFFFFFFFFFF)


def _to_int64(u: int) -> int:
    return u - (1 << 64) if u >= (1 << 63) else u


def _key(field: int, wire: int) -> bytes:
    return _uvarint((field << 3) | wire)


def _ld(field: int, payload: bytes) -> bytes:
    """Length-delimited field."""
    return _key(field, 2) + _uvarint(len(payload)) + payload


def _fields(data: bytes):
    """Iterate (field_num, wire_type, value) over a message.  Raises
    ValueError on truncation: a length-delimited field promising bytes
    past the end must fail decode loudly (a real protobuf parser's
    behavior), never yield a silently-shortened value."""
    pos = 0
    n = len(data)
    while pos < n:
        k, pos = _read_uvarint(data, pos)
        field, wire = k >> 3, k & 0x07
        if wire == 0:
            v, pos = _read_uvarint(data, pos)
        elif wire == 1:
            if pos + 8 > n:
                raise ValueError("truncated fixed64 field")
            v = data[pos:pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = _read_uvarint(data, pos)
            if pos + ln > n:
                raise ValueError("truncated length-delimited field")
            v = data[pos:pos + ln]
            pos += ln
        elif wire == 5:
            if pos + 4 > n:
                raise ValueError("truncated fixed32 field")
            v = data[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, v


# ------------------------------------------------- shared message codecs
#
# Each codec is an (encode, decode) pair over the Python-native shape the
# rest of the codebase consumes: Label <-> (name, value), Sample <->
# (value, ts_ms), TimeSeries <-> PromTimeSeries.  Both the read and the
# write protocol compose exclusively these for the shared messages.

def encode_label(pair: Tuple[str, str]) -> bytes:
    name, value = pair
    return _ld(1, name.encode("utf-8")) + _ld(2, value.encode("utf-8"))


def decode_label(data: bytes) -> Tuple[str, str]:
    name, value = "", ""
    for field, wire, v in _fields(data):
        if field == 1 and wire == 2:
            name = v.decode("utf-8")
        elif field == 2 and wire == 2:
            value = v.decode("utf-8")
    return name, value


def encode_sample(sample: Tuple[float, int]) -> bytes:
    value, ts = sample
    return _key(1, 1) + struct.pack("<d", value) + _key(2, 0) + _varint64(ts)


def decode_sample(data: bytes) -> Tuple[float, int]:
    value, ts = 0.0, 0
    for field, wire, v in _fields(data):
        if field == 1 and wire == 1:
            value = struct.unpack("<d", v)[0]
        elif field == 2 and wire == 0:
            ts = _to_int64(v)
    return value, ts


def encode_timeseries(ts: PromTimeSeries) -> bytes:
    body = bytearray()
    for pair in ts.labels:
        body += _ld(1, encode_label(pair))
    for sample in ts.samples:
        body += _ld(2, encode_sample(sample))
    return bytes(body)


def decode_timeseries(data: bytes) -> PromTimeSeries:
    labels, samples = [], []
    for field, wire, v in _fields(data):
        if field == 1 and wire == 2:
            labels.append(decode_label(v))
        elif field == 2 and wire == 2:
            samples.append(decode_sample(v))
    return PromTimeSeries(labels, samples)


# the one codec table shared by remote-read and remote-write: message
# name -> (encode, decode).  Request/response functions below never
# hand-roll these messages.
CODECS = {
    "Label": (encode_label, decode_label),
    "Sample": (encode_sample, decode_sample),
    "TimeSeries": (encode_timeseries, decode_timeseries),
}


# -------------------------------------------------- remote-read messages

def _decode_matcher(data: bytes) -> LabelMatcher:
    t, name, value = EQ, "", ""
    for field, wire, v in _fields(data):
        if field == 1 and wire == 0:
            t = int(v)
        elif field == 2 and wire == 2:
            name = v.decode("utf-8")
        elif field == 3 and wire == 2:
            value = v.decode("utf-8")
    return LabelMatcher(t, name, value)


def _decode_query(data: bytes) -> PromQuery:
    start, end, matchers = 0, 0, []
    for field, wire, v in _fields(data):
        if field == 1 and wire == 0:
            start = _to_int64(v)
        elif field == 2 and wire == 0:
            end = _to_int64(v)
        elif field == 3 and wire == 2:
            matchers.append(_decode_matcher(v))
    return PromQuery(start, end, matchers)


def decode_read_request(data: bytes) -> List[PromQuery]:
    queries = []
    for field, wire, v in _fields(data):
        if field == 1 and wire == 2:
            queries.append(_decode_query(v))
    return queries


def decode_read_response(data: bytes) -> List[List[PromTimeSeries]]:
    results = []
    for field, wire, v in _fields(data):
        if field == 1 and wire == 2:
            series = []
            for f2, w2, v2 in _fields(v):
                if f2 == 1 and w2 == 2:
                    series.append(decode_timeseries(v2))
            results.append(series)
    return results


def encode_read_request(queries: List[PromQuery]) -> bytes:
    out = bytearray()
    for q in queries:
        body = bytearray()
        body += _key(1, 0) + _varint64(q.start_timestamp_ms)
        body += _key(2, 0) + _varint64(q.end_timestamp_ms)
        for m in q.matchers:
            mb = bytearray()
            if m.type:
                mb += _key(1, 0) + _uvarint(m.type)
            mb += _ld(2, m.name.encode("utf-8"))
            mb += _ld(3, m.value.encode("utf-8"))
            body += _ld(3, bytes(mb))
        out += _ld(1, bytes(body))
    return bytes(out)


def encode_read_response(results: List[List[PromTimeSeries]]) -> bytes:
    out = bytearray()
    for series_list in results:
        qr = bytearray()
        for ts in series_list:
            qr += _ld(1, encode_timeseries(ts))
        out += _ld(1, bytes(qr))
    return bytes(out)


# ------------------------------------------------- remote-write messages

def decode_write_request(data: bytes) -> List[PromTimeSeries]:
    """WriteRequest { repeated TimeSeries timeseries = 1; } — the body a
    Prometheus/Grafana-agent/Cortex-shaped client POSTs (after snappy
    decompression) to /api/v1/write.  Unknown fields (metadata = 3,
    exemplars inside TimeSeries) are skipped per proto3 semantics."""
    series = []
    for field, wire, v in _fields(data):
        if field == 1 and wire == 2:
            series.append(decode_timeseries(v))
    return series


def encode_write_request(series: List[PromTimeSeries]) -> bytes:
    out = bytearray()
    for ts in series:
        out += _ld(1, encode_timeseries(ts))
    return bytes(out)
