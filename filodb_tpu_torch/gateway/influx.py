"""InfluxDB Line Protocol parser → record batches
(port of filodb_tpu/gateway/influx.py).

Re-implements the gateway's wire-format front-end (ref:
gateway/.../conversion/InfluxProtocolParser.scala:66-198,
InfluxRecord.scala:88-260) with the same semantics:

  - `measurement[,tag=v...] field=v[,field=v...] [timestamp_ns]`
  - backslash escapes for comma/space/equals; quoted string field values;
    `123i` integer suffix
  - nanosecond timestamps truncated to ms by dropping the last 6 digits
    (ref: InfluxProtocolParser.parseUnixTime)
  - ONE field → Prom single-value record; the schema is prom-counter when the
    field is named `counter`, else gauge (ref: InfluxPromSingleRecord:88-123)
  - MANY fields → histogram: field keys are bucket `le` tops (`+Inf`/`inf`),
    plus `sum` and `count`; the record is dropped unless a +Inf bucket exists
    (ref: InfluxHistogramRecord + HistogramFieldVisitor:171-252)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.records import RecordBatch, RecordBatchBuilder
from filodb_tpu_torch.core.schemas import Schemas, DEFAULT_SCHEMAS


@dataclasses.dataclass
class InfluxRecord:
    measurement: str
    tags: Dict[str, str]
    fields: Dict[str, object]      # str values stay str; numbers are float
    ts_ms: int


def _split_raw(s: str, delim: str, quoted: bool = False) -> List[str]:
    """Split on unescaped `delim`, KEEPING escape sequences intact — so a
    later split on a different delimiter still sees them escaped (the
    reference's parseInner tracks both delimiters in one pass,
    ref: InfluxProtocolParser.scala parseInner).  quoted=True additionally
    refuses to split inside double-quoted runs (field values)."""
    out, start, i, in_quote = [], 0, 0, False
    while i < len(s):
        ch = s[i]
        if ch == "\\" and i + 1 < len(s):
            i += 2
            continue
        if quoted and ch == '"':
            in_quote = not in_quote
            i += 1
            continue
        if ch == delim and not in_quote:
            out.append(s[start:i])
            start = i + 1
        i += 1
    out.append(s[start:])
    return out


def _parse_ts(ts_str: str) -> Optional[int]:
    """ns-epoch string -> ms, None when malformed (shared by both parse
    paths so validation can't drift between them).  The WHOLE string must
    be digits (one leading '-' allowed): int() alone would silently accept
    garbage in the truncated last-6 characters, '+', or '_' separators."""
    if len(ts_str) <= 6:
        return None
    body = ts_str[1:] if ts_str[0] == "-" else ts_str
    if not (body.isascii() and body.isdigit()):
        return None
    try:
        return int(ts_str[:-6])         # ns → ms: drop last 6 digits
    except ValueError:
        return None


def _unescape(s: str) -> str:
    if "\\" not in s:
        return s
    out, i = [], 0
    while i < len(s):
        if s[i] == "\\" and i + 1 < len(s):
            out.append(s[i + 1])
            i += 2
        else:
            out.append(s[i])
            i += 1
    return "".join(out)


def _split_top(s: str) -> List[str]:
    """Split line into ≤3 space-separated sections, honoring escapes and
    quoted strings."""
    out, cur, i, in_quote = [], [], 0, False
    while i < len(s):
        ch = s[i]
        # escapes are honored inside quotes too (so \" doesn't end the
        # quoted run) — must match _split_raw's escape-before-quote order
        if ch == "\\" and i + 1 < len(s):
            cur.append(s[i: i + 2])
            i += 2
            continue
        if ch == '"':
            in_quote = not in_quote
            cur.append(ch)
            i += 1
            continue
        if ch == " " and not in_quote:
            out.append("".join(cur))
            cur = []
            i += 1
            continue
        cur.append(ch)
        i += 1
    out.append("".join(cur))
    return [p for p in out if p != ""]


def _parse_field_value(v: str):
    if len(v) >= 2 and v[0] == '"' and v[-1] == '"':
        return v[1:-1]
    if not v:
        return ""
    if v.lower() in ("t", "true"):
        return 1.0
    if v.lower() in ("f", "false"):
        return 0.0
    body = v[:-1] if v[-1] in "iu" else v
    try:
        return float(body)
    except ValueError:
        return v


def _parse_fast(line: str, now_ms: Optional[int]) -> Optional[InfluxRecord]:
    """No-escape no-quote fast path: C-speed str.split does all delimiting.
    Correct exactly when the line contains no backslash and no quote —
    ~all real metric traffic; anything else takes the general parser."""
    sections = line.split(" ")
    if len(sections) < 2 or not sections[1]:
        return None
    head = sections[0].split(",")
    measurement = head[0]
    if not measurement:
        return None
    tags: Dict[str, str] = {}
    for kv in head[1:]:
        k, eq, v = kv.partition("=")
        if eq and k and "=" not in v:   # exactly one '=', like the general path
            tags[k] = v
    fields: Dict[str, object] = {}
    for kv in sections[1].split(","):
        k, eq, v = kv.partition("=")
        if eq and k and "=" not in v:
            fields[k] = _parse_field_value(v)
    if not fields:
        return None
    if len(sections) == 3:
        ts_ms = _parse_ts(sections[2])
        if ts_ms is None:
            return None
    else:
        ts_ms = now_ms if now_ms is not None else 0
    return InfluxRecord(measurement, tags, fields, ts_ms)


def parse_influx_line(line: str, now_ms: Optional[int] = None) -> Optional[InfluxRecord]:
    """Parse one line; returns None on malformed input (the reference logs and
    skips, ref: InfluxProtocolParser.parse:127-170)."""
    line = line.strip()
    if not line or line.startswith("#"):
        return None
    if "\\" not in line and '"' not in line and "  " not in line \
            and line.count(" ") <= 2:
        return _parse_fast(line, now_ms)
    sections = _split_top(line)
    if len(sections) < 2:
        return None
    head = _split_raw(sections[0], ",")
    measurement = _unescape(head[0])
    if not measurement:
        return None
    tags: Dict[str, str] = {}
    for kv in head[1:]:
        parts = _split_raw(kv, "=")
        if len(parts) == 2 and parts[0]:
            tags[_unescape(parts[0])] = _unescape(parts[1])
    fields: Dict[str, object] = {}
    for kv in _split_raw(sections[1], ",", quoted=True):
        parts = _split_raw(kv, "=", quoted=True)
        if len(parts) == 2 and parts[0]:
            fields[_unescape(parts[0])] = _parse_field_value(
                _unescape(parts[1]))
    if not fields:
        return None
    if len(sections) >= 3:
        ts_ms = _parse_ts(sections[2])
        if ts_ms is None:
            return None
    else:
        ts_ms = now_ms if now_ms is not None else 0
    return InfluxRecord(measurement, tags, fields, ts_ms)


_SPECIAL_HIST_KEYS = ("sum", "count")


def influx_lines_to_batches(lines: Iterable[str],
                            schemas: Schemas = DEFAULT_SCHEMAS,
                            now_ms: Optional[int] = None,
                            drops: Optional[Dict[str, int]] = None
                            ) -> List[RecordBatch]:
    """Convert parsed lines into per-schema RecordBatches (the gateway's
    InputRecord → RecordBuilder container step, ref: GatewayServer.scala:101-115).

    `drops` (optional dict) is bumped per drop REASON — the per-error
    visibility the reference's InfluxProtocolParser logs per line."""
    builders: Dict[str, RecordBatchBuilder] = {}
    hist_les: Optional[np.ndarray] = None

    def drop(reason: str) -> None:
        if drops is not None:
            drops[reason] = drops.get(reason, 0) + 1

    def builder(schema_name: str) -> RecordBatchBuilder:
        b = builders.get(schema_name)
        if b is None:
            b = RecordBatchBuilder(schemas[schema_name])
            builders[schema_name] = b
        return b

    for line in lines:
        rec = parse_influx_line(line, now_ms)
        if rec is None:
            s = line.strip()
            if s and not s.startswith("#"):
                drop("parse_error")
            continue
        numeric = {k: v for k, v in rec.fields.items() if isinstance(v, float)}
        if not numeric:
            drop("no_numeric_fields")
            continue
        pk = PartKey.make(rec.measurement, rec.tags)
        if len(numeric) == 1:
            (fname, fval), = numeric.items()
            schema_name = "prom-counter" if fname == "counter" else "gauge"
            col = schemas[schema_name].data_columns[0].name
            builder(schema_name).add(pk, rec.ts_ms, **{col: fval})
        else:
            # histogram: bucket tops + sum/count; +Inf required
            buckets: List[Tuple[float, float]] = []
            hsum = hcount = float("nan")
            got_inf = False
            for k, v in numeric.items():
                if k == "sum":
                    hsum = v
                elif k == "count":
                    hcount = v
                else:
                    try:
                        top = (math.inf if k in ("+Inf", "inf", "Inf")
                               else float(k))
                    except ValueError:
                        continue
                    got_inf = got_inf or math.isinf(top)
                    buckets.append((top, v))
            if not got_inf or not buckets:
                drop("histogram_missing_inf_bucket")
                continue
            buckets.sort(key=lambda bv: bv[0])
            les = np.asarray([b[0] for b in buckets])
            vals = np.asarray([b[1] for b in buckets])
            b = builder("prom-histogram")
            if b._les is None:
                b.set_bucket_les(les)
            elif len(b._les) != len(les) or not np.array_equal(b._les, les):
                drop("histogram_scheme_mismatch")
                continue                # one scheme per batch; drop outliers
            b.add(pk, rec.ts_ms, sum=hsum, count=hcount, h=vals)
    return [b.build() for b in builders.values()]
