"""HOCON-lite parser: the practical subset of HOCON the reference's config
files use (ref: core/src/main/resources/filodb-defaults.conf,
conf/timeseries-dev-source.conf).

Supported: `key = value` / `key: value`, nested `block { ... }` sections
(block open on its own line), dotted paths (`a.b.c = 1`), `#` and `//`
comments, quoted and bare strings, ints/floats/booleans, `[a, b]` lists of
scalars (one line or multi-line), duration strings (`5 minutes`, `2h`)
exposed as Duration so typed consumers can convert to the unit a field
wants, and later-wins merging of duplicate paths.  Not supported (not used
by our configs): includes, substitutions (`${...}`), concatenation,
single-line inline blocks, and lists of objects — structures needing those
(e.g. spread_assignment) go in a .json config instead.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List


class HoconError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class Duration:
    """A parsed duration; consumers pick the unit (ms/s) they store."""
    millis: float

    @property
    def seconds(self) -> float:
        return self.millis / 1000.0


_DUR_UNITS = {
    "ms": 1.0, "milli": 1.0, "millis": 1.0, "millisecond": 1.0,
    "milliseconds": 1.0,
    "s": 1000.0, "second": 1000.0, "seconds": 1000.0,
    "m": 60_000.0, "minute": 60_000.0, "minutes": 60_000.0,
    "h": 3_600_000.0, "hour": 3_600_000.0, "hours": 3_600_000.0,
    "d": 86_400_000.0, "day": 86_400_000.0, "days": 86_400_000.0,
}

_DUR_RE = re.compile(r"^(\d+(?:\.\d+)?)\s*([a-zA-Z]+)$")


def _strip_comment(line: str) -> str:
    """Remove # / // comments outside quotes."""
    out = []
    in_q = False
    i = 0
    while i < len(line):
        ch = line[i]
        if ch == '"':
            in_q = not in_q
        if not in_q:
            if ch == "#":
                break
            if ch == "/" and line[i:i + 2] == "//":
                break
        out.append(ch)
        i += 1
    return "".join(out)


def _parse_scalar(tok: str) -> Any:
    tok = tok.strip()
    if tok.startswith('"') and tok.endswith('"') and len(tok) >= 2:
        return tok[1:-1]
    low = tok.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "none"):
        return None
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    m = _DUR_RE.match(tok)
    if m and m.group(2).lower() in _DUR_UNITS:
        return Duration(float(m.group(1)) * _DUR_UNITS[m.group(2).lower()])
    return tok                       # bare string


def _parse_list(text: str) -> List[Any]:
    inner = text.strip()[1:-1]
    if not inner.strip():
        return []
    items = []
    depth = 0
    cur = []
    in_q = False
    for ch in inner:
        if ch == '"':
            in_q = not in_q
        if not in_q:
            if ch in "[{":
                depth += 1
            elif ch in "]}":
                depth -= 1
            elif ch == "," and depth == 0:
                items.append("".join(cur))
                cur = []
                continue
        cur.append(ch)
    if "".join(cur).strip():
        items.append("".join(cur))
    return [_parse_scalar(i) for i in items]


def _set_path(root: Dict, path: List[str], value: Any) -> None:
    cur = root
    for p in path[:-1]:
        nxt = cur.get(p)
        if not isinstance(nxt, dict):
            nxt = {}
            cur[p] = nxt
        cur = nxt
    key = path[-1]
    if isinstance(value, dict) and isinstance(cur.get(key), dict):
        _merge(cur[key], value)      # later keys merge into earlier blocks
    else:
        cur[key] = value


def _merge(dst: Dict, src: Dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v


def loads(text: str) -> Dict[str, Any]:
    """Parse HOCON-lite text into a nested dict."""
    root: Dict[str, Any] = {}
    stack: List[Dict[str, Any]] = [root]
    pending_list_key = None
    pending_list_buf: List[str] = []

    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).strip()
        if not line:
            continue
        if pending_list_key is not None:
            pending_list_buf.append(line)
            joined = " ".join(pending_list_buf)
            # bracket-depth check so a ']' inside a nested list does not
            # terminate the outer one
            if joined.count("]") >= joined.count("["):
                _set_path(stack[-1], pending_list_key, _parse_list(joined))
                pending_list_key = None
                pending_list_buf = []
            continue
        if line == "}":
            if len(stack) == 1:
                raise HoconError(f"line {lineno}: unmatched '}}'")
            stack.pop()
            continue
        m = re.match(r'^("?[^"={:\s]+"?(?:\.[^"={:\s]+)*)\s*[:=]?\s*\{\s*$',
                     line)
        if m:
            path = [p.strip('"') for p in m.group(1).split(".")]
            cur = stack[-1]
            for p in path:
                nxt = cur.get(p)
                if not isinstance(nxt, dict):
                    nxt = {}
                    cur[p] = nxt
                cur = nxt
            stack.append(cur)
            continue
        m = re.match(r'^("?[^"={:\s]+"?(?:\.[^"={:\s]+)*)\s*[:=]\s*(.+)$',
                     line)
        if not m:
            raise HoconError(f"line {lineno}: cannot parse {raw!r}")
        path = [p.strip('"') for p in m.group(1).split(".")]
        rhs = m.group(2).strip()
        if rhs.startswith("[") and "]" not in rhs:
            pending_list_key = path
            pending_list_buf = [rhs]
            continue
        if rhs.startswith("["):
            _set_path(stack[-1], path, _parse_list(rhs))
        else:
            _set_path(stack[-1], path, _parse_scalar(rhs))
    if pending_list_key is not None:
        raise HoconError("unterminated list")
    if len(stack) != 1:
        raise HoconError("unterminated block")
    return root


def load(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return loads(f.read())
