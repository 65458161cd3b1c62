"""Rule-group configuration: loading + validation (port of
filodb_tpu/rules/config.py).

Two sources, merged (group names must be unique across both):

  * the conf tree's `rules.groups` block — dict-shaped, because
    HOCON-lite has no object lists (see conf/example-filodb.conf)
  * a standalone rules file (`rules.file`) — a .json in the Prometheus
    rule-file shape ({"groups": [{"name", "interval", "rules": [...]}]})
    or a HOCON-lite .conf mirroring the inline dict shape

Every rule's `expr` is validated through the real PromQL parser at load
time (a typo'd standing query must fail the reload/boot loudly, not
silently evaluate to errors every interval), record/alert names against
the Prometheus metric-name grammar, and durations accept numbers
(seconds), duration strings ("30s", "1h30m") or HOCON-lite Durations.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Dict, List, Optional, Tuple

_METRIC_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class RulesConfigError(ValueError):
    """Invalid rules config — carries the full group/rule path."""


@dataclasses.dataclass(frozen=True)
class Rule:
    """One recording or alerting rule (Prometheus rule-file semantics)."""
    name: str                     # record metric name / alertname
    expr: str
    kind: str                     # "recording" | "alerting"
    labels: Tuple[Tuple[str, str], ...] = ()
    annotations: Tuple[Tuple[str, str], ...] = ()
    for_s: float = 0.0            # alerting: pending -> firing hold
    keep_firing_for_s: float = 0.0

    @property
    def labels_dict(self) -> Dict[str, str]:
        return dict(self.labels)

    @property
    def annotations_dict(self) -> Dict[str, str]:
        return dict(self.annotations)

    def identity(self) -> Tuple:
        """What must match for runtime state (alert instances, health) to
        carry across a hot reload — the Prometheus stance: same name +
        same expr + same timing semantics is the same rule."""
        return (self.kind, self.name, self.expr, self.labels,
                self.for_s, self.keep_firing_for_s)


@dataclasses.dataclass(frozen=True)
class RuleGroup:
    """Ordered rules sharing one evaluation interval.  Rules evaluate
    SEQUENTIALLY within the group — later rules see earlier rules'
    freshly-recorded output at the same evaluation timestamp."""
    name: str
    interval_s: float
    rules: Tuple[Rule, ...]
    source: str = "conf"          # "conf" or the rules-file path


def _duration_s(value, where: str) -> float:
    """Seconds from a number, a duration string, or a HOCON-lite
    Duration."""
    from filodb_tpu_torch.utils.hoconlite import Duration
    if isinstance(value, Duration):
        return float(value.seconds)
    if isinstance(value, bool):
        raise RulesConfigError(f"{where}: expected a duration, got {value!r}")
    if isinstance(value, (int, float)):
        return float(value)
    if isinstance(value, str):
        from filodb_tpu_torch.promql.lexer import duration_to_ms
        try:
            return duration_to_ms(value) / 1000.0
        except ValueError:
            raise RulesConfigError(
                f"{where}: not a duration: {value!r}") from None
    raise RulesConfigError(f"{where}: expected a duration, got {value!r}")


def _str_map(raw, where: str) -> Tuple[Tuple[str, str], ...]:
    if raw is None:
        return ()
    if not isinstance(raw, dict):
        raise RulesConfigError(f"{where}: expected a map, got {raw!r}")
    out = []
    for k, v in raw.items():
        if not _LABEL_RE.match(str(k)):
            raise RulesConfigError(f"{where}: bad label name {k!r}")
        out.append((str(k), str(v)))
    return tuple(sorted(out))


def _validate_expr(expr: str, where: str) -> str:
    """The standing query must parse through the REAL PromQL parser —
    the same grammar the serving path enforces per request."""
    if not isinstance(expr, str) or not expr.strip():
        raise RulesConfigError(f"{where}: missing expr")
    from filodb_tpu_torch.promql.parser import parse_query
    try:
        parse_query(expr)
    except Exception as e:  # noqa: BLE001 — parser raises its own types
        raise RulesConfigError(f"{where}: bad expr: {e}") from None
    return expr


def _build_rule(raw: dict, where: str) -> Rule:
    if not isinstance(raw, dict):
        raise RulesConfigError(f"{where}: expected a rule object")
    raw = dict(raw)
    record = raw.pop("record", None)
    alert = raw.pop("alert", None)
    if (record is None) == (alert is None):
        raise RulesConfigError(
            f"{where}: exactly one of 'record' or 'alert' is required")
    expr = _validate_expr(raw.pop("expr", ""), where)
    labels = _str_map(raw.pop("labels", None), f"{where}.labels")
    annotations = _str_map(raw.pop("annotations", None),
                           f"{where}.annotations")
    for_s = _duration_s(raw.pop("for", 0.0), f"{where}.for")
    keep_s = _duration_s(raw.pop("keep_firing_for", 0.0),
                         f"{where}.keep_firing_for")
    if raw:
        raise RulesConfigError(
            f"{where}: unknown rule keys {sorted(raw)}")
    if record is not None:
        if not _METRIC_RE.match(str(record)):
            raise RulesConfigError(
                f"{where}: bad record metric name {record!r}")
        if for_s or keep_s:
            raise RulesConfigError(
                f"{where}: 'for'/'keep_firing_for' are alerting-only")
        if annotations:
            raise RulesConfigError(
                f"{where}: 'annotations' are alerting-only")
        return Rule(str(record), expr, "recording", labels)
    if not _METRIC_RE.match(str(alert)):
        raise RulesConfigError(f"{where}: bad alert name {alert!r}")
    return Rule(str(alert), expr, "alerting", labels, annotations,
                for_s, keep_s)


def _build_group(name: str, raw: dict, default_interval_s: float,
                 source: str) -> RuleGroup:
    where = f"rules group {name!r}"
    if not isinstance(raw, dict):
        raise RulesConfigError(f"{where}: expected a group object")
    raw = dict(raw)
    interval = _duration_s(raw.pop("interval", default_interval_s),
                           f"{where}.interval")
    if interval <= 0:
        raise RulesConfigError(f"{where}: interval must be positive")
    rules_raw = raw.pop("rules", None)
    if raw:
        raise RulesConfigError(f"{where}: unknown group keys {sorted(raw)}")
    rules: List[Rule] = []
    if isinstance(rules_raw, dict):
        # conf-tree shape: rule entries keyed by a local name; dict
        # insertion order IS the (Prometheus-semantic) evaluation order
        for rname, rraw in rules_raw.items():
            rules.append(_build_rule(rraw, f"{where}.rules.{rname}"))
    elif isinstance(rules_raw, list):
        for i, rraw in enumerate(rules_raw):
            rules.append(_build_rule(rraw, f"{where}.rules[{i}]"))
    elif rules_raw is not None:
        raise RulesConfigError(f"{where}: 'rules' must be a list or map")
    if not rules:
        raise RulesConfigError(f"{where}: no rules")
    return RuleGroup(name, interval, tuple(rules), source)


def _load_rules_file(path: str) -> Dict[str, Any]:
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    from filodb_tpu_torch.utils import hoconlite
    raw = hoconlite.load(path)
    # allow the same top-level wrapper the main config accepts
    if set(raw) == {"rules"}:
        raw = raw["rules"]
    return raw


def load_rule_groups(rules_cfg) -> List[RuleGroup]:
    """All configured groups: the conf tree's inline `groups` block plus
    the standalone rules file, validated.  Group names must be unique
    across the two sources (a silent later-wins merge would make half a
    team's rules disappear)."""
    default_s = float(rules_cfg.default_interval_s)
    groups: List[RuleGroup] = []
    seen: Dict[str, str] = {}

    def add(g: RuleGroup) -> None:
        if g.name in seen:
            raise RulesConfigError(
                f"rules group {g.name!r} defined twice "
                f"({seen[g.name]} and {g.source})")
        seen[g.name] = g.source
        groups.append(g)

    inline = rules_cfg.groups or {}
    if not isinstance(inline, dict):
        raise RulesConfigError("rules.groups must be a map of groups")
    for name, raw in inline.items():
        add(_build_group(str(name), raw, default_s, "conf"))
    if rules_cfg.file:
        try:
            raw = _load_rules_file(rules_cfg.file)
        except OSError as e:
            raise RulesConfigError(
                f"rules file {rules_cfg.file!r}: {e}") from None
        except (ValueError, KeyError) as e:
            raise RulesConfigError(
                f"rules file {rules_cfg.file!r}: {e}") from None
        glist = raw.get("groups") if isinstance(raw, dict) else None
        if isinstance(glist, dict):
            for name, graw in glist.items():
                add(_build_group(str(name), graw, default_s,
                                 rules_cfg.file))
        elif isinstance(glist, list):
            for i, graw in enumerate(glist):
                if not isinstance(graw, dict) or "name" not in graw:
                    raise RulesConfigError(
                        f"rules file {rules_cfg.file!r}: groups[{i}] "
                        "needs a 'name'")
                graw = dict(graw)
                name = str(graw.pop("name"))
                add(_build_group(name, graw, default_s, rules_cfg.file))
        else:
            raise RulesConfigError(
                f"rules file {rules_cfg.file!r}: expected a top-level "
                "'groups' list or map")
    return groups
