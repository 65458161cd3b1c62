"""Ruler — recording & alerting rules engine (port of filodb_tpu/rules/;
doc/recording_rules.md).

Standing queries with Prometheus semantics: rule groups evaluated on an
interval through the QueryFrontend, recording-rule outputs written back
through the columnar ingest path, alert rules driven through the
inactive -> pending -> firing -> keep_firing_for state machine with
`ALERTS`/`ALERTS_FOR_STATE` write-back so state survives restart by
replay (ref: Cortex's ruler; Monarch's standing queries, VLDB'20).
"""
from filodb_tpu_torch.rules.config import (Rule, RuleGroup, RulesConfigError,
                                           load_rule_groups)
from filodb_tpu_torch.rules.notifier import WebhookNotifier
from filodb_tpu_torch.rules.ruler import MemstoreSink, Ruler

__all__ = ["Rule", "RuleGroup", "RulesConfigError", "load_rule_groups",
           "Ruler", "MemstoreSink", "WebhookNotifier"]
