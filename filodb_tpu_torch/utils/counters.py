"""Named integer counters, read and written by the port's query and ingest
paths and its tests.

A thin view over the metrics registry (utils/metrics.py): `inc(name)`
increments the untagged registry counter `name`, so /metrics exposes each
of these as `<name>_total` beside the registry's other families, under
one name only.  Tests read a counter before and after a query and
compare.
"""
from __future__ import annotations

from filodb_tpu_torch.utils.metrics import registry


class Counters:
    def inc(self, name: str, n: int = 1) -> None:
        registry.counter(name).increment(n)

    def get(self, name: str) -> int:
        return int(registry.counter(name).value)


counters = Counters()
