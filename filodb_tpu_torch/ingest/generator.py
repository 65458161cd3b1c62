"""Deterministic synthetic time-series generators
(port of filodb_tpu/ingest/generator.py).

The moral port of the reference's TestTimeseriesProducer / MachineMetricsData
(ref: gateway/src/main/scala/filodb/timeseries/TestTimeseriesProducer.scala:188,
core/src/test/.../MachineMetricsData) — shared by unit tests, stress apps and
benchmarks so perf runs and correctness runs see identical data shapes.
Produces the Prom-schema series the jmh harnesses use: `heap_usage{...}` gauges,
request counters, and native-histogram series, tagged with _ws_/_ns_ shard keys.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np

from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.records import RecordBatch, RecordBatchBuilder
from filodb_tpu_torch.core.schemas import GAUGE, PROM_COUNTER, PROM_HISTOGRAM


def gauge_part_keys(num_series: int, metric: str = "heap_usage",
                    ws: str = "demo", num_apps: int = 10) -> List[PartKey]:
    """Series identities like TestTimeseriesProducer: 10 apps x N instances,
    _ns_ = 'App-<n>'."""
    keys = []
    for i in range(num_series):
        keys.append(PartKey.make(metric, {
            "_ws_": ws,
            "_ns_": f"App-{i % num_apps}",
            "instance": f"Instance-{i}",
            "dc": f"DC{i % 2}",
        }))
    return keys


def gauge_batch(num_series: int, num_samples: int,
                start_ms: int = 1_600_000_000_000, step_ms: int = 10_000,
                metric: str = "heap_usage", seed: int = 42,
                num_apps: int = 10) -> RecordBatch:
    """Sinusoid-ish gauge data, columnar (one batch = all samples)."""
    rng = np.random.default_rng(seed)
    keys = gauge_part_keys(num_series, metric, num_apps=num_apps)
    n = num_series * num_samples
    part_idx = np.repeat(np.arange(num_series, dtype=np.int32), num_samples)
    ts = np.tile(start_ms + np.arange(num_samples, dtype=np.int64) * step_ms,
                 num_series)
    phase = rng.uniform(0, 2 * np.pi, size=num_series)
    t = np.tile(np.arange(num_samples), num_series)
    values = (100.0 + 50.0 * np.sin(t / 20.0 + np.repeat(phase, num_samples))
              + rng.normal(0, 2.0, size=n))
    return RecordBatch(GAUGE, keys, part_idx, ts, {"value": values})


def counter_batch(num_series: int, num_samples: int,
                  start_ms: int = 1_600_000_000_000, step_ms: int = 10_000,
                  metric: str = "request_total", seed: int = 7,
                  resets: bool = True, num_apps: int = 10) -> RecordBatch:
    """Monotonic counters with occasional resets (counter dips) so counter
    correction paths are exercised."""
    rng = np.random.default_rng(seed)
    keys = gauge_part_keys(num_series, metric, num_apps=num_apps)
    part_idx = np.repeat(np.arange(num_series, dtype=np.int32), num_samples)
    ts = np.tile(start_ms + np.arange(num_samples, dtype=np.int64) * step_ms,
                 num_series)
    incr = rng.exponential(10.0, size=(num_series, num_samples))
    vals = np.cumsum(incr, axis=1)
    if resets and num_samples > 10:
        # each series resets to ~0 at one random point
        reset_at = rng.integers(num_samples // 2, num_samples, size=num_series)
        for s in range(num_series):
            r = reset_at[s]
            vals[s, r:] = np.cumsum(incr[s, r:], axis=0)
    return RecordBatch(PROM_COUNTER, keys, part_idx, ts,
                       {"count": vals.ravel()})


def histogram_batch(num_series: int, num_samples: int, num_buckets: int = 8,
                    start_ms: int = 1_600_000_000_000, step_ms: int = 10_000,
                    metric: str = "http_latency", seed: int = 11) -> RecordBatch:
    """Native-histogram series: cumulative increasing bucket counts, plus
    sum/count columns (prom-histogram schema)."""
    rng = np.random.default_rng(seed)
    keys = gauge_part_keys(num_series, metric)
    part_idx = np.repeat(np.arange(num_series, dtype=np.int32), num_samples)
    ts = np.tile(start_ms + np.arange(num_samples, dtype=np.int64) * step_ms,
                 num_series)
    n = num_series * num_samples
    # per-step per-bucket increments, cumulative over time and buckets
    inc = rng.poisson(3.0, size=(num_series, num_samples, num_buckets))
    per_bucket_cum = np.cumsum(inc, axis=1)           # cumulative over time
    hist = np.cumsum(per_bucket_cum, axis=2)          # cumulative over buckets
    count = hist[:, :, -1].astype(np.float64)
    total_sum = count * rng.uniform(5.0, 15.0)
    les = [2.0 * (2.0 ** i) for i in range(num_buckets)]
    return RecordBatch(PROM_HISTOGRAM, keys, part_idx, ts,
                       {"sum": total_sum.ravel(), "count": count.ravel(),
                        "h": hist.reshape(n, num_buckets).astype(np.float64)},
                       bucket_les=np.asarray(les))


def region_gauge_batch(num_series: int, num_samples: int,
                       region: str = "east",
                       start_ms: int = 1_600_000_000_000,
                       step_ms: int = 10_000, metric: str = "fed_gauge",
                       seed: int = 0, num_apps: int = 3) -> RecordBatch:
    """Integer-valued gauges tagged with a `region` ownership label —
    the federation fixture's data shape (parallel/testcluster.py
    make_federated_pair).  Integer values make cross-cluster merges
    bit-comparable against a single-store ground truth: sum/count/avg
    over exact integers carry no float-ordering noise."""
    rng = np.random.default_rng(seed)
    keys = [PartKey.make(metric, {
        "_ws_": "demo",
        "_ns_": f"App-{i % num_apps}",
        "region": region,
        "instance": f"{region}-{i}",
    }) for i in range(num_series)]
    part_idx = np.repeat(np.arange(num_series, dtype=np.int32), num_samples)
    ts = np.tile(start_ms + np.arange(num_samples, dtype=np.int64) * step_ms,
                 num_series)
    values = rng.integers(1, 64,
                          size=num_series * num_samples).astype(np.float64)
    return RecordBatch(GAUGE, keys, part_idx, ts, {"value": values})


def batch_stream(batch: RecordBatch, samples_per_chunk: int,
                 base_offset: int = 0) -> Iterator[Tuple[RecordBatch, int]]:
    """Split a big columnar batch into a stream of (smaller batch, offset) —
    the Kafka-container stream shape used by recovery tests."""
    num_series = len(batch.part_keys)
    num_samples = batch.num_records // max(num_series, 1)
    mat_idx = np.arange(batch.num_records).reshape(num_series, num_samples)
    for c, lo in enumerate(range(0, num_samples, samples_per_chunk)):
        hi = min(lo + samples_per_chunk, num_samples)
        sel = mat_idx[:, lo:hi].ravel()
        yield RecordBatch(
            batch.schema, batch.part_keys, batch.part_idx[sel],
            batch.timestamps[sel],
            {k: v[sel] for k, v in batch.columns.items()},
            batch.bucket_les), base_offset + c
