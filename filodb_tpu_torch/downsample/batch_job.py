"""Batch downsampler job — rolls persisted raw chunks into the downsample
datasets (port of filodb_tpu/downsample/batch_job.py).

ref: spark-jobs/.../downsampler/chunk/DownsamplerMain.scala:14-53 +
BatchDownsampler.scala:399 — a periodic batch job that reads raw chunks
whose userTime falls in the job window, downsamples them with the same
ChunkDownsampler algorithms the streaming path uses, and writes
downsample-keyspace chunks; DSIndexJobMain copies part-key updates.

The job shares `downsample_chunk` with the streaming
ShardDownsampler, and writes through the stock chunk encoder — no Spark:
shards are an embarrassingly parallel loop (the driver can fan them out
over processes or hosts).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.schemas import Schemas, DEFAULT_SCHEMAS
from filodb_tpu_torch.core.store import ColumnStore, PartKeyRecord
from filodb_tpu_torch.downsample.downsamplers import downsample_chunk
from filodb_tpu_torch.downsample.shard_downsampler import DEFAULT_RESOLUTIONS
from filodb_tpu_torch.downsample.store import ds_dataset_name
from filodb_tpu_torch.memory.chunks import decode_chunkset, encode_chunkset


@dataclasses.dataclass
class DownsampleJobStats:
    parts_scanned: int = 0
    chunks_read: int = 0
    records_emitted: int = 0
    chunks_written: int = 0


class DownsamplerJob:
    """One run downsamples `[user_time_start, user_time_end)` for a set of
    shards (ref: DownsamplerMain.run window math — the driver schedules runs
    every N hours with a widened ingestion-time scan)."""

    def __init__(self, raw_store: ColumnStore, ds_store: ColumnStore,
                 dataset: str, schemas: Schemas = DEFAULT_SCHEMAS,
                 resolutions: Sequence[int] = DEFAULT_RESOLUTIONS):
        self.raw_store = raw_store
        self.ds_store = ds_store
        self.dataset = dataset
        self.schemas = schemas
        self.resolutions = tuple(resolutions)

    def run(self, shards: Sequence[int], user_time_start: int,
            user_time_end: int,
            ingestion_window: Optional[Sequence[int]] = None
            ) -> DownsampleJobStats:
        """ingestion_window (lo_ms, hi_ms): when given, chunks are selected
        by INGESTION time via the store's ingestion-time scan — the
        reference's read path, which catches late-arriving data whose user
        time predates the job window by widening the scan backwards (ref:
        DownsamplerMain.scala:64-90 ingestion-time range; the per-sample
        user-time filter below still bounds what is rolled up)."""
        stats = DownsampleJobStats()
        for shard in shards:
            self._run_shard(shard, user_time_start, user_time_end, stats,
                            ingestion_window)
        return stats

    def _downsamplable(self, rec) -> bool:
        schema = self.schemas[rec.schema_name]
        return bool(schema.downsamplers
                    and schema.downsample_schema is not None)

    def _chunks_for(self, shard: int, t0: int, t1: int,
                    ingestion_window: Optional[Sequence[int]]):
        """Yields (PartKeyRecord, [ChunkSet]) for the job window, by user
        time (default, streamed one partition at a time) or by the widened
        ingestion-time scan.  The schema downsampler gate applies BEFORE
        any chunk read, so non-downsamplable partitions cost nothing."""
        pk_records = self.raw_store.read_part_keys(self.dataset, shard)
        if ingestion_window is None:
            for rec in pk_records:
                if (self._downsamplable(rec) and rec.start_time_ms < t1
                        and rec.end_time_ms >= t0):
                    yield rec, self.raw_store.read_chunks(
                        self.dataset, shard, rec.part_key, t0, t1 - 1)
            return
        by_pk = {rec.part_key.to_bytes(): rec for rec in pk_records
                 if self._downsamplable(rec)}
        grouped: Dict[bytes, list] = {}
        lo, hi = int(ingestion_window[0]), int(ingestion_window[1])
        for pk, _schema_name, cs in \
                self.raw_store.scan_chunks_by_ingestion_time(
                    self.dataset, shard, lo, hi):
            b = pk.to_bytes()
            if b in by_pk and cs.info.start_time_ms < t1 \
                    and cs.info.end_time_ms >= t0:
                grouped.setdefault(b, []).append(cs)
        for b, chunks in grouped.items():
            yield by_pk[b], chunks

    def _run_shard(self, shard: int, t0: int, t1: int,
                   stats: DownsampleJobStats,
                   ingestion_window: Optional[Sequence[int]] = None) -> None:
        now = int(time.time() * 1000)
        ds_pk_updates: Dict[int, List[PartKeyRecord]] = {
            r: [] for r in self.resolutions}
        for rec, chunks in self._chunks_for(shard, t0, t1, ingestion_window):
            schema = self.schemas[rec.schema_name]
            stats.parts_scanned += 1
            per_res: Dict[int, Dict[str, List[np.ndarray]]] = {}
            for cs in chunks:
                stats.chunks_read += 1
                decoded = decode_chunkset(cs)
                ts = decoded.pop("timestamp")
                keep = (ts >= t0) & (ts < t1)
                if not keep.all():
                    ts = ts[keep]
                    decoded = {k: v[keep] for k, v in decoded.items()}
                if len(ts) == 0:
                    continue
                for res in self.resolutions:
                    out_ts, out_cols = downsample_chunk(schema, ts, decoded,
                                                        res)
                    if len(out_ts) == 0:
                        continue
                    acc = per_res.setdefault(res, {"timestamp": []})
                    acc["timestamp"].append(out_ts)
                    for name, vals in out_cols.items():
                        acc.setdefault(name, []).append(vals)
                    stats.records_emitted += len(out_ts)
            scheme = chunks[-1].bucket_scheme if chunks else None
            for res, acc in per_res.items():
                out_ts = np.concatenate(acc.pop("timestamp"))
                order = np.argsort(out_ts, kind="stable")
                cols = {k: np.concatenate(v)[order] for k, v in acc.items()}
                target = self.schemas[schema.downsample_schema]
                col_types = {c.name: c.col_type for c in target.data_columns}
                chunkset = encode_chunkset(out_ts[order], cols, col_types,
                                           now, scheme)
                ds_name = ds_dataset_name(self.dataset, res)
                self.ds_store.write_chunks(ds_name, shard, rec.part_key,
                                           [chunkset], target.name)
                stats.chunks_written += 1
                ds_pk_updates[res].append(PartKeyRecord(
                    rec.part_key, target.name, rec.start_time_ms,
                    rec.end_time_ms))
        # DSIndexJob half: publish part-key liveness to the ds keyspace
        # (ref: spark-jobs/.../index/DSIndexJobMain.scala)
        for res, recs in ds_pk_updates.items():
            if recs:
                self.ds_store.write_part_keys(ds_dataset_name(self.dataset, res),
                                              shard, recs)
