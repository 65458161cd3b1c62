"""TimeSeriesMemStore — per-node map of dataset -> shards (port of
filodb_tpu/core/memstore.py: setup, lookup, ingest, the ingest stream
with interleaved group flushes, flush_all, shard_map, drop_shard and the
recovery entry points `recover_index` and `recover_stream`).

Takes ``device=`` (default ``"cuda"``) and raises without a card unless
given ``device="cpu"``; every shard's DeviceMirror lives there.  A store
on a card registers it with the device telemetry when it is constructed,
so /admin/devices lists it before the first dispatch.  Shards
persist flushed chunks to ``column_store`` and group checkpoints to
``meta_store`` (by default a NullColumnStore and an InMemoryMetaStore,
as in the reference).  Schemas come from ``schemas=``, else from the
config's ``schemas`` block, else the built-in ``DEFAULT_SCHEMAS``; the
config (the ``settings()`` singleton unless one is given) is handed to
every shard, which reads its store and tenant settings from it.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from filodb_tpu_torch.config import settings as default_settings
from filodb_tpu_torch.core.records import RecordBatch
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, Schemas
from filodb_tpu_torch.core.shard import TimeSeriesShard
from filodb_tpu_torch.core.store import (ColumnStore, InMemoryMetaStore,
                                         MetaStore, NullColumnStore)
from filodb_tpu_torch.utils.device import resolve_device


class TimeSeriesMemStore:

    def __init__(self, schemas: Optional[Schemas] = None,
                 column_store: Optional[ColumnStore] = None,
                 meta_store: Optional[MetaStore] = None, device="cuda",
                 config=None):
        self.device = resolve_device(device)
        self.config = config or default_settings()
        # explicit schemas, then the config's schemas block, then the
        # built-ins: servers and cluster nodes pick up the config's block
        self.schemas = (schemas if schemas is not None
                        else (self.config.schemas or DEFAULT_SCHEMAS))
        self.column_store = column_store or NullColumnStore()
        self.meta_store = meta_store or InMemoryMetaStore()
        self._shards: Dict[str, Dict[int, TimeSeriesShard]] = {}
        if self.device.type == "cuda":
            from filodb_tpu_torch.utils.devicetelem import telem
            telem.register_devices([self.device])

    def setup(self, dataset: str, shard_num: int) -> TimeSeriesShard:
        shards = self._shards.setdefault(dataset, {})
        if shard_num in shards:
            return shards[shard_num]
        shard = TimeSeriesShard(dataset, shard_num, self.schemas,
                                device=self.device,
                                column_store=self.column_store,
                                meta_store=self.meta_store,
                                config=self.config)
        shards[shard_num] = shard
        return shard

    def get_shard(self, dataset: str,
                  shard_num: int) -> Optional[TimeSeriesShard]:
        return self._shards.get(dataset, {}).get(shard_num)

    def _shard(self, dataset: str, shard_num: int) -> TimeSeriesShard:
        shard = self.get_shard(dataset, shard_num)
        if shard is None:
            raise KeyError(f"shard {shard_num} of {dataset} not set up")
        return shard

    def shards_for(self, dataset: str) -> List[TimeSeriesShard]:
        return list(self._shards.get(dataset, {}).values())

    def shard_map(self) -> Dict[str, List[int]]:
        """dataset -> sorted shard numbers held locally."""
        return {ds: sorted(sh) for ds, sh in self._shards.items()}

    def drop_shard(self, dataset: str, shard_num: int) -> bool:
        """Tombstone a local shard copy (live-handoff completion,
        replication/handoff.py): the in-memory working set is released;
        persisted chunks stay in the column store for the new owner.  Its
        device memory comes back here, not when the last reference to the
        shard goes: each store's mirror drops its snapshot and `hot`
        booking, and the fused caches drop the padded copies keyed by
        that mirror (a query in flight keeps what it already holds until
        it ends)."""
        shards = self._shards.get(dataset)
        if shards is None or shard_num not in shards:
            return False
        shard = shards.pop(shard_num)
        from filodb_tpu_torch.query.execbase import release_mirror_caches
        for store in shard.stores.values():
            mirror = getattr(store, "device_mirror", None)
            if mirror is not None:
                mirror.release()
                release_mirror_caches(mirror.serial)
        return True

    def ingest(self, dataset: str, shard_num: int, batch: RecordBatch,
               offset: int = -1) -> int:
        return self._shard(dataset, shard_num).ingest(batch, offset)

    def ingest_columns(self, dataset: str, shard_num: int, schema_name: str,
                       part_keys, ts, columns, offset: int = -1,
                       bucket_les=None) -> int:
        """Columnar grid ingest (see TimeSeriesShard.ingest_columns)."""
        return self._shard(dataset, shard_num).ingest_columns(
            schema_name, part_keys, ts, columns, offset, bucket_les)

    def ingest_stream(self, dataset: str, shard_num: int,
                      stream: Iterable[Tuple[RecordBatch, int]],
                      flush_every: int = 0) -> int:
        """Consume a stream of (batch, offset), flushing one group round
        robin every `flush_every` batches."""
        shard = self._shard(dataset, shard_num)
        total = 0
        group = 0
        for i, (batch, offset) in enumerate(stream):
            total += shard.ingest(batch, offset)
            if flush_every and (i + 1) % flush_every == 0:
                shard.flush_group(group % shard._groups)
                group += 1
        return total

    def recover_index(self, dataset: str, shard_num: int) -> int:
        return self.setup(dataset, shard_num).recover_index()

    def recover_stream(self, dataset: str, shard_num: int,
                       batches: Iterable[Tuple[RecordBatch, int]]) -> int:
        return self.setup(dataset, shard_num).recover_stream(batches)

    def flush_all(self, dataset: str) -> int:
        return sum(s.flush_all_groups() for s in self.shards_for(dataset))
