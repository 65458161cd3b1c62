"""Compressed resident chunk tier — sealed history in host RAM (port of
filodb_tpu/memory/resident.py; its eviction metric is the port's plain
counter resident_chunks_evicted, its bytes gauge the bytes_used attribute).

The reference keeps its entire in-memory working set delta-delta/NibblePack
encoded off-heap (~1.5M series/GB, ref: doc/ingestion.md:110,
memory/.../format/vectors/DeltaDeltaVector.scala:28) and pages chunks into
query memory on demand.  This package inverts the layout — the query-hot
tier is DENSE [series, time] arrays because that is what the card wants —
but raw f64 for all history caps cardinality ~10-50x below the reference.

This module is the middle tier that restores the footprint: sealed chunks
(the same encoded ChunkSets written to the ColumnStore at flush) stay
resident in RAM under a byte budget, so the dense tier can be truncated to
the active tail and re-paged from RAM at memory-bandwidth cost instead of
disk cost.  Over-budget chunks are dropped oldest-first — they are already
persisted, so this is a clean cache eviction (the BlockManager time-ordered
reclaim analogue, ref: memory/.../BlockManager.scala:16).
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

from filodb_tpu_torch.memory.chunks import ChunkSet
from filodb_tpu_torch.utils.counters import counters


class ResidentChunkCache:
    """Per-shard cache of sealed, encoded chunks keyed by partition id.

    Insertion order is flush order, which is time order per partition —
    eviction walks the global insertion queue (oldest flush first), the
    same reclaim ordering the reference's BlockManager guarantees.
    """

    # Per-chunk accounting overhead beyond the encoded payload: the ChunkSet
    # object, its info record, per-column bytes objects, and list/queue
    # slots.  Without this, many tiny chunks (frequent flushes) cost far
    # more RSS than bytes_used claims and the budget never triggers —
    # observed as unbounded growth in the ingestion soak.
    CHUNK_OVERHEAD = 1024

    def __init__(self, budget_bytes: int = 256 << 20,
                 persistent: bool = True):
        """persistent=False (in-memory-only deployments, NullColumnStore):
        this cache IS the system of record for sealed history, so budget
        eviction would destroy data — it is disabled and growth is surfaced
        via bytes_used instead."""
        self.budget_bytes = budget_bytes
        self.persistent = persistent
        self.bytes_used = 0
        self.chunks_evicted = 0
        self._by_part: Dict[int, List[ChunkSet]] = {}
        self._queue: deque = deque()          # (part_id, chunk_id, nbytes)

    # ------------------------------------------------------------------ write

    def add(self, part_id: int, cs: ChunkSet) -> None:
        nb = cs.nbytes + self.CHUNK_OVERHEAD
        self._by_part.setdefault(part_id, []).append(cs)
        self._queue.append((part_id, cs.info.chunk_id, nb))
        self.bytes_used += nb
        self._enforce_budget()

    def _enforce_budget(self) -> None:
        if not self.persistent:
            return      # sole copy of sealed history — never drop it
        while self.bytes_used > self.budget_bytes and self._queue:
            part_id, chunk_id, nb = self._queue.popleft()
            lst = self._by_part.get(part_id)
            if lst is None:
                continue
            for i, cs in enumerate(lst):
                if cs.info.chunk_id == chunk_id:
                    del lst[i]
                    self.bytes_used -= nb
                    self.chunks_evicted += 1
                    counters.inc("resident_chunks_evicted")
                    break
            if not lst:
                self._by_part.pop(part_id, None)

    def drop_part(self, part_id: int) -> None:
        """Partition evicted from the shard entirely: forget its chunks
        (queue entries lazily skip missing chunks)."""
        lst = self._by_part.pop(part_id, None)
        if lst:
            self.bytes_used -= sum(cs.nbytes + self.CHUNK_OVERHEAD
                                   for cs in lst)

    # ------------------------------------------------------------------- read

    def read(self, part_id: int, start_time_ms: int,
             end_time_ms: int) -> List[ChunkSet]:
        """Chunks overlapping [start, end], time-ascending."""
        out = [cs for cs in self._by_part.get(part_id, ())
               if cs.info.end_time_ms >= start_time_ms
               and cs.info.start_time_ms <= end_time_ms]
        out.sort(key=lambda c: c.info.start_time_ms)
        return out

    def coverage_floor(self, part_id: int) -> Optional[int]:
        """Earliest start_time resident for the partition, or None."""
        lst = self._by_part.get(part_id)
        if not lst:
            return None
        return min(cs.info.start_time_ms for cs in lst)

    @property
    def num_chunks(self) -> int:
        return sum(len(v) for v in self._by_part.values())
