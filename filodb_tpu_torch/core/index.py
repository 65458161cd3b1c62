"""PartKeyIndex — the tag index (Lucene equivalent).

The reference indexes partKey -> tags/startTime/endTime/partId in Lucene with
Equals/In/Prefix/Regex filters, label-values queries, and endTime ordering
(ref: core/.../memstore/PartKeyLuceneIndex.scala:71,106-108; filter model
core/.../query/KeyFilter.scala).  This implementation is a compressed-bitmap
posting engine (core/postings.py: roaring-style 2^16-id containers, dense
uint64 bitsets vs sorted-uint16 arrays per density):

  * postings — label -> value -> Bitmap; a multi-filter selector is a
    per-container AND/ANDNOT word-op cascade, and negative matchers are an
    ANDNOT against the flat alive bitset instead of a setdiff1d complement;
  * value planning — a per-label sorted value snapshot + trigram posting
    map, so Prefix is a bisect range and `=~` matchers plan by literal /
    trigram extraction (mandatory trigrams intersect candidate values; only
    survivors hit the compiled regex), memoized per (label, pattern) and
    invalidated by a per-label value epoch;
  * churn maintenance — removal is an O(1) bit flip plus a tombstone
    record; `compact()` (driven by the `index_compaction` background job)
    prunes dead postings, drops empty values AND empty labels, and rebases
    the flat time/liveness arrays past fully-dead id containers so a
    series-churn soak holds index memory flat.

Liveness/time state lives in one `_Linear` holder swapped wholesale on
compaction; readers grab a single local reference per operation so a
concurrent rebase can never tear an id-to-offset translation.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.postings import (
    CONTAINER_SIZE, DENSE_WORDS, HI_SHIFT, LO_MASK, SPARSE_MAX, Bitmap,
    _c_and, _c_and_card, _c_andnot, _c_lo_ids, union_many,
)
from filodb_tpu_torch.utils.growable import grow_to

try:                                    # py3.11+ keeps sre private
    from re import _constants as _sre_c
    from re import _parser as _sre_p
except ImportError:                     # pragma: no cover - older pythons
    import sre_constants as _sre_c
    import sre_parse as _sre_p

MAX_TIME = (1 << 62)

_EMPTY_IDS = np.zeros(0, dtype=np.int64)
_ONE = np.uint64(1)
# planner guardrails: intersect at most this many trigram postings per
# pattern (smallest-first — more adds cost, not selectivity), and bound
# the (label, pattern) memo table
_MAX_TRIGRAMS = 12
_RE_MEMO_MAX = 512
_WALK_MEMO_MAX = 256


# ---- Column filters (ref: core/.../query/KeyFilter.scala Filter ADT) ----

@dataclasses.dataclass(frozen=True)
class ColumnFilter:
    column: str


@dataclasses.dataclass(frozen=True)
class Equals(ColumnFilter):
    value: str


@dataclasses.dataclass(frozen=True)
class NotEquals(ColumnFilter):
    value: str


@dataclasses.dataclass(frozen=True)
class In(ColumnFilter):
    values: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class NotIn(ColumnFilter):
    values: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class EqualsRegex(ColumnFilter):
    pattern: str


@dataclasses.dataclass(frozen=True)
class NotEqualsRegex(ColumnFilter):
    pattern: str


@dataclasses.dataclass(frozen=True)
class Prefix(ColumnFilter):
    prefix: str


def _full_match(pattern: str, value: str) -> bool:
    return re.fullmatch(pattern, value) is not None


# ---------------------------------------------------- regex planning


def _literal_alternatives(parsed) -> Optional[List[str]]:
    """`a|b|c` (every branch a pure literal) -> the branch strings.

    The sre parser rewrites literal alternations before we see them: a
    shared prefix is factored out ("ab|ac" -> "a" + BRANCH["b","c"]) and
    single-char branches fold into one IN token ("a|b" -> IN[a, b]), so
    a literal alternation arrives as leading LITERALs plus at most one
    trailing BRANCH/IN — recursing into branches unwinds nested
    factoring.  Returns None for anything non-literal."""
    toks = list(parsed)
    prefix: List[str] = []
    for i, (op, av) in enumerate(toks):
        if op is _sre_c.LITERAL:
            prefix.append(chr(av))
            continue
        if i != len(toks) - 1:
            return None
        p = "".join(prefix)
        if op is _sre_c.BRANCH:
            outs = []
            for br in av[1]:
                sub = _literal_alternatives(br)
                if sub is None:
                    return None
                outs.extend(p + s for s in sub)
            return outs
        if op is _sre_c.IN:
            outs = []
            for iop, iav in av:
                if iop is not _sre_c.LITERAL:
                    return None
                outs.append(p + chr(iav))
            return outs
        return None
    return ["".join(prefix)]


def _mandatory_runs(seq) -> Tuple[str, List[str]]:
    """(anchored literal prefix, literal runs every match must contain).

    Conservative: only constructs that PROVE a literal appears in every
    match contribute (top-level literals, plain groups, repeats with
    min >= 1); everything else just breaks the current run.  Wrong-side
    conservatism is safe — a missed run only widens the candidate set.
    """
    runs: List[str] = []
    cur: List[str] = []
    prefix = ""
    at_start = True

    def flush(starts: bool) -> bool:
        nonlocal prefix
        if cur:
            s = "".join(cur)
            if starts:
                prefix = s
            runs.append(s)
            del cur[:]
            return False
        return starts

    for op, av in seq:
        if op is _sre_c.LITERAL:
            cur.append(chr(av))
            continue
        if op is _sre_c.AT:            # anchors match empty: transparent
            continue
        at_start = flush(at_start)
        at_start = False
        if op is _sre_c.SUBPATTERN:
            # av = (group, add_flags, del_flags, subpattern)
            if av[1] == 0 and av[2] == 0:
                runs.extend(_mandatory_runs(av[3])[1])
        elif op in (_sre_c.MAX_REPEAT, _sre_c.MIN_REPEAT):
            lo, _hi, sub = av
            if lo >= 1:
                runs.extend(_mandatory_runs(sub)[1])
    flush(at_start)
    return prefix, runs


def _analyze_pattern(pattern: str):
    """(exact_alternatives | None, literal_prefix, mandatory_runs).

    Bails to (None, "", []) — i.e. "plan nothing, scan every value" —
    on inline flags or anything the parser rejects.
    """
    if "(?" in pattern and "(?:" not in pattern:
        # inline flags like (?i) change literal semantics; lookarounds
        # et al are rare in matchers — full scan keeps them correct
        return None, "", []
    if "(?i" in pattern or "(?s" in pattern or "(?m" in pattern \
            or "(?x" in pattern or "(?a" in pattern or "(?L" in pattern \
            or "(?=" in pattern or "(?!" in pattern or "(?<" in pattern:
        return None, "", []
    try:
        parsed = _sre_p.parse(pattern)
    except Exception:  # noqa: BLE001 — re.compile will surface the error
        return None, "", []
    alts = _literal_alternatives(parsed)
    if alts is not None:
        return alts, "", []
    prefix, runs = _mandatory_runs(parsed)
    return None, prefix, runs


def _prefix_end(p: str) -> Optional[str]:
    """Smallest string greater than every string with prefix `p`."""
    for i in range(len(p) - 1, -1, -1):
        if ord(p[i]) < 0x10FFFF:
            return p[:i] + chr(ord(p[i]) + 1)
    return None


class _Linear:
    """The flat per-partId state, indexed by pid - base (base is always
    container-aligned).  Swapped wholesale on compaction rebase so
    readers holding one reference never see torn base/array pairs."""

    __slots__ = ("base", "start", "end", "alive", "alive_words",
                 "part_keys")

    def __init__(self, base: int, start: np.ndarray, end: np.ndarray,
                 alive: np.ndarray, alive_words: np.ndarray,
                 part_keys: List[Optional[PartKey]]):
        self.base = base
        self.start = start
        self.end = end
        self.alive = alive
        self.alive_words = alive_words
        self.part_keys = part_keys


def _words_for(capacity: int) -> int:
    """alive_words length covering `capacity` slots, whole containers."""
    return ((capacity + CONTAINER_SIZE - 1) >> HI_SHIFT) * DENSE_WORDS


class PartKeyIndex:
    """In-memory tag index for one shard."""

    def __init__(self):
        # label -> value -> posting bitmap over partIds
        self._postings: Dict[str, Dict[str, Bitmap]] = {}
        # label -> ids that EVER had a non-empty value for it (grows on
        # add, alive-pruned on compact); queries AND it with alive, so
        # stale dead bits are harmless — this is the complement basis for
        # the absent-label "" convention
        self._having: Dict[str, Bitmap] = {}
        self._lin = _Linear(0, np.zeros(0, dtype=np.int64),
                            np.zeros(0, dtype=np.int64),
                            np.zeros(0, dtype=bool),
                            np.zeros(0, dtype=np.uint64), [])
        # lazily-removed partitions: pid -> part key at removal time;
        # postings keep the dead bits until compact() prunes them in bulk
        self._tombstones: Dict[int, PartKey] = {}
        # label -> value-set epoch: bumps when a NEW value appears or a
        # value is pruned — the invalidation token for the sorted value
        # snapshot / trigram map / regex plan memo
        self._vepoch: Dict[str, int] = {}
        # label -> [epoch, sorted values, trigram map or None]
        self._vdict: Dict[str, list] = {}
        # (label, pattern) -> (epoch, matched non-empty values)
        self._re_memo: Dict[Tuple[str, str], Tuple[int, List[str]]] = {}
        # mutations-keyed memos (satellite: the absent-set and the
        # filtered label_names/label_values membership walks)
        self._absent_memo: Dict[str, Tuple[int, Bitmap]] = {}
        self._walk_memo: Dict[tuple, Tuple[int, list]] = {}
        self._alive_ids_memo: Optional[Tuple[int, np.ndarray]] = None
        self.num_docs = 0
        # bumps on any mutation that can change a lookup's result (add,
        # end-time update, removal, compaction) — the invalidation token
        # for TimeSeriesShard.lookup_partitions' result cache and every
        # memo above
        self.mutations = 0

    # ---- write path ----

    def add_partition(self, part_id: int, part_key: PartKey,
                      start_time_ms: int, end_time_ms: int = MAX_TIME) -> None:
        """ref: PartKeyLuceneIndex.addPartKey; endTime=MAX means still ingesting."""
        lin = self._lin
        if part_id < lin.base:
            lin = self._rebase_down(part_id)
        idx = part_id - lin.base
        if idx >= len(lin.part_keys):
            n = idx + 1
            lin.start = grow_to(lin.start, n)
            lin.end = grow_to(lin.end, n, fill=MAX_TIME)
            lin.alive = grow_to(lin.alive, n, fill=False)
            nw = _words_for(lin.start.shape[0])
            if lin.alive_words.shape[0] < nw:
                w = np.zeros(nw, dtype=np.uint64)
                w[:lin.alive_words.shape[0]] = lin.alive_words
                lin.alive_words = w
            lin.part_keys.extend(
                [None] * (lin.start.shape[0] - len(lin.part_keys)))
        old = self._tombstones.pop(part_id, None)
        if old is not None:
            # pid reuse after a lazy removal: the dead bits for the OLD
            # key are still in the postings — purge them eagerly so the
            # re-added pid only matches its new labels (the old index
            # removed postings at removal time; same net semantics)
            self._purge_postings(part_id, old)
        lin.part_keys[idx] = part_key
        lin.start[idx] = start_time_ms
        lin.end[idx] = end_time_ms
        lin.alive[idx] = True
        lin.alive_words[idx >> 6] |= _ONE << np.uint64(idx & 63)
        self._index_label("__name__", part_key.metric, part_id)
        for k, v in part_key.tags:
            self._index_label(k, v, part_id)
        self.num_docs += 1
        self.mutations += 1

    def _index_label(self, key: str, value: str, part_id: int) -> None:
        d = self._postings.get(key)
        if d is None:
            d = self._postings[key] = {}
        bm = d.get(value)
        if bm is None:
            bm = d[value] = Bitmap()
            self._vepoch[key] = self._vepoch.get(key, 0) + 1
        bm.add(part_id)
        if value:
            h = self._having.get(key)
            if h is None:
                h = self._having[key] = Bitmap()
            h.add(part_id)

    def _purge_postings(self, part_id: int, part_key: PartKey) -> None:
        for k, v in (("__name__", part_key.metric), *part_key.tags):
            d = self._postings.get(k)
            bm = d.get(v) if d is not None else None
            if bm is not None:
                bm.discard(part_id)
                if not bm:
                    del d[v]
                    self._vepoch[k] = self._vepoch.get(k, 0) + 1
            if v:
                h = self._having.get(k)
                if h is not None:
                    h.discard(part_id)
                    if not h:
                        del self._having[k]
            if d is not None and not d:
                del self._postings[k]
                self._vepoch.pop(k, None)
                self._vdict.pop(k, None)

    def update_end_time(self, part_id: int, end_time_ms: int) -> None:
        """ref: PartKeyLuceneIndex.updatePartKeyWithEndTime (series stopped)."""
        lin = self._lin
        idx = part_id - lin.base
        if 0 <= idx < lin.end.shape[0]:
            lin.end[idx] = end_time_ms
        self.mutations += 1

    def start_time(self, part_id: int) -> int:
        lin = self._lin
        idx = part_id - lin.base
        return int(lin.start[idx]) if 0 <= idx < lin.start.shape[0] else 0

    def earliest_start_time(self) -> Optional[int]:
        """The earliest start time over the alive partitions (None when
        there are none): the oldest sample the shard answers, resident
        or paged in from its column store on demand."""
        lin = self._lin
        n = min(lin.start.shape[0], lin.alive.shape[0])
        starts = lin.start[:n][lin.alive[:n].astype(bool)]
        return int(starts.min()) if starts.size else None

    def end_time(self, part_id: int) -> int:
        lin = self._lin
        idx = part_id - lin.base
        return int(lin.end[idx]) if 0 <= idx < lin.end.shape[0] \
            else MAX_TIME

    def part_key(self, part_id: int) -> Optional[PartKey]:
        lin = self._lin
        idx = part_id - lin.base
        return lin.part_keys[idx] if 0 <= idx < len(lin.part_keys) \
            else None

    def remove_partition(self, part_id: int) -> None:
        """Eviction support (ref: PartKeyLuceneIndex.removePartKeys).
        O(1): flip the alive bit and tombstone the key — posting bits
        stay until compact() prunes them in bulk."""
        lin = self._lin
        idx = part_id - lin.base
        if idx < 0 or idx >= len(lin.part_keys):
            return
        pk = lin.part_keys[idx]
        if pk is None:
            return
        lin.part_keys[idx] = None
        lin.alive[idx] = False
        lin.alive_words[idx >> 6] &= ~(_ONE << np.uint64(idx & 63))
        self._tombstones[part_id] = pk
        self.num_docs -= 1
        self.mutations += 1

    def _rebase_down(self, part_id: int) -> _Linear:
        """Re-admit ids below the rebased floor (restore/replay paths
        only — live shards assign monotonically increasing pids)."""
        lin = self._lin
        new_base = (part_id >> HI_SHIFT) << HI_SHIFT
        pad = lin.base - new_base
        start = np.concatenate([np.zeros(pad, dtype=np.int64), lin.start])
        end = np.concatenate(
            [np.full(pad, MAX_TIME, dtype=np.int64), lin.end])
        alive = np.concatenate([np.zeros(pad, dtype=bool), lin.alive])
        words = np.concatenate([np.zeros(pad >> 6, dtype=np.uint64),
                                lin.alive_words])
        self._lin = _Linear(new_base, start, end, alive, words,
                            [None] * pad + lin.part_keys)
        return self._lin

    # ---- maintenance (churn) ----

    @property
    def tombstone_count(self) -> int:
        return len(self._tombstones)

    def maybe_compact(self, threshold: int) -> bool:
        """Compact when the tombstone backlog crossed `threshold` (the
        index_compaction job's per-tick check).  0 disables."""
        if threshold and len(self._tombstones) >= threshold:
            self.compact()
            return True
        return False

    def compact(self) -> Dict[str, int]:
        """Prune tombstoned ids out of the postings, drop empty values
        and labels, re-tighten the having sets to alive, and rebase the
        flat arrays past fully-dead leading containers.  NOT safe
        against concurrent writers — the shard runs it under its write
        lock (TimeSeriesShard.compact_index)."""
        pruned = len(self._tombstones)
        if self._tombstones:
            by_lv: Dict[Tuple[str, str], List[int]] = {}
            for pid, pk in self._tombstones.items():
                for k, v in (("__name__", pk.metric), *pk.tags):
                    by_lv.setdefault((k, v), []).append(pid)
            for (k, v), pids in by_lv.items():
                d = self._postings.get(k)
                bm = d.get(v) if d is not None else None
                if bm is None:
                    continue
                bm.remove_many(np.asarray(pids, dtype=np.int64))
                if not bm:
                    del d[v]
                    self._vepoch[k] = self._vepoch.get(k, 0) + 1
                if not d:
                    # the satellite fix: a label whose last value died
                    # must stop existing, so label_names() on a churned
                    # shard doesn't list dead labels forever
                    del self._postings[k]
                    self._vepoch.pop(k, None)
                    self._vdict.pop(k, None)
            self._tombstones.clear()
        for k in list(self._having):
            if k not in self._postings:
                del self._having[k]
                continue
            nb = self._and_alive(self._having[k])
            if nb:
                self._having[k] = nb
            else:
                del self._having[k]
        rebased = self._maybe_rebase()
        self._absent_memo.clear()
        self._walk_memo.clear()
        self._alive_ids_memo = None
        self.mutations += 1
        return {"tombstones_pruned": pruned, "ids_rebased": rebased}

    def _maybe_rebase(self) -> int:
        """Slice fully-dead leading containers off the linear arrays."""
        lin = self._lin
        n = len(lin.part_keys)
        if n == 0:
            return 0
        alive = lin.alive[:n]
        first = int(np.argmax(alive)) if alive.any() else n
        drop = (first >> HI_SHIFT) << HI_SHIFT
        if drop < CONTAINER_SIZE:
            return 0
        self._lin = _Linear(
            lin.base + drop, lin.start[drop:].copy(),
            lin.end[drop:].copy(), lin.alive[drop:].copy(),
            lin.alive_words[drop >> 6:].copy(), lin.part_keys[drop:])
        return drop

    def memory_bytes(self) -> int:
        """Rough resident estimate of the index structures (the churn
        soak's flatness gauge)."""
        lin = self._lin
        n = (lin.start.nbytes + lin.end.nbytes + lin.alive.nbytes
             + lin.alive_words.nbytes + 8 * len(lin.part_keys))
        for d in self._postings.values():
            n += 96 * len(d)
            for bm in d.values():
                n += bm.memory_bytes()
        for bm in self._having.values():
            n += bm.memory_bytes()
        for ent in self._vdict.values():
            n += 8 * len(ent[1])
            if ent[2] is not None:
                n += sum(48 + a.nbytes for a in ent[2].values())
        return n

    def container_count(self) -> int:
        n = sum(bm.container_count()
                for d in self._postings.values() for bm in d.values())
        return n + sum(bm.container_count()
                       for bm in self._having.values())

    def label_memory_bytes(self, label: str) -> int:
        """Resident estimate of one label's postings + value strings +
        having set (the /api/v1/status/tsdb memoryInBytesByLabelName
        view)."""
        key = "__name__" if label in ("__name__", "_metric_") else label
        d = self._postings.get(key, {})
        n = sum(bm.memory_bytes() + 64 + 2 * len(v)
                for v, bm in d.items())
        h = self._having.get(key)
        return n + (h.memory_bytes() if h is not None else 0)

    # ---- read path: container algebra ----

    def _alive_container(self, lin: _Linear,
                         hi: int) -> Optional[np.ndarray]:
        off = hi - (lin.base >> HI_SHIFT)
        if off < 0:
            return None
        s = off * DENSE_WORDS
        w = lin.alive_words
        if s >= w.shape[0]:
            return None
        return w[s:s + DENSE_WORDS]

    def _and_alive(self, bm: Bitmap) -> Bitmap:
        lin = self._lin
        out = Bitmap()
        if bm._is_small():
            ids = self._alive_filter(bm._small_ids())
            out._s = ids if ids.size else None
            return out
        for hi in bm.container_his():
            c = _c_and(self._alive_container(lin, hi), bm.container(hi))
            if c is not None:
                out._c[hi] = c
        return out

    def _alive_intersection_card(self, bm: Bitmap) -> int:
        lin = self._lin
        if bm._is_small():
            off = bm._small_ids() - lin.base
            off = off[(off >= 0) & (off < lin.alive.shape[0])]
            return int(lin.alive[off].sum())
        return sum(
            _c_and_card(self._alive_container(lin, hi), bm.container(hi))
            for hi in bm.container_his())

    def _alive_filter(self, ids: np.ndarray) -> np.ndarray:
        """Sorted ids -> the alive subset, one fancy-index probe."""
        lin = self._lin
        off = ids - lin.base
        ok = (off >= 0) & (off < lin.alive.shape[0])
        if not ok.all():
            ids, off = ids[ok], off[ok]
        return ids[lin.alive[off]] if ids.size else ids

    def _materialize(self, pos: List[Bitmap],
                     neg: List[Bitmap]) -> np.ndarray:
        """alive AND all(pos) ANDNOT each(neg) -> ascending int64 ids."""
        lin = self._lin
        base_hi = lin.base >> HI_SHIFT
        small = [b for b in pos if b._is_small()]
        if small:
            # array-mode fast path: the smallest selector is already a
            # sorted id vector — AND/alive/neg all run as single numpy
            # passes over it, never touching container geometry
            arrs = sorted((b._small_ids() for b in small),
                          key=lambda a: a.shape[0])
            ids = arrs[0]
            for a in arrs[1:]:
                if ids.size == 0:
                    return _EMPTY_IDS
                ids = np.intersect1d(ids, a, assume_unique=True)
            ids = self._alive_filter(ids)
            for b in pos:
                if ids.size == 0:
                    return _EMPTY_IDS
                if not b._is_small():
                    ids = ids[b._member_mask(ids)]
            for b in neg:
                if ids.size == 0:
                    return _EMPTY_IDS
                ids = ids[~b._member_mask(ids)]
            return ids
        views = [b._container_view() for b in pos]
        neg_views = [b._container_view() for b in neg]
        if views:
            views.sort(key=len)
            his = set(views[0])
            for v in views[1:]:
                his &= v.keys()
                if not his:
                    return _EMPTY_IDS
        else:
            his = range(base_hi,
                        base_hi + lin.alive_words.shape[0] // DENSE_WORDS)
        parts = []
        for hi in sorted(his):
            c = self._alive_container(lin, hi)
            if c is None:
                continue
            for v in views:
                c = _c_and(c, v.get(hi))
                if c is None:
                    break
            if c is None:
                continue
            for v in neg_views:
                c = _c_andnot(c, v.get(hi))
                if c is None:
                    break
            if c is not None:
                parts.append((hi << HI_SHIFT) + _c_lo_ids(c))
        if not parts:
            return _EMPTY_IDS
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def _alive_ids(self) -> np.ndarray:
        memo = self._alive_ids_memo
        if memo is not None and memo[0] == self.mutations:
            return memo[1]
        lin = self._lin
        n = len(lin.part_keys)
        ids = np.flatnonzero(lin.alive[:n]) + lin.base
        self._alive_ids_memo = (self.mutations, ids)
        return ids

    def _absent_bitmap(self, key: str) -> Bitmap:
        """Series where label `key` is missing or "" — PromQL treats the
        two identically (an absent label HAS the value ""), so `{l=""}`
        and regexes matching "" must select these.  alive ANDNOT having,
        memoized against `mutations`."""
        memo = self._absent_memo.get(key)
        if memo is not None and memo[0] == self.mutations:
            return memo[1]
        lin = self._lin
        having = self._having.get(key)
        out = Bitmap()
        nw = lin.alive_words.shape[0] // DENSE_WORDS
        base_hi = lin.base >> HI_SHIFT
        for hi in range(base_hi, base_hi + nw):
            c = self._alive_container(lin, hi)
            if having is not None:
                c = _c_andnot(c, having.container(hi))
            if c is not None and (c.dtype != np.uint64 or c.any()):
                out._c[hi] = c
        if len(self._absent_memo) > _WALK_MEMO_MAX:
            self._absent_memo.clear()
        self._absent_memo[key] = (self.mutations, out)
        return out

    # ---- read path: value planning ----

    def _values_snapshot(self, key: str) -> list:
        """Sorted value list for `key`, rebuilt when the label's value
        epoch moved (new value indexed / value pruned)."""
        d = self._postings.get(key)
        if d is None:
            return []
        ep = self._vepoch.get(key, 0)
        ent = self._vdict.get(key)
        if ent is None or ent[0] != ep:
            ent = [ep, sorted(d.keys()), None]
            self._vdict[key] = ent
        return ent[1]

    def _trigram_map(self, key: str) -> Dict[str, np.ndarray]:
        ent = self._vdict[key]          # _values_snapshot ran first
        if ent[2] is None:
            tm: Dict[str, List[int]] = {}
            for i, v in enumerate(ent[1]):
                for j in range(len(v) - 2):
                    tm.setdefault(v[j:j + 3], []).append(i)
            ent[2] = {t: np.unique(np.asarray(ix, dtype=np.int64))
                      for t, ix in tm.items()}
        return ent[2]

    def _plan_regex(self, key: str, pattern: str) -> List[str]:
        """Non-empty values of `key` matching `pattern`, planned via
        literal/trigram extraction so only candidate survivors hit the
        compiled regex; memoized per (label, pattern) until the label's
        value set changes."""
        vals = self._values_snapshot(key)
        ep = self._vepoch.get(key, 0)
        memo = self._re_memo.get((key, pattern))
        if memo is not None and memo[0] == ep:
            return memo[1]
        rx = re.compile(pattern)
        exact, prefix, runs = _analyze_pattern(pattern)
        if exact is not None:
            d = self._postings.get(key, {})
            out = [v for v in sorted(set(exact))
                   if v and v in d and rx.fullmatch(v)]
        else:
            cand = self._candidates(key, vals, prefix, runs)
            if cand is None:
                out = [v for v in vals if v and rx.fullmatch(v)]
            else:
                out = [v for v in cand if v and rx.fullmatch(v)]
        if len(self._re_memo) > _RE_MEMO_MAX:
            self._re_memo.clear()
        self._re_memo[(key, pattern)] = (ep, out)
        return out

    def _candidates(self, key: str, vals: list, prefix: str,
                    runs: List[str]) -> Optional[List[str]]:
        """Candidate values from the prefix bisect range intersected
        with mandatory-trigram postings; None = no plan (scan all)."""
        tris = {r[j:j + 3] for r in runs if len(r) >= 3
                for j in range(len(r) - 2)}
        if not prefix and not tris:
            return None
        lo, hi = 0, len(vals)
        if prefix:
            lo = bisect.bisect_left(vals, prefix)
            end = _prefix_end(prefix)
            if end is not None:
                hi = bisect.bisect_left(vals, end)
        if not tris:
            return vals[lo:hi]
        tm = self._trigram_map(key)
        arrs = []
        for t in tris:
            a = tm.get(t)
            if a is None:
                return []               # a mandatory trigram no value has
            arrs.append(a)
        arrs.sort(key=lambda a: a.shape[0])
        cand = arrs[0]
        for a in arrs[1:_MAX_TRIGRAMS]:
            cand = np.intersect1d(cand, a, assume_unique=True)
            if cand.size == 0:
                return []
        if prefix:
            cand = cand[(cand >= lo) & (cand < hi)]
        return [vals[i] for i in cand.tolist()]

    # ---- read path: filters ----

    def _match_positive(self, f: ColumnFilter, key: str) -> Bitmap:
        values = self._postings.get(key, {})
        if isinstance(f, Equals):
            if f.value == "":
                return self._absent_bitmap(key)
            return values.get(f.value) or Bitmap()
        if isinstance(f, In):
            parts = [values[v] for v in f.values if v and v in values]
            if "" in f.values:
                parts.append(self._absent_bitmap(key))
            return union_many(parts)
        if isinstance(f, Prefix):
            # FiloDB extension over indexed values only (no "" convention:
            # upstream PromQL has no prefix matcher) — a bisect range over
            # the sorted value snapshot instead of a startswith scan
            vals = self._values_snapshot(key)
            lo = bisect.bisect_left(vals, f.prefix)
            end = _prefix_end(f.prefix)
            hi = bisect.bisect_left(vals, end) if end is not None \
                else len(vals)
            return union_many([values[v] for v in vals[lo:hi]])
        if isinstance(f, EqualsRegex):
            survivors = self._plan_regex(key, f.pattern)
            nonempty = len(values) - (1 if "" in values else 0)
            if survivors and len(survivors) == nonempty \
                    and key in self._having:
                # every non-empty value matched: the having union IS the
                # answer (alive-masked at materialize time)
                pos = self._having[key]
                parts = [pos]
            else:
                parts = [values[v] for v in survivors if v in values]
            if _full_match(f.pattern, ""):
                parts.append(self._absent_bitmap(key))
            if len(parts) == 1:
                return parts[0]
            return union_many(parts)
        raise TypeError(f"unsupported filter {f!r}")

    def part_ids_from_filters(self, filters: Sequence[ColumnFilter],
                              start_time_ms: int, end_time_ms: int,
                              limit: Optional[int] = None) -> np.ndarray:
        """AND of filters, intersected with [start,end] series liveness
        (ref: PartKeyLuceneIndex.partIdsFromFilters; docs sorted by endTime)."""
        pos: List[Bitmap] = []
        neg: List[Bitmap] = []
        for f in filters:
            key = "__name__" if f.column in ("__name__", "_metric_") \
                else f.column
            if isinstance(f, NotEquals):
                neg.append(self._match_positive(
                    Equals(f.column, f.value), key))
            elif isinstance(f, NotIn):
                neg.append(self._match_positive(
                    In(f.column, f.values), key))
            elif isinstance(f, NotEqualsRegex):
                neg.append(self._match_positive(
                    EqualsRegex(f.column, f.pattern), key))
            else:
                pos.append(self._match_positive(f, key))
        ids = self._materialize(pos, neg)
        lin = self._lin
        off = ids - lin.base
        mask = (lin.start[off] <= end_time_ms) \
            & (lin.end[off] >= start_time_ms)
        ids = ids[mask]
        # sort by endTime like the reference index ordering
        ids = ids[np.argsort(lin.end[ids - lin.base], kind="stable")]
        return ids[:limit] if limit is not None else ids

    # ---- read path: label walks ----

    @staticmethod
    def _ids_bitmap(ids: np.ndarray) -> Bitmap:
        bm = Bitmap()
        ids = np.sort(ids)
        his = ids >> HI_SHIFT
        for hi in np.unique(his).tolist():
            los = (ids[his == hi] & LO_MASK).astype(np.uint16)
            bm._c[hi] = los
        return bm

    def label_values(self, label: str,
                     filters: Sequence[ColumnFilter] = (),
                     start_time_ms: int = 0, end_time_ms: int = MAX_TIME,
                     limit: Optional[int] = None) -> List[str]:
        key = "__name__" if label in ("__name__", "_metric_") else label
        if not filters:
            vals = list(self._values_snapshot(key))
            return vals[:limit] if limit else vals
        token = ("lv", key, tuple(filters), start_time_ms, end_time_ms)
        memo = self._walk_memo.get(token)
        if memo is not None and memo[0] == self.mutations:
            vals = memo[1]
            return vals[:limit] if limit else list(vals)
        ids = self.part_ids_from_filters(filters, start_time_ms,
                                         end_time_ms)
        vals = []
        if ids.size:
            idbm = self._ids_bitmap(ids)
            vals = [v for v, bm in self._postings.get(key, {}).items()
                    if idbm.intersects(bm)]
            vals.sort()
        if len(self._walk_memo) > _WALK_MEMO_MAX:
            self._walk_memo.clear()
        self._walk_memo[token] = (self.mutations, vals)
        return vals[:limit] if limit else list(vals)

    def label_value_counts(self, label: str) -> List[Tuple[str, int]]:
        """(value, alive series count) pairs, most numerous first — the
        cardinality view behind indexvalues/topkcard and
        /api/v1/status/tsdb (ref: PartKeyLuceneIndex indexValues with
        counts, CliMain indexvalues)."""
        key = "__name__" if label in ("__name__", "_metric_") else label
        out = [(v, self._alive_intersection_card(bm))
               for v, bm in self._postings.get(key, {}).items()]
        return sorted(out, key=lambda kv: (-kv[1], kv[0]))

    def label_names(self, filters: Sequence[ColumnFilter] = (),
                    start_time_ms: int = 0, end_time_ms: int = MAX_TIME) -> List[str]:
        if not filters:
            return sorted(self._postings.keys())
        token = ("ln", tuple(filters), start_time_ms, end_time_ms)
        memo = self._walk_memo.get(token)
        if memo is not None and memo[0] == self.mutations:
            return list(memo[1])
        ids = self.part_ids_from_filters(filters, start_time_ms,
                                         end_time_ms)
        out = []
        if ids.size:
            idbm = self._ids_bitmap(ids)
            for key, vals in self._postings.items():
                h = self._having.get(key)
                if h is not None and idbm.intersects(h):
                    out.append(key)
                    continue
                e = vals.get("")
                if e is not None and idbm.intersects(e):
                    out.append(key)
            out.sort()
        if len(self._walk_memo) > _WALK_MEMO_MAX:
            self._walk_memo.clear()
        self._walk_memo[token] = (self.mutations, out)
        return list(out)

    def ended_pids(self, before_ms: int) -> np.ndarray:
        """Alive partIds whose series ended before `before_ms` — the
        eviction candidate sweep as one vectorized compare instead of a
        per-partition Python loop (TimeSeriesShard.evict_ended_partitions
        drains these in fixed-size increments)."""
        lin = self._lin
        n = len(lin.part_keys)
        return np.flatnonzero(lin.alive[:n]
                              & (lin.end[:n] < before_ms)) + lin.base
