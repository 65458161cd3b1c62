"""Row-sliced streaming of query result payloads over the node transport
(port of filodb_tpu/parallel/streams.py; a device tensor is sliced from
its one host copy).

The single-frame reply protocol buffers an entire serialized result —
for a 30-day cold-tier block that is the whole [S, W] matrix TWICE on
the coordinator (raw reply bytes + decoded arrays) before the exec tree
even sees it.  This module is the chunking half of the streamed reply
path (parallel/transport.py): the data node splits a result into
bounded row slices, and the coordinator's `StreamAssembler` writes each
slice into preallocated arrays as its frame arrives — peak memory is
the result itself plus ONE frame, regardless of range.

The begin/piece shape is deliberately dumb: a `begin` dict carries the
constant fields plus per-array dtype/shape templates, every `piece`
carries a row offset and the row slices.  `finish()` refuses to hand
back a block whose rows were not all filled — a torn stream can never
be silently treated as a full result (the transport layer raises the
typed `remote_failure` before that, but the assembler is the last
line).

Splittable payloads: RawBlock / ResultBlock (row axis = series) and
AggPartial (row axis = groups for the component/sketch forms, candidate
rows for the topk/count_values form).  Everything else rides inline in
the final frame.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from filodb_tpu_torch.query.execbase import AggPartial, RawBlock
from filodb_tpu_torch.query.rangevector import ResultBlock

# type name -> (list-valued row fields, array-valued row fields,
# constant fields).  Optional row arrays (vbase, comp vs sketch) are
# simply absent from a begin's templates when None.
_SPECS: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...], Tuple[str, ...]]] = {
    "RawBlock": (("keys",), ("ts_off", "values", "vbase"),
                 ("base_ms", "bucket_les", "samples", "precorrected",
                  "shared_ts_row", "dense", "route_host")),
    "ResultBlock": (("keys",), ("values",), ("wends", "bucket_les")),
    # component / sketch forms: rows are groups
    "AggPartial": (("group_keys",), ("comp", "sketch"),
                   ("op", "wends", "params", "bucket_les")),
    # candidate form: rows are candidate series, groups ride whole
    "AggPartialCand": (("cand_keys",), ("cand_vals", "cand_groups"),
                       ("op", "wends", "params", "bucket_les",
                        "group_keys")),
}

_CLASSES = {"RawBlock": RawBlock, "ResultBlock": ResultBlock,
            "AggPartial": AggPartial, "AggPartialCand": AggPartial}


def _host(v):
    """A field's value as a host array (a device tensor is copied off
    the card once; numpy passes through)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _spec_for(data) -> Optional[Tuple[str, int]]:
    """(spec name, row count) for a splittable payload, else None."""
    if isinstance(data, RawBlock):
        return "RawBlock", int(data.ts_off.shape[0])
    if isinstance(data, AggPartial):
        if data.cand_vals is not None:
            return "AggPartialCand", int(data.cand_vals.shape[0])
        return "AggPartial", len(data.group_keys)
    if isinstance(data, ResultBlock):
        return "ResultBlock", int(data.values.shape[0])
    return None


def split_for_stream(data, max_bytes: int):
    """(begin, [piece, ...]) when `data` is a splittable payload bigger
    than `max_bytes`, else None (the reply rides inline in one frame).

    Pieces slice ONLY along the row axis so the receiving assembler can
    preallocate from the begin templates and fill slices in place."""
    if max_bytes <= 0:
        return None
    found = _spec_for(data)
    if found is None:
        return None
    name, nrows = found
    if nrows <= 1:
        return None
    list_fields, arr_fields, const_fields = _SPECS[name]
    arrays: Dict[str, np.ndarray] = {}
    for f in arr_fields:
        v = getattr(data, f, None)
        if v is not None:
            a = _host(v)
            if a.shape and a.shape[0] == nrows:
                arrays[f] = a
    lists: Dict[str, List] = {}
    for f in list_fields:
        v = getattr(data, f, None)
        lists[f] = list(v) if v is not None else []  # LazyKeys materialize
    total = sum(a.nbytes for a in arrays.values())
    if total <= max_bytes or not arrays:
        return None
    row_bytes = max(total / nrows, 1.0)
    step = max(1, int(max_bytes // row_bytes))
    begin = {
        "type": name,
        "rows": nrows,
        "fields": {f: {"dtype": str(a.dtype), "shape": list(a.shape)}
                   for f, a in arrays.items()},
        "lists": sorted(lists),
        "const": {f: getattr(data, f, None) for f in const_fields},
    }
    pieces = []
    for r0 in range(0, nrows, step):
        r1 = min(r0 + step, nrows)
        pieces.append({
            "r0": r0, "n": r1 - r0,
            # row slices stay VIEWS: a row slice of a contiguous array
            # is contiguous, so the serializer's ascontiguousarray is a
            # no-op and the only per-frame copy is tobytes() at send
            # time — the sender never holds a second full copy
            "arrays": {f: a[r0:r1] for f, a in arrays.items()},
            "lists": {f: l[r0:r1] for f, l in lists.items()},
        })
    return begin, pieces


def piece_block(begin: dict, piece: dict):
    """Materialize ONE piece as a standalone payload of the begin's type
    (a row-slice mini block) — the incremental-fold path: a parent that
    can merge row slices directly (ReduceAggregateExec's map+reduce
    fold) consumes each frame and never holds the child whole."""
    name = begin.get("type")
    if name not in _SPECS:
        raise ValueError(f"unknown stream payload type {name!r}")
    cls = _CLASSES[name]
    kwargs = dict(begin.get("const") or {})
    n = int(piece["n"])
    for f, arr in (piece.get("arrays") or {}).items():
        a = np.asarray(arr)
        if not a.shape or a.shape[0] != n:
            raise ValueError(f"stream piece field {f} does not lead with "
                             f"its row count {n}")
        kwargs[f] = a
    for f, items in (piece.get("lists") or {}).items():
        if len(items) != n:
            raise ValueError(f"stream piece list {f} has {len(items)} "
                             f"items for {n} rows")
        kwargs[f] = list(items)
    if isinstance(kwargs.get("params"), list):
        kwargs["params"] = tuple(kwargs["params"])
    field_names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in kwargs.items() if k in field_names})


class FoldError(Exception):
    """An APPLICATION error raised inside a parent's fold (e.g. the
    group-by cardinality limit) — distinct from protocol/shape errors so
    the transport can surface the real error instead of remote_failure.
    The original exception rides in `cause`."""

    def __init__(self, cause: BaseException):
        super().__init__(str(cause))
        self.cause = cause


class StreamFold:
    """Incremental consumer: each piece becomes a mini block handed to
    the parent-provided fold object (`fold.add(block)` / `fold.result()`)
    as its frame arrives.  Row accounting matches the assembler's — a
    short stream still refuses to finish."""

    def __init__(self, begin: dict, fold):
        if begin.get("type") not in _SPECS:
            raise ValueError(
                f"unknown stream payload type {begin.get('type')!r}")
        self._begin = begin
        self._fold = fold
        self._rows = int(begin["rows"])
        self._filled = 0

    def add(self, piece: dict) -> None:
        # pieces are emitted in strict row order — continuity closes
        # duplicated/overlapping/reordered frames, which would otherwise
        # double-fold rows while still satisfying the row count
        if int(piece["r0"]) != self._filled:
            raise ValueError(
                f"stream piece rows start at {piece['r0']}, expected "
                f"{self._filled} (out-of-order or duplicated frame)")
        blk = piece_block(self._begin, piece)
        try:
            self._fold.add(blk)
        except Exception as e:  # noqa: BLE001 — app error, not protocol
            raise FoldError(e) from e
        self._filled += int(piece["n"])

    def finish(self):
        if self._filled != self._rows:
            raise ValueError(
                f"short stream: {self._filled}/{self._rows} rows arrived")
        try:
            return self._fold.result()
        except Exception as e:  # noqa: BLE001 — app error, not protocol
            raise FoldError(e) from e


class StreamAssembler:
    """Coordinator-side incremental reassembly: preallocates the row
    arrays from the begin frame's templates and writes each piece's row
    slice in place as its frame arrives."""

    def __init__(self, begin: dict):
        name = begin.get("type")
        if name not in _SPECS:
            raise ValueError(f"unknown stream payload type {name!r}")
        self._name = name
        self._rows = int(begin["rows"])
        if self._rows <= 0:
            raise ValueError("stream begin frame with no rows")
        self._arrays: Dict[str, np.ndarray] = {}
        for f, t in (begin.get("fields") or {}).items():
            shape = tuple(int(x) for x in t["shape"])
            if not shape or shape[0] != self._rows:
                raise ValueError(f"stream field {f} shape {shape} does not "
                                 f"lead with the row count {self._rows}")
            self._arrays[f] = np.empty(shape, dtype=np.dtype(t["dtype"]))
        self._lists: Dict[str, List] = {
            f: [None] * self._rows for f in (begin.get("lists") or [])}
        self._const = dict(begin.get("const") or {})
        self._filled = 0

    def add(self, piece: dict) -> None:
        r0 = int(piece["r0"])
        n = int(piece["n"])
        if r0 < 0 or n <= 0 or r0 + n > self._rows:
            raise ValueError(f"stream piece rows [{r0}, {r0 + n}) outside "
                             f"[0, {self._rows})")
        # pieces are emitted in strict row order — continuity means a
        # duplicated or dropped frame can NEVER leave np.empty garbage
        # rows behind a satisfied row count
        if r0 != self._filled:
            raise ValueError(
                f"stream piece rows start at {r0}, expected "
                f"{self._filled} (out-of-order or duplicated frame)")
        for f, arr in (piece.get("arrays") or {}).items():
            dst = self._arrays.get(f)
            if dst is None:
                raise ValueError(f"stream piece carries undeclared field {f}")
            a = np.asarray(arr)
            if a.shape != (n,) + dst.shape[1:] or a.dtype != dst.dtype:
                raise ValueError(
                    f"stream piece field {f} shape/dtype mismatch "
                    f"({a.dtype}{a.shape} vs {dst.dtype}"
                    f"{(n,) + dst.shape[1:]})")
            dst[r0:r0 + n] = a
        for f, items in (piece.get("lists") or {}).items():
            dst_l = self._lists.get(f)
            if dst_l is None:
                raise ValueError(f"stream piece carries undeclared list {f}")
            if len(items) != n:
                raise ValueError(f"stream piece list {f} has {len(items)} "
                                 f"items for {n} rows")
            dst_l[r0:r0 + n] = items
        self._filled += n

    def finish(self):
        """Build the payload — refuses a short stream (`finish` on fewer
        filled rows than declared can NEVER pass a partial off as full)."""
        if self._filled != self._rows:
            raise ValueError(
                f"short stream: {self._filled}/{self._rows} rows arrived")
        cls = _CLASSES[self._name]
        kwargs = dict(self._const)
        kwargs.update(self._arrays)
        kwargs.update(self._lists)
        if isinstance(kwargs.get("params"), list):
            kwargs["params"] = tuple(kwargs["params"])
        field_names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in kwargs.items() if k in field_names}
        return cls(**kwargs)
