"""Multi-process meshes over torch.distributed (port of
filodb_tpu/parallel/multihost.py).

The reference joins `jax.distributed` and builds one global ('shard',
'time') mesh whose collectives ride ICI within a slice and DCN across
slices.  Here each process joins one torch.distributed process group and
owns a contiguous block of the mesh's shard rows (process-major,
global_mesh); it packs and places only its own rows
(device_put_packed_multihost), runs its own slots' kernels, and the
processes all-reduce their merged [G, W] partials (all_reduce_partials).
No process ever holds another's series.

The backend follows one rule, logged when the group starts: NCCL where
every rank holds a card of its own (ranks on one host <= its cards), gloo
on the host and where ranks share a card (NCCL refuses two ranks on one
device).  A collective under gloo travels as a host tensor.

The invariants the reference leaves to its caller (globally consistent
group slots, agreed static flags) are established here at every pack by
agree_pack, one all_gather_object of each process's group labels, shared
grid and flags: every process must therefore make the same executor
calls in the same order.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch

from filodb_tpu_torch.core.devicecache import local_cards
from filodb_tpu_torch.parallel.mesh import (Mesh, PackedShards, SlotArrays,
                                            _dev_key, _row_devices,
                                            device_put_packed)
from filodb_tpu_torch.utils.device import resolve_device

_log = logging.getLogger("filodb.multihost")


def _dist():
    import torch.distributed as dist
    return dist


def process_count() -> int:
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def pick_backend(world: int, device="cuda",
                 local_world: Optional[int] = None) -> str:
    """The backend rule for slots on `device` (default the card, through
    resolve_device: raises without one): "nccl" where every rank holds a
    card of its own (the ranks on this host, `local_world` (default
    LOCAL_WORLD_SIZE, else the world), fit on its cards), else "gloo"
    (the host, or ranks sharing a card)."""
    if resolve_device(device).type != "cuda":
        return "gloo"
    if local_world is None:
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               auto: bool = False, device="cuda",
               backend: Optional[str] = None,
               timeout_s: float = 300.0) -> Optional[str]:
    """Join the process group -> the backend chosen (None when there is
    nothing to join).

    auto=True calls torch.distributed.init_process_group from PyTorch's
    own environment (MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK, as
    torchrun sets them).  Otherwise the arguments default from those
    variables (coordinator_address "host:port"); with one process (or
    none of them set) this is a no-op, so single-process tools run
    unchanged.  `device` is where this process's slots live (default the
    card; pass "cpu" for the host), which picks the backend by
    pick_backend unless `backend` is given."""
    import datetime
    dist = _dist()
    if dist.is_initialized():
        return dist.get_backend()
    if auto:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        chosen = backend or pick_backend(world, device)
        _log.info("joining the process group from the environment, "
                  "backend %s", chosen)
        dist.init_process_group(chosen, timeout=datetime.timedelta(
            seconds=timeout_s))
        return chosen
    num = num_processes if num_processes is not None else int(
        os.environ.get("WORLD_SIZE", "1"))
    if num <= 1:
        return None
    rank = process_id if process_id is not None else int(
        os.environ.get("RANK", "0"))
    addr = coordinator_address or "{}:{}".format(
        os.environ.get("MASTER_ADDR", "localhost"),
        os.environ.get("MASTER_PORT", "29500"))
    chosen = backend or pick_backend(num, device)
    _log.info("rank %d of %d joining tcp://%s, backend %s (%s)", rank, num,
              addr, chosen,
              "a card per rank" if chosen == "nccl"
              else "host or a shared card")
    dist.init_process_group(chosen, init_method=f"tcp://{addr}",
                            world_size=num, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return chosen


def local_devices() -> list:
    """This process's cards (raises without one, as resolve_device does);
    a process that means the host passes its devices to global_mesh."""
    resolve_device("cuda")
    return local_cards()


def global_mesh(n_shard: Optional[int] = None, n_time: int = 1,
                devices: Optional[Sequence] = None) -> Mesh:
    """('shard', 'time') mesh over every process's devices (call after
    initialize()).  `devices` are this process's (default its cards,
    local_devices();
    a device may repeat, e.g. two slots on one card); every process must
    bring as many.  Slots are ordered process-major, so each process's
    slots form contiguous shard rows.  Raises if the shape would leave a
    process's devices out (allowed only in one process) or split a shard
    row across processes."""
    world, rank = process_count(), process_index()
    local = [torch.device(d) for d in (devices if devices is not None
                                        else local_devices())]
    total = world * len(local)
    if n_shard is None:
        n_shard = total // n_time
    need = n_shard * n_time
    if total < need:
        raise ValueError(f"need {need} devices globally, have {total}")
    if world > 1:
        if need != total:
            raise ValueError(
                f"mesh shape {n_shard}x{n_time} uses {need} of {total} "
                f"devices; multi-process meshes must cover every process")
        if len(local) % n_time != 0:
            raise ValueError(
                f"time axis {n_time} does not divide the {len(local)} "
                f"devices per process; a shard row would span two "
                f"processes")
    per_proc = len(local)
    grid = np.empty((n_shard, n_time), dtype=object)
    owner = np.zeros((n_shard, n_time), np.int64)
    for k in range(need):
        s, t = divmod(k, n_time)
        owner[s, t] = k // per_proc
        if owner[s, t] == rank:
            grid[s, t] = local[k % per_proc]
    return Mesh(grid, owner=owner, rank=rank)


def assemble_global(mesh: Mesh, local: np.ndarray,
                    spec: Sequence[Optional[str]]) -> SlotArrays:
    """One global array from this process's block of the data: `local`
    holds the shard rows this process owns along spec's 'shard' axis
    (e.g. its [D_local, S, T] block for ('shard', None, None)); each row
    goes to the devices of its slots.  No process holds the whole
    array."""
    if not spec or spec[0] != "shard":
        raise ValueError(f"assemble_global shards the leading axis, not "
                         f"{tuple(spec)}")
    rows = mesh.local_shard_rows()
    if len(rows) != local.shape[0]:
        raise ValueError(f"{local.shape[0]} local rows for this process's "
                         f"{len(rows)} shard rows")
    parts = {}
    for i, s in enumerate(rows):
        for dev in _row_devices(mesh, s):
            parts[(s, _dev_key(dev))] = torch.from_numpy(
                np.ascontiguousarray(local[i])).to(dev)
    return SlotArrays((mesh.shape["shard"],) + tuple(local.shape[1:]), parts)


def device_put_packed_multihost(packed: PackedShards, mesh: Mesh
                                ) -> PackedShards:
    """Placement for a PackedShards whose arrays hold THIS process's shard
    rows (D_local leading rows, in mesh-row order): each goes to its
    slots' devices.  One process delegates to the local path, so there is
    exactly one field list."""
    if mesh.world == 1:
        return device_put_packed(packed, mesh)
    return device_put_packed(packed, mesh, rows=mesh.local_shard_rows())


def agree_pack(packed: PackedShards) -> PackedShards:
    """Make this process's placed pack (its own shard rows) agree with the
    other processes': one all_gather_object of (group labels, shared
    grid, dense, precorrected, group sizes).  The group slots become the
    union of every process's labels in sorted order (this pack's ids
    remapped, on the host and on the devices), the group sizes their sum,
    the shared grid the common one (None unless every process with
    series has the same), dense and precorrected the conjunction.  Then
    every process takes the same route with the same shapes."""
    world = process_count()
    if world == 1:
        return packed
    dist = _dist()
    keys = [tuple(sorted(d.items())) for d in packed.group_labels]
    has = bool(np.asarray(packed.n_series).sum())
    mine = (keys, packed.shared_ts_row.tobytes()
            if packed.shared_ts_row is not None else None, has,
            packed.dense, packed.precorrected,
            [int(x) for x in np.asarray(packed.gsize)[:len(keys)]])
    got = [None] * world
    dist.all_gather_object(got, mine)
    union = sorted(set().union(*[set(g[0]) for g in got]))
    index = {k: i for i, k in enumerate(union)}
    G = max(len(union), 1)
    remap = np.asarray([index[k] for k in keys] or [0], np.int32)
    gids = packed.host_group_ids.copy()
    for d, n in enumerate(np.asarray(packed.n_series)):
        gids[d, :n] = remap[gids[d, :n]]
    rows = sorted({s for s, _ in packed.group_ids.parts})
    parts = {}
    for (s, dev), t in packed.group_ids.parts.items():
        parts[(s, dev)] = torch.from_numpy(
            np.ascontiguousarray(gids[rows.index(s)])).to(t.device)
    gsize = np.zeros(G, np.int64)
    for g in got:
        for k, c in zip(g[0], g[5]):
            gsize[index[k]] += c
    grids = {g[1] for g in got if g[2]}
    shared = None
    if len(grids) == 1 and None not in grids:
        shared = np.frombuffer(grids.pop(), np.int32).copy()
    return dataclasses.replace(
        packed, host_group_ids=gids,
        group_ids=SlotArrays(packed.group_ids.shape, parts), num_groups=G,
        group_labels=[dict(k) for k in union], gsize=gsize,
        shared_ts_row=shared, dense=all(g[3] for g in got),
        precorrected=all(g[4] for g in got))


def all_reduce_partials(x, combs):
    """All-reduce a process's merged partials [G, W(, C)] across the
    process group with each trailing component's combiner (one for all,
    or one per component: sum, min, max) -> a host numpy array.  Under
    gloo the reduce travels as a host tensor; under NCCL on the card."""
    dist = _dist()
    ops = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
           "max": dist.ReduceOp.MAX}
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    t = t.to(torch.float64)
    if dist.get_backend() == "nccl":
        if t.device.type != "cuda":
            t = t.to(torch.device("cuda", torch.cuda.current_device()))
    else:
        t = t.cpu()
    if isinstance(combs, str) or len(set(combs)) == 1:
        comb = combs if isinstance(combs, str) else combs[0]
        t = t.contiguous()
        dist.all_reduce(t, op=ops[comb])
        return t.cpu().numpy()
    pieces = []
    for i, comb in enumerate(combs):
        p = t[..., i].contiguous()
        dist.all_reduce(p, op=ops[comb])
        pieces.append(p.cpu())
    return torch.stack(pieces, -1).numpy()
