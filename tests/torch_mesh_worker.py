"""Worker of the port's two-process mesh test
(tests/test_torch_multihost.py::test_two_process_mesh_matches_one_process).

Each process owns 2 of the 4 shards of one seeded counter dataset (the
reference shard math, spread 2), joins a gloo process group over
localhost (filodb_tpu_torch.parallel.multihost.initialize), and runs
sum by (_ns_) (rate(...[5m])) (the fused per-slot path), avg of it and
max by (_ns_) of it (the general path) through a MeshExecutor over the
global 4 x N_TIME mesh; its memstore holds only its own shards.  Every
process also answers the same panels from a one-process mesh over all
four shards and checks that the two agree within 1e-12 relative (the
merges differ only in association) with the same NaN pattern, then
prints one JSON line.

Run: python tests/torch_mesh_worker.py <rank> <port> <n_time>
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from filodb_tpu_torch.core.index import Equals  # noqa: E402
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore  # noqa: E402
from filodb_tpu_torch.core.records import RecordBatch  # noqa: E402
from filodb_tpu_torch.ingest.generator import counter_batch  # noqa: E402
from filodb_tpu_torch.ops.timewindow import make_window_ends  # noqa: E402
from filodb_tpu_torch.parallel import multihost  # noqa: E402
from filodb_tpu_torch.parallel.mesh import MeshExecutor, make_mesh  # noqa: E402
from filodb_tpu_torch.parallel.shardmapper import ShardMapper  # noqa: E402

START_MS = 1_600_000_000_000
T = 240
N_SERIES = 96
RANGE_MS = 300_000
PANELS = (("rate", "sum"), ("rate", "avg"), ("rate", "max"))


def shard_batches():
    """The dataset's 4 shard slices, routed as the gateway routes."""
    batch = counter_batch(N_SERIES, T, start_ms=START_MS, resets=True,
                          seed=19)
    mapper = ShardMapper(4)
    shard_of = np.asarray([
        mapper.ingestion_shard(pk.shard_key_hash(), pk.partition_hash(), 2)
        for pk in batch.part_keys])
    out = []
    for s in range(4):
        keep = shard_of[batch.part_idx] == s
        out.append(RecordBatch(batch.schema, batch.part_keys,
                               batch.part_idx[keep], batch.timestamps[keep],
                               {k: v[keep] for k, v in
                                batch.columns.items()},
                               batch.bucket_les))
    return out


def store(shards, slices):
    ms = TimeSeriesMemStore(device="cpu")
    for s in shards:
        ms.setup("prometheus", s).ingest(slices[s])
    return ms


def answers(ex):
    filters = [Equals("_metric_", "request_total")]
    t0, t1 = START_MS, START_MS + (T - 1) * 10_000
    wends = make_window_ends(t0 + 600_000, t1, 60_000)
    out = {}
    for fn, op in PANELS:
        pk = ex.lookup_and_pack(filters, t0, t1, by=("_ns_",), fn_name=fn)
        vals, labels = ex.run_agg(pk, wends, range_ms=RANGE_MS, fn_name=fn,
                                  agg_op=op)
        out[f"{op}({fn})"] = {tuple(sorted(d.items())): vals[i]
                              for i, d in enumerate(labels)}
    return out


def main():
    rank, port, n_time = (int(a) for a in sys.argv[1:4])
    backend = multihost.initialize(f"127.0.0.1:{port}", num_processes=2,
                                   process_id=rank, device="cpu",
                                   timeout_s=60)
    slices = shard_batches()
    mine = [0, 1] if rank == 0 else [2, 3]
    mesh = multihost.global_mesh(n_shard=4, n_time=n_time,
                                 devices=["cpu"] * (2 * n_time))
    assert mesh.local_shard_rows() == mine, mesh.local_shard_rows()
    got = answers(MeshExecutor(store(mine, slices), "prometheus", mesh))
    one = answers(MeshExecutor(store(range(4), slices), "prometheus",
                               make_mesh(4, n_time,
                                         devices=["cpu"] * (4 * n_time))))
    worst = 0.0
    for panel, want in one.items():
        assert got[panel].keys() == want.keys(), panel
        for k, w in want.items():
            g = got[panel][k]
            assert (np.isnan(g) == np.isnan(w)).all(), (panel, k)
            ok = ~np.isnan(w)
            rel = np.abs(g[ok] - w[ok]) / np.maximum(np.abs(w[ok]), 1e-300)
            worst = max(worst, float(rel.max()) if rel.size else 0.0)
    assert worst <= 1e-12, worst
    print(json.dumps({"rank": rank, "backend": backend,
                      "rows": mine, "panels": sorted(one),
                      "groups": len(one["sum(rate)"]),
                      "max_rel": worst}), flush=True)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
