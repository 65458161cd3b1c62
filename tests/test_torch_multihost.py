"""The port's multi-process meshes (filodb_tpu_torch/parallel/
multihost.py) against the JAX package's (tests/test_multihost.py), on
the CPU.

One process degrades exactly to the local mesh path: initialize() is a
no-op, global_mesh() is make_mesh's shape, device_put_packed_multihost
places what device_put_packed places, and a MeshExecutor over it answers
as the JAX one over its global mesh (rtol 2e-4 / atol 1e-3).  The
backend rule picks gloo on the host.  Then two real processes
(tests/torch_mesh_worker.py) join one gloo group over localhost, each
owning 2 of 4 shards, and answer the rate panels over a 4 x 1 and a
4 x 2 global mesh within 1e-12 relative of a one-process mesh over all
four shards.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from filodb_tpu.core.index import Equals as JEquals
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.ingest import generator as jgen
from filodb_tpu.parallel import multihost as jmh
from filodb_tpu.parallel.mesh import MeshExecutor as JMeshExecutor

from filodb_tpu_torch.core.index import Equals
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
from filodb_tpu_torch.ingest import generator as pgen
from filodb_tpu_torch.ops.timewindow import make_window_ends
from filodb_tpu_torch.parallel import multihost
from filodb_tpu_torch.parallel.mesh import (MeshExecutor, device_put_packed,
                                            make_mesh, pack_shards)
from filodb_tpu_torch.utils.device import NoCudaDevice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mesh_worker.py")
START = 1_600_000_000_000


@pytest.fixture(autouse=True, scope="module")
def _clear_compile_journal():
    """The JAX mesh journals jit compiles, which the reference's health
    model reads as a compile storm for the next 120 s in whatever file
    this process runs next: clear it after this file."""
    yield
    from filodb_tpu.utils.events import journal
    journal.clear()


def test_initialize_single_process_is_a_noop():
    assert multihost.initialize(num_processes=1) is None
    assert multihost.process_count() == 1 and multihost.process_index() == 0


def test_backend_rule():
    assert multihost.pick_backend(2, "cpu") == "gloo"
    # the default is the card: without one the rule raises, as every entry
    # point's default does, and never picks NCCL or the host on its own
    if torch.cuda.is_available():
        assert multihost.pick_backend(1, local_world=1) == "nccl"
    else:
        with pytest.raises(NoCudaDevice):
            multihost.pick_backend(1, local_world=1)
        with pytest.raises(NoCudaDevice):
            multihost.global_mesh(n_shard=1)


def test_global_mesh_shapes():
    mesh = multihost.global_mesh(n_shard=4, n_time=2, devices=["cpu"] * 8)
    assert mesh.shape == {"shard": 4, "time": 2}
    assert mesh.addressable and mesh.local_shard_rows() == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        multihost.global_mesh(n_shard=64, n_time=64, devices=["cpu"] * 8)
    jm = jmh.global_mesh(n_shard=4, n_time=2)
    assert jm.shape == mesh.shape


def test_multihost_put_matches_local_put():
    """Under one process device_put_packed_multihost places exactly what
    device_put_packed places."""
    rng = np.random.default_rng(0)
    blocks = []
    for d in range(4):
        ts = np.arange(12, dtype=np.int32)[None, :].repeat(3, 0)
        labels = [{"_ns_": f"App-{i % 2}", "inst": f"d{d}-{i}"}
                  for i in range(3)]
        blocks.append((ts, rng.normal(size=(3, 12)), labels))
    packed = pack_shards(blocks, by=("_ns_",), base_ms=0)
    mesh = multihost.global_mesh(n_shard=4, n_time=2, devices=["cpu"] * 8)
    a = device_put_packed(packed, mesh)
    b = multihost.device_put_packed_multihost(packed, mesh)
    for name in ("ts_off", "values", "group_ids", "vbase"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.shape == y.shape and x.parts.keys() == y.parts.keys()
        for k in x.parts:
            assert x.parts[k].numpy().tobytes() == \
                y.parts[k].numpy().tobytes(), (name, k)
    g = multihost.assemble_global(mesh, packed.group_ids, ("shard", None))
    for s in range(4):
        assert (g.block(s, "cpu").numpy() == packed.group_ids[s]).all()


def test_multihost_mesh_runs_the_agg_as_the_reference():
    """The global-mesh executor drives the per-slot path end to end and
    answers as the JAX one over its global mesh."""
    jms, pms = JMemStore(), TimeSeriesMemStore(device="cpu")
    for ms, gen in ((jms, jgen), (pms, pgen)):
        ms.setup("prometheus", 0)
        ms.setup("prometheus", 1)
        ms.ingest("prometheus", 0, gen.counter_batch(8, 120, start_ms=START),
                  offset=1)
    end = START + 119 * 10_000
    w = make_window_ends(START + 400_000, end, 60_000)
    jex = JMeshExecutor(jms, "prometheus", jmh.global_mesh(n_shard=2,
                                                           n_time=2))
    jp = jex.lookup_and_pack([JEquals("_metric_", "request_total")], START,
                             end, by=("_ns_",), fn_name="rate")
    jo, jl = jex.run_agg(jp, w, range_ms=300_000, fn_name="rate",
                         agg_op="sum")
    ex = MeshExecutor(pms, "prometheus", multihost.global_mesh(
        n_shard=2, n_time=2, devices=["cpu"] * 4))
    p = ex.lookup_and_pack([Equals("_metric_", "request_total")], START,
                           end, by=("_ns_",), fn_name="rate")
    out, labels = ex.run_agg(p, w, range_ms=300_000, fn_name="rate",
                             agg_op="sum")
    assert labels == jl and np.isfinite(out).any()
    np.testing.assert_allclose(out, np.asarray(jo), rtol=2e-4, atol=1e-3,
                               equal_nan=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("n_time", [1, 2])
def test_two_process_mesh_matches_one_process(tmp_path, n_time):
    """Two worker processes over gloo, 2 of 4 shards each: every panel
    (the fused sum and avg, the general max) within 1e-12 relative of
    the one-process mesh, both workers exit 0."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "MASTER_", "WORLD_",
                                "RANK", "LOCAL_"))}
    env["PYTHONPATH"] = REPO
    logs, procs = [], []
    for rank in (0, 1):
        f = open(tmp_path / f"w{rank}.log", "w+")
        logs.append(f)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(rank), str(port), str(n_time)],
            stdout=f, stderr=subprocess.STDOUT, env=env, cwd=REPO))
    try:
        rcs = [p.wait(timeout=60) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    assert rcs == [0, 0], outs
    lines = [json.loads(next(ln for ln in o.splitlines()
                             if ln.startswith("{"))) for o in outs]
    assert [ln["rows"] for ln in lines] == [[0, 1], [2, 3]]
    for ln in lines:
        assert ln["backend"] == "gloo" and ln["groups"] == 10
        assert ln["max_rel"] <= 1e-12
        assert ln["panels"] == ["avg(rate)", "max(rate)", "sum(rate)"]
