"""filodb_tpu_torch stands alone: importing every one of its modules, in
a fresh interpreter, pulls in neither jax nor any filodb_tpu module."""
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import filodb_tpu_torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import filodb_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    filodb_tpu_torch.__path__, "filodb_tpu_torch."))
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "filodb_tpu" or m.startswith("filodb_tpu."))
print(json.dumps({"imported": names, "bad": bad}))
"""


def _probe():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_and_no_reference_package():
    res = _probe()
    assert res["bad"] == []
    expected = sorted(m.name for m in pkgutil.walk_packages(
        filodb_tpu_torch.__path__, "filodb_tpu_torch."))
    assert res["imported"] == expected
    for mod in ("filodb_tpu_torch.ops.fused", "filodb_tpu_torch.ops.kernels",
                "filodb_tpu_torch.ops.minmax", "filodb_tpu_torch.ops.agg",
                "filodb_tpu_torch.core.devicecache",
                "filodb_tpu_torch.query.engine"):
        assert mod in res["imported"]


NEW_MODULES = ("ops.rangefns", "ops.instant", "ops.hist", "ops.select",
               "ops.probe", "ops.timewindow", "ops.counter",
               "query.transformers", "query.nonleaf", "query.planner",
               "tools.probe_slice", "memory.histogram", "ops.hostleaf",
               "query.metaexec", "core.records", "core.store",
               "memory.nibblepack", "memory.chunks", "memory.resident",
               "query.exprfuse", "query.frontend", "query.resultcache",
               "query.coalesce", "query.qos", "query.activequeries",
               "http.routes", "http.server", "config", "utils.hoconlite",
               "utils.metrics", "utils.events", "utils.slowlog",
               "utils.usage", "utils.devicetelem", "utils.jobs",
               "utils.freshness", "utils.health", "utils.faults",
               "utils.profiler", "parallel.breaker", "query.planners",
               "query.exec", "persist", "persist.localstore",
               "persist.segments", "persist.compactor", "utils.varint",
               "utils.snappy", "wal", "wal.segment", "wal.writer",
               "wal.replay", "core.flush", "ingest", "ingest.stream",
               "persist.objectstore", "http.remotepb", "core.ratelimit",
               "gateway", "gateway.accounting", "gateway.influx",
               "gateway.router", "gateway.remotewrite", "gateway.server",
               "ingest.generator", "ingest.filebroker", "ingest.kafka_wire",
               "ingest.kafka", "memory.binhist", "downsample",
               "downsample.downsamplers", "downsample.shard_downsampler",
               "downsample.store", "downsample.batch_job",
               "downsample.dist_job", "rules", "rules.config",
               "rules.notifier", "rules.ruler", "utils.selfmon",
               "utils.traceexport")


def _bare_import(module):
    probe = (
        "import importlib, json, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'filodb_tpu'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", NEW_MODULES)
def test_general_path_module_stands_alone(module):
    """Each module of the general path, the probe, the live write path,
    the serving stack, the operations surface, the composed planners,
    the persisted-segment tier, the durability layer (the WAL, the
    flush scheduler, the ingestion streams and the shared object
    store), the write doors (the prompb codec, the cardinality
    tracker, the gateway, the broker and Kafka streams), the downsample
    runtime and the rules engine with selfmon and span export, imported alone
    in a fresh interpreter, pulls in neither jax nor the reference
    package."""
    assert _bare_import("filodb_tpu_torch." + module) == []


def test_port_sources_name_no_reference_import():
    """No source line imports jax or filodb_tpu (only filodb_tpu_torch)."""
    offenders = []
    pkg = ROOT / "filodb_tpu_torch"
    for path in pkg.rglob("*.py"):
        if path.relative_to(pkg).parts[0] == "build":
            continue                 # kernel builds and unpacked checkouts
        for i, line in enumerate(path.read_text().splitlines(), 1):
            s = line.strip()
            if not s.startswith(("import ", "from ")):
                continue
            mod = s.split()[1]
            if mod.split(".")[0] in ("jax", "jaxlib", "filodb_tpu"):
                offenders.append(f"{path.relative_to(ROOT)}:{i}: {s}")
    assert offenders == []


def test_kernel_level_api_stands_alone():
    """The kernel-level API and its CUDA source list import in a
    fresh interpreter without jax or the reference package."""
    probe = (
        "import json, sys\n"
        "from filodb_tpu_torch.ops.fused import (PreparedInputs, pad_inputs,"
        " fused_rate_groupsum, fused_leaf_agg, run_kernel, gather_default,"
        " warmup_compile)\n"
        "from filodb_tpu_torch.ops import kernels\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'filodb_tpu'))\n"
        "print(json.dumps({'bad': bad, 'sources': sorted(kernels.SOURCES),"
        " 'drops': sorted(k for k in kernels.LAUNCHES if 'drops' in k)}))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["sources"] == ["fused_drops", "fused_over_time", "fused_rate",
                              "probe_select"]
    assert res["drops"] == ["fused_rate_drops_dense",
                            "fused_rate_drops_dense_series",
                            "fused_rate_drops_ragged",
                            "fused_rate_drops_ragged_series"]
    assert (ROOT / "filodb_tpu_torch" / "csrc" / "fused_drops.cu").exists()


def test_chip_smoke_imports_no_reference():
    """chip_smoke.py names neither jax nor filodb_tpu on any import line,
    and importing it (and the write doors it drives) in a fresh
    interpreter loads neither."""
    src = (ROOT / "chip_smoke.py").read_text().splitlines()
    offenders = [f"chip_smoke.py:{i}: {line.strip()}"
                 for i, line in enumerate(src, 1)
                 if line.strip().startswith(("import ", "from "))
                 and line.strip().split()[1].split(".")[0]
                 in ("jax", "jaxlib", "filodb_tpu")]
    assert offenders == []
    probe = (
        "import importlib, json, sys\n"
        "sys.path.insert(0, '.')\n"
        "importlib.import_module('chip_smoke')\n"
        "for m in ('gateway.router', 'gateway.remotewrite', 'http.routes',"
        " 'core.ratelimit'):\n"
        "    importlib.import_module('filodb_tpu_torch.' + m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'filodb_tpu'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
