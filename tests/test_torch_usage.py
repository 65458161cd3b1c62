"""Per-tenant ingest accounting on the port's shard against the JAX
package's: the same batches go through both packages' shards on every
ingest path (a grid RecordBatch, a flat one, a columnar slab, one whose
samples arrive out of order and are dropped, one with a duplicated key),
then the usage accountant's rows (utils/usage.snapshot) and GET
/admin/tenants must be the reference's, tenant by tenant.  The
accounting counts samples offered on kept keys, as the reference's
TimeSeriesShard._account_ingest does.
"""
import numpy as np
import pytest

from test_torch_ingest import _clear_compile_journal  # noqa: F401
from torch_doors import DS, Node, assert_same_stores, usage_of

START = 1_600_000_000_000
PKGS = ("jax", "port")


@pytest.fixture()
def pair():
    for pkg in PKGS:
        usage_of(pkg).clear()
    nodes = {pkg: Node(pkg, shards=1) for pkg in PKGS}
    yield nodes
    for n in nodes.values():
        n.close()
    for pkg in PKGS:
        usage_of(pkg).clear()


def _mods(pkg):
    if pkg == "jax":
        from filodb_tpu.core.partkey import PartKey
        from filodb_tpu.core.records import RecordBatch
    else:
        from filodb_tpu_torch.core.partkey import PartKey
        from filodb_tpu_torch.core.records import RecordBatch
    return PartKey, RecordBatch


def _keys(PartKey, n, metric):
    return [PartKey.make(metric, {"_ws_": ("demo", "other", "")[i % 3],
                                  "_ns_": f"App-{i % 4}", "i": str(i)})
            for i in range(n)]


def _drive(node, pkg, path):
    PartKey, RecordBatch = _mods(pkg)
    sh = node.memstore.get_shard(DS, 0)
    schemas = sh.schemas
    rng = np.random.default_rng(5)
    S, k = 12, 4
    ts = START + np.arange(k, dtype=np.int64)[None, :] * 10_000
    ts = np.repeat(ts, S, 0)
    vals = rng.normal(size=(S, k))
    keys = _keys(PartKey, S, "heap")
    if path == "grid":
        sh.ingest(RecordBatch.from_grid(schemas["gauge"], keys, ts,
                                        {"value": vals}))
    elif path == "flat":
        b = RecordBatch.from_grid(schemas["gauge"], keys, ts,
                                  {"value": vals})
        order = rng.permutation(b.num_records)
        order = order[np.argsort(b.timestamps[order], kind="stable")]
        sh.ingest(RecordBatch(b.schema, b.part_keys, b.part_idx[order],
                              b.timestamps[order],
                              {"value": b.columns["value"][order]}))
    elif path == "columnar":
        sh.ingest_columns("prom-counter", _keys(PartKey, S, "req_total"),
                          ts, {"count": np.cumsum(np.abs(vals), axis=1)})
    elif path == "out_of_order":
        sh.ingest_columns("gauge", keys, ts, {"value": vals})
        # the same timestamps again (dropped as out of order) plus new ones
        sh.ingest_columns("gauge", keys, ts, {"value": vals + 1})
        sh.ingest(RecordBatch.from_grid(schemas["gauge"], keys,
                                        ts - 5_000, {"value": vals}))
        sh.ingest_columns("gauge", keys, ts + 100_000, {"value": vals})
    elif path == "duplicate_keys":
        dup = keys[:3] + keys[:3]
        sh.ingest_columns("gauge", dup, ts[:6], {"value": vals[:6]})
    return sh.stats.rows_ingested, sh.stats.rows_dropped


def _tenant_rows(pkg):
    return [{k: r[k] for k in ("ws", "ns", "ingestSamples",
                               "ingestRejected", "windowSamplesOffered")}
            for r in usage_of(pkg).snapshot()]


@pytest.mark.parametrize("path", ["grid", "flat", "columnar",
                                  "out_of_order", "duplicate_keys"])
def test_ingest_is_accounted_per_tenant_as_the_reference(pair, path):
    stats = {pkg: _drive(node, pkg, path) for pkg, node in pair.items()}
    assert stats["port"] == stats["jax"]
    assert_same_stores(pair["jax"].memstore, pair["port"].memstore)
    rows = _tenant_rows("port")
    assert rows == _tenant_rows("jax")
    assert sum(r["ingestSamples"] for r in rows) > 0
    panels = {pkg: node.get("/admin/tenants") for pkg, node in pair.items()}
    assert panels["port"] == panels["jax"]
    assert panels["port"][0] == 200
    ingest = {t["ws"]: t["ingestSamples"]
              for t in panels["port"][1]["data"]["tenants"]}
    assert sum(ingest.values()) == sum(r["ingestSamples"] for r in rows)


def test_every_path_in_one_process_adds_up(pair):
    for path in ("grid", "flat", "columnar", "out_of_order",
                 "duplicate_keys"):
        for pkg, node in pair.items():
            _drive(node, pkg, path)
    assert _tenant_rows("port") == _tenant_rows("jax")
    assert pair["port"].get("/admin/tenants") == \
        pair["jax"].get("/admin/tenants")
    assert pair["port"].get("/api/v1/usage")[1]["data"] == \
        usage_of("port").snapshot()
