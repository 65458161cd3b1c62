"""Shared fixtures of the write-door tests (tests/test_torch_remote_write.py,
test_torch_remote_read.py, test_torch_ratelimit.py, test_torch_gateway.py,
test_torch_usage.py): one node per package over the same settings, each
its package's FiloServer (the port's on the host, device="cpu"), as the
JAX package's own tests build it.
"""
import numpy as np

DS = "prometheus"


def apply_settings(cfg, settings):
    """settings: {"section.field": value}, set on a FilodbSettings."""
    for path, value in (settings or {}).items():
        section, field = path.split(".")
        setattr(getattr(cfg, section), field, value)
    return cfg


class Node:
    """A node of package `pkg` ("jax" or "port") with `shards` shards;
    `wal_dir` turns the write-ahead log on (and replays it at boot)."""

    def __init__(self, pkg, shards=2, wal_dir=None, settings=None):
        self.pkg = pkg
        self.shards = shards
        if pkg == "jax":
            from filodb_tpu.config import FilodbSettings
            from filodb_tpu.standalone import DatasetConfig, FiloServer
            kw = {}
        else:
            from filodb_tpu_torch.config import FilodbSettings
            from filodb_tpu_torch.standalone import DatasetConfig, FiloServer
            kw = {"device": "cpu"}
        cfg = apply_settings(FilodbSettings(), settings)
        if wal_dir is not None:
            cfg.wal.enabled = True
            cfg.wal.dir = str(wal_dir)
        self.srv = FiloServer(datasets=[DatasetConfig(
            DS, num_shards=shards)], config=cfg, **kw)
        self.api = self.srv.api
        self.memstore = self.srv.memstore
        self.gateway = self.srv.gateways[DS]
        self.wal = self.srv.wals.get(DS)
        self.engine = self.srv.engines[DS]

    def post(self, path, body, headers=None, params=None):
        return self.api.handle("POST", path, params or {}, body,
                               headers=headers or {})

    def get(self, path, params=None):
        return self.api.handle("GET", path, params or {}, b"")

    def close(self):
        self.srv.shutdown()


def usage_of(pkg):
    if pkg == "jax":
        from filodb_tpu.utils.usage import usage
    else:
        from filodb_tpu_torch.utils.usage import usage
    return usage


def split_headers(status, payload):
    """(status, payload without `_headers`, the headers) with the trace
    headers checked present and dropped (their ids are random)."""
    if not isinstance(payload, dict):
        return status, payload, {}
    payload = dict(payload)
    headers = dict(payload.pop("_headers", {}))
    if "X-Trace-Id" in headers:
        assert headers.pop("traceparent").split("-")[1] == \
            headers.pop("X-Trace-Id")
    return status, payload, headers


def store_dump(memstore, dataset=DS):
    """{(shard, schema, part key bytes): (ts, {column: values})} over
    every live partition, the samples each store row holds."""
    out = {}
    for shard in memstore.shards_for(dataset):
        for info in shard.partitions:
            if info is None or not shard._pid_alive[info.part_id]:
                continue
            store = shard.stores[info.schema_name]
            n = int(store.counts[info.row])
            cols = {c: np.asarray(v[info.row, :n]).copy()
                    for c, v in store.cols.items() if v is not None}
            out[(shard.shard_num, info.schema_name,
                 info.part_key.to_bytes())] = (
                store.ts[info.row, :n].copy(), cols)
    return out


def assert_same_stores(a, b):
    da, db = store_dump(a), store_dump(b)
    assert sorted(da) == sorted(db)
    for k in da:
        np.testing.assert_array_equal(da[k][0], db[k][0])
        assert sorted(da[k][1]) == sorted(db[k][1])
        for c in da[k][1]:
            assert da[k][1][c].tobytes() == db[k][1][c].tobytes(), (k, c)
