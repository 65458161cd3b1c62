"""The shared object-store segment tier in the port
(filodb_tpu_torch.persist.objectstore) against the JAX package's, over
the same compacted segments (tests/test_torch_longrange's grid: 6 gauges
x 4 one-hour windows at 1 m):

- content keys, objects and manifests are byte-identical, and each
  package decodes the other's manifest;
- the uploader's sync_shard, run_once, backlog, retries, dedup and
  failure counts match, and retries past the budget give up with
  ObjectStoreUnavailable;
- the allowed_prune_cutoff retention gate (through the compactor's
  uploader and LocalDiskColumnStore.prune_guards) and persistence_probe
  match;
- restore_from_objectstore writes the same files, byte for byte;
- make_query_tier answers the same panel as the JAX package's (within
  rtol 2e-4 / atol 1e-3, __graft_entry__.py:221) and bit-identically
  to the port's local tier;
- a bucket written by either package is restored and served by the
  other;
- objectstore.put/get/list faults trip the store's breaker
  (`objectstore:<name>` in /admin/breakers), which then fails fast.
"""
import os
import time

import numpy as np
import pytest

from filodb_tpu.parallel.breaker import breakers as jbreakers
from filodb_tpu.persist import objectstore as jobj
from filodb_tpu.utils.faults import faults as jfaults
from filodb_tpu_torch.parallel.breaker import breakers
from filodb_tpu_torch.persist import objectstore as pobj
from filodb_tpu_torch.utils.faults import faults

from test_torch_ingest import _clear_compile_journal  # noqa: F401
from test_torch_longrange import (DS, N_WINDOWS, NS, S, WINDOW, _grid, _Pkg,
                                  _vals, assert_close, assert_identical)

PKGS = {"jax": (_Pkg(False), jobj, jfaults, jbreakers),
        "port": (_Pkg(True), pobj, faults, breakers)}


@pytest.fixture(autouse=True)
def _fresh_failure_state():
    """Faults and breakers are process-wide: every test starts with both
    packages' disarmed and closed."""
    for _, _, fr, br in PKGS.values():
        fr.disarm()
        br.configure(failure_threshold=1000, open_base_s=0.01,
                     open_max_s=0.05, jitter=0.0)
        br.reset()
    yield
    for _, _, fr, br in PKGS.values():
        fr.disarm()
        br.configure()
        br.reset()


def _compacted(pkg, root):
    """A disk column store with every window flushed, compacted into
    segments -> (column store, segment store, compactor, now_ms)."""
    ts_grid = _grid()
    cs = pkg.Disk(str(root / "disk"))
    sh = pkg.memstore(column_store=cs).setup(DS, 0)
    sh.ingest_columns("gauge", pkg.pks(), np.broadcast_to(ts_grid, (S, NS)),
                      {"value": _vals()})
    sh.flush_all_groups()
    # retention keeps frames flushed in the millisecond the compaction
    # pass starts; step past it so every frame is prunable
    time.sleep(0.005)
    seg_store = pkg.Seg(str(root / "disk"))
    comp = pkg.Comp(cs, seg_store, DS, 1, window_ms=WINDOW, closed_lag_ms=0)
    now = int(ts_grid[-1]) + 10 * WINDOW
    assert comp.compact_all(now_ms=now) == N_WINDOWS
    return cs, seg_store, comp, now


def _setup(name, root, **kw):
    pkg, mod, _, _ = PKGS[name]
    cs, seg_store, comp, now = _compacted(pkg, root / name)
    store = mod.LocalObjectStore(str(root / name / "bucket"),
                                 name=f"bucket-{name}")
    up = mod.SegmentUploader(store, seg_store, DS, 1, retry_base_s=0.001,
                             retry_max_s=0.002, **kw)
    return cs, seg_store, comp, now, store, up


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for fn in files:
            p = os.path.join(dirpath, fn)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _uploader_state(up):
    return (up.uploads, up.upload_bytes, up.dedup_skips, up.retries,
            up.failures, up.retention_blocks, up.backlog_segments(),
            up.last_pass_failed, up.mounted)


def test_bucket_bytes_keys_and_manifest_are_the_reference(tmp_path):
    states = {}
    for name in PKGS:
        *_, store, up = _setup(name, tmp_path)
        assert up.mount() == 0
        assert up.sync_shard(0) == N_WINDOWS
        assert up.sync_shard(0) == 0                   # nothing stale
        states[name] = (_uploader_state(up), store)
    assert states["port"][0] == states["jax"][0]
    ours = _tree(states["port"][1].root)
    ref = _tree(states["jax"][1].root)
    assert sorted(ours) == sorted(ref)
    assert len([k for k in ours if k.startswith("objects")]) == N_WINDOWS
    for key in ref:
        assert ours[key] == ref[key], key
    for key, payload in ref.items():
        if key.startswith("objects"):
            assert pobj.content_key(payload) == jobj.content_key(payload) \
                == key.replace(os.sep, "/")
    raw = ref[os.path.join("manifests", DS, "shard-0")]
    ours_m, ref_m = pobj.ShardManifest.decode(raw), \
        jobj.ShardManifest.decode(raw)
    assert ours_m.encode() == ref_m.encode() == raw
    assert ours_m.generation == 1 and len(ours_m.entries) == N_WINDOWS
    with pytest.raises(ValueError) as a:
        pobj.ShardManifest.decode(raw[:-3])
    with pytest.raises(ValueError) as b:
        jobj.ShardManifest.decode(raw[:-3])
    assert str(a.value) == str(b.value)


def test_run_once_backlog_and_failure_budget_match(tmp_path):
    seen = {}
    for name in PKGS:
        _, _, fr, _ = PKGS[name]
        *_, store, up = _setup(name, tmp_path, max_attempts=2)
        up.mount()
        steps = []
        with fr.plan("objectstore.put", "error", first_k=10_000):
            steps.append(up.run_once())
        steps.append(_uploader_state(up))
        steps.append(up.probe()["status"])
        assert up.backlog_age_s() > 0.0
        with fr.plan("objectstore.put", "error", first_k=1):
            steps.append(up.run_once())                # retried through
        steps.append(_uploader_state(up))
        steps.append(up.probe()["status"])
        steps.append(up.run_once())
        seen[name] = steps
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == 0 and seen["port"][1][6] == N_WINDOWS
    assert seen["port"][2] == "degraded" and seen["port"][5] == "ok"
    assert seen["port"][3] == N_WINDOWS and seen["port"][6] == 0


@pytest.mark.parametrize("name", ["jax", "port"])
def test_retries_give_up_with_object_store_unavailable(tmp_path, name):
    pkg, mod, fr, _ = PKGS[name]
    *_, store, up = _setup(name, tmp_path, max_attempts=3)
    with fr.plan("objectstore.put", "error", first_k=10_000):
        with pytest.raises(mod.ObjectStoreUnavailable):
            up.sync_shard(0)
    assert (up.retries, up.failures, up.uploads) == (2, 1, 0)


def test_dedup_when_the_objects_already_exist(tmp_path):
    seen = {}
    for name in PKGS:
        _, mod, _, _ = PKGS[name]
        _, seg_store, _, _, store, up = _setup(name, tmp_path)
        up.run_once()
        os.unlink(os.path.join(store.root, "manifests", DS, "shard-0"))
        up2 = mod.SegmentUploader(store, seg_store, DS, 1, node="other")
        seen[name] = (up2.run_once(), _uploader_state(up2))
    assert seen["port"] == seen["jax"]
    assert seen["port"][1][2] == N_WINDOWS            # every put deduped


def test_retention_gate_and_probe_match(tmp_path):
    seen = {}
    for name in PKGS:
        pkg, mod, _, _ = PKGS[name]
        cs, seg_store, comp, now, store, up = _setup(name, tmp_path)
        comp.uploader = up
        up.install_prune_guard(cs)
        probe = mod.persistence_probe({DS: up})
        steps = [cs.num_chunksets(DS, 0)]
        cutoff = int(_grid()[-1]) + WINDOW
        steps.append(up.allowed_prune_cutoff(0, cutoff))
        steps.append(comp.enforce_retention(retain_raw_ms=1, now_ms=now))
        steps.append(cs.prune_chunks_before(DS, 0, cutoff))
        steps.append(up.retention_blocks)
        p = probe()
        steps.append((p["status"], p["datasets"][DS]["status"],
                      p["datasets"][DS]["mounted"]))
        up.mount()
        steps.append(up.run_once())
        steps.append(up.allowed_prune_cutoff(0, cutoff) == cutoff)
        steps.append(comp.enforce_retention(retain_raw_ms=1, now_ms=now))
        steps.append(cs.num_chunksets(DS, 0))
        p = probe()
        steps.append({k: v for k, v in p["datasets"][DS].items()
                      if k != "backlogAgeSeconds"})
        steps.append(p["status"])
        seen[name] = steps
    assert seen["port"] == seen["jax"]
    s = seen["port"]
    assert s[0] > 0 and s[1] < int(_grid()[-1])       # held back
    assert s[2] == 0 and s[3] == 0                    # nothing pruned
    assert s[5] == ("degraded", "degraded", False)
    assert s[8] == s[0] and s[9] == 0 and s[11] == "ok"


def _local_engine(pkg, seg_store):
    mapper = pkg.mapper()
    tier = pkg.Tier(seg_store, DS, 1, pkg.cold_cache())
    return pkg.engine(pkg.memstore(), mapper, pkg.Persisted(DS, mapper,
                                                            tier))


def _query_tier_engine(name, store):
    pkg, mod, _, _ = PKGS[name]
    kw = ({"device": "cpu"} if name == "port"
          else {"cold_cache": pkg.cold_cache()})
    tier, remote = mod.make_query_tier(store, DS, 1, **kw)
    assert remote.mounted and len(remote.list(DS, 0)) == N_WINDOWS
    mapper = pkg.mapper()
    return pkg.engine(pkg.memstore(), mapper,
                      pkg.Persisted(DS, mapper, tier)), remote


PANELS = ["sum(m)", "max by (inst) (avg_over_time(m[10m]))", "m"]
SPAN = (int(_grid()[0]) // 1000 + 600, int(_grid()[-1]) // 1000)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_restore_and_query_tier_over_either_bucket(tmp_path, writer):
    """One package uploads; both restore its bucket into empty segment
    stores (the same files, byte for byte, as the writer's) and serve it
    from a query-only tier: each package's query tier answers as its
    own local tier, and the two within tolerance of each other."""
    _, seg_store, _, _, store, up = _setup(writer, tmp_path)
    assert up.run_once() == N_WINDOWS
    src = _tree(seg_store.seg_dir(DS, 0))
    stats = {}
    for name in PKGS:
        pkg, mod, _, _ = PKGS[name]
        fresh = pkg.Seg(str(tmp_path / f"restored-{name}"))
        st = mod.restore_from_objectstore(store, fresh, DS, 1)
        stats[name] = (st.shards, st.segments_fetched, st.segments_present,
                       st.bytes_fetched)
        assert _tree(fresh.seg_dir(DS, 0)) == src
        again = mod.restore_from_objectstore(store, fresh, DS, 1)
        assert (again.segments_fetched, again.segments_present) == \
            (0, N_WINDOWS)
    assert stats["port"] == stats["jax"]
    assert stats["port"][1] == N_WINDOWS
    answers = {}
    for name in PKGS:
        pkg = PKGS[name][0]
        remote_eng, _ = _query_tier_engine(name, store)
        local = _local_engine(pkg, pkg.Seg(str(tmp_path / f"restored-{name}")))
        answers[name] = []
        for q in PANELS:
            got = remote_eng.query_range(q, SPAN[0], 300, SPAN[1])
            if name == "port":
                assert_identical(got, local.query_range(q, SPAN[0], 300,
                                                        SPAN[1]), q)
            answers[name].append(got)
    for q, p, j in zip(PANELS, answers["port"], answers["jax"]):
        assert_close(p, j, q)
        assert p.num_series > 0


@pytest.mark.parametrize("op", ["put", "get", "list"])
def test_faults_trip_the_breaker_then_fail_fast(tmp_path, op):
    seen = {}
    for name in PKGS:
        _, mod, fr, br = PKGS[name]
        br.configure(failure_threshold=2, open_base_s=30.0,
                     open_max_s=60.0, jitter=0.0)
        br.reset()
        store = mod.LocalObjectStore(str(tmp_path / name), name="dead")
        key, _ = store.put_object(b"payload")
        verbs = {"put": lambda: store.put_object(b"other payload"),
                 "get": lambda: store.get_object(key),
                 "list": lambda: store.list("objects")}
        errs = []
        with fr.plan(f"objectstore.{op}", "error", first_k=10):
            for _ in range(4):
                with pytest.raises(mod.ObjectStoreUnavailable) as e:
                    verbs[op]()
                errs.append("circuit open" in str(e.value))
        snap = [b for b in br.snapshot() if b["peer"] == "objectstore:dead"]
        seen[name] = (errs, store.breaker.state, len(snap),
                      snap[0]["state"] if snap else None)
    assert seen["port"] == seen["jax"]
    assert seen["port"] == ([False, False, True, True], "open", 1, "open")
