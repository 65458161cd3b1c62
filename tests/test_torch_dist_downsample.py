"""The port's distributed batch downsampler
(filodb_tpu_torch/downsample/dist_job.py) against the JAX package's,
modelled on tests/test_dist_downsample.py: worker fan-out equal to the
sequential job (and to the reference's sequential job), a killed worker's
split requeued, resume from the split ledger (one the reference's driver
wrote, too), an exhausted split, and the ingestion-time-widened scan.

Each port worker is a `python -m filodb_tpu_torch.downsample.dist_job`
process that imports torch, so the raw stores hold two shards and the
cases spawn few workers.
"""
import json
import os
import time

import numpy as np
import pytest

START = 1_600_000_020_000
T = 240
N_SHARDS = 2
N_SERIES = 6
RES = 300_000
T0, T1 = START, START + T * 10_000


def _mk_raw(tmp_path, n_shards=N_SHARDS):
    """A raw LocalDiskColumnStore of n_shards x N_SERIES gauges, flushed
    by the port (the reference reads it as its own)."""
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.core.store import InMemoryMetaStore
    from filodb_tpu_torch.ingest.generator import gauge_batch
    from filodb_tpu_torch.persist.localstore import LocalDiskColumnStore
    raw_root = str(tmp_path / "raw")
    cs = LocalDiskColumnStore(raw_root)
    ms = TimeSeriesMemStore(column_store=cs, meta_store=InMemoryMetaStore(),
                            device="cpu")
    for sh in range(n_shards):
        s = ms.setup("prometheus", sh)
        s.ingest(gauge_batch(N_SERIES, T, start_ms=START, seed=sh))
        s.flush_all_groups()
    cs.close()
    return raw_root


def _decoded(ds_root, n_shards=N_SHARDS):
    """{(shard, part key bytes): decoded columns} of the RES dataset."""
    from filodb_tpu_torch.downsample.store import ds_dataset_name
    from filodb_tpu_torch.memory.chunks import decode_chunkset
    from filodb_tpu_torch.persist.localstore import LocalDiskColumnStore
    cs = LocalDiskColumnStore(ds_root)
    name = ds_dataset_name("prometheus", RES)
    out = {}
    for sh in range(n_shards):
        for rec in cs.read_part_keys(name, sh):
            (chunk,) = cs.read_chunks(name, sh, rec.part_key, 0, 1 << 62)
            out[(sh, rec.part_key.to_bytes())] = decode_chunkset(chunk)
    cs.close()
    return out


def _same_decoded(a, b):
    assert a.keys() == b.keys() and a
    for k in a:
        assert a[k].keys() == b[k].keys()
        for col in a[k]:
            np.testing.assert_array_equal(a[k][col], b[k][col])


def _job(raw_root, ds_root, **kw):
    from filodb_tpu_torch.downsample.dist_job import \
        DistributedDownsamplerJob
    kw.setdefault("workers", 2)
    return DistributedDownsamplerJob(raw_root, ds_root, "prometheus",
                                     resolutions=(RES,), **kw)


def test_distributed_equals_sequential_and_the_reference(tmp_path):
    from filodb_tpu.downsample.batch_job import DownsamplerJob as JJob
    from filodb_tpu.persist.localstore import LocalDiskColumnStore as JDisk
    from filodb_tpu_torch.downsample.batch_job import DownsamplerJob
    from filodb_tpu_torch.persist.localstore import LocalDiskColumnStore
    raw_root = _mk_raw(tmp_path)
    seq_root, ref_root = str(tmp_path / "seq"), str(tmp_path / "ref")
    seq = DownsamplerJob(LocalDiskColumnStore(raw_root),
                         LocalDiskColumnStore(seq_root), "prometheus",
                         resolutions=(RES,)).run(list(range(N_SHARDS)),
                                                 T0, T1)
    ref = JJob(JDisk(raw_root), JDisk(ref_root), "prometheus",
               resolutions=(RES,)).run(list(range(N_SHARDS)), T0, T1)
    dist_root = str(tmp_path / "dist")
    job = _job(raw_root, dist_root)
    stats = job.run(list(range(N_SHARDS)), T0, T1)
    assert vars(stats) == vars(seq) == vars(ref)
    assert stats.parts_scanned == N_SHARDS * N_SERIES
    assert job.attempts == {s: 1 for s in range(N_SHARDS)}
    _same_decoded(_decoded(dist_root), _decoded(seq_root))
    _same_decoded(_decoded(dist_root), _decoded(ref_root))


def test_worker_sigkill_requeues_split(tmp_path, monkeypatch):
    raw_root = _mk_raw(tmp_path)
    marker = str(tmp_path / "died.marker")
    monkeypatch.setenv("FILODB_DS_DIE_MARKER", marker)
    monkeypatch.setenv("FILODB_DS_DIE_SHARD", "1")
    dist_root = str(tmp_path / "dist")
    job = _job(raw_root, dist_root)
    stats = job.run(list(range(N_SHARDS)), T0, T1)
    assert os.path.exists(marker), "the hook should have fired"
    assert job.attempts == {0: 1, 1: 2}
    assert stats.parts_scanned == N_SHARDS * N_SERIES
    assert {sh for sh, _ in _decoded(dist_root)} == {0, 1}


def _ledger_path(root):
    return os.path.join(root, ".downsample_ledger",
                        f"prometheus_{T0}_{T1}.json")


def test_split_ledger_file_equals_the_reference(tmp_path):
    from filodb_tpu.downsample.dist_job import SplitLedger as JLedger
    from filodb_tpu.downsample.dist_job import _split_id as jsid
    from filodb_tpu_torch.downsample.dist_job import SplitLedger, _split_id
    paths = [str(tmp_path / pkg / "l.json") for pkg in ("jax", "port")]
    ledgers = [JLedger(paths[0]), SplitLedger(paths[1])]
    for sh in (3, 0, 7):
        sid = _split_id(sh, T0, T1)
        assert sid == jsid(sh, T0, T1)
        for led in ledgers:
            led.mark(sid, {"parts_scanned": sh, "chunks_read": 2 * sh,
                           "records_emitted": 3, "chunks_written": 1,
                           "attempts": 1})
    blobs = [open(p, "rb").read() for p in paths]
    assert blobs[0] == blobs[1]
    # each package reads the other's file
    assert SplitLedger(paths[0]).completed_stats() == \
        JLedger(paths[1]).completed_stats()
    assert SplitLedger(paths[0]).done(_split_id(7, T0, T1))
    # a torn or missing file is an empty ledger, as in the reference
    with open(paths[1], "w") as f:
        f.write("{not json")
    assert SplitLedger(paths[1]).completed_stats() == []


def test_resume_from_a_ledger_the_reference_wrote(tmp_path):
    """The reference's driver completes shard 0; the port's driver over
    both shards runs only shard 1 and aggregates both from the ledger; a
    rerun of the port's (and of the reference's) driver runs nothing."""
    from filodb_tpu.downsample.dist_job import \
        DistributedDownsamplerJob as JDist
    raw_root = _mk_raw(tmp_path)
    dist_root = str(tmp_path / "dist")
    jfirst = JDist(raw_root, dist_root, "prometheus", workers=1,
                   resolutions=(RES,)).run([0], T0, T1)
    assert jfirst.parts_scanned == N_SERIES
    with open(_ledger_path(dist_root)) as f:
        assert list(json.load(f)) == [f"0:{T0}:{T1}"]
    job = _job(raw_root, dist_root)
    stats = job.run(list(range(N_SHARDS)), T0, T1)
    assert job.attempts == {1: 1}
    assert stats.parts_scanned == N_SHARDS * N_SERIES
    again = _job(raw_root, dist_root)
    assert vars(again.run(list(range(N_SHARDS)), T0, T1)) == vars(stats)
    assert again.attempts == {}
    jagain = JDist(raw_root, dist_root, "prometheus", workers=1,
                   resolutions=(RES,))
    assert vars(jagain.run(list(range(N_SHARDS)), T0, T1)) == vars(stats)
    assert jagain.attempts == {}


def test_exhausted_split_raises_then_resumes(tmp_path, monkeypatch):
    from filodb_tpu_torch.downsample.dist_job import SplitLedger, _split_id
    raw_root = _mk_raw(tmp_path)
    monkeypatch.setenv("FILODB_DS_DIE_MARKER",
                       str(tmp_path / "never-created" / "marker"))
    monkeypatch.setenv("FILODB_DS_DIE_SHARD", "1")
    dist_root = str(tmp_path / "dist")
    job = _job(raw_root, dist_root, max_attempts=2)
    with pytest.raises(RuntimeError, match="shard 1"):
        job.run(list(range(N_SHARDS)), T0, T1)
    assert job.attempts == {0: 1, 1: 2}
    # the hook cannot write its marker there, so each attempt dies
    assert [(f.shard, f.attempts) for f in job.failures] == [(1, 2)]
    assert job.failures[0].last_rc != 0
    assert "FileNotFoundError" in job.failures[0].last_err
    ledger = SplitLedger(_ledger_path(dist_root))
    assert ledger.done(_split_id(0, T0, T1))
    assert not ledger.done(_split_id(1, T0, T1))
    monkeypatch.delenv("FILODB_DS_DIE_MARKER")
    monkeypatch.delenv("FILODB_DS_DIE_SHARD")
    job2 = _job(raw_root, dist_root)
    stats = job2.run(list(range(N_SHARDS)), T0, T1)
    assert job2.attempts == {1: 1}
    assert stats.parts_scanned == N_SHARDS * N_SERIES


def test_ingestion_widened_scan(tmp_path):
    """Chunks are selected by ingestion time when a window is given: a
    window covering the flush rolls everything up, one before it selects
    nothing; both packages count the same."""
    from filodb_tpu.downsample.batch_job import DownsamplerJob as JJob
    from filodb_tpu.persist.localstore import LocalDiskColumnStore as JDisk
    from filodb_tpu_torch.downsample.batch_job import DownsamplerJob
    from filodb_tpu_torch.persist.localstore import LocalDiskColumnStore
    raw_root = _mk_raw(tmp_path, n_shards=1)
    now = int(time.time() * 1000)
    for window, parts in (((now - 3_600_000, now + 60_000), N_SERIES),
                          ((now - 7_200_000, now - 3_600_000), 0)):
        got = []
        for Job, Disk, name in ((DownsamplerJob, LocalDiskColumnStore, "p"),
                                (JJob, JDisk, "j")):
            job = Job(Disk(raw_root), Disk(str(tmp_path / f"{name}{parts}")),
                      "prometheus", resolutions=(RES,))
            got.append(vars(job.run([0], T0, T1, ingestion_window=window)))
        assert got[0] == got[1]
        assert got[0]["parts_scanned"] == parts
        assert (got[0]["records_emitted"] > 0) == (parts > 0)


def test_distributed_uses_widened_ingestion_scan(tmp_path):
    raw_root = _mk_raw(tmp_path)
    job = _job(raw_root, str(tmp_path / "dist"),
               ingestion_widen_ms=3_600_000)
    stats = job.run(list(range(N_SHARDS)), T0, T1)
    assert stats.parts_scanned == N_SHARDS * N_SERIES
    assert stats.records_emitted > 0
