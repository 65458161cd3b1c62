"""Distributed batch downsampler: shard splits fanned out over worker
processes, restartable per split, tolerant of worker death (port of
filodb_tpu/downsample/dist_job.py; its workers run as
``python -m filodb_tpu_torch.downsample.dist_job``, and its ledgers are the
reference's, so either package's driver resumes from the other's).

ref: spark-jobs/src/main/scala/filodb/downsampler/chunk/DownsamplerMain.scala
:44-90 — the reference runs downsampling as a Spark job over Cassandra
token-range splits (splits from CassandraColumnStore.getScanSplits:53-80),
parallel across executors, restartable per split.  This rebuild
replaces Spark executors with OS worker processes over the SHARED column
store (the local-disk store here; any network ColumnStore backend works the
same way):

  - one split = one shard of the job's user-time window;
  - the driver runs up to `workers` split subprocesses concurrently, each
    invoking this module's worker mode over the store roots;
  - per-split completion lands in an atomic JSON ledger keyed by the job
    window, so a restarted driver resumes exactly where it stopped (the
    Spark analogue: per-partition task completion);
  - a worker death (any nonzero exit, incl. SIGKILL) requeues the split up
    to `max_attempts` times — matching executor-loss recovery;
  - the chunk scan is ingestion-time-widened (DownsamplerMain reads raw
    chunks by ingestion-time window so late-arriving data is caught; the
    per-sample user-time filter bounds what is rolled up).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

from filodb_tpu_torch.downsample.batch_job import DownsampleJobStats


def _split_id(shard: int, t0: int, t1: int) -> str:
    return f"{shard}:{t0}:{t1}"


class SplitLedger:
    """Atomic JSON ledger of completed splits for one job window."""

    def __init__(self, path: str):
        self.path = path
        self._doc: Dict[str, dict] = {}
        try:
            with open(path) as f:
                self._doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            self._doc = {}

    def done(self, split: str) -> bool:
        return split in self._doc

    def mark(self, split: str, stats: dict) -> None:
        self._doc[split] = stats
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._doc, f)
        os.replace(tmp, self.path)

    def completed_stats(self) -> List[dict]:
        return list(self._doc.values())


@dataclasses.dataclass
class SplitFailure:
    shard: int
    attempts: int
    last_rc: int
    last_err: str


class DistributedDownsamplerJob:
    """Driver: fan shard splits over worker subprocesses.

    raw_root / ds_root are LocalDiskColumnStore roots (the shared-store
    contract: every worker can open them independently, like Spark
    executors each opening their own Cassandra sessions)."""

    def __init__(self, raw_root: str, ds_root: str, dataset: str,
                 workers: int = 4, max_attempts: int = 3,
                 ingestion_widen_ms: Optional[int] = None,
                 resolutions: Optional[Sequence[int]] = None,
                 ledger_dir: Optional[str] = None):
        self.raw_root = raw_root
        self.ds_root = ds_root
        self.dataset = dataset
        self.workers = max(1, workers)
        self.max_attempts = max_attempts
        self.ingestion_widen_ms = ingestion_widen_ms
        self.resolutions = tuple(resolutions) if resolutions else None
        self.ledger_dir = ledger_dir or os.path.join(ds_root,
                                                     ".downsample_ledger")
        self.failures: List[SplitFailure] = []
        self.attempts: Dict[int, int] = {}

    def _ledger(self, t0: int, t1: int) -> SplitLedger:
        return SplitLedger(os.path.join(
            self.ledger_dir, f"{self.dataset}_{t0}_{t1}.json"))

    def _spawn(self, shard: int, t0: int, t1: int
               ) -> Tuple[subprocess.Popen, str, str]:
        fd, stats_path = tempfile.mkstemp(prefix=f"dsw_{shard}_",
                                          suffix=".json")
        os.close(fd)
        err_path = stats_path + ".err"
        cmd = [sys.executable, "-m", "filodb_tpu_torch.downsample.dist_job",
               "--worker", "--raw-root", self.raw_root,
               "--ds-root", self.ds_root, "--dataset", self.dataset,
               "--shard", str(shard), "--t0", str(t0), "--t1", str(t1),
               "--stats-out", stats_path]
        if self.ingestion_widen_ms is not None:
            cmd += ["--ingestion-widen-ms", str(self.ingestion_widen_ms)]
        if self.resolutions:
            cmd += ["--resolutions",
                    ",".join(str(r) for r in self.resolutions)]
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [repo_root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                           else []))
        # stderr to a FILE, not a pipe: an undrained pipe blocks a chatty
        # worker at ~64KiB and would hang the whole job
        with open(err_path, "w") as errf:
            proc = subprocess.Popen(cmd, env=env,
                                    stdout=subprocess.DEVNULL, stderr=errf)
        return proc, stats_path, err_path

    def run(self, shards: Sequence[int], user_time_start: int,
            user_time_end: int) -> DownsampleJobStats:
        """Blocks until every split completed or exhausted its attempts.
        Raises RuntimeError when any split ultimately failed; completed
        splits stay in the ledger either way, so a rerun resumes."""
        t0, t1 = int(user_time_start), int(user_time_end)
        ledger = self._ledger(t0, t1)
        pending: List[int] = [s for s in shards
                              if not ledger.done(_split_id(s, t0, t1))]
        self.attempts = {s: 0 for s in pending}
        self.failures = []
        active: Dict[subprocess.Popen, Tuple[int, str, str]] = {}
        try:
            while pending or active:
                while pending and len(active) < self.workers:
                    shard = pending.pop(0)
                    self.attempts[shard] += 1
                    proc, stats_path, err_path = self._spawn(shard, t0, t1)
                    active[proc] = (shard, stats_path, err_path)
                self._reap(active, pending, ledger, t0, t1)
                if active:
                    time.sleep(0.05)
        finally:
            for proc, (_, stats_path, err_path) in active.items():
                proc.kill()
                proc.wait()
                for p in (stats_path, err_path):
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
        agg = DownsampleJobStats()
        for st in ledger.completed_stats():
            agg.parts_scanned += st.get("parts_scanned", 0)
            agg.chunks_read += st.get("chunks_read", 0)
            agg.records_emitted += st.get("records_emitted", 0)
            agg.chunks_written += st.get("chunks_written", 0)
        if self.failures:
            raise RuntimeError(
                f"{len(self.failures)} split(s) failed after "
                f"{self.max_attempts} attempts: "
                + ", ".join(f"shard {f.shard} rc={f.last_rc}"
                            for f in self.failures))
        return agg

    def _reap(self, active, pending, ledger, t0, t1) -> None:
        for proc in [p for p in active if p.poll() is not None]:
            shard, stats_path, err_path = active.pop(proc)
            try:
                with open(err_path) as f:
                    err = f.read()
            except OSError:
                err = ""
            stats = None
            if proc.returncode == 0:
                try:
                    with open(stats_path) as f:
                        stats = json.load(f)
                except (OSError, json.JSONDecodeError):
                    stats = None
            for p in (stats_path, err_path):
                try:
                    os.unlink(p)
                except OSError:
                    pass
            if stats is not None:
                stats["attempts"] = self.attempts[shard]
                ledger.mark(_split_id(shard, t0, t1), stats)
            elif self.attempts[shard] < self.max_attempts:
                pending.append(shard)       # executor-loss recovery
            else:
                self.failures.append(SplitFailure(
                    shard, self.attempts[shard], proc.returncode,
                    err.strip()[-300:]))


# ------------------------------------------------------------- worker mode

def _worker_main(args) -> int:
    # deterministic-death test hook: die by SIGKILL on first attempt for
    # the configured shard (marker file distinguishes attempts)
    die_marker = os.environ.get("FILODB_DS_DIE_MARKER")
    die_shard = os.environ.get("FILODB_DS_DIE_SHARD")
    if die_marker and die_shard and int(die_shard) == args.shard \
            and not os.path.exists(die_marker):
        with open(die_marker, "w") as f:
            f.write("died once\n")
        os.kill(os.getpid(), signal.SIGKILL)

    from filodb_tpu_torch.downsample.batch_job import DownsamplerJob
    from filodb_tpu_torch.persist.localstore import LocalDiskColumnStore

    raw = LocalDiskColumnStore(args.raw_root)
    ds = LocalDiskColumnStore(args.ds_root)
    kw = {}
    if args.resolutions:
        kw["resolutions"] = [int(r) for r in args.resolutions.split(",")]
    job = DownsamplerJob(raw, ds, args.dataset, **kw)
    ingestion_window = None
    if args.ingestion_widen_ms is not None:
        ingestion_window = (args.t0 - args.ingestion_widen_ms,
                            int(time.time() * 1000) + 60_000)
    stats = job.run([args.shard], args.t0, args.t1,
                    ingestion_window=ingestion_window)
    with open(args.stats_out, "w") as f:
        json.dump(dataclasses.asdict(stats), f)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--raw-root", required=True)
    ap.add_argument("--ds-root", required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--shard", type=int)
    ap.add_argument("--t0", type=int)
    ap.add_argument("--t1", type=int)
    ap.add_argument("--stats-out")
    ap.add_argument("--ingestion-widen-ms", type=int, default=None)
    ap.add_argument("--resolutions", default="")
    args = ap.parse_args(argv)
    if not args.worker:
        raise SystemExit("driver use is programmatic; pass --worker")
    return _worker_main(args)


if __name__ == "__main__":
    sys.exit(main())
