"""The port's operator CLI (python -m filodb_tpu_torch.cli) against the
JAX package's filo-cli:

- every subcommand of the reference's build_parser exists with the same
  options, plus `--device {cuda,cpu}` on the commands that open a
  memstore;
- each offline command over one data directory that the reference's CLI
  wrote prints what the reference prints (the JSON of `query` and
  `querybatch` within rtol 2e-4 / atol 1e-3), and `exportbundle` writes
  the reference's arrays;
- `serve --device cpu` runs as a subprocess that answers `query --host`,
  shows its shards and ready phase, and flushes on SIGINT, its data then
  read back by the offline commands.
"""
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from filodb_tpu import cli as jcli
from filodb_tpu_torch import cli

from test_torch_ingest import _clear_compile_journal  # noqa: F401

START = 1_600_000_020_000
START_S = START // 1000
RTOL, ATOL = 2e-4, 1e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _options(parser):
    """{command: {option: (dest, default, required, choices, nargs)}}."""
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    out = {}
    for name, sp in sub.choices.items():
        opts = {}
        for a in sp._actions:
            if a.dest == "help":
                continue
            key = "/".join(a.option_strings) or a.dest
            opts[key] = (a.dest, a.default, a.required,
                         tuple(a.choices) if a.choices else None, a.nargs,
                         getattr(a.type, "__name__", None))
        out[name] = opts
    return out


MEMSTORE_COMMANDS = {"init", "importcsv", "exportbundle", "importbundle",
                     "indexnames", "indexvalues", "topkcard", "query",
                     "querybatch", "decodechunks", "chunkinfos",
                     "decodevector", "serve"}


def test_subcommands_and_options_equal_the_reference_plus_device():
    ref, port = _options(jcli.build_parser()), _options(cli.build_parser())
    assert sorted(port) == sorted(ref)
    assert len(ref) == 29
    for name in ref:
        got = dict(port[name])
        if name in MEMSTORE_COMMANDS:
            assert got.pop("--device") == (
                "device", "cuda", False, ("cuda", "cpu"), None, None), name
        assert got == ref[name], name


def _run(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """A data directory the reference's CLI wrote: init, a CSV import of
    gauges and an NPZ bundle of counters, both flushed to disk."""
    from filodb_tpu.core.index import Equals
    from filodb_tpu.core.memstore import TimeSeriesMemStore
    from filodb_tpu.ingest.generator import counter_batch
    from filodb_tpu.jobs.batch_io import export_series
    root = tmp_path_factory.mktemp("cli")
    d = str(root / "data")
    assert jcli.main(["init", "--data-dir", d]) == 0
    rng = np.random.default_rng(16)
    rows = ["metric,tags,timestamp,value"]
    for i in range(90):
        rows.append(f"cpu_load,host=h{i % 3},{START + i * 10_000},"
                    f"{float(rng.integers(0, 1000)) / 8}")
    (root / "in.csv").write_text("\n".join(rows))
    assert jcli.main(["importcsv", "--data-dir", d,
                      "--file", str(root / "in.csv")]) == 0
    ms = TimeSeriesMemStore()
    ms.setup("prometheus", 0).ingest(counter_batch(12, 90, start_ms=START),
                                     offset=1)
    bundle = str(root / "counters.npz")
    assert export_series(ms, "prometheus",
                         [Equals("_metric_", "request_total")],
                         START, START + 10**7, bundle) == 12
    assert jcli.main(["importbundle", "--data-dir", d,
                      "--bundle", bundle]) == 0
    return root, d, bundle


def _frame_hex(d):
    from filodb_tpu.persist.localstore import LocalDiskColumnStore
    cs = LocalDiskColumnStore(os.path.join(d, "chunks"))
    rec = cs.read_part_keys("prometheus", 0)[0]
    chunk = cs.read_chunks("prometheus", 0, rec.part_key, 0, 1 << 62)[0]
    from filodb_tpu.persist.localstore import _encode_chunkset_frame
    return _encode_chunkset_frame(rec.part_key, rec.schema_name,
                                  chunk).hex()


OFFLINE = [
    ["list"],
    ["indexnames"],
    ["indexvalues", "--label", "host"],
    ["indexvalues", "--label", "_ns_", "--limit", "3"],
    ["topkcard"],
    ["topkcard", "--prefix", "demo", "--k", "4"],
    ["decodechunks", "--limit", "30"],
    ["decodevector", "--metric", "cpu_load", "--rows", "3"],
    ["chunkinfos", 'cpu_load{host="h1"}'],
    ["chunkinfos", 'request_total{_ns_="App-2"}', "--limit", "5"],
    ["partkey", 'cpu_load{_ws_="demo",host="h1"}', "--num-shards", "16"],
    ["partkey", '{__name__!="x",_ws_="demo"}'],
    ["validateSchemas"],
    ["decodechunkinfo", None],
]


@pytest.mark.parametrize("argv", OFFLINE, ids=lambda a: " ".join(
    x for x in a if x)[:40])
def test_offline_command_prints_what_the_reference_prints(data_dir, argv,
                                                          capsys):
    _, d, _ = data_dir
    argv = list(argv)
    if argv[0] == "decodechunkinfo":
        argv[1] = _frame_hex(d)
    needs_dir = argv[0] not in ("partkey", "validateSchemas",
                                "decodechunkinfo")
    extra = ["--data-dir", d] if needs_dir else []
    dev = ["--device", "cpu"] if argv[0] in MEMSTORE_COMMANDS else []
    want = _run(jcli.main, argv + extra, capsys)
    got = _run(cli.main, argv + extra + dev, capsys)
    assert got == want
    assert got[1].strip() or argv[0] == "partkey"


def _matrices(payload):
    results = payload["results"] if "results" in payload else [payload]
    out = []
    for r in results:
        assert r["status"] == "success", r
        out.append({tuple(sorted(s["metric"].items())):
                    (np.array([t for t, _ in s["values"]]),
                     np.array([float(v) for _, v in s["values"]]))
                    for s in r["data"]["result"]})
    return out


def _assert_same_payloads(got, want):
    # an HTTP answer carries its trace id; a local one has none
    assert got.keys() - {"traceID"} == want.keys() - {"traceID"}
    for a, b in zip(_matrices(got), _matrices(want)):
        assert sorted(a) == sorted(b) and a
        for k in a:
            np.testing.assert_array_equal(a[k][0], b[k][0])
            np.testing.assert_allclose(a[k][1], b[k][1], rtol=RTOL,
                                       atol=ATOL, equal_nan=True)


QUERY_RANGE = ["--start", str(START_S + 300), "--end", str(START_S + 890),
               "--step", "60", "--raw"]


@pytest.mark.parametrize("argv", [
    ["query", "--promql", "sum by (_ns_) (rate(request_total[5m]))"],
    ["query", "--promql", 'max by (host) (cpu_load{host=~"h[01]"})'],
    ["querybatch", "--promql", "sum by (_ns_) (rate(request_total[5m]))",
     "--promql", "avg(cpu_load)", "--promql", "bad{{{"],
], ids=["rate", "gauge", "batch"])
def test_local_query_answers_as_the_reference(data_dir, argv, capsys):
    _, d, _ = data_dir
    rc_j, out_j = _run(jcli.main, argv + QUERY_RANGE + ["--data-dir", d],
                       capsys)
    rc_p, out_p = _run(cli.main, argv + QUERY_RANGE + [
        "--data-dir", d, "--device", "cpu"], capsys)
    assert rc_p == rc_j
    want, got = json.loads(out_j), json.loads(out_p)
    if argv[0] == "querybatch":
        assert [r["status"] for r in got["results"]] == \
            [r["status"] for r in want["results"]] == \
            ["success", "success", "error"]
        got["results"], want["results"] = got["results"][:2], \
            want["results"][:2]
    _assert_same_payloads(got, want)


def test_exportbundle_writes_the_reference_arrays(data_dir, capsys):
    root, d, bundle = data_dir
    args = ["exportbundle", "--data-dir", d, "--metric", "request_total",
            "--start", str(START), "--end", str(START + 10**7)]
    want = _run(jcli.main, args + ["--out", str(root / "j.npz")], capsys)
    got = _run(cli.main, args + ["--out", str(root / "p.npz"),
                                 "--device", "cpu"], capsys)
    assert got[0] == want[0] == 0
    assert got[1].replace("p.npz", "j.npz") == want[1]
    with np.load(root / "p.npz") as a, np.load(root / "j.npz") as b, \
            np.load(bundle) as c:
        assert sorted(a.files) == sorted(b.files) == sorted(c.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_filter_without_equals_is_refused_as_the_reference(data_dir,
                                                           capsys):
    _, d, _ = data_dir
    args = ["exportbundle", "--data-dir", d, "--filter", "host", "--start",
            "0", "--end", "1", "--out", os.devnull]
    capsys.readouterr()
    assert jcli.main(args) == 2
    want = capsys.readouterr().err
    assert cli.main(args + ["--device", "cpu"]) == 2
    assert capsys.readouterr().err == want


def test_checkrules_prints_what_the_reference_prints(tmp_path, capsys):
    good = tmp_path / "rules.json"
    good.write_text(json.dumps({"groups": [{"name": "g", "interval": "30s",
                                            "rules": [
        {"record": "ns:x:rate5m", "expr": "sum(rate(x[5m]))"},
        {"alert": "High", "expr": "ns:x:rate5m > 1", "for": "1m"}]}]}))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"groups": [{"name": "g", "rules": [
        {"record": "y", "expr": "sum(((("}]}]}))
    for f in (good, bad):
        capsys.readouterr()
        rc_j = jcli.main(["checkrules", str(f)])
        want = capsys.readouterr()
        rc_p = cli.main(["checkrules", str(f)])
        got = capsys.readouterr()
        assert (rc_p, got.out, got.err) == (rc_j, want.out, want.err)


def test_http_commands_print_a_refused_route_as_the_reference(capsys):
    """Against a server the CLI cannot reach each HTTP command prints the
    error JSON; against a server without federation `federation` prints
    what the reference's CLI prints (the route answers an empty cluster
    list since federation was ported)."""
    from filodb_tpu_torch.standalone import DatasetConfig, FiloServer
    srv = FiloServer([DatasetConfig("prometheus", 1)], device="cpu")
    srv.start(background_flush=False)
    host = f"127.0.0.1:{srv.http.port}"
    try:
        rc, out = _run(cli.main, ["federation", "--host", host], capsys)
        assert (rc, out) == _run(jcli.main, ["federation", "--host", host],
                                 capsys)
        assert rc == 0 and "federation not configured" in out
        rc, out = _run(cli.main, ["shards", "--host", host, "--raw"], capsys)
        assert rc == 0
        assert json.loads(out)["data"]["datasets"]["prometheus"][
            "numShards"] == 1
        rc, out = _run(cli.main, ["status", "--host", host], capsys)
        assert rc == 0 and json.loads(out)["data"][0]["status"] == "Active"
    finally:
        srv.shutdown()
    rc, out = _run(cli.main, ["health", "--host", host], capsys)
    assert rc == 2 and "cannot reach" in json.loads(out)["error"]


def test_federation_and_shards_print_real_payloads(capsys):
    """`federation` against a federated pair's east and `shards` against
    a replicated node print the rows the reference's CLI prints for the
    same server."""
    from filodb_tpu_torch.parallel.breaker import breakers
    from filodb_tpu_torch.parallel.testcluster import make_federated_pair
    pair = make_federated_pair(device="cpu")
    try:
        pair.east.federation_registry.probe_once()
        host = f"127.0.0.1:{pair.east.http.port}"
        rc, out = _run(cli.main, ["federation", "--host", host], capsys)
        assert (rc, out) == _run(jcli.main, ["federation", "--host", host],
                                 capsys)
        assert rc == 0 and "local cluster: 'east'" in out
        assert any(line.startswith("west ") and " up " in line
                   for line in out.splitlines())
        pair.kill_west()
        pair.east.federation_registry.probe_once()
        rc, out = _run(cli.main, ["federation", "--host", host], capsys)
        assert rc == 1 and " DOWN " in out
    finally:
        pair.stop()
        breakers.reset()
    from filodb_tpu_torch.config import FilodbSettings
    from filodb_tpu_torch.standalone import DatasetConfig, FiloServer
    cfg = FilodbSettings()
    cfg.replication.enabled = True
    peer = FiloServer([DatasetConfig("prometheus", 2)], config=cfg,
                      node_name="B", device="cpu")
    peer.start(background_flush=False)
    node = FiloServer([DatasetConfig("prometheus", 2)], config=cfg,
                      node_name="A", device="cpu",
                      replication_peers={
                          "B": peer.replication_server.address})
    node.start(background_flush=False)
    try:
        host = f"127.0.0.1:{node.http.port}"
        rc, out = _run(cli.main, ["shards", "--host", host], capsys)
        assert (rc, out) == _run(jcli.main, ["shards", "--host", host],
                                 capsys)
        assert rc == 0 and "rf=2" in out and "B(Active)" in out
    finally:
        node.shutdown()
        peer.shutdown()


def _serve(d, timeout_s=120):
    """`python -m filodb_tpu_torch.cli serve --device cpu` over `d` ->
    (process, host:port); its stdout is a pipe."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "filodb_tpu_torch.cli", "serve",
         "--data-dir", d, "--port", "0", "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    import select
    ready, _, _ = select.select([proc.stdout], [], [], timeout_s)
    line = proc.stdout.readline() if ready else ""
    if not line.startswith("serving prometheus on "):
        proc.kill()
        raise AssertionError(f"serve did not start: {line!r}"
                             f"{proc.communicate(timeout=30)[0]}")
    return proc, line.split()[-1]


def test_serve_subprocess_answers_query_and_flushes_on_sigint(data_dir,
                                                              tmp_path,
                                                              capsys):
    import shutil
    _, src, _ = data_dir
    d = str(tmp_path / "data")
    shutil.copytree(src, d)
    proc, host = _serve(d)
    try:
        rc, out = _run(cli.main, ["query", "--host", host, "--promql",
                                  "sum by (_ns_) (rate(request_total[5m]))"]
                       + QUERY_RANGE, capsys)
        assert rc == 0
        rc_j, out_j = _run(jcli.main, [
            "query", "--data-dir", src, "--promql",
            "sum by (_ns_) (rate(request_total[5m]))"] + QUERY_RANGE, capsys)
        _assert_same_payloads(json.loads(out), json.loads(out_j))
        assert _run(cli.main, ["health", "--host", host, "--ready"],
                    capsys)[0] == 0
        # a sample the server holds only in memory until its final flush
        from filodb_tpu_torch.http import remotepb
        from filodb_tpu_torch.utils import snappy
        body = snappy.compress(remotepb.encode_write_request([
            remotepb.PromTimeSeries(
                [("__name__", "late_total"), ("_ws_", "demo"),
                 ("_ns_", "App-0")], [(1.0, START + 1_000_000)])]))
        from urllib.request import Request, urlopen
        with urlopen(Request(f"http://{host}/api/v1/write", data=body,
                             method="POST"), timeout=60) as r:
            assert r.status == 204
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode == 0, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    rc, out = _run(cli.main, ["indexvalues", "--data-dir", d, "--label",
                              "_metric_", "--device", "cpu"], capsys)
    assert rc == 0 and "late_total" in out
