"""Standalone cluster node process (port of filodb_tpu/parallel/nodeapp.py).

The multi-process analogue of the reference's FiloDB standalone node
(ref: standalone/.../FiloServer.scala + multi-jvm IngestionAndRecoverySpec):
one process = memstore + query-plan server + cluster agent (register /
heartbeat / assignment application with index recovery), plus a small
framed-JSON control socket the test harness uses as its ingest feed (the
Kafka-consumer stand-in: every node sees the full stream and ingests only
the shards it owns).

Run: python -m filodb_tpu_torch.parallel.nodeapp --name A \
         --coordinator 127.0.0.1:9999 --data-dir DIR [--platform cpu]

`--platform` is the reference's flag: `cpu` runs the node's memstore
and queries on the CPU; empty (the default), `gpu` or `cuda` on the
card.  `--device {cuda,cpu}` says the same in the port's words; given
both, they must agree.  Prints one JSON line {"ready": true,
"query_port": N, "control_port": N, "replication_port": N, "node":
NAME} on stdout once serving; `replication_port` is the node's replication door
(replication/service.py), which peers fan ingest slabs into and a
joining replica streams WAL segments and handoff snapshots out of.
"""
from __future__ import annotations

import argparse
import json
import socketserver
import sys
import threading

# --platform's values and the device each runs the node on
PLATFORMS = {"": "cuda", "cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--name", required=True)
    ap.add_argument("--coordinator", required=True, help="host:port")
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--store-url", default="",
                    help="host:port of a chunk service (persist/netstore) — "
                         "the node then needs NO shared filesystem; default "
                         "is the local-disk store in --data-dir")
    ap.add_argument("--platform", default="", choices=PLATFORMS,
                    help="where the memstore and its queries run: cpu, or "
                         "the card (empty, gpu or cuda)")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="the same as --platform, in the port's words")
    ap.add_argument("--heartbeat-interval", type=float, default=0.5)
    args = ap.parse_args(argv)
    device = PLATFORMS[args.platform]
    if args.device is not None:
        if args.platform and args.device != device:
            ap.error(f"--platform {args.platform} and --device "
                     f"{args.device} disagree")
        device = args.device

    from filodb_tpu_torch.utils import metrics as _metrics
    _metrics.NODE_NAME = args.name       # stamp this node on trace spans
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.gateway.influx import influx_lines_to_batches
    from filodb_tpu_torch.gateway.router import split_batch_by_shard
    from filodb_tpu_torch.parallel.cluster import (ClusterClient, NodeAgent,
                                                   _recv_json, _send_json)
    from filodb_tpu_torch.parallel.shardmapper import SpreadProvider
    from filodb_tpu_torch.parallel.transport import NodeQueryServer
    from filodb_tpu_torch.persist.localstore import (LocalDiskColumnStore,
                                                     LocalDiskMetaStore)

    host, port = args.coordinator.rsplit(":", 1)
    coord_addr = (host, int(port))
    if args.store_url:
        # shared NETWORK store (ref: CassandraColumnStore — a remote
        # service every node reads through; failover recovery included)
        from filodb_tpu_torch.persist.netstore import (RemoteColumnStore,
                                                       RemoteMetaStore)
        s_host, s_port = args.store_url.rsplit(":", 1)
        column_store = RemoteColumnStore(s_host, int(s_port))
        meta_store = RemoteMetaStore(s_host, int(s_port))
    else:
        column_store = LocalDiskColumnStore(args.data_dir)
        meta_store = LocalDiskMetaStore(args.data_dir)
    memstore = TimeSeriesMemStore(column_store=column_store,
                                  meta_store=meta_store, device=device)
    qsrv = NodeQueryServer(memstore).start()
    # replication door (filodb_tpu_torch/replication): peers fan ingest
    # slabs here, and a joining replica streams WAL segments / handoff
    # snapshots out of it
    from filodb_tpu_torch.replication import ReplicationServer
    rsrv = ReplicationServer(memstore, node=args.name).start()

    def on_assign(dataset: str, shard: int) -> None:
        sh = memstore.get_shard(dataset, shard) or \
            memstore.setup(dataset, shard)
        # recovery-by-replay: rebuild the index from persisted part keys;
        # historical chunk data pages in on demand at query time
        sh.recover_index()

    agent = NodeAgent(args.name, coord_addr, qsrv.address, on_assign,
                      heartbeat_interval_s=args.heartbeat_interval)
    client = ClusterClient(coord_addr)
    spread = SpreadProvider(default_spread=1)

    class _Control(socketserver.BaseRequestHandler):
        def handle(self):
            try:
                while True:
                    req = _recv_json(self.request)
                    try:
                        reply = _control(req)
                    except Exception as e:  # noqa: BLE001
                        reply = {"ok": False,
                                 "error": f"{type(e).__name__}: {e}"}
                    _send_json(self.request, reply)
            except (ConnectionError, OSError, json.JSONDecodeError):
                return

    def _control(req):
        cmd = req.get("cmd")
        if cmd == "ping":
            return {"ok": True, "owned": agent.owned}
        if cmd == "ingest_lines":
            dataset = req.get("dataset", "prometheus")
            mapper, _ = client.mapper(dataset)
            n = 0
            for batch in influx_lines_to_batches(req["lines"]):
                routed = split_batch_by_shard(batch, mapper, spread)
                for shard_num, sub in routed.items():
                    sh = memstore.get_shard(dataset, shard_num)
                    if sh is not None and \
                            shard_num in agent.owned.get(dataset, []):
                        n += sh.ingest(sub, offset=int(req.get("offset", -1)))
            return {"ok": True, "ingested": n}
        if cmd == "flush":
            n = 0
            for ds, shards in agent.owned.items():
                for s in shards:
                    sh = memstore.get_shard(ds, s)
                    if sh is not None:
                        n += sh.flush_all_groups()
            return {"ok": True, "chunks": n}
        if cmd == "stop":
            threading.Thread(target=_shutdown, daemon=True).start()
            return {"ok": True}
        return {"ok": False, "error": f"unknown cmd {cmd!r}"}

    class _Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    ctrl = _Server(("127.0.0.1", 0), _Control)
    stop_evt = threading.Event()

    def _shutdown():
        agent.stop()
        qsrv.stop()
        rsrv.stop()
        ctrl.shutdown()
        stop_evt.set()

    agent.start()
    t = threading.Thread(target=ctrl.serve_forever, daemon=True)
    t.start()
    print(json.dumps({"ready": True, "query_port": qsrv.address[1],
                      "control_port": ctrl.server_address[1],
                      "replication_port": rsrv.address[1],
                      "node": args.name}), flush=True)
    try:
        stop_evt.wait()
    except KeyboardInterrupt:
        _shutdown()


if __name__ == "__main__":
    main()
