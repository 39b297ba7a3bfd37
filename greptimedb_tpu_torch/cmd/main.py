"""greptime CLI: option loading (TOML + flags) and server lifecycle.

Reference behavior: src/cmd — `greptime standalone start -c config.toml
--http-addr ...`; flags override file options (src/cmd/src/options.rs).

Ported from greptimedb_tpu/cmd/main.py: `standalone start`, `metasrv
start`, `datanode start`, `frontend start` and `cli attach`. The
standalone process, a datanode and a frontend run their query engine on
the card ("cuda"), which no TOML key or flag changes: on a machine
without CUDA each exits non-zero with the datanode's (or the frontend's)
message. A metasrv holds no regions and never touches CUDA. `frontend
start` serves HTTP, MySQL, Postgres and Arrow Flight over a DistInstance
(frontend/distributed.py) whose datanodes it finds through meta
(`build_frontend` composes them, not yet started). No role turns on a
compile cache: the port compiles no program at run time, and its kernels
are built once per source digest (ops/cuda_build.py), so a restart
reuses them.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class StandaloneOptions:
    data_home: str = "./greptimedb_data"
    http_addr: str = "127.0.0.1:4000"
    mysql_addr: str = "127.0.0.1:4002"
    postgres_addr: str = "127.0.0.1:4003"
    grpc_addr: str = "127.0.0.1:4001"
    #: OpenTSDB telnet `put` listener; empty/None = disabled (reference
    #: serves it on 4242, src/servers/src/opentsdb.rs:60)
    opentsdb_addr: Optional[str] = None
    user_provider: Optional[str] = None
    enable_mysql: bool = True
    enable_postgres: bool = True
    enable_grpc: bool = True
    log_level: str = "info"
    #: [storage] table from the TOML: type=File|S3, bucket, endpoint,
    #: cache_path... (reference: ObjectStoreConfig, datanode.rs:126-204)
    storage: dict = field(default_factory=dict)
    #: [tls] table: mode=disable|prefer|require + cert/key paths
    #: (reference: TlsOption, servers/src/tls.rs)
    tls: dict = field(default_factory=dict)
    #: [query] table: stream_threshold_rows / stream_slice_rows (cold-scan
    #: streaming), cold_reduce ("host"/"device" partial reduction),
    #: scan_cache_budget_mb (device scan cache bound)
    query: dict = field(default_factory=dict)
    log_dir: Optional[str] = None
    #: [logging] otlp_endpoint: OTLP/HTTP collector base URL (spans are
    #: exported to {endpoint}/v1/traces when set)
    otlp_endpoint: Optional[str] = None
    #: where the query engine and the flow folds run; no TOML key or flag
    #: sets it, so the CLI always runs on the card (tests pass "cpu")
    device: str = "cuda"


def load_options(args) -> StandaloneOptions:
    opts = StandaloneOptions()
    if getattr(args, "config_file", None):
        import tomllib
        with open(args.config_file, "rb") as f:
            doc = tomllib.load(f)
        opts.storage = doc.get("storage", {})
        opts.data_home = opts.storage.get("data_home", opts.data_home)
        http = doc.get("http", {})
        opts.http_addr = http.get("addr", opts.http_addr)
        mysql = doc.get("mysql", {})
        opts.mysql_addr = mysql.get("addr", opts.mysql_addr)
        opts.enable_mysql = mysql.get("enable", True)
        pg = doc.get("postgres", {})
        opts.postgres_addr = pg.get("addr", opts.postgres_addr)
        opts.enable_postgres = pg.get("enable", True)
        grpc = doc.get("grpc", {})
        opts.grpc_addr = grpc.get("addr", opts.grpc_addr)
        opts.enable_grpc = grpc.get("enable", True)
        tsdb = doc.get("opentsdb", {})
        if tsdb.get("enable", False):
            opts.opentsdb_addr = tsdb.get("addr", "127.0.0.1:4242")
        logging_doc = doc.get("logging", {})
        opts.log_level = logging_doc.get("level", opts.log_level)
        opts.log_dir = logging_doc.get("dir", opts.log_dir)
        opts.otlp_endpoint = logging_doc.get("otlp_endpoint",
                                             opts.otlp_endpoint)
        opts.tls = doc.get("tls", {})
        opts.query = doc.get("query", {})
    for name in ("data_home", "http_addr", "mysql_addr", "postgres_addr",
                 "grpc_addr", "opentsdb_addr", "user_provider"):
        v = getattr(args, name, None)
        if v is not None:
            setattr(opts, name, v)
    return opts


def build_servers(opts: StandaloneOptions):
    """Compose standalone frontend + protocol servers (not yet started)."""
    from ..datanode import DatanodeInstance, DatanodeOptions
    from ..frontend import FrontendInstance
    from ..servers.auth import NoopUserProvider, StaticUserProvider
    from ..servers.http import HttpServer

    if opts.query:
        from ..query.stream_exec import configure_streaming
        configure_streaming(
            threshold_rows=opts.query.get("stream_threshold_rows"),
            slice_rows=opts.query.get("stream_slice_rows"),
            cold_reduce=opts.query.get("cold_reduce"))
        budget_mb = opts.query.get("scan_cache_budget_mb")
        if budget_mb is not None:
            from ..query.tpu_exec import SCAN_CACHE
            SCAN_CACHE.configure(budget_bytes=int(budget_mb) << 20)
    store = None
    if opts.storage and str(opts.storage.get("type", "File")) != "File":
        from ..storage.object_store import build_object_store
        store = build_object_store(opts.storage, opts.data_home)
    dn = DatanodeInstance(DatanodeOptions(data_home=opts.data_home,
                                          device=opts.device),
                          store=store)
    fe = FrontendInstance(dn)
    fe.start()
    provider = NoopUserProvider()
    if opts.user_provider:
        provider = StaticUserProvider.from_option(opts.user_provider)

    def split_addr(addr):
        host, _, port = addr.partition(":")
        return host or "127.0.0.1", int(port or 0)

    ssl_context = None
    if opts.tls:
        from ..servers.tls import TlsOption
        ssl_context = TlsOption.from_config(opts.tls).setup()
    servers = [HttpServer(fe, provider, opts.http_addr,
                          ssl_context=ssl_context)]
    if opts.enable_mysql:
        from ..servers.mysql import MysqlServer
        host, port = split_addr(opts.mysql_addr)
        servers.append(MysqlServer(fe, host=host, port=port,
                                   user_provider=provider,
                                   ssl_context=ssl_context))
    if opts.enable_postgres:
        from ..servers.postgres import PostgresServer
        host, port = split_addr(opts.postgres_addr)
        servers.append(PostgresServer(fe, host=host, port=port,
                                      user_provider=provider,
                                      ssl_context=ssl_context))
    if opts.enable_grpc:
        from ..servers.grpc import GrpcServer
        servers.append(GrpcServer(fe, provider, opts.grpc_addr))
    if opts.opentsdb_addr:
        from ..servers.opentsdb import OpentsdbServer
        host, port = split_addr(opts.opentsdb_addr)
        servers.append(OpentsdbServer(fe, host=host, port=port))
    return fe, servers


def standalone_start(args) -> None:
    opts = load_options(args)
    from ..common.telemetry import (configure_otlp, init_logging,
                                    install_panic_hook)
    init_logging(opts.log_level, opts.log_dir)
    if opts.otlp_endpoint:
        configure_otlp(opts.otlp_endpoint, service_name="greptimedb")
    install_panic_hook()
    fe, servers = build_servers(opts)
    for s in servers:
        s.start()
        logging.info("started %s on %s:%s", type(s).__name__,
                     getattr(s, "host", "?"), getattr(s, "port", "?"))
    stop = threading.Event()

    def on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    logging.info("greptimedb_tpu_torch standalone ready (data_home=%s, "
                 "device=%s)", opts.data_home, opts.device)
    stop.wait()
    for s in servers:
        s.shutdown()
    fe.shutdown()


def _block_until_signal(on_shutdown) -> None:
    stop = threading.Event()

    def on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    stop.wait()
    on_shutdown()


def _meta_client(addr_arg: str):
    """--metasrv-addr accepts a comma-separated replica list; the
    failover client walks it until a leader answers."""
    from ..meta.flight import FailoverFlightMetaClient
    addrs = [a.strip() for a in addr_arg.split(",") if a.strip()]
    return FailoverFlightMetaClient([f"grpc://{a}" for a in addrs])


#: how long `datanode start` and `frontend start` wait for a meta leader
META_LEADER_WAIT_S = 120.0


def _wait_for_meta_leader(meta, timeout_s: float = META_LEADER_WAIT_S
                          ) -> None:
    """Block until a metasrv replica answers cluster_info as the leader,
    so a datanode or frontend may start together with its metasrv
    replicas instead of after their election (the reference's roles give
    up after the failover client's retries). Raises the last error once
    `timeout_s` has passed."""
    quick = meta.advisory()
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            quick.cluster_info()
            return
        except Exception as e:  # noqa: BLE001 — not up or no leader yet
            if time.monotonic() > deadline:
                raise
            logging.debug("waiting for a meta leader: %s", e)
            time.sleep(0.2)


def metasrv_start(args) -> None:
    """Run the metadata server role (reference: greptime metasrv start;
    etcd is replaced by a file-backed KV snapshot, or with --peers by a
    raft-replicated KV). It holds no regions and never touches CUDA."""
    from ..common.telemetry import init_logging
    from ..meta import MetaSrv
    from ..meta.flight import FlightMetaServer
    from ..meta.kv import FileKv, MemKv

    init_logging(args.log_level or "info")
    from ..common import background_jobs, trace_store
    background_jobs.configure_node("metasrv")
    # buffer-role sink: balancer-op traces root here and verdict locally;
    # retained spans ride home on the next meta RPC's response
    trace_store.install(trace_store.TraceSink(
        node_label="metasrv", service="metasrv", role="buffer"))
    raft_node = None
    if args.peers:
        # replicated meta: --peers is the full replica set (this node
        # included) and must be identical on every node: raft ids come
        # from its sorted order. Transports ride the same Flight plane.
        from ..meta.replication import (
            FlightTransport, RaftNode, ReplicatedKv)
        peers = sorted({a.strip() for a in args.peers.split(",")
                        if a.strip()})
        if args.bind_addr not in peers:
            raise SystemExit(
                f"--peers must list every replica including this node's "
                f"--bind-addr {args.bind_addr!r} verbatim; got {peers}")
        peer_addrs = dict(enumerate(peers, start=1))
        my_id = next(i for i, a in peer_addrs.items()
                     if a == args.bind_addr)
        raft_node = RaftNode(
            my_id, list(peer_addrs),
            store_path=f"{args.store}.raft" if args.store else None)
        for pid, addr in peer_addrs.items():
            if pid != my_id:
                raft_node.transports[pid] = FlightTransport(
                    f"grpc://{addr}", node=raft_node)
        kv = ReplicatedKv(raft_node)
    else:
        kv = FileKv(args.store) if args.store else MemKv()
    srv = MetaSrv(kv, datanode_lease_secs=args.datanode_lease_secs)
    server = FlightMetaServer(srv, f"grpc://{args.bind_addr}",
                              raft_node=raft_node)
    server.serve_in_background()
    if raft_node is not None:
        raft_node.start()
    # only the lease holder mutates routes (reference: election/etcd.rs);
    # under raft the consensus leader is the lease holder
    if raft_node is not None:
        class _RaftElection:
            def start(self):
                pass

            def stop(self):
                pass

            @property
            def is_leader(self):
                return raft_node.is_leader
        election = _RaftElection()
    else:
        from ..meta.lock import Election
        election = Election(kv, f"metasrv-{args.bind_addr}")
    election.start()

    # region failover runner on the leader, plus the region balancer's
    # control loop (its state machines resume from __balancer/ keys)
    from ..common.runtime import RepeatedTask
    srv.balancer.is_leader_fn = lambda: election.is_leader

    def failover_tick():
        if not election.is_leader:
            return
        moves = srv.failover_check()
        for m in moves:
            logging.warning("failover: region %s of %s moved %d -> %d",
                            m["region"], m["table"], m["from"], m["to"])
        srv.balancer.tick()

    runner = RepeatedTask(args.failover_interval, failover_tick,
                          name="failover-runner")
    runner.start()
    logging.info("metasrv ready on %s (leader=%s)", server.address,
                 election.is_leader)

    def shutdown():
        runner.stop()
        election.stop()
        if raft_node is not None:
            raft_node.stop()
        server.shutdown()

    _block_until_signal(shutdown)


def datanode_start(args) -> None:
    """Run a region-hosting worker: Flight data plane + meta heartbeats
    (reference: greptime datanode start). Its query engine runs on the
    card: without CUDA the datanode raises and the process exits
    non-zero."""
    from ..common.telemetry import init_logging
    from ..datanode import DatanodeInstance, DatanodeOptions
    from ..meta import Peer
    from ..servers.flight import FlightDatanodeServer

    init_logging(args.log_level or "info")
    # buffer-role trace sink: this process sees only its fragments of
    # each trace, so it buffers spans until the frontend's verdict rides
    # a later RPC and ships the released ones home on its response
    from ..common import background_jobs, profiler, trace_store
    label = f"dn{args.node_id}"
    background_jobs.configure_node(label)
    trace_store.install(trace_store.TraceSink(
        node_label=label, service="datanode", role="buffer"))
    # writer-less sampler: folded stacks drain over the Flight `profile`
    # action to the asking frontend, which writes them
    profiler.install(profiler.Profiler(node_label=label))
    dn = DatanodeInstance(DatanodeOptions(
        data_home=args.data_home or "./greptimedb_data",
        node_id=args.node_id, register_numbers_table=False,
        wal_sync_on_write=bool(getattr(args, "wal_sync_on_write",
                                       False))))
    dn.start()
    server = FlightDatanodeServer(dn, f"grpc://{args.rpc_addr}")
    server.serve_in_background()
    meta = _meta_client(args.metasrv_addr)
    _wait_for_meta_leader(meta)
    meta.register(Peer(args.node_id, server.address))
    dn.start_heartbeat(meta, interval_s=args.heartbeat_interval)
    logging.info("datanode %d ready on %s (meta %s, device %s)",
                 args.node_id, server.address, args.metasrv_addr,
                 dn.opts.device)

    def shutdown():
        server.shutdown()
        dn.shutdown()
        meta.close()

    _block_until_signal(shutdown)


def build_frontend(metasrv_addr: str, http_addr: str,
                   mysql_addr: Optional[str] = None,
                   postgres_addr: Optional[str] = None,
                   grpc_addr: Optional[str] = None, device: str = "cuda"):
    """Compose the distributed frontend and its protocol servers (not yet
    started): a DistInstance on `device` over the meta replicas of
    `metasrv_addr` (comma-separated) and the datanodes they list, dialled
    lazily, once a meta leader answers. Returns (frontend, servers, meta
    client)."""
    from ..frontend.distributed import DistInstance
    from ..meta.flight import PeerClientRegistry
    from ..servers.auth import NoopUserProvider
    from ..servers.flight import FlightFrontendServer
    from ..servers.http import HttpServer

    import torch
    meta = _meta_client(metasrv_addr)
    try:
        if torch.device(device).type != "cuda" or torch.cuda.is_available():
            # without its device the frontend raises at once (below),
            # without waiting for meta
            _wait_for_meta_leader(meta)
        fe = DistInstance(meta, PeerClientRegistry(meta), device=device)
    except Exception:
        meta.close()
        raise
    servers = [HttpServer(fe, NoopUserProvider(), http_addr)]
    if mysql_addr:
        from ..servers.mysql import MysqlServer
        host, _, port = mysql_addr.partition(":")
        servers.append(MysqlServer(fe, host=host or "127.0.0.1",
                                   port=int(port or 0)))
    if postgres_addr:
        from ..servers.postgres import PostgresServer
        host, _, port = postgres_addr.partition(":")
        servers.append(PostgresServer(fe, host=host or "127.0.0.1",
                                      port=int(port or 0)))
    if grpc_addr:
        servers.append(FlightFrontendServer(fe, f"grpc://{grpc_addr}"))
    return fe, servers, meta


def frontend_start(args) -> None:
    """Run the stateless router role: SQL over HTTP/MySQL/Postgres/Flight
    against datanodes resolved through the meta service (reference:
    greptime frontend start). Its query engine runs on the card: without
    CUDA the frontend raises and the process exits non-zero."""
    from ..common.telemetry import init_logging

    init_logging(args.log_level or "info")
    fe, servers, meta = build_frontend(
        args.metasrv_addr, args.http_addr, mysql_addr=args.mysql_addr,
        postgres_addr=args.postgres_addr, grpc_addr=args.grpc_addr)
    # self-monitoring scrape loop: frontend registry + cluster-wide
    # region heat (meta heartbeats) → greptime_private tables
    from ..common.runtime import env_int
    monitor_interval = env_int("GREPTIME_SELF_MONITOR_INTERVAL_S", 30)
    if monitor_interval > 0:
        fe.self_monitor.start_background(monitor_interval)
    for s in servers:
        if hasattr(s, "serve_in_background"):
            s.serve_in_background()
        else:
            s.start()
    logging.info("frontend ready (http %s, meta %s, device %s)",
                 args.http_addr, args.metasrv_addr,
                 fe.query_engine.device)

    def shutdown():
        fe.shutdown()
        for s in servers:
            s.shutdown()
        meta.close()

    _block_until_signal(shutdown)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="greptime", description="greptimedb_tpu_torch CLI")
    sub = parser.add_subparsers(dest="subcommand", required=True)

    standalone = sub.add_parser("standalone")
    ssub = standalone.add_subparsers(dest="action", required=True)
    start = ssub.add_parser("start")
    start.add_argument("-c", "--config-file")
    start.add_argument("--data-home")
    start.add_argument("--http-addr")
    start.add_argument("--mysql-addr")
    start.add_argument("--postgres-addr")
    start.add_argument("--grpc-addr")
    start.add_argument("--opentsdb-addr")
    start.add_argument("--user-provider")
    start.set_defaults(func=standalone_start)

    metasrv = sub.add_parser("metasrv")
    msub = metasrv.add_subparsers(dest="action", required=True)
    mstart = msub.add_parser("start")
    mstart.add_argument("--bind-addr", default="127.0.0.1:3002")
    mstart.add_argument("--store", help="path for the file-backed KV")
    mstart.add_argument("--peers", help="comma-separated bind addrs of "
                        "the full metasrv replica set (enables the "
                        "replicated raft store)")
    mstart.add_argument("--failover-interval", type=float, default=10.0)
    mstart.add_argument("--datanode-lease-secs", type=float, default=15.0)
    mstart.add_argument("--log-level")
    mstart.set_defaults(func=metasrv_start)

    datanode = sub.add_parser("datanode")
    dsub = datanode.add_subparsers(dest="action", required=True)
    dstart = dsub.add_parser("start")
    dstart.add_argument("--node-id", type=int, required=True)
    dstart.add_argument("--rpc-addr", default="127.0.0.1:0")
    dstart.add_argument("--metasrv-addr", default="127.0.0.1:3002")
    dstart.add_argument("--data-home")
    dstart.add_argument("--heartbeat-interval", type=float, default=5.0)
    dstart.add_argument("--wal-sync-on-write", action="store_true",
                        help="fsync the WAL before acking each write "
                             "(the replication acceptance drives run "
                             "with this on)")
    dstart.add_argument("--log-level")
    dstart.set_defaults(func=datanode_start)

    frontend = sub.add_parser("frontend")
    fsub = frontend.add_subparsers(dest="action", required=True)
    fstart = fsub.add_parser("start")
    fstart.add_argument("--metasrv-addr", default="127.0.0.1:3002")
    fstart.add_argument("--http-addr", default="127.0.0.1:4000")
    fstart.add_argument("--mysql-addr")
    fstart.add_argument("--postgres-addr")
    fstart.add_argument("--grpc-addr")
    fstart.add_argument("--log-level")
    fstart.set_defaults(func=frontend_start)

    cli = sub.add_parser("cli")
    csub = cli.add_subparsers(dest="action", required=True)
    attach = csub.add_parser("attach")
    attach.add_argument("--grpc-addr", default="127.0.0.1:4001")
    attach.set_defaults(func=_cli_attach)

    args = parser.parse_args(argv)
    args.func(args)
    return 0


def _cli_attach(args) -> None:
    """Interactive SQL REPL over the Flight/gRPC client."""
    from ..client.flight import Database
    from ..datatypes.record_batch import pretty_print
    addr = args.grpc_addr
    if "://" not in addr:
        addr = f"grpc://{addr}"
    db = Database(addr)
    print("greptimedb_tpu_torch REPL — end statements with ';', \\q to "
          "quit")
    buf = []
    while True:
        try:
            line = input("> " if not buf else "… ")
        except EOFError:
            break
        if line.strip() in ("\\q", "exit", "quit"):
            break
        buf.append(line)
        if line.rstrip().endswith(";"):
            sql = "\n".join(buf)
            buf = []
            try:
                out = db.sql(sql)
                if isinstance(out, int):
                    print(f"Affected Rows: {out}")
                else:
                    print(pretty_print(out))
            except Exception as e:  # noqa: BLE001
                print(f"error: {e}")


if __name__ == "__main__":
    sys.exit(main())
