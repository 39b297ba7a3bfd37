"""greptime CLI: option loading (TOML + flags) and server lifecycle.

Reference behavior: src/cmd — `greptime standalone start -c config.toml
--http-addr ...`; flags override file options (src/cmd/src/options.rs).

Ported from greptimedb_tpu/cmd/main.py: `standalone start` and `cli
attach`. The standalone process runs its query engine on
`StandaloneOptions.device`, "cuda", which no TOML key or flag changes:
on a machine without CUDA `standalone start` exits non-zero with the
datanode's message. It turns on no compile cache: the port compiles no
program at run time, and its kernels are built once per source digest
(ops/cuda_build.py), so a restart reuses them. `metasrv`, `datanode`
and `frontend start` keep the reference's flags and raise until the
distributed frontend, datanode and meta service are ported.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading
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


def _not_ported(role: str, items: str):
    def start(args) -> None:
        from ..errors import UnsupportedError
        raise UnsupportedError(
            f"greptime {role} start: the port has no distributed {role} "
            f"(ROADMAP Queue 1 {items}); run `greptime standalone start`")
    return start


#: the distributed roles (reference cmd/main.py metasrv_start,
#: datanode_start, frontend_start) wait for the meta service (h2) and the
#: Flight datanode plane (h1, h3)
metasrv_start = _not_ported("metasrv", "h2")
datanode_start = _not_ported("datanode", "h1/h3")
frontend_start = _not_ported("frontend", "h2/h3")


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
