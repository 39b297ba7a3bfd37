"""Differential tests of the port's `greptime` CLI (cmd/main.py).

greptimedb_tpu_torch/cmd/ against greptimedb_tpu/cmd/: `load_options`
reads the same TOML and flags into the same fields (the port's options
add `device`, "cuda", which nothing in a TOML or on the command line
sets); `build_servers` on the CPU builds the same servers in the same
order, over S3 with the disk cache too; every subcommand parses its
flags as the reference's does; `cli attach` prints the same text for the
same input against either package's server; `frontend start`'s
`build_frontend` (on "cpu") composes the servers the reference's
`frontend start` starts, in the same order, over a meta server; and
`standalone start`, `datanode start` and `frontend start` on a machine
without CUDA exit non-zero with the datanode's (or the frontend's)
message instead of starting on the CPU.
"""

import argparse
import builtins
import dataclasses
import importlib
import os
import socket
import subprocess
import sys
import time

import pytest
import torch

from test_torch_object_store import mock_s3  # noqa: F401 — a fixture

# the packages' `cmd` re-exports `main`, the function: import the module
ref_main = importlib.import_module("greptimedb_tpu.cmd.main")
port_main = importlib.import_module("greptimedb_tpu_torch.cmd.main")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAINS = {"reference": ref_main, "port": port_main}

TOMLS = {
    "full": """
[storage]
type = "S3"
data_home = "{home}"
bucket = "bkt"
root = "gt"
endpoint = "{endpoint}"
access_key_id = "ak"
secret_access_key = "sk"
cache_path = "{home}/cache"
cache_capacity = 1048576

[http]
addr = "127.0.0.1:0"

[mysql]
addr = "127.0.0.1:0"

[postgres]
addr = "127.0.0.1:0"

[grpc]
addr = "127.0.0.1:0"

[opentsdb]
enable = true
addr = "127.0.0.1:0"

[logging]
level = "warn"
dir = "{home}/logs"
otlp_endpoint = "http://127.0.0.1:9/otlp"

[query]
stream_threshold_rows = 1000
cold_reduce = "device"
scan_cache_budget_mb = 64
""",
    "disabled": """
[storage]
data_home = "{home}"

[http]
addr = "127.0.0.1:0"

[mysql]
enable = false

[postgres]
enable = false
addr = "127.0.0.1:0"

[grpc]
enable = false

[opentsdb]
enable = false
addr = "127.0.0.1:1"
""",
    "empty": "",
}

FLAGS = {
    "none": {},
    "addrs": {"data_home": "{home}/flag", "http_addr": "127.0.0.1:0",
              "mysql_addr": "127.0.0.1:0", "postgres_addr": "127.0.0.1:0",
              "grpc_addr": "127.0.0.1:0", "opentsdb_addr": "127.0.0.1:0",
              "user_provider": "cmd:greptime_user=greptime_pwd"},
}


def _args(tmp_path, toml, flags, endpoint="http://127.0.0.1:9"):
    ns = argparse.Namespace(config_file=None)
    if toml is not None:
        path = tmp_path / "config.toml"
        path.write_text(TOMLS[toml].format(home=tmp_path, endpoint=endpoint))
        ns.config_file = str(path)
    for k, v in FLAGS[flags].items():
        setattr(ns, k, v.format(home=tmp_path))
    return ns


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("toml", [None] + list(TOMLS))
def test_load_options_equal(tmp_path, toml, flags):
    """The same TOML and flags give the same options; the port's extra
    field is the device, always "cuda" from a file or flags."""
    got = {side: dataclasses.asdict(m.load_options(
        _args(tmp_path, toml, flags))) for side, m in MAINS.items()}
    assert got["port"].pop("device") == "cuda"
    assert got["port"] == got["reference"]


def _servers(side, opts):
    """build_servers, then each server started and shut down as
    `standalone start` does."""
    fe, servers = MAINS[side].build_servers(opts)
    try:
        for s in servers:
            s.start()
        return [(type(s).__name__, getattr(s, "host", None))
                for s in servers], type(fe.datanode.store).__name__
    finally:
        for s in servers:
            s.shutdown()
        fe.shutdown()


# without a TOML or address flags the servers take the fixed default
# ports, which the two packages' servers cannot both bind
@pytest.mark.parametrize("toml,flags", [
    ("full", "none"), ("full", "addrs"), ("disabled", "none"),
    ("disabled", "addrs"), (None, "addrs")])
def test_build_servers_same_types_in_order(tmp_path, mock_s3,  # noqa: F811
                                           monkeypatch, toml, flags):
    """`build_servers` (the port's on "cpu") composes the same servers in
    the same order over the same kind of object store: HTTP, MySQL,
    Postgres, gRPC, OpenTSDB, each only when enabled."""
    from greptimedb_tpu.query import stream_exec as ref_se
    from greptimedb_tpu.query import tpu_exec as ref_tx
    from greptimedb_tpu_torch.query import stream_exec as port_se
    from greptimedb_tpu_torch.query import tpu_exec as port_tx
    # [query] sets process-wide knobs in both packages: restored after
    for mod in (ref_se, port_se):
        for name in ("_STREAM_THRESHOLD_ROWS", "_SLICE_ROWS",
                     "_COLD_REDUCE"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, list(getattr(mod, name)))
    for tx in (ref_tx, port_tx):
        monkeypatch.setattr(tx.SCAN_CACHE, "budget_bytes",
                            tx.SCAN_CACHE.budget_bytes)
    got = {}
    for side, m in MAINS.items():
        home = tmp_path / side
        home.mkdir()
        opts = m.load_options(_args(home, toml, flags, mock_s3.endpoint))
        if side == "port":
            opts.device = "cpu"
        got[side] = _servers(side, opts)
    assert got["port"] == got["reference"]
    if toml == "full":
        assert [s[0] for s in got["port"][0]] == [
            "HttpServer", "MysqlServer", "PostgresServer", "GrpcServer",
            "OpentsdbServer"]
        assert got["port"][1] == "LruCacheLayer"


ARGVS = [
    ["standalone", "start"],
    ["standalone", "start", "-c", "x.toml", "--data-home", "d",
     "--http-addr", "h:1", "--mysql-addr", "m:2", "--postgres-addr", "p:3",
     "--grpc-addr", "g:4", "--opentsdb-addr", "o:5",
     "--user-provider", "cmd:a=b"],
    ["metasrv", "start"],
    ["metasrv", "start", "--bind-addr", "0.0.0.0:1", "--store", "kv",
     "--peers", "a:1,b:2", "--failover-interval", "2.5",
     "--datanode-lease-secs", "3", "--log-level", "debug"],
    ["datanode", "start", "--node-id", "3"],
    ["datanode", "start", "--node-id", "4", "--rpc-addr", "r:1",
     "--metasrv-addr", "m:2", "--data-home", "d", "--heartbeat-interval",
     "0.5", "--wal-sync-on-write", "--log-level", "info"],
    ["frontend", "start"],
    ["frontend", "start", "--metasrv-addr", "m:1", "--http-addr", "h:2",
     "--mysql-addr", "m:3", "--postgres-addr", "p:4", "--grpc-addr", "g:5",
     "--log-level", "warn"],
    ["cli", "attach"],
    ["cli", "attach", "--grpc-addr", "g:9"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) for a in ARGVS])
def test_subcommands_parse_the_same_flags(monkeypatch, argv):
    """Every subparser and flag of the reference, with its defaults."""
    got = {}
    for side, m in MAINS.items():
        seen = []
        for fn in ("standalone_start", "metasrv_start", "datanode_start",
                   "frontend_start", "_cli_attach"):
            monkeypatch.setattr(m, fn, lambda a, _fn=fn: seen.append(
                (_fn, {k: v for k, v in vars(a).items() if k != "func"})))
        assert m.main(argv) == 0
        got[side] = seen
    assert got["port"] == got["reference"]


@pytest.mark.parametrize("argv", [["standalone"], ["cli"], ["nope"],
                                  ["datanode", "start"]])
def test_bad_command_lines_exit_alike(argv, capsys):
    codes = {}
    for side, m in MAINS.items():
        with pytest.raises(SystemExit) as e:
            m.main(argv)
        codes[side] = e.value.code
    assert codes["port"] == codes["reference"] == 2


def _meta_server(side):
    """An in-process meta server of `side`'s package over a MemKv;
    (server, its serve thread)."""
    pkg = "greptimedb_tpu" if side == "reference" else "greptimedb_tpu_torch"
    meta = importlib.import_module(f"{pkg}.meta")
    flight = importlib.import_module(f"{pkg}.meta.flight")
    server = flight.FlightMetaServer(meta.MetaSrv(meta.MemKv()))
    return server, server.serve_in_background()


def _join_flight_serving():
    """Wait for every Flight frontend serve thread to return: a Flight
    server still winding down after its shutdown can close the listening
    socket of a server made after it in the process (ROADMAP Queue 3)."""
    import threading
    for t in threading.enumerate():
        if t.name == "flight-frontend":
            t.join(60)
            assert not t.is_alive(), "a Flight frontend server serves on"


def _reference_frontend_servers(addr, monkeypatch):
    """The servers the reference's `frontend start` starts: its blocking
    wait is replaced by one that reads the shutdown closure's `servers`,
    then shuts down."""
    seen = {}

    def block(shutdown):
        cells = dict(zip(shutdown.__code__.co_freevars,
                         (c.cell_contents for c in shutdown.__closure__)))
        seen["servers"] = [type(s).__name__ for s in cells["servers"]]
        shutdown()
        _join_flight_serving()
    monkeypatch.setattr(ref_main, "_block_until_signal", block)
    monkeypatch.setenv("GREPTIME_SELF_MONITOR_INTERVAL_S", "0")
    ref_main.main(["frontend", "start", "--metasrv-addr", addr,
                   "--http-addr", "127.0.0.1:0", "--mysql-addr",
                   "127.0.0.1:0", "--postgres-addr", "127.0.0.1:0",
                   "--grpc-addr", "127.0.0.1:0"])
    return seen["servers"]


@pytest.mark.parametrize("role,items", [("frontend", "h3a")])
def test_distributed_roles_raise(role, items, monkeypatch):
    """`frontend start` (ROADMAP item h3a) is ported: `build_frontend` on
    "cpu" composes over a meta server the servers the reference's
    `frontend start` starts, in the same order (HTTP, MySQL, Postgres,
    Flight), and they answer; on a machine without CUDA the command
    raises and exits non-zero instead of starting on the CPU."""
    import urllib.parse
    import urllib.request
    metas = {side: _meta_server(side) for side in ("reference", "port")}
    try:
        addr = {side: m[0].address.split("://", 1)[1]
                for side, m in metas.items()}
        want = _reference_frontend_servers(addr["reference"], monkeypatch)
        fe, servers, meta = port_main.build_frontend(
            addr["port"], "127.0.0.1:0", mysql_addr="127.0.0.1:0",
            postgres_addr="127.0.0.1:0", grpc_addr="127.0.0.1:0",
            device="cpu")
        try:
            assert [type(s).__name__ for s in servers] == want == [
                "HttpServer", "MysqlServer", "PostgresServer",
                "FlightFrontendServer"]
            assert fe.query_engine.device.type == "cpu"
            for s in servers:
                if hasattr(s, "serve_in_background"):
                    s.serve_in_background()
                else:
                    s.start()
            url = (f"http://127.0.0.1:{servers[0].port}/v1/sql?" +
                   urllib.parse.urlencode({"sql": "SHOW TABLES"}))
            with urllib.request.urlopen(url, timeout=30) as r:
                assert r.status == 200
        finally:
            fe.shutdown()
            for s in servers:
                s.shutdown()
            _join_flight_serving()
            meta.close()
        if torch.cuda.is_available():
            return
        out = subprocess.run(
            [sys.executable, "-m", "greptimedb_tpu_torch.cmd.main", role,
             "start", "--metasrv-addr", addr["port"], "--http-addr",
             f"127.0.0.1:{_free_port()}"], cwd=REPO,
            env=dict(os.environ, OMP_NUM_THREADS="1"), capture_output=True,
            text=True, timeout=120)
        assert out.returncode != 0
        assert "CUDA is not available" in out.stderr
        assert "device='cpu'" in out.stderr
        assert "frontend ready" not in out.stderr
    finally:
        for server, thread in metas.values():
            server.shutdown()
            thread.join(60)


def _flight_server(side, home):
    if side == "reference":
        from greptimedb_tpu.datanode.instance import (
            DatanodeInstance, DatanodeOptions)
        from greptimedb_tpu.frontend.instance import FrontendInstance
        from greptimedb_tpu.servers.grpc import GrpcServer
        opts = DatanodeOptions(data_home=home, register_numbers_table=False)
    else:
        from greptimedb_tpu_torch.datanode import (
            DatanodeInstance, DatanodeOptions)
        from greptimedb_tpu_torch.frontend import FrontendInstance
        from greptimedb_tpu_torch.servers.grpc import GrpcServer
        opts = DatanodeOptions(data_home=home, register_numbers_table=False,
                               device="cpu")
    fe = FrontendInstance(DatanodeInstance(opts))
    fe.start()
    srv = GrpcServer(fe, None, "127.0.0.1:0")
    srv.start()
    t0 = time.time()
    while srv.port == 0 and time.time() - t0 < 10:
        time.sleep(0.01)
    return fe, srv


ATTACH_INPUT = [
    "CREATE TABLE m (host STRING, ts TIMESTAMP TIME INDEX,",
    "  v DOUBLE, PRIMARY KEY(host));",
    "INSERT INTO m VALUES ('a', 1000, 1.5), ('b', 2000, NULL);",
    "SELECT host, v FROM m ORDER BY host;",
    "SELECT count(*) FROM m;",
    "SELECT * FROM missing;",
    "SELECT 1",
    "  + 2;",
    "\\q",
    "SELECT 'never run';",
]


def _attach(side, port, monkeypatch, capsys):
    lines = iter(ATTACH_INPUT)

    def fake_input(prompt=""):
        print(prompt, end="")
        try:
            return next(lines)
        except StopIteration:
            raise EOFError from None

    monkeypatch.setattr(builtins, "input", fake_input)
    capsys.readouterr()
    MAINS[side].main(["cli", "attach", "--grpc-addr", f"127.0.0.1:{port}"])
    out = capsys.readouterr().out.splitlines()
    # the banner names the package; the rest is the session
    return out[0], out[1:]


@pytest.mark.parametrize("server", ["reference", "port"])
def test_cli_attach_prints_the_same(tmp_path, monkeypatch, capsys, server):
    """`cli attach` of each package against `server`: the same prompts,
    results and errors for the same input, ended by \\q."""
    got = {}
    for side in MAINS:
        fe, srv = _flight_server(server, str(tmp_path / side))
        try:
            got[side] = _attach(side, srv.port, monkeypatch, capsys)
        finally:
            srv.shutdown()
            fe.shutdown()
    assert got["port"][1] == got["reference"][1]
    assert got["port"][0].startswith("greptimedb_tpu_torch REPL")
    text = "\n".join(got["port"][1])
    assert "Affected Rows: 2" in text and "never run" not in text
    assert "error: table greptime.public.missing not found" in text
    assert "| 3     |" in text and "| b    | NULL |" in text


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_standalone_start_refuses_the_cpu(tmp_path):
    """No fallback: without CUDA the entry point exits non-zero with the
    datanode's message, opens no port and writes no data."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the CLI would start on the card")
    grpc = _free_port()
    toml = tmp_path / "c.toml"
    toml.write_text(f'[storage]\ndata_home = "{tmp_path}/home"\n'
                    f'[http]\naddr = "127.0.0.1:0"\n'
                    f'[grpc]\naddr = "127.0.0.1:{grpc}"\n'
                    f'[mysql]\nenable = false\n[postgres]\nenable = false\n')
    out = subprocess.run(
        [sys.executable, "-m", "greptimedb_tpu_torch.cmd.main",
         "standalone", "start", "-c", str(toml)], cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"), capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert "device='cpu'" in out.stderr
    assert "standalone ready" not in out.stderr
    assert not os.path.exists(tmp_path / "home" / "data")


def test_datanode_start_refuses_the_cpu(tmp_path):
    """`datanode start` without CUDA exits non-zero with the datanode's
    message: it neither serves nor registers with meta on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the datanode would start on the card")
    out = subprocess.run(
        [sys.executable, "-m", "greptimedb_tpu_torch.cmd.main", "datanode",
         "start", "--node-id", "3", "--data-home", str(tmp_path / "home"),
         "--metasrv-addr", f"127.0.0.1:{_free_port()}"], cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"), capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert "device='cpu'" in out.stderr
    assert "ready on" not in out.stderr
    assert not os.path.exists(tmp_path / "home" / "data")
