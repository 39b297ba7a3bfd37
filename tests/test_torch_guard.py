"""Guards on the port's boundaries.

- Importing the port's slice modules (and running queries through them on
  the CPU) adds no jax or greptimedb_tpu module to sys.modules, and the
  PromQL path adds no pandas or pyarrow either (the SQL path's host layer
  is pandas, as the reference's is). The check compares sys.modules
  before and after, in a subprocess, because the interpreter's site setup
  may import JAX first.
- No source file of the port imports jax, jaxlib or greptimedb_tpu; the
  modules of the PromQL path import no pandas or pyarrow; imports inside
  the package stay relative.
- An engine left on its default device ("cuda") raises on a machine
  without CUDA rather than running on the CPU; chip_smoke.py exits
  non-zero there and prints no result.
- The standalone frontend (frontend/, datanode/, mito/, procedure/,
  partition/ and the durable catalog) runs DDL, writes, a device-path
  query, a partitioned table and a restart without adding jax or
  greptimedb_tpu to sys.modules, and each of those packages is there
  with relative imports only.
- The rest of the SQL surface (SHOW, DESCRIBE, information_schema,
  EXPLAIN / EXPLAIN ANALYZE, sketch and expression aggregates, window
  functions) and the port's golden runner run without the reference, and
  their modules are the port's own; chip_smoke.py imports neither jax
  nor the JAX package.
- PromQL over tables (promql/lowering.py: the region-backed select, the
  lowered aggregate path, TQL EVAL / EXPLAIN / ANALYZE through the
  frontend) runs without the reference; the golden runner, like every
  entry point, runs on "cuda" unless asked for the CPU, and refuses to
  answer on a machine without CUDA.
- The storage engine (WAL, memtable, SSTs, manifest, compaction) runs
  without the reference; the port's host substrate (`common/`) imports
  no pandas or pyarrow; the port's metrics live in a registry of their
  own, so both packages count under the same names in one process; the
  port's native WAL builds from its own `native/wal.cpp`.
- The HTTP server family (servers/, utils/{protowire,snappy}.py,
  common/{admission,plugins}.py) serves SQL, PromQL, remote write and
  read and InfluxDB lines without adding jax or greptimedb_tpu to
  sys.modules; its modules are the port's own; the port's snappy library
  builds from its own `native/snappy.cpp` into `native/build/`.
- The MySQL and Postgres servers (servers/{mysql,postgres}.py), KILL, COPY
  and external tables (file_table/, common/datasource.py) run without
  adding jax or greptimedb_tpu to sys.modules, and their modules are the
  port's own. common/datasource.py is the one module of common/ that
  reads pyarrow (COPY's and the file tables' codecs): only
  frontend/statement.py and file_table/ import it, never the PromQL path.
- The trace store, the profiler, the self-monitor and the script engine
  (common/{trace_store,profiler}.py, monitor/, script/) answer ADMIN SHOW
  TRACE / SHOW PROFILE, tick and run a torch coprocessor without adding
  jax or greptimedb_tpu to sys.modules; their modules are the port's own
  with relative imports; the coprocessor namespace holds torch and no
  jnp; the profiler's sampler thread creates no CUDA context, because
  the sampler module and what it reads at sample time never import
  torch.
- The standalone process (cmd/, api/, client/, servers/{flight,grpc}.py,
  storage/{s3,cache}.py) builds its servers over S3 with the disk cache,
  answers the Flight client and `cli attach` without adding jax or
  greptimedb_tpu to sys.modules; its packages are the port's own with
  relative imports; cmd/main.py turns on no compile cache (the port has
  no jax_cache); storage/retry.py and storage/object_store.py import s3
  and cache only inside functions, as the reference does, so their
  failpoints register when the reference's do; the client side (`cli
  attach`, the Flight `Database`) imports no torch.
- The datanode as a cluster member (meta/, datanode/, client/,
  servers/flight.py's FlightDatanodeServer): meta places a table's
  regions on two datanodes with node ids, each behind its Flight server,
  which create, load and answer region moments over Flight and report by
  heartbeat, without adding jax or greptimedb_tpu to sys.modules; meta/
  is the port's own with relative imports; the datanode clients and the
  meta service import no torch; a datanode with a node id left on its
  default device raises without CUDA and opens nothing.
"""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "greptimedb_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "greptimedb_tpu")
#: forbidden on the PromQL path only
HOST_STACK = ("pandas", "pyarrow")
#: the port's files the PromQL path imports (package-relative prefixes)
PROMQL_PATH = ("__init__.py", "common/", "errors.py", "ops/__init__.py",
               "ops/cuda_build.py", "ops/pallas_window.py", "ops/window.py",
               "promql/", "session/", "sql/", "tools/")
#: under PROMQL_PATH but off the PromQL path: COPY's and the file tables'
#: codecs over pyarrow streams
DATASOURCE = "common/datasource.py"
#: the only modules that import DATASOURCE
DATASOURCE_USERS = ("frontend/statement.py", "file_table/engine.py")
# one intra-op thread: the subprocesses share cores with parallel workers
_ENV = dict(os.environ, OMP_NUM_THREADS="1")

_PROBE = r"""
import json, sys
before = set(sys.modules)
import greptimedb_tpu_torch
import greptimedb_tpu_torch.common.time
import greptimedb_tpu_torch.errors
import greptimedb_tpu_torch.ops.cuda_build
import greptimedb_tpu_torch.ops.pallas_window
import greptimedb_tpu_torch.ops.window as win
import greptimedb_tpu_torch.promql
import greptimedb_tpu_torch.session
import greptimedb_tpu_torch.sql
from greptimedb_tpu_torch.promql import engine as eng
import numpy as np

ts = 1_700_000_000_000 + np.arange(0, 1_800_000, 15_000)
sm = win.SeriesMatrix.build(np.zeros(len(ts), int), ts,
                            np.arange(len(ts), dtype=float), 1)

class Mem(eng.PromqlEngine):
    def select(self, sel, lo, hi, ctx):
        return eng._Selection([{"__name__": "x"}], sm, int(ts[0]),
                              int(ts[-1]))

e = Mem(None, device="cpu")
for q in ["rate(x[5m])", "max_over_time(x[5m])", "hour()", "x",
          "timestamp(x)"]:
    e.query_to_prom_json(q, int(ts[0]), int(ts[-1]), 60_000)
greptimedb_tpu_torch.common.time.parse_prom_time("2023-11-14T22:13:20Z")
new = sorted(set(sys.modules) - before)
print(json.dumps(new))
"""


def test_port_imports_no_reference_or_storage_stack():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=_ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    new = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in new if m.split(".")[0] in FORBIDDEN + HOST_STACK]
    assert not bad, bad
    assert "greptimedb_tpu_torch.promql.engine" in new


_SQL_PROBE = r"""
import json, sys, types
before = set(sys.modules)
import numpy as np
from greptimedb_tpu_torch.catalog import MemoryCatalogManager
from greptimedb_tpu_torch.datatypes import data_type as dt
from greptimedb_tpu_torch.datatypes.schema import (ColumnSchema, Schema,
                                                   SemanticType)
from greptimedb_tpu_torch.query import QueryEngine, tpu_exec
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.sql import parse_sql
from greptimedb_tpu_torch.storage import ScanData, SeriesDict
from greptimedb_tpu_torch.table import Table, TableIdent, TableInfo, TableMeta

schema = Schema([
    ColumnSchema("host", dt.STRING, semantic_type=SemanticType.TAG),
    ColumnSchema("ts", dt.TIMESTAMP_MILLISECOND, nullable=False,
                 semantic_type=SemanticType.TIMESTAMP),
    ColumnSchema("v", dt.FLOAT64, semantic_type=SemanticType.FIELD)])
n = 600
sd = SeriesDict(["host"])
sids = sd.encode_rows([[f"h{i % 3}" for i in range(n)]])
data = ScanData(schema, sd, sids, 1_700_000_000_000 + np.arange(n) * 1000,
                np.arange(n, dtype=np.int64), np.zeros(n, np.int8),
                {"v": (np.arange(n, dtype=np.float64), None)})
mt = types.SimpleNamespace(num_rows=n)
ver = types.SimpleNamespace(
    schema=schema, memtables=types.SimpleNamespace(all_memtables=lambda: [mt]),
    ssts=types.SimpleNamespace(all_files=lambda: []))
region = types.SimpleNamespace(
    uid="t-0", name="t_0", series_dict=sd,
    version_control=types.SimpleNamespace(current=ver, committed_sequence=n),
    snapshot=lambda: types.SimpleNamespace(
        _version=ver, scan=lambda: data, visible_sequence=n))
table = Table(TableInfo(TableIdent(1), "t", TableMeta(schema)))
table.regions = {0: region}
cat = MemoryCatalogManager()
cat.register_table("greptime", "public", "t", table)
tpu_exec.TPU_DISPATCH_MIN_ROWS = 0
out = QueryEngine(cat, device="cpu").execute(parse_sql(
    "SELECT host, avg(v), count(*) FROM t GROUP BY host ORDER BY host"),
    QueryContext())
assert region.last_scan_profile.path == "resident"
assert out.num_rows == 3
new = sorted(set(sys.modules) - before)
print(json.dumps(new))
"""


def test_sql_path_imports_no_reference():
    out = subprocess.run([sys.executable, "-c", _SQL_PROBE], cwd=REPO,
                         env=_ENV, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    new = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in new if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    assert "greptimedb_tpu_torch.query.tpu_exec" in new


_FRONTEND_PROBE = r"""
import json, sys, tempfile
before = set(sys.modules)
from greptimedb_tpu_torch.datanode import DatanodeOptions
from greptimedb_tpu_torch.frontend import build_standalone

with tempfile.TemporaryDirectory() as home:
    opts = DatanodeOptions(data_home=home, device="cpu")
    fe = build_standalone(opts)
    fe.do_query("CREATE TABLE t (host STRING, ts TIMESTAMP TIME INDEX, "
                "v DOUBLE, PRIMARY KEY(host)) PARTITION BY RANGE COLUMNS "
                "(host) (PARTITION r0 VALUES LESS THAN ('h1'), PARTITION r1 "
                "VALUES LESS THAN (MAXVALUE))")
    fe.do_query("INSERT INTO t VALUES ('h0', 1, 1.5), ('h2', 2, 2.5)")
    fe.handle_row_insert("m", {"host": ["a"], "greptime_timestamp": [3],
                               "greptime_value": [0.5]},
                         tag_columns=["host"])
    fe.do_query("ADMIN FLUSH TABLE t")
    fe.do_query("SET tpu_dispatch_min_rows = 0")
    out = fe.do_query("SELECT host, avg(v) FROM t GROUP BY host "
                      "ORDER BY host")[0]
    assert {r.last_scan_profile.path for r in
            fe.catalog.table("greptime", "public", "t").regions.values()} \
        == {"resident"}
    assert out.num_rows == 2
    fe.shutdown()
    fe = build_standalone(opts)
    assert fe.do_query("SELECT count(*) FROM m")[0].num_rows == 1
    fe.shutdown()
new = sorted(set(sys.modules) - before)
print(json.dumps(new))
"""


def test_frontend_path_imports_no_reference():
    out = subprocess.run([sys.executable, "-c", _FRONTEND_PROBE], cwd=REPO,
                         env=_ENV, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    new = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in new if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    for m in ("frontend.instance", "frontend.statement", "datanode.instance",
              "mito.engine", "mito.procedure", "procedure.framework",
              "partition.rule", "partition.splitter", "catalog.manager"):
        assert f"greptimedb_tpu_torch.{m}" in new, m


_STREAM_PROBE = r"""
import json, sys, tempfile
before = set(sys.modules)
from greptimedb_tpu_torch.datanode import DatanodeOptions
from greptimedb_tpu_torch.frontend import build_standalone
from greptimedb_tpu_torch.query import stream_exec

with tempfile.TemporaryDirectory() as home:
    fe = build_standalone(DatanodeOptions(data_home=home, device="cpu"))
    fe.do_query("CREATE TABLE t (host STRING, ts TIMESTAMP TIME INDEX, "
                "v DOUBLE, PRIMARY KEY(host))")
    fe.do_query("INSERT INTO t VALUES ('h0', 1, 1.5), ('h2', 2, 2.5)")
    fe.do_query("ADMIN FLUSH TABLE t")
    fe.do_query("INSERT INTO t VALUES ('h1', 3, 0.5)")
    (region,) = fe.catalog.table("greptime", "public", "t").regions.values()
    fe.do_query("SET stream_threshold_rows = 0")
    paths = []
    for mode, sql in (("host", "SELECT host, avg(v) FROM t GROUP BY host"),
                      ("device", "SELECT host, avg(v) FROM t GROUP BY host"),
                      ("host", "SELECT count(*) FROM t WHERE host = 'h2'")):
        stream_exec.configure_streaming(cold_reduce=mode)
        fe.do_query("SET tpu_dispatch_min_rows = 0")
        assert fe.do_query(sql)[0].num_rows >= 1
        paths.append(region.last_scan_profile.path)
    fe.do_query("SET stream_threshold_rows = 64000000")
    fe.do_query("SET tpu_dispatch_min_rows = 0")
    fe.do_query("SELECT host, avg(v) FROM t GROUP BY host")
    paths.append(region.last_scan_profile.path)
    assert paths == ["streamed", "streamed", "indexed-point", "resident"], \
        paths
    fe.shutdown()
new = sorted(set(sys.modules) - before)
print(json.dumps(new))
"""


def test_streamed_path_imports_no_reference():
    """The streamed cold path (both reductions), the indexed-point path
    and the plan codec behind scan fusion run on the CPU without adding
    jax or greptimedb_tpu to sys.modules."""
    out = subprocess.run([sys.executable, "-c", _STREAM_PROBE], cwd=REPO,
                         env=_ENV, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    new = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in new if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    for m in ("query.stream_exec", "query.plan_codec", "query.tpu_exec"):
        assert f"greptimedb_tpu_torch.{m}" in new, m


@pytest.mark.parametrize("module", ["query/stream_exec.py",
                                    "query/plan_codec.py"])
def test_scan_path_modules_are_the_ports_own(module):
    """The cold scan paths' modules exist in the port, import nothing
    forbidden and keep their imports relative."""
    path = os.path.join(PORT, module)
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            assert node.module.split(".")[0] not in \
                FORBIDDEN + ("greptimedb_tpu_torch",), path
        elif isinstance(node, ast.Import):
            assert all(a.name.split(".")[0] not in FORBIDDEN
                       for a in node.names), path


_SURFACE_PROBE = r"""
import json, sys, tempfile
before = set(sys.modules)
from greptimedb_tpu_torch.datanode import DatanodeOptions
from greptimedb_tpu_torch.frontend import build_standalone
from greptimedb_tpu_torch.tools import sqlness

with tempfile.TemporaryDirectory() as home:
    fe = build_standalone(DatanodeOptions(data_home=home, device="cpu"))
    fe.do_query("CREATE TABLE t (host STRING, ts TIMESTAMP TIME INDEX, "
                "v DOUBLE, PRIMARY KEY(host))")
    fe.do_query("INSERT INTO t VALUES ('h0', 1, 1.5), ('h2', 2, 2.5), "
                "('h2', 3, 0.5)")
    fe.do_query("SET tpu_dispatch_min_rows = 0")
    for sql in ("SHOW TABLES", "SHOW DATABASES", "DESCRIBE TABLE t",
                "SHOW CREATE TABLE t",
                "SELECT * FROM information_schema.columns",
                "SELECT * FROM information_schema.runtime_metrics",
                "EXPLAIN SELECT host, median(v) FROM t GROUP BY host",
                "EXPLAIN ANALYZE SELECT host, approx_distinct(v), "
                "sum(v * 2) FROM t GROUP BY host",
                "SELECT host, rank() OVER (ORDER BY avg(v)) FROM t "
                "GROUP BY host"):
        assert fe.do_query(sql)[0].num_rows >= 1, sql
    fe.shutdown()
assert sqlness.run_one(sqlness.CASES_DIR / "show" / "show.sql",
                       device="cpu") is None
new = sorted(set(sys.modules) - before)
print(json.dumps(new))
"""


def test_sql_surface_imports_no_reference():
    """SHOW, DESCRIBE, information_schema, EXPLAIN (ANALYZE), sketch and
    expression aggregates, window functions and the golden runner run on
    the CPU without adding jax or greptimedb_tpu to sys.modules."""
    out = subprocess.run([sys.executable, "-c", _SURFACE_PROBE], cwd=REPO,
                         env=_ENV, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    new = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in new if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    for m in ("query.sketches", "query.show", "query.window",
              "catalog.information_schema", "tools.sqlness"):
        assert f"greptimedb_tpu_torch.{m}" in new, m


@pytest.mark.parametrize("module", ["query/sketches.py", "query/show.py",
                                    "query/window.py",
                                    "catalog/information_schema.py",
                                    "tools/sqlness.py",
                                    "promql/lowering.py",
                                    "storage/downsample.py"])
def test_surface_modules_are_the_ports_own(module):
    """The SQL surface's modules exist in the port, import nothing
    forbidden and keep their imports relative."""
    path = os.path.join(PORT, module)
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            assert node.module.split(".")[0] not in \
                FORBIDDEN + ("greptimedb_tpu_torch",), path
        elif isinstance(node, ast.Import):
            assert all(a.name.split(".")[0] not in FORBIDDEN
                       for a in node.names), path


_PROMQL_TABLE_PROBE = r"""
import json, sys, tempfile
before = set(sys.modules)
import numpy as np
from greptimedb_tpu_torch.datanode import DatanodeOptions
from greptimedb_tpu_torch.frontend import build_standalone
from greptimedb_tpu_torch.query import tpu_exec

with tempfile.TemporaryDirectory() as home:
    fe = build_standalone(DatanodeOptions(data_home=home, device="cpu"))
    fe.do_query("CREATE TABLE c (host STRING, ts TIMESTAMP TIME INDEX, "
                "v DOUBLE, PRIMARY KEY(host))")
    fe.do_query("INSERT INTO c VALUES " + ", ".join(
        f"('h{i % 3}', {i * 10_000}, {float(i % 7)})" for i in range(90)))
    fe.do_query("ADMIN FLUSH TABLE c")
    out = fe.do_query("TQL EVAL (0, 300, '60s') rate(c[2m])")[0]
    assert out.num_rows > 0
    tpu_exec.TPU_DISPATCH_MIN_ROWS = 0
    v, _ = fe.promql_engine().query_range(
        "sum by (host) (rate(c[1m]))", 0, 600_000, 60_000)
    assert len(v.labels) == 3 and v.ok.any()
    (region,) = fe.catalog.table("greptime", "public", "c").regions.values()
    assert region.last_scan_profile.path == "resident"
    text = fe.do_query("TQL EXPLAIN (0, 600, '60s') avg(c)")[0]
    assert "TpuAggregateExec" in text.batches[0].to_pydict()["plan"][0]
    fe.do_query("TQL ANALYZE (0, 600, '60s') avg(c)")
    fe.shutdown()
new = sorted(set(sys.modules) - before)
print(json.dumps(new))
"""


def test_promql_over_tables_imports_no_reference():
    """TQL EVAL / EXPLAIN / ANALYZE through the frontend and a lowered
    query_range run on the CPU without adding jax or greptimedb_tpu to
    sys.modules, through the port's own lowering."""
    out = subprocess.run([sys.executable, "-c", _PROMQL_TABLE_PROBE],
                         cwd=REPO, env=_ENV, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    new = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in new if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    for m in ("promql.lowering", "promql.engine", "query.ir"):
        assert f"greptimedb_tpu_torch.{m}" in new, m


_FLOW_PROBE = r"""
import json, sys, tempfile
before = set(sys.modules)
from greptimedb_tpu_torch.datanode import DatanodeOptions
from greptimedb_tpu_torch.frontend import build_standalone

with tempfile.TemporaryDirectory() as home:
    fe = build_standalone(DatanodeOptions(data_home=home, device="cpu"))
    fe.do_query("CREATE TABLE c (host STRING, ts TIMESTAMP TIME INDEX, "
                "v DOUBLE, PRIMARY KEY(host))")
    fe.do_query("INSERT INTO c VALUES " + ", ".join(
        f"('h{i % 3}', {i * 10_000}, {float(i % 7)})" for i in range(90)))
    fe.do_query("CREATE FLOW c_1m AS SELECT host, date_bin(INTERVAL "
                "'1 minute', ts) AS b, sum(v) AS s, count(v) AS n FROM c "
                "GROUP BY host, b")
    assert fe.datanode.flow_manager.tick()["greptime.public.c_1m"] > 0
    fe.do_query("SELECT host, date_bin(INTERVAL '5 minutes', ts) AS b, "
                "avg(v) FROM c GROUP BY host, b")
    assert "rollup-rewrite" in fe.query_engine.last_exec_stats.dispatch
    assert fe.do_query("SHOW FLOWS")[0].num_rows == 1
    assert fe.do_query("SELECT * FROM information_schema.flows")[0]         .num_rows == 1
    fe.shutdown()
new = sorted(set(sys.modules) - before)
print(json.dumps(new))
"""


def test_flow_path_imports_no_reference():
    """CREATE FLOW, a fold, the rollup rewrite, SHOW FLOWS and
    information_schema.flows run on the CPU without adding jax or
    greptimedb_tpu to sys.modules, through the port's own flow/ and
    storage/downsample.py."""
    out = subprocess.run([sys.executable, "-c", _FLOW_PROBE], cwd=REPO,
                         env=_ENV, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    new = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in new if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    for m in ("flow.manager", "flow.lowering", "flow.rewrite",
              "storage.downsample"):
        assert f"greptimedb_tpu_torch.{m}" in new, m


def test_chip_smoke_imports_nothing_forbidden():
    """chip_smoke.py imports neither jax nor the JAX package, at module
    level or inside a function."""
    path = os.path.join(REPO, "chip_smoke.py")
    names = []
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert "greptimedb_tpu_torch.tools" in names    # the golden runner
    assert not [n for n in names if n.split(".")[0] in FORBIDDEN], names


def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_port_sources_import_nothing_forbidden():
    seen = 0
    for path in _port_sources():
        rel = os.path.relpath(path, PORT).replace(os.sep, "/")
        forbidden = FORBIDDEN + (HOST_STACK if rel.startswith(PROMQL_PATH)
                                 and rel != DATASOURCE else ())
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in forbidden, f"{path}: imports {name}"
                assert top != "greptimedb_tpu_torch", \
                    f"{path}: absolute import of {name}; keep it relative"
        seen += 1
    assert seen >= 10


@pytest.mark.parametrize("package", ["mito", "procedure", "partition",
                                     "datanode", "frontend", "flow",
                                     "servers", "file_table", "monitor",
                                     "script", "api", "client", "cmd",
                                     "meta"])
def test_frontend_packages_are_the_ports_own(package):
    """Each package of the standalone frontend exists in the port, imports
    nothing forbidden and keeps its imports relative (the walk over every
    source above covers them; this pins that they are there to walk)."""
    files = [p for p in _port_sources()
             if os.path.relpath(p, PORT).startswith(package + os.sep)]
    assert any(p.endswith("__init__.py") for p in files), package
    for path in files:
        for node in ast.walk(ast.parse(open(path).read(), path)):
            if isinstance(node, ast.ImportFrom) and node.level == 0:
                assert node.module.split(".")[0] not in \
                    FORBIDDEN + ("greptimedb_tpu_torch",), path
            elif isinstance(node, ast.Import):
                assert all(a.name.split(".")[0] not in FORBIDDEN
                           for a in node.names), path


@pytest.mark.parametrize("engine", ["promql", "sql", "frontend",
                                    "sqlness"])
def test_default_device_raises_without_cuda(engine, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is usable")
    if engine == "sql":
        _sql_default_device_raises()
        return
    if engine == "sqlness":
        # the golden runner without --device refuses rather than answer
        # on the CPU (in a subprocess: a run resets the process's
        # failpoint and background-job registries, as a fresh server's)
        out = subprocess.run(
            [sys.executable, "-m", "greptimedb_tpu_torch.tools.sqlness",
             "basic/basic"], cwd=REPO, env=_ENV, capture_output=True,
            text=True, timeout=120)
        assert out.returncode != 0
        assert "CUDA is not available" in out.stderr
        assert "[PASS]" not in out.stdout and "[FAIL]" not in out.stdout
        return
    if engine == "frontend":
        from greptimedb_tpu_torch.datanode import DatanodeOptions
        from greptimedb_tpu_torch.frontend import build_standalone
        assert DatanodeOptions().device == "cuda"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_standalone(DatanodeOptions(data_home=str(tmp_path)))
        assert not os.listdir(tmp_path)      # nothing was opened
        return
    from greptimedb_tpu_torch.ops import window as win
    from greptimedb_tpu_torch.promql import engine as eng
    import numpy as np
    ts = 1_700_000_000_000 + np.arange(0, 600_000, 15_000)
    sm = win.SeriesMatrix.build(np.zeros(len(ts), int), ts,
                                np.ones(len(ts)), 1)

    class Mem(eng.PromqlEngine):
        def select(self, sel, lo, hi, ctx):
            return eng._Selection([{"__name__": "x"}], sm, int(ts[0]),
                                  int(ts[-1]))

    e = Mem(None)
    assert e.device.type == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        e.query_to_prom_json("rate(x[5m])", int(ts[0]), int(ts[-1]),
                             60_000)


def _sql_default_device_raises():
    """A QueryEngine left on "cuda" raises at its first device transfer
    (the floor pinned so the statement takes the device path)."""
    ns = {}
    probe = _SQL_PROBE.split("tpu_exec.TPU_DISPATCH_MIN_ROWS = 0")[0]
    exec(probe, ns)
    from greptimedb_tpu_torch.query import QueryEngine, tpu_exec
    from greptimedb_tpu_torch.session import QueryContext
    from greptimedb_tpu_torch.sql import parse_sql
    e = QueryEngine(ns["cat"])
    assert e.device.type == "cuda"
    saved = tpu_exec.TPU_DISPATCH_MIN_ROWS, tpu_exec._observed_min_dt[0]
    tpu_exec.TPU_DISPATCH_MIN_ROWS, tpu_exec._observed_min_dt[0] = 0, None
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            e.execute(parse_sql("SELECT host, max(v) FROM t GROUP BY host"),
                      QueryContext())
    finally:
        tpu_exec.TPU_DISPATCH_MIN_ROWS, tpu_exec._observed_min_dt[0] = saved
        tpu_exec.SCAN_CACHE.clear()


def test_counts_leq_refuses_devices_it_has_no_kernel_for():
    from greptimedb_tpu_torch.ops import pallas_window as pw
    b = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pw.counts_leq(b, 4)


def test_chip_smoke_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=_ENV, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "CUDA is not available" in out.stderr


_STORAGE_PROBE = r"""
import json, sys, tempfile
before = set(sys.modules)
import numpy as np
from greptimedb_tpu_torch.common import (admission, background_jobs,
                                         exec_stats, failpoint, locks,
                                         plugins, process_list, telemetry,
                                         tracking)
host_only = sorted(set(sys.modules) - before)
from greptimedb_tpu_torch.datatypes import data_type as dt
from greptimedb_tpu_torch.datatypes.schema import (ColumnSchema, Schema,
                                                   SemanticType)
from greptimedb_tpu_torch.storage import (EngineConfig, StorageEngine,
                                          WriteBatch)

schema = Schema([
    ColumnSchema("host", dt.STRING, semantic_type=SemanticType.TAG),
    ColumnSchema("ts", dt.TIMESTAMP_MILLISECOND, nullable=False,
                 semantic_type=SemanticType.TIMESTAMP),
    ColumnSchema("v", dt.FLOAT64, semantic_type=SemanticType.FIELD)])
with tempfile.TemporaryDirectory() as home:
    eng = StorageEngine(EngineConfig(data_home=home, wal_backend="python"))
    region = eng.create_region("t_0", schema)
    region.bulk_ingest({"host": np.array(["a", "b"] * 50, dtype=object),
                        "ts": np.arange(100, dtype=np.int64),
                        "v": np.arange(100.0)})
    wb = WriteBatch(schema)
    wb.put({"host": ["a"], "ts": [200], "v": [1.0]})
    region.write(wb)
    region.flush()
    region.compact()
    assert region.snapshot().read_merged().num_rows == 101
    eng.close()
    eng = StorageEngine(EngineConfig(data_home=home, wal_backend="python"))
    assert eng.open_region("t_0").snapshot().scan().num_rows == 101
    eng.close()
new = sorted(set(sys.modules) - before)
print(json.dumps({"new": new, "host_only": host_only}))
"""


def test_storage_engine_runs_without_reference():
    out = subprocess.run([sys.executable, "-c", _STORAGE_PROBE], cwd=REPO,
                         env=_ENV, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in got["new"] if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    assert "greptimedb_tpu_torch.storage.region" in got["new"]
    heavy = [m for m in got["host_only"]
             if m.split(".")[0] in FORBIDDEN + HOST_STACK]
    assert not heavy, heavy
    assert "greptimedb_tpu_torch.common.telemetry" in got["host_only"]


def test_telemetry_names_shared_without_registry_clash():
    """The same counter and timer names through both packages in one
    process: the port's go to its own registry, not prometheus_client's
    default one, where the reference's live."""
    from prometheus_client import REGISTRY
    from greptimedb_tpu.common import telemetry as ref_tel
    from greptimedb_tpu_torch.common import telemetry as port_tel
    name = "torch_guard_shared_name"
    for tel in (ref_tel, port_tel, ref_tel, port_tel):
        tel.increment_counter(name, 2)
        tel._observe(name, 0.001)
    total = f"greptime_{name}_total"
    assert REGISTRY.get_sample_value(total) == 4
    assert port_tel.registry() is not REGISTRY
    assert port_tel.registry().get_sample_value(total) == 4
    assert any(f.name == f"greptime_{name}" for f in
               port_tel.collect_families())


def test_native_wal_builds_from_port_source():
    from greptimedb_tpu.storage import native_wal as ref_nw
    from greptimedb_tpu_torch.storage import native_wal as nw
    assert nw._SRC == os.path.join(PORT, "native", "wal.cpp")
    assert os.path.dirname(nw._LIB) == os.path.join(PORT, "native", "build")
    assert nw._LIB != ref_nw._LIB
    if shutil.which("g++") is None:
        pytest.skip("the native WAL builds with g++, which this machine "
                    "lacks")
    lib = nw.load_library()
    assert lib is not None and lib._name == nw._LIB
    assert os.path.getmtime(nw._LIB) >= os.path.getmtime(nw._SRC)


_HTTP_PROBE = r"""
import json, sys, tempfile, urllib.parse, urllib.request
before = set(sys.modules)
from greptimedb_tpu_torch.datanode import DatanodeOptions
from greptimedb_tpu_torch.frontend import build_standalone
from greptimedb_tpu_torch.servers import prometheus
from greptimedb_tpu_torch.servers.http import HttpServer
from greptimedb_tpu_torch.utils import snappy


def req(path, body=None, params=None):
    url = f"http://127.0.0.1:{srv.port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    with urllib.request.urlopen(urllib.request.Request(
            url, data=body, method="POST" if body is not None else "GET"),
            timeout=10) as resp:
        return resp.status, resp.read()


with tempfile.TemporaryDirectory() as home:
    fe = build_standalone(DatanodeOptions(data_home=home, device="cpu"))
    srv = HttpServer(fe, addr="127.0.0.1:0")
    srv.start()
    try:
        series = [prometheus.TimeSeries(
            labels={"__name__": "up", "host": f"h{i}"},
            samples=[(float(j), 1_700_000_000_000 + j * 10_000)
                     for j in range(30)]) for i in range(3)]
        assert req("/v1/prometheus/write",
                   prometheus.encode_write_request(series))[0] == 204
        assert req("/v1/influxdb/write", b"m,h=a v=1 1",
                   {"precision": "ms"})[0] == 204
        assert req("/v1/sql", params={
            "sql": "SET tpu_dispatch_min_rows = 0; SELECT host, avg("
                   "greptime_value) FROM up GROUP BY host"})[0] == 200
        status, body = req("/api/v1/query_range", params={
            "query": "sum(rate(up[1m]))", "start": "1700000000",
            "end": "1700000290", "step": "30"})
        assert status == 200 and json.loads(body)["data"]["result"]
        q = snappy.compress(prometheus.pw.field_bytes(1, (
            prometheus.pw.field_varint(1, 0) +
            prometheus.pw.field_varint(2, 1_800_000_000_000) +
            prometheus.pw.field_bytes(3, prometheus.pw.field_varint(1, 0) +
                                      prometheus.pw.field_bytes(
                                          2, b"__name__") +
                                      prometheus.pw.field_bytes(3, b"up")))))
        assert req("/v1/prometheus/read", q)[0] == 200
        assert snappy._lib is not None
    finally:
        srv.shutdown()
        fe.shutdown()
new = sorted(set(sys.modules) - before)
print(json.dumps(new))
"""


def test_http_path_imports_no_reference():
    """The port's HTTP server answers remote write, InfluxDB lines, a
    device-path SQL aggregate, a Prometheus range query and remote read on
    the CPU without adding jax or greptimedb_tpu to sys.modules, through
    its own servers/ and codecs."""
    out = subprocess.run([sys.executable, "-c", _HTTP_PROBE], cwd=REPO,
                         env=_ENV, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    new = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in new if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    for m in ("servers.http", "servers.prom_api", "servers.prometheus",
              "servers.influxdb", "servers.coalesce", "servers.auth",
              "servers.interceptor", "common.admission", "common.plugins",
              "utils.snappy", "utils.protowire"):
        assert f"greptimedb_tpu_torch.{m}" in new, m


def test_native_snappy_builds_from_port_source():
    from greptimedb_tpu.utils import snappy as ref_snappy
    from greptimedb_tpu_torch.utils import snappy
    assert snappy._SRC == os.path.join(PORT, "native", "snappy.cpp")
    assert os.path.dirname(snappy._LIB_PATH) == os.path.join(PORT, "native",
                                                             "build")
    assert snappy._LIB_PATH != ref_snappy._LIB_PATH
    if shutil.which("g++") is None:
        pytest.skip("the native snappy builds with g++, which this machine "
                    "lacks")
    lib = snappy._load()
    assert lib is not None and lib._name == snappy._LIB_PATH
    assert os.path.getmtime(snappy._LIB_PATH) >= os.path.getmtime(snappy._SRC)


def test_datasource_stays_off_the_promql_path():
    """common/datasource.py (pyarrow) is imported by COPY and the file
    tables only: no other source of the port names it."""
    users = []
    for path in _port_sources():
        rel = os.path.relpath(path, PORT).replace(os.sep, "/")
        for node in ast.walk(ast.parse(open(path).read(), path)):
            if isinstance(node, ast.ImportFrom) and (node.module or "") \
                    .endswith("datasource"):
                users.append(rel)
    assert sorted(set(users)) == sorted(DATASOURCE_USERS)


_WIRE_PROBE = r"""
import json, sys, tempfile, socket, struct, os
before = set(sys.modules)
from greptimedb_tpu_torch.datanode import DatanodeOptions
from greptimedb_tpu_torch.frontend import build_standalone
from greptimedb_tpu_torch.servers import mysql
from greptimedb_tpu_torch.servers.mysql import MysqlServer
from greptimedb_tpu_torch.servers.postgres import PostgresServer


def my_query(port, sql):
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    io = mysql.PacketIO(s)
    g = io.read_packet()
    io.write_packet(struct.pack("<IIB", mysql.CLIENT_PROTOCOL_41 |
                                mysql.CLIENT_SECURE_CONNECTION, 1 << 24, 45)
                    + b"\0" * 23 + b"greptime\0\0")
    assert io.read_packet()[0] == 0
    io.reset_seq()
    io.write_packet(bytes([mysql.COM_QUERY]) + sql.encode())
    head = io.read_packet()
    s.close()
    return head


def pg_query(port, sql):
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    body = struct.pack("!I", 196608) + b"user\0greptime\0\0"
    s.sendall(struct.pack("!I", len(body) + 4) + body)
    f = s.makefile("rb")
    def msg():
        head = f.read(5)
        return chr(head[0]), f.read(struct.unpack("!I", head[1:])[0] - 4)
    while msg()[0] != "Z":
        pass
    s.sendall(b"Q" + struct.pack("!I", len(sql) + 5) + sql.encode() + b"\0")
    tags = []
    while True:
        t, _ = msg()
        tags.append(t)
        if t == "Z":
            s.close()
            return tags


with tempfile.TemporaryDirectory() as home:
    fe = build_standalone(DatanodeOptions(data_home=home, device="cpu"))
    my, pg = MysqlServer(fe), PostgresServer(fe)
    my.start(); pg.start()
    try:
        fe.do_query("CREATE TABLE t (host STRING, ts TIMESTAMP TIME INDEX, "
                    "v DOUBLE, PRIMARY KEY(host))")
        fe.do_query("INSERT INTO t VALUES ('h0', 1, 1.5), ('h2', 2, 2.5)")
        assert my_query(my.port, "SELECT host, avg(v) FROM t GROUP BY "
                        "host")[0] == 2
        assert pg_query(pg.port, "SELECT * FROM t") == ["T", "D", "D", "C",
                                                         "Z"]
        assert my_query(my.port, "KILL 99")[0] == 0xFF
        # an external table's location is a key under the object store
        out = os.path.join(fe.datanode.store.root, "ext", "t.csv.gz")
        fe.do_query(f"COPY t TO '{out}' WITH (format='csv')")
        fe.do_query("CREATE EXTERNAL TABLE e WITH (location='ext/t.csv.gz', "
                    "format='csv')")
        fe.do_query("CREATE TABLE u (host STRING, ts TIMESTAMP TIME INDEX, "
                    "v DOUBLE, PRIMARY KEY(host))")
        fe.do_query(f"COPY u FROM '{out}' WITH (format='csv')")
        assert fe.do_query("SELECT count(*) FROM e")[0].num_rows == 1
    finally:
        my.shutdown(); pg.shutdown()
        fe.shutdown()
new = sorted(set(sys.modules) - before)
print(json.dumps(new))
"""


def test_wire_servers_and_copy_import_no_reference():
    """The MySQL and Postgres servers answer over real sockets, KILL
    answers, COPY TO / FROM and an external table run on the CPU without
    adding jax or greptimedb_tpu to sys.modules, through the port's own
    modules."""
    out = subprocess.run([sys.executable, "-c", _WIRE_PROBE], cwd=REPO,
                         env=_ENV, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    new = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in new if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    for m in ("servers.mysql", "servers.postgres", "file_table.engine",
              "common.datasource"):
        assert f"greptimedb_tpu_torch.{m}" in new, m


_OBSERVABILITY_PROBE = r"""
import json, sys, tempfile
before = set(sys.modules)
from greptimedb_tpu_torch.datanode import DatanodeOptions
from greptimedb_tpu_torch.frontend import build_standalone

with tempfile.TemporaryDirectory() as home:
    fe = build_standalone(DatanodeOptions(data_home=home, device="cpu"))
    try:
        fe.do_query("CREATE TABLE t (host STRING, ts TIMESTAMP TIME INDEX, "
                    "v DOUBLE, PRIMARY KEY(host))")
        fe.do_query("INSERT INTO t VALUES ('h0', 1, 1.5), ('h2', 2, 2.5)")
        fe.do_query("SET trace_sample_ratio = 1")
        fe.do_query("SELECT host, v FROM t")
        assert fe.do_query("ADMIN SHOW TRACE 'last'")[0].num_rows >= 1
        fe.profiler.sample_once()
        assert fe.self_monitor.tick() > 0
        for view in ("self_monitor", "trace_spans", "profile_samples"):
            fe.do_query(f"SELECT * FROM information_schema.{view}")
        fe.script_engine.insert_script("half", (
            "@copr(args=['v'], returns=['h'], sql='SELECT v FROM t')\n"
            "def half(v):\n    return torch.as_tensor(v) / 2\n"))
        out = fe.script_engine.run("half")
        assert out.batches[0].column(0).to_pylist() == [0.75, 1.25]
        fe.do_query("SET trace_sample_ratio = 0.01")
    finally:
        fe.shutdown()
new = sorted(set(sys.modules) - before)
print(json.dumps(new))
"""


def test_observability_and_scripts_import_no_reference():
    """A traced statement, ADMIN SHOW TRACE, a profiler sample, a
    self-monitor tick, the three information_schema views and a torch
    coprocessor run on the CPU without adding jax or greptimedb_tpu to
    sys.modules, through the port's own modules."""
    out = subprocess.run([sys.executable, "-c", _OBSERVABILITY_PROBE],
                         cwd=REPO, env=_ENV, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    new = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in new if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    for m in ("common.trace_store", "common.profiler", "monitor.scraper",
              "script.engine", "script.copr"):
        assert f"greptimedb_tpu_torch.{m}" in new, m


#: what the profiler's sampling pass imports or calls into at sample time
SAMPLER_MODULES = ("common/profiler.py", "common/background_jobs.py",
                   "common/process_list.py", "common/failpoint.py",
                   "common/locks.py", "common/tracking.py",
                   "common/runtime.py", "utils/__init__.py")


@pytest.mark.parametrize("rel", SAMPLER_MODULES)
def test_sampler_never_imports_torch(rel):
    """The profiler's thread walks sys._current_frames() and the port's
    process and job registries only: none of the modules it runs imports
    torch, at module level or inside a function, so sampling can neither
    create a CUDA context nor synchronize the device."""
    path = os.path.join(PORT, rel)
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not [n for n in names if n.split(".")[0] == "torch"], path


_SAMPLER_PROBE = r"""
import os, sys, threading, time
import torch
from greptimedb_tpu_torch.common import profiler

torch_dir = os.path.dirname(torch.__file__)
touched = []


def watch(frame, event, arg):
    if not threading.current_thread().name.startswith("profiler-"):
        return
    if event == "call" and frame.f_code.co_filename.startswith(torch_dir):
        touched.append(frame.f_code.co_name)
    elif event == "c_call" and str(getattr(arg, "__module__", "")) \
            .startswith("torch"):
        touched.append(arg.__name__)


threading.setprofile(watch)
p = profiler.Profiler(node_label="probe", writer=None)
profiler.install(p)
profiler.configure(enabled=True, hz=250)
time.sleep(0.3)
p.collect_burst(0.1, burst_hz=250)
profiler.configure(enabled=False)
profiler.install(None)
threading.setprofile(None)
assert p.stats["samples"] > 0, p.stats
assert not touched, touched[:10]
print("ok")
"""


def test_sampler_thread_calls_no_torch():
    """The profiler's own thread, sampling at 250 Hz and through a burst,
    enters no torch function (Python or C): it cannot create a CUDA
    context or synchronize the device the sampled statements run on."""
    out = subprocess.run([sys.executable, "-c", _SAMPLER_PROBE], cwd=REPO,
                         env=_ENV, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_script_namespace_holds_torch_and_no_jnp(tmp_path):
    from greptimedb_tpu_torch.datanode import DatanodeOptions
    from greptimedb_tpu_torch.frontend import build_standalone
    fe = build_standalone(DatanodeOptions(data_home=str(tmp_path),
                                          device="cpu"))
    try:
        c = fe.script_engine.compile(
            "@copr(args=[])\ndef ns():\n    return sorted(globals())\n")
        names = set(c())
        assert {"torch", "np", "numpy", "copr", "coprocessor"} <= names
        assert "jnp" not in names and "jax" not in names
        assert fe.script_engine.device == fe.query_engine.device
    finally:
        fe.shutdown()


_STANDALONE_PROBE = r"""
import builtins, http.server, json, sys, tempfile, threading, urllib.parse
before = set(sys.modules)
objects = {}


class S3(http.server.BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def _key(self):
        return urllib.parse.unquote(self.path.split("?")[0].lstrip("/"))

    def _reply(self, status, body=b""):
        self.send_response(status)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_PUT(self):
        objects[self._key()] = self.rfile.read(
            int(self.headers["Content-Length"]))
        self._reply(200)

    def do_GET(self):
        u = urllib.parse.urlparse(self.path)
        q = urllib.parse.parse_qs(u.query)
        if "list-type" in q:
            b, p = u.path.lstrip("/"), q.get("prefix", [""])[0]
            keys = sorted(k[len(b) + 1:] for k in objects
                          if k.startswith(f"{b}/{p}"))
            self._reply(200, ("<ListBucketResult>" + "".join(
                f"<Contents><Key>{k}</Key></Contents>" for k in keys) +
                "</ListBucketResult>").encode())
        elif self._key() in objects:
            self._reply(200, objects[self._key()])
        else:
            self._reply(404)

    def do_HEAD(self):
        self._reply(200 if self._key() in objects else 404)

    def do_DELETE(self):
        objects.pop(self._key(), None)
        self._reply(204)


srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), S3)
threading.Thread(target=srv.serve_forever, args=(0.01,), daemon=True).start()
from greptimedb_tpu_torch.cmd.main import StandaloneOptions, build_servers, main
from greptimedb_tpu_torch.client.flight import Database

with tempfile.TemporaryDirectory() as home:
    opts = StandaloneOptions(
        data_home=home, http_addr="127.0.0.1:0", mysql_addr="127.0.0.1:0",
        postgres_addr="127.0.0.1:0", grpc_addr="127.0.0.1:0", device="cpu",
        storage={"type": "S3", "bucket": "b", "root": "r",
                 "endpoint": f"http://127.0.0.1:{srv.server_address[1]}",
                 "cache_path": home + "/cache"})
    fe, servers = build_servers(opts)
    for s in servers:
        s.start()
    grpc = servers[-1]
    db = Database(f"grpc://127.0.0.1:{grpc.port}")
    db.bulk_load("t", {"h": ["a", "b"], "greptime_timestamp": [1, 2],
                       "v": [1.0, 2.0]}, tag_columns=["h"])
    db.insert("t", {"h": ["c"], "greptime_timestamp": [3], "v": [3.0]},
              tag_columns=["h"])
    assert db.sql("ADMIN FLUSH TABLE t") == 0
    got = [tuple(r) for b in db.sql("SELECT h, v FROM t ORDER BY h")
           for r in b.rows()]
    assert got == [("a", 1.0), ("b", 2.0), ("c", 3.0)], got
    assert any(k.endswith(".parquet") for k in objects)
    from greptimedb_tpu_torch.api.client import GreptimeDatabase
    proto = GreptimeDatabase(f"grpc://127.0.0.1:{grpc.port}")
    table, _ = proto.sql("SELECT count(*) FROM t")
    assert table.column(0).to_pylist() == [3]
    proto.close()
    lines = iter(["SELECT count(*) FROM t;", "\\q"])
    builtins.input = lambda prompt="": next(lines)
    main(["cli", "attach", "--grpc-addr", f"127.0.0.1:{grpc.port}"])
    db.close()
    for s in servers:
        s.shutdown()
    fe.shutdown()
srv.shutdown()
new = sorted(set(sys.modules) - before)
print(json.dumps(new))
"""


def test_standalone_process_imports_no_reference():
    """`build_servers` over S3 with the disk cache, a bulk load, a row
    insert, a flush to the bucket, queries over Flight (a JSON ticket and
    a greptime-proto one) and `cli attach` run on the CPU without adding jax or greptimedb_tpu to sys.modules,
    through the port's own modules."""
    out = subprocess.run([sys.executable, "-c", _STANDALONE_PROBE],
                         cwd=REPO, env=_ENV, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert any("| 3        |" in line for line in lines), lines
    new = json.loads(lines[-1])
    bad = [m for m in new if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    for m in ("storage.s3", "storage.cache", "api.v1", "servers.flight",
              "servers.grpc", "client.flight", "cmd.main"):
        assert f"greptimedb_tpu_torch.{m}" in new, m


def _imports(tree):
    """(module-level, inside-function) relative imports of a module, as
    dotted names ('.s3')."""
    top, inner = set(), set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            top.add("." * node.level + (node.module or ""))
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for sub in ast.walk(node):
                if isinstance(sub, ast.ImportFrom):
                    inner.add("." * sub.level + (sub.module or ""))
    return top, inner


@pytest.mark.parametrize("rel,lazy", [
    ("storage/retry.py", {".s3"}),
    ("storage/object_store.py", {".s3", ".cache"})])
def test_s3_and_cache_import_lazily_as_in_the_reference(rel, lazy):
    """retry.py and object_store.py import s3 and cache only inside
    functions, where the reference's do, so that `objstore_request` and
    `cache_read` register at the same point in a process's life."""
    got = {}
    for pkg in ("greptimedb_tpu", "greptimedb_tpu_torch"):
        path = os.path.join(REPO, pkg, rel)
        got[pkg] = _imports(ast.parse(open(path).read(), path))
    for pkg, (top, inner) in got.items():
        assert not top & {".s3", ".cache"}, (pkg, top)
        assert lazy <= inner, (pkg, inner)
    assert {m for m in got["greptimedb_tpu_torch"][1] if m in lazy} == \
        {m for m in got["greptimedb_tpu"][1] if m in lazy}


def test_cmd_turns_on_no_compile_cache():
    """The port compiles no program at run time: cmd/main.py names no
    jax_cache and no compile-cache call, and the port has no
    common/jax_cache.py."""
    path = os.path.join(PORT, "cmd", "main.py")
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.Name):
            names.add(node.id)
        elif isinstance(node, ast.Attribute):
            names.add(node.attr)
    assert not {n for n in names if "jax_cache" in n or
                "compile_cache" in n}, names
    assert not os.path.exists(os.path.join(PORT, "common", "jax_cache.py"))


_CLIENT_PROBE = r"""
import importlib, json, sys
import pyarrow as pa
importlib.import_module("greptimedb_tpu_torch.cmd.main")
from greptimedb_tpu_torch.client import flight
from greptimedb_tpu_torch.datatypes.record_batch import (
    RecordBatch, pretty_print)
flight._traced({"type": "sql", "sql": "SELECT 1"})
flight._absorb_stream_stats(pa.schema([]))
pretty_print([RecordBatch.from_arrow(pa.record_batch({"a": [1]}))])
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("torch", "jax"))))
"""


def test_client_imports_no_torch():
    """`cli attach` and the Flight `Database` (what a client process runs
    to send a statement and print its answer) import no torch: a client
    starts in under a second instead of loading the CUDA libraries."""
    out = subprocess.run([sys.executable, "-c", _CLIENT_PROBE], cwd=REPO,
                         env=_ENV, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


_CLUSTER_PROBE = r"""
import json, sys, tempfile
before = set(sys.modules)
from greptimedb_tpu_torch.client import LocalDatanodeClient
from greptimedb_tpu_torch.client.flight import FlightDatanodeClient
from greptimedb_tpu_torch.datanode import DatanodeInstance, DatanodeOptions
from greptimedb_tpu_torch.frontend.statement import build_schema_from_create
from greptimedb_tpu_torch.meta import MemKv, MetaClient, MetaSrv, Peer
from greptimedb_tpu_torch.partition.rule import rule_from_partitions
from greptimedb_tpu_torch.query import tpu_exec
from greptimedb_tpu_torch.query.planner import analyze
from greptimedb_tpu_torch.servers.flight import FlightDatanodeServer
from greptimedb_tpu_torch.sql import parse_sql
from greptimedb_tpu_torch.table import CreateTableRequest
home = tempfile.mkdtemp()
srv = MetaSrv(MemKv())
meta = MetaClient(srv)
nodes, servers, clients = {}, {}, {}
for i in (1, 2):
    nodes[i] = DatanodeInstance(DatanodeOptions(
        data_home=home, node_id=i, device="cpu",
        register_numbers_table=False))
    nodes[i].start()
    servers[i] = FlightDatanodeServer(nodes[i])
    servers[i].serve_in_background()
    clients[i] = FlightDatanodeClient(servers[i].address, i)
    meta.register(Peer(i, servers[i].address))
    nodes[i].start_heartbeat(meta, interval_s=3600, stats_every=1)
stmt = parse_sql("CREATE TABLE t (h STRING, ts TIMESTAMP TIME INDEX, "
                 "v DOUBLE, PRIMARY KEY(h)) PARTITION BY RANGE COLUMNS (h) "
                 "(PARTITION a VALUES LESS THAN ('m'), PARTITION b VALUES "
                 "LESS THAN (MAXVALUE))")
schema, pk = build_schema_from_create(stmt)
route = meta.create_route("greptime.public.t", [0, 1])
for i in (1, 2):
    clients[i].ddl_create_table(CreateTableRequest(
        "t", schema, primary_key_indices=pk, partitions=stmt.partitions,
        table_id=route.table_id,
        assigned_region_numbers=route.regions_on(i)))
rule = rule_from_partitions(stmt.partitions)
for rn, h in ((0, "a"), (1, "z")):
    owner = next(r.leader.id for r in route.region_routes
                 if r.region_number == rn)
    clients[owner].write_region("greptime", "public", "t", rn, {
        "h": [h, h], "ts": [1, 2], "v": [1.0, 2.0]}, op="bulk")
q = parse_sql("SELECT h, sum(v) FROM t GROUP BY h")
table = nodes[1].catalog.table("greptime", "public", "t")
plan = tpu_exec.plan_for(table, analyze(q), q)
got = [len(clients[i].region_moments("greptime", "public", "t", plan))
       for i in (1, 2)]
local = LocalDatanodeClient(nodes[1]).region_moments(
    "greptime", "public", "t", plan)
assert got == [1, 1] and len(local) == 1, got
for i in (1, 2):
    nodes[i]._heartbeat_task.fn()
rows = sum(r["approximate_rows"] for r in srv.cluster_info()
           if r["peer_type"] == "datanode")
assert rows == 4, rows
for i in (1, 2):
    clients[i].close()
    servers[i].shutdown()
    nodes[i].shutdown()
print(json.dumps(sorted(set(sys.modules) - before)))
"""


def test_cluster_member_imports_no_reference():
    """Meta, two datanodes with node ids behind their Flight servers,
    DDL, a bulk write_region, region moments over Flight and in the
    process and full heartbeats run on the CPU without adding jax or
    greptimedb_tpu to sys.modules, through the port's own modules."""
    out = subprocess.run([sys.executable, "-c", _CLUSTER_PROBE], cwd=REPO,
                         env=_ENV, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    new = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in new if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    for m in ("meta.service", "meta.balancer", "meta.failure_detector",
              "datanode.instance", "servers.flight", "client.flight",
              "client"):
        assert f"greptimedb_tpu_torch.{m}" in new, m


_CLUSTER_CLIENT_PROBE = r"""
import json, sys
from greptimedb_tpu_torch.client import DatanodeClient, LocalDatanodeClient
from greptimedb_tpu_torch.client.flight import FlightDatanodeClient
from greptimedb_tpu_torch.meta import MemKv, MetaClient, MetaSrv
from greptimedb_tpu_torch.meta.lock import DistributedLock, Election
client = FlightDatanodeClient("grpc://127.0.0.1:1", 3)
assert isinstance(client, DatanodeClient) and client.node_id == 3
srv = MetaSrv(MemKv())
MetaClient(srv).heartbeat(3, None)
assert [p.id for p in srv.alive_datanodes()] == [3]
assert DistributedLock(MemKv(), "x", holder="a").try_acquire()
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("torch", "jax"))))
"""


def test_datanode_clients_and_meta_import_no_torch():
    """client/__init__.py (DatanodeClient, LocalDatanodeClient),
    client/flight.py's FlightDatanodeClient and meta/ import no torch: a
    frontend-side process or a metasrv loads no CUDA library to route."""
    out = subprocess.run([sys.executable, "-c", _CLUSTER_CLIENT_PROBE],
                         cwd=REPO, env=_ENV, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_cluster_datanode_default_device_raises_without_cuda(tmp_path):
    """A datanode with a node id left on its default device ("cuda")
    raises on a machine without CUDA, opens nothing on its data home and
    does not join the in-process registry."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is usable")
    from greptimedb_tpu_torch.datanode import (
        DatanodeInstance, DatanodeOptions)
    from greptimedb_tpu_torch.datanode.instance import live_datanode
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DatanodeInstance(DatanodeOptions(data_home=str(tmp_path),
                                         node_id=2))
    assert not os.listdir(tmp_path)
    assert live_datanode(2) is None
