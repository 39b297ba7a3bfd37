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
                                     "servers", "file_table"])
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
