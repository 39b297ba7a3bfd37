"""EXPLAIN, EXPLAIN ANALYZE, SHOW / DESCRIBE, information_schema and
window functions: the JAX package against the port, on the CPU.

One statement script builds the same tables in both packages' standalone
frontends (`build_standalone(DatanodeOptions(device="cpu"))` and the
reference's FrontendInstance): a seeded `cpu_explain` wider than
tests/sqlness/cases/standalone/explain/dispatch.sql's (three SSTs and a
memtable), a table of every column type with defaults, a range- and a
hash-partitioned table, a second database, and a seeded `wf` wider than
window/window.sql's (ties and NULLs). Then each statement runs through
both and is compared:

- EXPLAIN text byte-equal for the shapes of explain/dispatch.sql, under
  each of its knob settings (the static dispatch floor, `SET
  tpu_dispatch_min_rows`, `SET stream_threshold_rows`), and for the
  sketch and expression shapes, whose dispatch carries the host-partial
  suffix; a point query on an uncached region explains `indexed-point`;
- EXPLAIN ANALYZE: the stage, rows, files and detail columns equal
  (elapsed_ms, wall clock, excluded), on the CPU fallback, the resident
  device path, the resident host-partial path, the streamed path and the
  indexed-point path, and for a window over an aggregate;
- SHOW DATABASES / TABLES (LIKE, WHERE), SHOW CREATE TABLE, DESCRIBE,
  SHOW VARIABLES and the ported information_schema tables: the rendered
  tables equal, with run-dependent columns (ids, wall clock, process
  ordinals) left out of the comparison;
- the window functions of window/window.sql over `wf`: every value
  equal.

Outputs are rendered by each package's own golden renderer
(tests/sqlness/runner.py and greptimedb_tpu_torch/tools/sqlness.py) and
compared as text. The resident device statements use one aggregate
signature (avg over one DOUBLE column), so the reference compiles few
JAX programs; every other path compiles none.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from greptimedb_tpu.datanode import DatanodeInstance as RefDatanode
from greptimedb_tpu.datanode import DatanodeOptions as RefOptions
from greptimedb_tpu.frontend import FrontendInstance as RefFrontend
from greptimedb_tpu.query import stream_exec as ref_stream
from greptimedb_tpu.query import tpu_exec as ref_exec
from greptimedb_tpu.session import QueryContext as RefCtx
from greptimedb_tpu_torch.datanode import DatanodeOptions
from greptimedb_tpu_torch.frontend import build_standalone
from greptimedb_tpu_torch.query import stream_exec, tpu_exec
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.tools import sqlness as port_runner

sys.path.insert(0, str(Path(__file__).parent / "sqlness"))
import runner as ref_runner  # noqa: E402

T0 = 1_700_000_000_000


def _values(rows):
    def lit(v):
        return "NULL" if v is None else repr(v)
    return ", ".join("(" + ", ".join(lit(v) for v in r) + ")" for r in rows)


def _script():
    rng = np.random.default_rng(17)
    ex = [(f"h{i:02d}", T0 + k * 1000, float(np.round(rng.random() * 100, 3)),
           float(np.round(rng.normal(20, 5), 3)))
          for k in range(60) for i in range(30)]
    wf = []
    for i in range(6):
        for k in range(40):
            v = None if rng.random() < 0.08 else \
                float(rng.integers(0, 12)) / 2
            wf.append((f"w{i}", T0 + k * 500, v))
    third = len(ex) // 3
    return [
        "CREATE TABLE cpu_explain (hostname STRING, ts TIMESTAMP TIME "
        "INDEX, usage_user DOUBLE, usage_system DOUBLE, "
        "PRIMARY KEY(hostname))",
        "INSERT INTO cpu_explain VALUES " + _values(ex[:third]),
        "ADMIN FLUSH TABLE cpu_explain",
        "INSERT INTO cpu_explain VALUES " + _values(ex[third:2 * third]),
        "ADMIN FLUSH TABLE cpu_explain",
        "INSERT INTO cpu_explain VALUES " + _values(ex[2 * third:-90]),
        "ADMIN FLUSH TABLE cpu_explain",
        "INSERT INTO cpu_explain VALUES " + _values(ex[-90:]),
        "CREATE TABLE wf (host STRING, ts TIMESTAMP TIME INDEX, v DOUBLE, "
        "PRIMARY KEY(host))",
        "INSERT INTO wf VALUES " + _values(wf),
        "CREATE TABLE typed (tag_a STRING, tag_b INT, ts TIMESTAMP(3) TIME "
        "INDEX, b BOOLEAN, i8 TINYINT, u16 SMALLINT UNSIGNED, i64 BIGINT "
        "DEFAULT 7, f32 FLOAT, f64 DOUBLE DEFAULT 1.5, s STRING DEFAULT "
        "'x', PRIMARY KEY(tag_a, tag_b)) ENGINE=mito WITH(ttl='7d')",
        "INSERT INTO typed (tag_a, tag_b, ts, b, i8, u16, f32) VALUES "
        "('a', 1, 1000, true, -3, 65000, 0.5), ('b', 2, 2000, false, 4, "
        "7, NULL)",
        "CREATE TABLE ranged (host STRING, ts TIMESTAMP TIME INDEX, v DOUBLE, "
        "PRIMARY KEY(host)) PARTITION BY RANGE COLUMNS (host) (PARTITION r0 "
        "VALUES LESS THAN ('h3'), PARTITION r1 VALUES LESS THAN (MAXVALUE))",
        "INSERT INTO ranged VALUES ('h1', 1000, 1.0), ('h5', 2000, 2.0)",
        "CREATE TABLE hashed (host STRING, ts TIMESTAMP TIME INDEX, v DOUBLE, "
        "PRIMARY KEY(host)) PARTITION BY HASH (host) PARTITIONS 3",
        "INSERT INTO hashed VALUES ('a', 1, 1.0), ('b', 2, 2.0), "
        "('c', 3, 3.0), ('d', 4, 4.0)",
        "CREATE DATABASE other",
        "CREATE TABLE other.t2 (k STRING, ts TIMESTAMP TIME INDEX, x BIGINT, "
        "PRIMARY KEY(k))",
    ]


class Side:
    def __init__(self, port: bool, home):
        self.port = port
        if port:
            self.fe = build_standalone(DatanodeOptions(
                data_home=str(home), device="cpu"))
        else:
            self.fe = RefFrontend(RefDatanode(RefOptions(
                data_home=str(home))))
            self.fe.start()
        self.runner = port_runner if port else ref_runner
        self.exec = tpu_exec if port else ref_exec
        self.ctx = QueryContext() if port else RefCtx()
        for sql in _script():
            self.fe.do_query(sql, self.ctx)
        self.fe.datanode.storage.scheduler.wait_idle(timeout=60)

    def run(self, sql):
        return self.fe.do_query(sql, self.ctx)[-1]

    def text(self, sql, drop=()):
        """The statement's rendered output, `drop` columns removed, or
        its error's message."""
        try:
            out = self.run(sql)
        except Exception as e:  # noqa: BLE001 — each package's own class
            return f"Error: {e}"
        if drop and out.is_batches:
            keep = [n for n in out.batches[0].schema.names()
                    if n not in drop]
            out = type(out).record_batches(
                [b.project(keep) for b in out.batches],
                out.batches[0].schema.project(keep) if hasattr(
                    out.batches[0].schema, "project") else None)
        return self.runner.render_output(out)

    def clear_cache(self):
        cache = self.exec.SCAN_CACHE
        with cache._lock:                # the reference has no clear()
            cache._entries.clear()

    def close(self):
        self.fe.shutdown()


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    ref = Side(False, tmp_path_factory.mktemp("ref"))
    port = Side(True, tmp_path_factory.mktemp("port"))
    yield ref, port
    ref.close()
    port.close()


@pytest.fixture(autouse=True)
def _restore_knobs(monkeypatch, sides):
    """SET statements change module state in both packages: restore it,
    and start each statement with empty scan caches."""
    for ex, st in ((ref_exec, ref_stream), (tpu_exec, stream_exec)):
        monkeypatch.setattr(ex, "TPU_DISPATCH_MIN_ROWS",
                            ex.TPU_DISPATCH_MIN_ROWS)
        monkeypatch.setattr(ex, "_observed_min_dt", [None])
        monkeypatch.setattr(st, "_STREAM_THRESHOLD_ROWS",
                            list(st._STREAM_THRESHOLD_ROWS))
    for side in sides:
        side.clear_cache()
    yield


def _both(sides, sql, setup=(), drop=()):
    texts = []
    for side in sides:
        for s in setup:
            side.run(s)
        texts.append(side.text(sql, drop))
    return texts


# ---------------------------------------------------------------------------
# EXPLAIN
# ---------------------------------------------------------------------------

#: explain/dispatch.sql's shapes, then the sketch and expression shapes
EXPLAIN_SHAPES = {
    "avg-by-host":
        "SELECT hostname, avg(usage_user) FROM cpu_explain GROUP BY hostname",
    "projection":
        "SELECT hostname, usage_user FROM cpu_explain WHERE usage_user > 20",
    "date-bin":
        "SELECT hostname, date_bin(INTERVAL '1 hour', ts) AS bucket, "
        "avg(usage_user) FROM cpu_explain GROUP BY hostname, bucket",
    "field-expr-key":
        "SELECT usage_user * 2 AS k, count(*) FROM cpu_explain GROUP BY k",
    "filters":
        f"SELECT hostname, max(usage_system), count(*) FROM cpu_explain "
        f"WHERE hostname != 'h03' AND ts >= {T0 + 5000} AND usage_user < 90 "
        f"GROUP BY hostname",
    "sketches":
        "SELECT hostname, approx_distinct(usage_user), "
        "approx_percentile(usage_user, 95), median(usage_system) FROM "
        "cpu_explain GROUP BY hostname",
    "count-distinct":
        "SELECT count(DISTINCT hostname), count(DISTINCT usage_user) FROM "
        "cpu_explain",
    "expressions":
        "SELECT hostname, avg(usage_user + usage_system), "
        "sum(usage_user * 2) FROM cpu_explain GROUP BY hostname",
    "point":
        "SELECT hostname, approx_percentile(usage_user, 50), "
        "avg(usage_user) FROM cpu_explain WHERE hostname = 'h07' "
        "GROUP BY hostname",
    "window":
        "SELECT hostname, avg(usage_user) AS a, rank() OVER (ORDER BY "
        "avg(usage_user) DESC) AS rk FROM cpu_explain GROUP BY hostname",
}
KNOBS = {
    "static-floor": (),
    "device": ("SET tpu_dispatch_min_rows = 1",),
    "streamed": ("SET tpu_dispatch_min_rows = 1",
                 "SET stream_threshold_rows = 2"),
}


@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("shape", list(EXPLAIN_SHAPES))
def test_explain_text_equal(sides, shape, knob):
    sql = "EXPLAIN " + EXPLAIN_SHAPES[shape]
    ref, port = _both(sides, sql, KNOBS[knob])
    assert port == ref, f"{sql}\n{port}\n{ref}"
    if shape in ("sketches", "expressions", "point") and knob != \
            "static-floor":
        assert "; host-partial moments (sketch/expr))" in port, port
    if shape == "point" and knob == "device":
        assert "Dispatch: indexed-point (sst index, 1 candidate" in port


# ---------------------------------------------------------------------------
# EXPLAIN ANALYZE
# ---------------------------------------------------------------------------

ANALYZE = {
    "cpu-fallback": ((), EXPLAIN_SHAPES["avg-by-host"]),
    "resident-device": (KNOBS["device"], EXPLAIN_SHAPES["avg-by-host"]),
    "resident-host-partial": (KNOBS["device"], EXPLAIN_SHAPES["sketches"]),
    "streamed": (KNOBS["streamed"], EXPLAIN_SHAPES["expressions"]),
    "indexed-point": (KNOBS["device"], EXPLAIN_SHAPES["point"]),
    "window-over-aggregate": (KNOBS["device"], EXPLAIN_SHAPES["window"]),
    "union": ((), "SELECT hostname FROM cpu_explain WHERE usage_user > 99 "
                  "UNION SELECT host FROM wf WHERE v > 5"),
}


@pytest.mark.parametrize("name", list(ANALYZE))
def test_explain_analyze_equal(sides, name):
    setup, sql = ANALYZE[name]
    ref, port = _both(sides, "EXPLAIN ANALYZE " + sql, setup)
    assert port == ref, f"{sql}\n{port}\n{ref}"
    # the plan row leads; elapsed is normalised by both renderers
    assert port.splitlines()[3].startswith("| plan "), port
    if name == "resident-device":
        assert "device-resident (scan cache)" in port
    if name == "window-over-aggregate":
        # a statement with window calls is not lowered (the reference's
        # plan_for refuses it): the aggregate and the window both run
        # on the CPU fallback
        assert "cpu-fallback" in port and "CpuAggregateExec" in port


# ---------------------------------------------------------------------------
# SHOW / DESCRIBE / information_schema
# ---------------------------------------------------------------------------

CATALOG_STATEMENTS = {
    "show-databases": "SHOW DATABASES",
    "show-databases-like": "SHOW DATABASES LIKE 'oth%'",
    "show-tables": "SHOW TABLES",
    "show-tables-like": "SHOW TABLES LIKE '%e%'",
    "show-tables-where": "SHOW TABLES WHERE Table = 'wf'",
    "show-tables-from": "SHOW TABLES FROM other",
    "show-create-typed": "SHOW CREATE TABLE typed",
    "show-create-ranged": "SHOW CREATE TABLE ranged",
    "show-create-hashed": "SHOW CREATE TABLE hashed",
    "show-create-explain": "SHOW CREATE TABLE cpu_explain",
    "describe-typed": "DESCRIBE TABLE typed",
    "describe-other": "DESCRIBE TABLE other.t2",
    "describe-missing": "DESCRIBE TABLE nope",
    "show-variables": "SHOW VARIABLES LIKE 'time_zone'",
    "is-tables":
        "SELECT table_catalog, table_schema, table_name, table_type, engine "
        "FROM information_schema.tables ORDER BY table_schema, table_name",
    "is-columns":
        "SELECT * FROM information_schema.columns ORDER BY table_schema, "
        "table_name, column_name",
    "is-columns-count":
        "SELECT table_name, count(*) FROM information_schema.columns GROUP "
        "BY table_name ORDER BY table_name",
    "is-failpoints":
        "SELECT name, action, hits, fires FROM information_schema.failpoints "
        "WHERE name LIKE 'wal_%' OR name LIKE 'sst_%' OR name LIKE "
        "'manifest_%' ORDER BY name",
    "is-region-peers":
        "SELECT table_name, region_number, peer_id, is_leader, status, "
        "replicated_seq, lag_ms FROM information_schema.region_peers "
        "ORDER BY table_name, region_number",
    "is-cluster-info":
        "SELECT peer_id, peer_type, lease_state, region_count, "
        "approximate_rows, region_stats FROM information_schema.cluster_info",
    "is-processes":
        "SELECT node, catalog, schema, query, protocol, state, "
        "rows_scanned FROM information_schema.processes",
    "is-runtime-metrics":
        "SELECT metric_name, labels, value, kind FROM "
        "information_schema.runtime_metrics WHERE kind = 'gauge' AND "
        "metric_name LIKE 'greptime_region_%' ORDER BY metric_name, labels",
    "is-background-jobs":
        "SELECT kind, table_name, region, node, state, error FROM "
        "information_schema.background_jobs ORDER BY kind, table_name, "
        "region",
}


@pytest.mark.parametrize("name", list(CATALOG_STATEMENTS))
def test_catalog_statement_equal(sides, name):
    sql = CATALOG_STATEMENTS[name]
    ref, port = _both(sides, sql)
    assert port == ref, f"{sql}\n{port}\n{ref}"


def test_show_processlist_equal(sides):
    """SHOW [FULL] PROCESSLIST lists the running statement itself; ids,
    elapsed time and trace ids are per run."""
    drop = ("Id", "Elapsed_ms", "Trace_id")
    for sql in ("SHOW PROCESSLIST", "SHOW FULL PROCESSLIST"):
        ref, port = _both(sides, sql, drop=drop)
        assert port == ref and "PROCESSLIST" in port, port


# ---------------------------------------------------------------------------
# window functions
# ---------------------------------------------------------------------------

WINDOWS = {
    "row-number":
        "SELECT host, ts, v, row_number() OVER (PARTITION BY host ORDER BY "
        "ts) AS rn FROM wf ORDER BY host, ts",
    "rank-dense-rank":
        "SELECT host, ts, v, rank() OVER (PARTITION BY host ORDER BY v) AS "
        "rk, dense_rank() OVER (PARTITION BY host ORDER BY v) AS dr FROM wf "
        "ORDER BY host, ts",
    "lag-lead":
        "SELECT host, ts, lag(v) OVER (PARTITION BY host ORDER BY ts) AS pv, "
        "lead(v, 1, -1.0) OVER (PARTITION BY host ORDER BY ts) AS nv FROM wf "
        "ORDER BY host, ts",
    "running-sum":
        "SELECT host, ts, sum(v) OVER (PARTITION BY host ORDER BY ts) AS cs "
        "FROM wf ORDER BY host, ts",
    "rows-frame-avg":
        "SELECT host, ts, avg(v) OVER (PARTITION BY host ORDER BY ts ROWS "
        "BETWEEN 1 PRECEDING AND CURRENT ROW) AS mv FROM wf ORDER BY host, ts",
    "first-last-value":
        "SELECT host, ts, first_value(v) OVER (PARTITION BY host ORDER BY "
        "ts) AS fv, last_value(v) OVER (PARTITION BY host ORDER BY ts ROWS "
        "BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING) AS lv FROM wf "
        "ORDER BY host, ts",
    "rank-over-aggregate":
        "SELECT host, sum(v) AS total, rank() OVER (ORDER BY sum(v) DESC) "
        "AS rk FROM wf GROUP BY host ORDER BY host",
    "count-partition":
        "SELECT host, ts, count(*) OVER (PARTITION BY host) AS c FROM wf "
        "ORDER BY host, ts",
    "unordered-running":
        "SELECT host, ts, max(v) OVER (ORDER BY v DESC) AS m, min(v) OVER "
        "(PARTITION BY host) AS lo FROM wf ORDER BY host, ts",
    "device-aggregate-rank":
        "SELECT hostname, avg(usage_user) AS a, rank() OVER (ORDER BY "
        "avg(usage_user) DESC) AS rk FROM cpu_explain GROUP BY hostname "
        "ORDER BY hostname",
}


@pytest.mark.parametrize("name", list(WINDOWS))
def test_window_functions_equal(sides, name):
    setup = KNOBS["device"] if name == "device-aggregate-rank" else ()
    ref, port = _both(sides, WINDOWS[name], setup)
    assert port == ref, f"{WINDOWS[name]}\n{port}\n{ref}"
    assert len(port.splitlines()) >= 10
