"""Standalone frontend differential tests: one statement script through
the JAX package's standalone instance and through the port's
(`build_standalone(DatanodeOptions(..., device="cpu"))`), each over its
own data home, on the CPU.

The script is the SURVEY §7 minimum slice (CREATE TABLE monitor, INSERT,
`SELECT host, avg(cpu) ... GROUP BY host` with and without `date_bin`),
then CREATE DATABASE / USE, ALTER TABLE ... ADD COLUMN ... DEFAULT read
back over rows written before it, ADMIN FLUSH / COMPACT TABLE, DELETE ...
WHERE, TRUNCATE, DROP TABLE, a table partitioned into three ranges, and
the protocol ingest calls (`handle_row_insert` with auto-create and
auto-alter, `handle_bulk_load`), and TQL EVAL over a table of three
fields and over the partitioned table. Every Output is compared: affected rows,
columns, keys, counts, integers, strings, min and max exact; sums and
averages within the float32 bound of tests/test_torch_sql.py,
|port - ref| <= 1e-5 |ref| + 8 eps32 P, P the sum of |x| over the
column's values in the script. Statements marked "device" run with the
dispatch floor at 0 on both sides (`SET tpu_dispatch_min_rows = 0`), so
both take their device path (the port's segment_moments on the CPU runs
its plain version), and use one aggregate signature so the reference
compiles few programs.

Then: both instances restart on their own data homes and answer the
same reads, the port's unflushed rows replayed from its WAL; each
package opens the other's data home (catalog document, mito registry,
table manifests, regions) and reads the same rows; and a
CreateTableProcedure persisted midway with no commit marker resumes in a
fresh ProcedureManager on each side.
"""

import dataclasses
import types

import numpy as np
import pandas as pd
import pytest

from greptimedb_tpu.datanode import DatanodeInstance as RefDatanode
from greptimedb_tpu.datanode import DatanodeOptions as RefOptions
from greptimedb_tpu.frontend import FrontendInstance as RefFrontend
from greptimedb_tpu.mito.procedure import \
    CreateTableProcedure as RefCreateProc
from greptimedb_tpu.mito.procedure import register_loaders as ref_loaders
from greptimedb_tpu.procedure import ProcedureManager as RefProcManager
from greptimedb_tpu.query import tpu_exec as ref_exec
from greptimedb_tpu.session import QueryContext as RefCtx
from greptimedb_tpu.sql import parse_sql as ref_parse
from greptimedb_tpu.table.requests import CreateTableRequest as RefCreateReq
from greptimedb_tpu_torch.datanode import DatanodeOptions
from greptimedb_tpu_torch.errors import UnsupportedError
from greptimedb_tpu_torch.frontend import build_standalone
from greptimedb_tpu_torch.mito.procedure import (CreateTableProcedure,
                                                 register_loaders)
from greptimedb_tpu_torch.procedure import ProcedureManager
from greptimedb_tpu_torch.query import tpu_exec
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.sql import parse_sql
from greptimedb_tpu_torch.table.requests import CreateTableRequest

EPS32 = 2.0 ** -24
T0 = 1_700_000_000_000
STEP = 5_000


@dataclasses.dataclass
class Item:
    """One step of the script: SQL text, or a protocol call on the
    frontend; `device` names the table whose regions must take the device
    path."""
    label: str
    sql: str = ""
    call: object = None
    device: str = ""


def _values(rows):
    return ", ".join("(" + ", ".join(repr(v) for v in r) + ")" for r in rows)


def _script():
    """The statement script and P, the sum of |x| per column name."""
    rng = np.random.default_rng(7)
    hosts = [f"h{i}" for i in range(4)]
    mon = [(h, T0 + k * STEP, float(np.round(rng.random() * 100, 3)),
            float(rng.integers(100, 5000))) for k in range(12) for h in hosts]
    disk = [float(np.round(rng.random() * 10, 2)) for _ in mon]
    part = [(f"h{i}", T0 + k * STEP, float(np.round(rng.normal(5, 3), 4)))
            for i in range(9) for k in range(5)]
    t2 = [(f"h{i % 3}", T0 + i * STEP, int(rng.integers(-2**40, 2**40)))
          for i in range(12)]
    metrics = {"host": ["a", "b", "a", "c"],
               "greptime_timestamp": [T0 + i * STEP for i in range(4)],
               "greptime_value": [0.25, 1.5, 2.75, -4.0]}
    metrics2 = dict(metrics, greptime_timestamp=[
        T0 + (i + 10) * STEP for i in range(4)], extra=[1, 2, None, 4])
    n = 600
    bulk = {"host": np.array([f"b{i % 6}" for i in range(n)], dtype=object),
            "ts": T0 + np.arange(n, dtype=np.int64) * 1000,
            "val": np.round(rng.normal(0, 50, n), 3),
            "n": rng.integers(0, 1 << 40, n).astype(np.int64)}
    P = {"cpu": sum(r[2] for r in mon), "memory": sum(r[3] for r in mon),
         "disk": sum(disk) + 1.5 * len(mon), "v": sum(abs(r[2]) for r in part),
         "x": float(sum(abs(r[2]) for r in t2)),
         "greptime_value": 2 * sum(abs(v) for v in metrics["greptime_value"]),
         "val": float(np.abs(bulk["val"]).sum())}
    first = [r for r in mon if r[1] < T0 + 8 * STEP]
    second = [r + (d,) for r, d in zip(mon, disk) if r[1] >= T0 + 8 * STEP]
    avg_by_host = "SELECT host, avg(cpu) FROM monitor GROUP BY host " \
                  "ORDER BY host"
    avg_by_bin = ("SELECT host, date_bin(INTERVAL '20 seconds', ts) AS b, "
                  "avg(cpu) FROM monitor GROUP BY host, b ORDER BY host, b")
    script = [
        Item("create monitor", "CREATE TABLE monitor (host STRING, ts "
             "TIMESTAMP TIME INDEX, cpu DOUBLE, memory DOUBLE, "
             "PRIMARY KEY(host))"),
        Item("insert monitor", "INSERT INTO monitor VALUES " +
             _values(first)),
        Item("avg by host", avg_by_host),
        Item("avg by host, device", avg_by_host, device="monitor"),
        Item("avg by host and date_bin", avg_by_bin),
        Item("avg by host and date_bin, device", avg_by_bin,
             device="monitor"),
        Item("select star", "SELECT * FROM monitor ORDER BY host, ts"),
        Item("alter add column with default",
             "ALTER TABLE monitor ADD COLUMN disk DOUBLE DEFAULT 1.5"),
        Item("default over rows written before the alter",
             "SELECT host, ts, disk FROM monitor ORDER BY host, ts"),
        Item("admin flush", "ADMIN FLUSH TABLE monitor"),
        Item("insert after the flush", "INSERT INTO monitor (host, ts, cpu, "
             "memory, disk) VALUES " + _values(second)),
        Item("admin compact", "ADMIN COMPACT TABLE monitor"),
        Item("moments by host", "SELECT host, count(*), min(cpu), "
             "max(memory), sum(disk), avg(memory) FROM monitor GROUP BY host "
             "ORDER BY host"),
        Item("delete where", f"DELETE FROM monitor WHERE host = 'h1' AND "
             f"ts >= {T0 + 4 * STEP}"),
        Item("count after the delete", "SELECT host, count(*), max(ts) FROM "
             "monitor GROUP BY host ORDER BY host"),
        Item("avg by host after the delete, device", avg_by_host,
             device="monitor"),
        Item("create database", "CREATE DATABASE mydb"),
        Item("use", "USE mydb"),
        Item("create in mydb", "CREATE TABLE t2 (host STRING, ts TIMESTAMP "
             "TIME INDEX, x BIGINT, PRIMARY KEY(host))"),
        Item("insert in mydb", "INSERT INTO t2 VALUES " + _values(t2)),
        Item("sum in mydb", "SELECT host, sum(x), count(x) FROM t2 GROUP BY "
             "host ORDER BY host"),
        Item("truncate", "TRUNCATE TABLE t2"),
        Item("count after the truncate", "SELECT count(*) FROM t2"),
        Item("use public", "USE public"),
        Item("qualified name", "SELECT count(*) FROM mydb.t2"),
        Item("create partitioned", "CREATE TABLE p (host STRING, ts "
             "TIMESTAMP TIME INDEX, v DOUBLE, PRIMARY KEY(host)) PARTITION BY "
             "RANGE COLUMNS (host) (PARTITION r0 VALUES LESS THAN ('h3'), "
             "PARTITION r1 VALUES LESS THAN ('h6'), PARTITION r2 VALUES "
             "LESS THAN (MAXVALUE))"),
        Item("insert partitioned", "INSERT INTO p VALUES " + _values(part)),
        Item("partitioned avg", "SELECT host, avg(v) FROM p GROUP BY host "
             "ORDER BY host"),
        Item("partitioned avg, device", "SELECT host, avg(v) FROM p GROUP BY "
             "host ORDER BY host", device="p"),
        Item("partitioned global moments, device", "SELECT count(*), "
             "sum(v), min(v), max(v), first_value(v), last_value(v) FROM p",
             device="p"),
        Item("partitioned date_bin only, device", "SELECT date_bin("
             "INTERVAL '10 seconds', ts) AS b, count(*), avg(v), min(v) FROM "
             "p GROUP BY b ORDER BY b", device="p"),
        Item("partitioned delete", "DELETE FROM p WHERE host IN ('h2', 'h3') "
             f"AND ts = {T0}"),
        Item("partitioned count", "SELECT host, count(*) FROM p GROUP BY "
             "host ORDER BY host"),
        Item("create p2", "CREATE TABLE p2 (host STRING, ts TIMESTAMP TIME "
             "INDEX, v DOUBLE, PRIMARY KEY(host))"),
        Item("drop table", "DROP TABLE p2"),
        Item("select from a dropped table", "SELECT * FROM p2"),
        Item("row insert, auto-create", call=lambda fe, ctx:
             fe.handle_row_insert("metrics", metrics, tag_columns=["host"],
                                  ctx=ctx)),
        Item("row insert, auto-alter", call=lambda fe, ctx:
             fe.handle_row_insert("metrics", metrics2, tag_columns=["host"],
                                  ctx=ctx)),
        Item("read the auto-created table", "SELECT * FROM metrics ORDER BY "
             "host, greptime_timestamp"),
        Item("bulk load, auto-create", call=lambda fe, ctx:
             fe.handle_bulk_load("bulk", bulk, tag_columns=["host"],
                                 timestamp_column="ts", ctx=ctx)),
        Item("read the bulk-loaded table", "SELECT host, count(*), sum(val), "
             "max(n), min(ts) FROM bulk GROUP BY host ORDER BY host"),
        Item("tql eval over two fields", f"TQL EVAL ({T0 // 1000}, "
             f"{T0 // 1000 + 60}, '5s') monitor{{host=\"h0\"}}"),
        Item("tql eval over a partitioned table", f"TQL EVAL ({T0 // 1000}, "
             f"{T0 // 1000 + 30}, '10s') sum by (host) (p)"),
        Item("unflushed insert", "INSERT INTO monitor (host, ts, cpu) VALUES "
             f"('h9', {T0 + 99 * STEP}, 12.5)"),
    ]
    return script, P


SCRIPT, P_COLUMN = _script()
#: what every restart and cross-open must read back
READS = [
    ("monitor rows", "SELECT * FROM monitor ORDER BY host, ts"),
    ("monitor avg by host", "SELECT host, avg(cpu) FROM monitor GROUP BY "
     "host ORDER BY host"),
    ("partitioned rows", "SELECT * FROM p ORDER BY host, ts"),
    ("auto-created rows", "SELECT * FROM metrics ORDER BY host, "
     "greptime_timestamp"),
    ("bulk rows", "SELECT * FROM bulk ORDER BY host, ts"),
    ("resumed rows", "SELECT * FROM resumed ORDER BY host, ts"),
    ("mydb count", "SELECT count(*) FROM mydb.t2"),
]
SIDES = ("ref", "port")


def _open(side, home):
    if side == "ref":
        fe = RefFrontend(RefDatanode(RefOptions(
            data_home=str(home), register_numbers_table=False)))
        fe.start()
        return fe
    return build_standalone(DatanodeOptions(
        data_home=str(home), register_numbers_table=False, device="cpu"))


def _ctx(side):
    return RefCtx() if side == "ref" else QueryContext()


def _regions(fe, name):
    return list(fe.catalog.table("greptime", "public", name).regions
                .values())


def _run(fe, side, item, ctx):
    """One script item on one side: its Output or affected count, or the
    name of the error it raised."""
    mod = ref_exec if side == "ref" else tpu_exec
    saved = mod.TPU_DISPATCH_MIN_ROWS, mod._observed_min_dt[0]
    try:
        if item.device:
            fe.do_query("SET tpu_dispatch_min_rows = 0", ctx)
            for r in _regions(fe, item.device):
                r.last_scan_profile = None
        try:
            out = item.call(fe, ctx) if item.call is not None else \
                fe.do_query(item.sql, ctx)[-1]
        except Exception as e:  # noqa: BLE001 — compared across packages
            return type(e).__name__
        if item.device:
            paths = {r.last_scan_profile.path for r in
                     _regions(fe, item.device)}
            assert paths == {"resident"}, (side, item.label, paths)
        return out
    finally:
        mod.TPU_DISPATCH_MIN_ROWS, mod._observed_min_dt[0] = saved


def _frame(out):
    frames = [pd.DataFrame(b.to_pydict()) for b in out.batches]
    return pd.concat(frames, ignore_index=True) if frames else \
        pd.DataFrame()


def _assert_same(want, got, what):
    """The port's result against the reference's (see the module
    docstring for the tolerances)."""
    if isinstance(want, (str, int)):
        assert got == want, what
        return
    assert not isinstance(got, str), f"{what}: the port raised {got}"
    assert got.is_batches == want.is_batches, what
    if not want.is_batches:
        assert got.affected_rows == want.affected_rows, what
        return
    w, g = _frame(want), _frame(got)
    assert list(g.columns) == list(w.columns), what
    assert len(g) == len(w), what
    for col in w.columns:
        lc = col.lower()
        if not lc.startswith(("sum(", "avg(")):
            pd.testing.assert_series_equal(g[col], w[col], check_exact=True,
                                           obj=f"{what}: {col}")
            continue
        wv, gv = w[col].to_numpy(), g[col].to_numpy()
        w64, g64 = wv.astype(np.float64), gv.astype(np.float64)
        np.testing.assert_array_equal(np.isnan(g64), np.isnan(w64),
                                      err_msg=f"{what}: {col} NULLs")
        ok = ~np.isnan(w64)
        tol = 1e-5 * np.abs(w64) + 8 * EPS32 * P_COLUMN[lc[4:-1]]
        assert (np.abs(g64 - w64)[ok] <= tol[ok]).all(), \
            f"{what}: {col} {g64[ok]} vs {w64[ok]}"


def _crash_create_midway(side, fe):
    """A CreateTableProcedure stopped after its engine step: the table's
    manifest and region exist, the catalog does not know the table, and
    the procedure's state after that step is persisted with no commit
    marker (tests/test_procedure.py fakes crashes the same way)."""
    dn = fe.datanode
    schema = fe.catalog.table("greptime", "public", "p").schema
    Req, Proc = (RefCreateReq, RefCreateProc) if side == "ref" else \
        (CreateTableRequest, CreateTableProcedure)
    req = Req("resumed", schema, primary_key_indices=[0])
    dn.mito.create_table(req)
    proc = Proc(req, dn.mito, dn.catalog, state="register_catalog")
    dn.procedure_manager._persist("c0ffee", 1, proc)


def _resume(side, fe):
    """A fresh manager over the same store recovers the procedure."""
    dn = fe.datanode
    Mgr, loaders = (RefProcManager, ref_loaders) if side == "ref" else \
        (ProcedureManager, register_loaders)
    mgr = Mgr(dn.store)
    loaders(mgr, dn.mito, dn.catalog)
    known = fe.catalog.table("greptime", "public", "resumed") is not None
    return {"known before": known, "recovered": mgr.recover(),
            "left": dn.store.list("procedures/")}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The script through both packages, then the procedure resume, the
    restarts and the cross-opens; everything the tests compare."""
    homes = {s: tmp_path_factory.mktemp(s) for s in SIDES}
    res = types.SimpleNamespace(script={}, reads={}, resume={})
    fes = {s: _open(s, homes[s]) for s in SIDES}
    try:
        ctxs = {s: _ctx(s) for s in SIDES}
        for item in SCRIPT:
            res.script[item.label] = {s: _run(fes[s], s, item, ctxs[s])
                                      for s in SIDES}
        res.region_rows = {s: [r.snapshot().read_merged().num_rows
                               for r in _regions(fes[s], "p")]
                           for s in SIDES}
        for s in SIDES:
            _crash_create_midway(s, fes[s])
            res.resume[s] = _resume(s, fes[s])
            fes[s].do_query("INSERT INTO resumed VALUES ('h1', 5, 1.25), "
                            "('h7', 6, -2.5)", _ctx(s))
        read = {s: _read_all(fes[s], s) for s in SIDES}
    finally:
        for fe in fes.values():
            fe.shutdown()
    res.reads["before"] = read
    # restart on its own data home: the catalog replays, tables reopen,
    # unflushed rows come back from the WAL
    fes = {s: _open(s, homes[s]) for s in SIDES}
    try:
        res.replayed = sum(r.version_control.current.memtables.mutable
                           .num_rows for r in _regions(fes["port"],
                                                       "monitor"))
        res.reads["restart"] = {s: _read_all(fes[s], s) for s in SIDES}
    finally:
        for fe in fes.values():
            fe.shutdown()
    # each package over the other's data home
    fes = {"port": _open("port", homes["ref"]),
           "ref": _open("ref", homes["port"])}
    try:
        res.reads["cross"] = {s: _read_all(fes[s], s) for s in SIDES}
    finally:
        for fe in fes.values():
            fe.shutdown()
    return res


def _read_all(fe, side):
    return {label: _run(fe, side, Item(label, sql), _ctx(side))
            for label, sql in READS}


@pytest.mark.parametrize("label", [i.label for i in SCRIPT])
def test_statement_matches_reference(run, label):
    out = run.script[label]
    _assert_same(out["ref"], out["port"], label)


def test_script_reached_what_it_tests(run):
    """The script's outputs are the ones its steps are about (so a step
    that fails alike on both sides cannot pass unnoticed)."""
    out = {k: v["port"] for k, v in run.script.items()}
    assert out["select from a dropped table"] == "TableNotFoundError"
    errors = {k: v for k, v in out.items() if isinstance(v, str)}
    assert list(errors) == ["select from a dropped table"], errors
    assert _frame(out["default over rows written before the alter"])[
        "disk"].tolist() == [1.5] * 32
    assert out["delete where"].affected_rows == 8
    # the partitioned folds span all three regions
    assert _frame(out["partitioned global moments, device"]).iloc[0, 0] == 45
    assert _frame(out["partitioned date_bin only, device"])[
        "count(*)"].tolist() == [18, 18, 9]
    assert _frame(out["count after the truncate"]).iloc[0, 0] == 0
    assert out["row insert, auto-alter"] == 4
    assert out["bulk load, auto-create"] == 600
    assert list(_frame(out["read the auto-created table"]).columns) == [
        "host", "greptime_timestamp", "greptime_value", "extra"]
    # TQL over the tables: a series per field, a sum per host over the
    # three partitions
    fields = _frame(out["tql eval over two fields"])
    assert set(fields["__field__"]) == {"cpu", "memory", "disk"}
    assert len(fields) == 3 * 13
    assert sorted(set(_frame(out["tql eval over a partitioned table"])[
        "host"])) == [f"h{i}" for i in range(9)]


def test_partitioned_table_splits_rows_like_reference(run):
    # 9 hosts x 5 samples over ranges [.., 'h3'), ['h3', 'h6'), ['h6', ..),
    # less the first samples of h2 and h3, which the script deletes
    assert run.region_rows["ref"] == [14, 14, 15]
    assert run.region_rows["port"] == run.region_rows["ref"]


def test_create_procedure_resumes_after_crash(run):
    for side in SIDES:
        assert run.resume[side] == {"known before": False,
                                    "recovered": ["c0ffee"], "left": []}
    rows = _frame(run.reads["before"]["port"]["resumed rows"])
    assert rows["host"].tolist() == ["h1", "h7"]


@pytest.mark.parametrize("label", [label for label, _ in READS])
def test_restart_reads_the_same(run, label):
    before, after = run.reads["before"], run.reads["restart"]
    _assert_same(before["ref"][label], before["port"][label], label)
    _assert_same(after["ref"][label], after["port"][label], label)
    # each package's answers survive its restart bit for bit
    for side in SIDES:
        pd.testing.assert_frame_equal(_frame(after[side][label]),
                                      _frame(before[side][label]))
    assert run.replayed > 0       # rows inserted after the flush


@pytest.mark.parametrize("label", [label for label, _ in READS])
def test_packages_open_each_others_data_home(run, label):
    cross, before = run.reads["cross"], run.reads["before"]
    # the port over the reference's home reads what the reference read
    pd.testing.assert_frame_equal(_frame(cross["port"][label]),
                                  _frame(before["ref"][label]))
    pd.testing.assert_frame_equal(_frame(cross["ref"][label]),
                                  _frame(before["port"][label]))


@pytest.mark.parametrize("sql", [
    "ADMIN SHOW TRACE 'last'",
    "ADMIN SHOW PROFILE 'last'",
    "SET profiling = 1",
    "SET dist_fanout = 4",
    "SET exact_distinct = 1",
    "SET trace_sample_ratio = 1",
    "SET self_monitor_retention_ms = 60000",
])
def test_port_raises_for_what_it_has_not_ported(tmp_path, sql):
    ref_parse(sql)                        # the reference's grammar has it
    fe = _open("port", tmp_path)
    try:
        fe.do_query("CREATE TABLE monitor (host STRING, ts TIMESTAMP TIME "
                    "INDEX, cpu DOUBLE, PRIMARY KEY(host))")
        parse_sql(sql)
        with pytest.raises(UnsupportedError, match="not ported|require"):
            fe.do_query(sql)
    finally:
        fe.shutdown()


def test_streaming_and_fusion_knobs_match_reference(tmp_path):
    """SET stream_threshold_rows and SET scan_fusion work in the port as
    in the reference: a threshold under the table's rows moves an
    aggregate from the scan cache to the streamed cold path, and back,
    with the reference's decision strings and answers; a point query on
    the uncached table takes the SST index; fusion off or on leaves the
    answer as it was."""
    from greptimedb_tpu.common import exec_stats as ref_stats
    from greptimedb_tpu.query import stream_exec as ref_stream
    from greptimedb_tpu_torch.common import exec_stats
    from greptimedb_tpu_torch.query import stream_exec

    sqls = {"avg": "SELECT host, avg(cpu) FROM monitor GROUP BY host "
                   "ORDER BY host",
            "point": "SELECT host, avg(cpu) FROM monitor WHERE host = 'h1' "
                     "GROUP BY host ORDER BY host"}
    rows = [(f"h{i % 4}", T0 + i * STEP, float(i % 7), float(i)) for i in
            range(40)]
    saved = ref_stream.stream_threshold_rows(), \
        stream_exec.stream_threshold_rows()
    seen = {}
    try:
        for side in SIDES:
            fe, ctx = _open(side, tmp_path / side), _ctx(side)
            mod = ref_exec if side == "ref" else tpu_exec
            stats = ref_stats if side == "ref" else exec_stats
            try:
                fe.do_query("CREATE TABLE monitor (host STRING, ts TIMESTAMP "
                            "TIME INDEX, cpu DOUBLE, memory DOUBLE, PRIMARY "
                            "KEY(host))", ctx)
                fe.do_query("INSERT INTO monitor VALUES " +
                            _values(rows[:30]), ctx)
                fe.do_query("ADMIN FLUSH TABLE monitor", ctx)
                fe.do_query("INSERT INTO monitor VALUES " +
                            _values(rows[30:]), ctx)
                (region,) = _regions(fe, "monitor")
                for step, knobs, sql in [
                        ("streamed", ["stream_threshold_rows = 10"], "avg"),
                        ("point", [], "point"),
                        ("resident", ["stream_threshold_rows = 64000000"],
                         "avg"),
                        ("fusion off", ["scan_fusion = 0"], "avg"),
                        ("fusion on", ["scan_fusion = 1"], "avg")]:
                    for k in knobs + ["tpu_dispatch_min_rows = 0"]:
                        fe.do_query(f"SET {k}", ctx)
                    region.last_scan_profile = None
                    with stats.collect() as st:
                        out = fe.do_query(sqls[sql], ctx)[-1]
                    mod.TPU_DISPATCH_MIN_ROWS = 131072
                    mod._observed_min_dt[0] = None
                    seen[side, step] = (st.dispatch,
                                        region.last_scan_profile.path, out)
            finally:
                fe.shutdown()
    finally:
        ref_stream.configure_streaming(threshold_rows=saved[0])
        stream_exec.configure_streaming(threshold_rows=saved[1])
        ref_exec.configure_scan_fusion(enabled=True)
        tpu_exec.configure_scan_fusion(enabled=True)
    paths = {"streamed": "streamed", "point": "indexed-point",
             "resident": "resident", "fusion off": "resident",
             "fusion on": "resident"}
    for step, path in paths.items():
        ref_d, ref_path, ref_out = seen["ref", step]
        d, p, out = seen["port", step]
        assert (d, p) == (ref_d, ref_path), step
        assert p == path, step
        _assert_same(ref_out, out, step)
    assert seen["port", "streamed"][0] == \
        "streamed-cold (est_rows=40, stream_threshold_rows=10)"
    assert seen["port", "resident"][0] == "device-resident (scan cache)"
