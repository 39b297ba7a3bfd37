"""SQL differential tests: the same statements through the JAX package's
QueryEngine and through the port's, on the CPU, over the same rows.

Each package gets its rows through its own write path. The reference:
CREATE TABLE, a bulk load, an INSERT that overwrites one key with a later
sequence, a DELETE, through its frontend. The port: a region of its own
StorageEngine (storage/engine.py), loaded with the same columns by
`Region.bulk_ingest` and given the same overwrite and DELETE as
`WriteBatch`es (WAL + memtable), under a port `Table`.

Both packages pin the dispatch floor to 0 before every device-path
statement, so each takes its device path (checked through the region's
`last_scan_profile`); the CPU-path cases say which path each takes.

Tolerances: rows, their order, keys, counts, min, max, first and last
exact (float32 device mirrors on both sides). Sums and averages: the
reference's float32 prefix-difference sums err by about eps32 times the
global prefix (see tests/test_torch_kernels.py), so
|port - ref| <= 1e-5 |ref| + 8 eps32 P / c, P the sum of |x| over the
table and c the group's row count (1 for sums); standard deviations
within 1e-3 relative (their fold runs in float32 from those sums). The
narrow and unsigned integer table is exact throughout: integer sums wrap
to the column's type on both sides.
"""

import types

import numpy as np
import pandas as pd
import pytest

from greptimedb_tpu.query import tpu_exec as ref_exec
from greptimedb_tpu.query.engine import QueryEngine as RefEngine
from greptimedb_tpu.session import QueryContext as RefCtx
from greptimedb_tpu.sql import parse_sql as ref_parse
from greptimedb_tpu_torch.catalog import MemoryCatalogManager
from greptimedb_tpu_torch.datatypes import Schema
from greptimedb_tpu_torch.errors import UnsupportedError
from greptimedb_tpu_torch.query import QueryEngine, tpu_exec
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.sql import parse_sql
from greptimedb_tpu_torch.storage import (EngineConfig, StorageEngine,
                                          WriteBatch)
from greptimedb_tpu_torch.table import Table, TableIdent, TableInfo, TableMeta

EPS32 = 2.0 ** -24
T0 = 1_700_000_000_000
HOSTS, SAMPLES, STEP = 24, 360, 10_000          # 8640 rows over 1 h
#: the overwrite and the DELETE both packages receive after the load
OVERWRITE = {"hostname": ["host_3"], "region": ["r0"], "ts": [T0 + 5 * STEP],
             "usage_user": [99.5], "usage_system": [1.5], "req": [7]}
DELETE = {"hostname": ["host_4"], "region": ["r1"], "ts": [T0 + 7 * STEP]}


def _cpu_columns():
    rng = np.random.default_rng(42)
    n = HOSTS * SAMPLES
    host = np.repeat([f"host_{i}" for i in range(HOSTS)], SAMPLES)
    region = np.repeat([f"r{i % 3}" for i in range(HOSTS)], SAMPLES)
    ts = np.tile(T0 + np.arange(SAMPLES, dtype=np.int64) * STEP, HOSTS)
    walk = np.clip(50 + np.cumsum(rng.normal(size=(HOSTS, SAMPLES)),
                                  axis=1), 0, 100).ravel()
    user = [None if rng.random() < 0.03 else float(v) for v in walk]
    return {
        "hostname": host.astype(object), "region": region.astype(object),
        "ts": ts, "usage_user": user,
        "usage_system": rng.random(n) * 100,
        "req": rng.integers(0, 1000, n).astype(np.int64)}


def _load_reference(fe, columns):
    ctx = RefCtx()
    fe.do_query("CREATE TABLE cpu (hostname STRING, region STRING, ts "
                "TIMESTAMP TIME INDEX, usage_user DOUBLE, usage_system "
                "DOUBLE, req BIGINT, PRIMARY KEY(hostname, region))", ctx)
    table = fe.catalog.table("greptime", "public", "cpu")
    table.bulk_load(columns)
    # a later sequence overwrites one key; a DELETE drops another
    o = OVERWRITE
    fe.do_query(f"INSERT INTO cpu VALUES ('{o['hostname'][0]}', "
                f"'{o['region'][0]}', {o['ts'][0]}, {o['usage_user'][0]}, "
                f"{o['usage_system'][0]}, {o['req'][0]})", ctx)
    fe.do_query(f"DELETE FROM cpu WHERE hostname = '{DELETE['hostname'][0]}'"
                f" AND region = '{DELETE['region'][0]}' AND ts = "
                f"{DELETE['ts'][0]}", ctx)
    return table


def _port_table(storage, catalog, name, ref_table, columns, batches=()):
    """A port table over one region of the port's own StorageEngine, with
    the reference table's schema: `columns` through bulk_ingest, then each
    of `batches` ((op, columns), op "put" or "delete") as one WriteBatch
    through the WAL and the memtable."""
    schema = Schema.from_dict(ref_table.schema.to_dict())
    region = storage.create_region(f"{name}_0", schema)
    region.bulk_ingest(columns)
    for op, cols in batches:
        wb = WriteBatch(region.schema)
        getattr(wb, op)(cols)
        region.write(wb)
    table = Table(TableInfo(TableIdent(ref_table.info.ident.table_id), name,
                            TableMeta(schema)))
    table.regions = {0: region}
    catalog.register_table("greptime", "public", name, table)
    return table


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """The reference's datanode and frontend, and the port's catalog over
    its own StorageEngine; `cpu` loaded into both."""
    from greptimedb_tpu.datanode.instance import (DatanodeInstance,
                                                  DatanodeOptions)
    from greptimedb_tpu.frontend.instance import FrontendInstance
    from greptimedb_tpu.storage import index as ref_index
    dn = DatanodeInstance(DatanodeOptions(
        data_home=str(tmp_path_factory.mktemp("ref")),
        register_numbers_table=False))
    dn.start()
    fe = FrontendInstance(dn)
    fe.start()
    storage = StorageEngine(EngineConfig(
        data_home=str(tmp_path_factory.mktemp("port"))))
    columns = _cpu_columns()
    ref_table = _load_reference(fe, columns)
    catalog = MemoryCatalogManager()
    table = _port_table(storage, catalog, "cpu", ref_table, columns,
                        [("put", OVERWRITE), ("delete", DELETE)])
    # the resident device path on both sides (both packages would route
    # selective tag predicates through their SST index on a cold cache)
    from greptimedb_tpu_torch.storage import index as port_index
    saved_index = ref_index.sst_index_enabled()
    saved_port_index = port_index.sst_index_enabled()
    fe.do_query("SET sst_index = 0", RefCtx())
    port_index.configure_sst_index(enabled=False)
    yield types.SimpleNamespace(
        fe=fe, storage=storage, catalog=catalog,
        ref=RefEngine(fe.catalog), port=QueryEngine(catalog, device="cpu"),
        ref_table=ref_table, table=table)
    fe.do_query(f"SET sst_index = {int(saved_index)}", RefCtx())
    port_index.configure_sst_index(enabled=saved_port_index)
    storage.close()
    fe.shutdown()


@pytest.fixture(scope="module")
def engines(stack):
    (region,) = stack.table.regions.values()
    return (stack.ref, stack.ref_table, stack.port, stack.table,
            region.snapshot().scan())


def _frame(out) -> pd.DataFrame:
    frames = [pd.DataFrame(b.to_pydict()) for b in out.batches]
    return pd.concat(frames, ignore_index=True) if frames else \
        pd.DataFrame()


def _run(engines, sql, floor):
    ref, ref_table, port, table, _ = engines
    return _run_tables(ref, ref_table, port, table, sql, floor)


def _run_tables(ref, ref_table, port, table, sql, floor):
    (rr,) = ref_table.regions.values()
    (pr,) = table.regions.values()
    rr.last_scan_profile = pr.last_scan_profile = None
    saved = (ref_exec.TPU_DISPATCH_MIN_ROWS, tpu_exec.TPU_DISPATCH_MIN_ROWS)
    ref_exec.TPU_DISPATCH_MIN_ROWS = tpu_exec.TPU_DISPATCH_MIN_ROWS = floor
    try:
        ref_exec._observed_min_dt[0] = tpu_exec._observed_min_dt[0] = None
        want = _frame(ref.execute(ref_parse(sql), RefCtx()))
        ref_exec._observed_min_dt[0] = tpu_exec._observed_min_dt[0] = None
        got = _frame(port.execute(parse_sql(sql), QueryContext()))
    finally:
        ref_exec.TPU_DISPATCH_MIN_ROWS, tpu_exec.TPU_DISPATCH_MIN_ROWS = \
            saved
        ref_exec._observed_min_dt[0] = tpu_exec._observed_min_dt[0] = None
    return want, got, rr.last_scan_profile, pr.last_scan_profile


def _compare(want, got, data, sql):
    assert list(got.columns) == list(want.columns), sql
    assert len(got) == len(want), sql
    P = {k: float(np.abs(v[m] if m is not None else v).sum())
         for k, (v, m) in data.fields.items()}
    for col in want.columns:
        w, g = want[col].to_numpy(), got[col].to_numpy()
        lc = ALIASES.get(col, col).lower()
        if not any(lc.startswith(f) for f in ("sum(", "avg(", "stddev(")):
            np.testing.assert_array_equal(
                g.astype(object), w.astype(object), err_msg=f"{col}: {sql}")
            continue
        w64 = w.astype(np.float64)
        g64 = g.astype(np.float64)
        np.testing.assert_array_equal(np.isnan(g64), np.isnan(w64),
                                      err_msg=f"{col} NULLs: {sql}")
        ok = ~np.isnan(w64)
        if lc.startswith("stddev("):
            tol = 1e-3 * np.abs(w64) + 1e-4
        else:
            field = lc[lc.index("(") + 1:lc.index(")")]
            c = 1.0
            if lc.startswith("avg("):
                cc = [k for k in want.columns if k.lower().startswith(
                    f"count({field})")]
                c = want[cc[0]].to_numpy(np.float64) if cc else 1.0
            tol = 1e-5 * np.abs(w64) + 8 * EPS32 * P[field] / np.maximum(
                c, 1)
        err = np.abs(g64 - w64)
        assert (err[ok] <= np.broadcast_to(tol, err.shape)[ok]).all(), \
            f"{col}: max err {err[ok].max()} over the bound: {sql}"


#: result columns named by an alias, and the aggregate each one is
ALIASES = {"a": "avg(usage_user)", "s2": "sum(usage_user)"}
H = 3_600_000
Q = {
    "double-groupby-all":
        f"SELECT date_bin(INTERVAL '10 minutes', ts) AS b, hostname, "
        f"avg(usage_user), count(usage_user), avg(usage_system), "
        f"avg(req), count(req) FROM cpu WHERE ts >= {T0} AND "
        f"ts < {T0 + H} GROUP BY b, hostname ORDER BY b, hostname",
    "double-groupby-1":
        f"SELECT date_bin(INTERVAL '10 minutes', ts) AS b, hostname, "
        f"avg(usage_user), count(usage_user) FROM cpu WHERE ts >= {T0} "
        f"AND ts < {T0 + H} GROUP BY b, hostname ORDER BY b, hostname",
    "cpu-max-all":
        f"SELECT date_bin(INTERVAL '10 minutes', ts) AS b, hostname, "
        f"max(usage_user), max(usage_system), max(req) FROM cpu WHERE "
        f"hostname IN ('host_1', 'host_5', 'host_9') AND ts >= {T0} AND "
        f"ts < {T0 + H // 2} GROUP BY b, hostname ORDER BY b, hostname",
    "single-groupby-1-minute":
        f"SELECT date_bin(INTERVAL '1 minute', ts) AS m, hostname, "
        f"max(usage_user), max(usage_system) FROM cpu WHERE hostname IN "
        f"('host_2', 'host_3') AND ts >= {T0} AND ts < {T0 + H // 4} "
        f"GROUP BY m, hostname ORDER BY m, hostname",
    "per-host-moments":
        "SELECT hostname, count(*), sum(usage_user), min(usage_user), "
        "max(usage_user), stddev(usage_user), first_value(usage_user), "
        "last_value(usage_user), sum(req), min(req) FROM cpu GROUP BY "
        "hostname ORDER BY hostname",
    "global":
        "SELECT max(usage_user), avg(usage_system), "
        "first_value(usage_system), last_value(usage_system), count(*) "
        "FROM cpu",
    "field-filter":
        "SELECT region, count(*), avg(usage_system) FROM cpu WHERE "
        "usage_user > 50 GROUP BY region ORDER BY region",
    "tag-not-equal":
        "SELECT region, hostname, min(usage_system), last_value(req) FROM "
        "cpu WHERE region != 'r1' GROUP BY region, hostname ORDER BY "
        "hostname",
    "having-order-limit":
        "SELECT hostname, avg(usage_user) AS a, count(*) AS c FROM cpu "
        "GROUP BY hostname HAVING avg(usage_user) > 40 ORDER BY a DESC "
        "LIMIT 5",
    "region-first-last":
        "SELECT region, first_value(usage_user), last_value(usage_user), "
        "count(usage_user) FROM cpu GROUP BY region ORDER BY region",
}


@pytest.mark.parametrize("name", list(Q))
def test_device_path_matches_reference(engines, name):
    want, got, ref_prof, port_prof = _run(engines, Q[name], floor=0)
    assert ref_prof is not None and ref_prof.path == "resident", name
    assert port_prof is not None and port_prof.path == "resident", name
    _compare(want, got, engines[4], Q[name])


@pytest.mark.parametrize("sql,floor,ref_path", [
    # below the (unpinned) dispatch floor: the CPU columnar path in both
    ("SELECT hostname, avg(usage_user), max(req) FROM cpu GROUP BY "
     "hostname ORDER BY hostname", 131072, None),
    # an expression over a field: both packages reduce it on the host
    # beside their resident scans (host-partial moments)
    ("SELECT hostname, sum(usage_user * 2) AS s2 FROM cpu WHERE ts < "
     f"{T0 + 600_000} GROUP BY hostname ORDER BY hostname", 0, "resident"),
    # no aggregate: rows through the CPU path, MVCC applied
    (f"SELECT hostname, ts, usage_user FROM cpu WHERE hostname = 'host_3' "
     f"AND ts <= {T0 + 6 * STEP} ORDER BY ts", 0, None),
], ids=["small-table", "expression-arg", "raw-rows"])
def test_cpu_path_matches_reference(engines, sql, floor, ref_path):
    want, got, ref_prof, port_prof = _run(engines, sql, floor=floor)
    assert (port_prof.path if port_prof is not None else None) == ref_path
    assert (ref_prof.path if ref_prof is not None else None) == ref_path
    _compare(want, got, engines[4], sql)


def test_mvcc_overwrite_and_delete_visible(engines):
    """The later INSERT's value wins and the deleted key is gone, on the
    device path."""
    sql = (f"SELECT hostname, count(*), max(usage_user) FROM cpu WHERE "
           f"ts >= {T0 + 5 * STEP} AND ts <= {T0 + 7 * STEP} AND hostname "
           f"IN ('host_3', 'host_4') GROUP BY hostname ORDER BY hostname")
    want, got, _, port_prof = _run(engines, sql, floor=0)
    assert port_prof is not None and port_prof.path == "resident"
    _compare(want, got, engines[4], sql)
    assert got["count(*)"].tolist() == [3, 2]
    assert got["max(usage_user)"].iloc[0] >= 99.5


def test_unsupported_statements_raise(engines):
    """information_schema tables over modules the port does not have
    yet (the trace store, the profiler, the self-monitor) raise
    UnsupportedError naming them."""
    port = engines[2]
    for sql in ("SELECT * FROM information_schema.trace_spans",
                "SELECT * FROM information_schema.profile_samples",
                "SELECT * FROM information_schema.self_monitor"):
        with pytest.raises(UnsupportedError):
            port.execute(parse_sql(sql), QueryContext())


def test_all_valid_fields_share_the_valid_mask(engines):
    """The port's region merges SSTs with memtable rows, whose write
    batches carry a validity array for every field: the scan keeps each
    array on the host, as the reference does (the raw-row frame reads a
    field with one as float64), a field with no null among the merged
    rows mirrors as the one all-valid mask, a field with nulls keeps its
    own."""
    _, _, _, table, _ = engines
    (region,) = table.regions.values()
    assert region.version_control.current.memtables.mutable.num_rows == 2
    scan = tpu_exec.SCAN_CACHE.get(region, "cpu")
    assert scan.fields["usage_system"][1].all()
    assert scan.device_valid("usage_system") is scan.device_valid_all()
    assert not scan.fields["usage_user"][1].all()


def test_scan_cache_keeps_devices_apart(engines):
    """A scan mirrored for one device is rebuilt, not reused, for an
    engine on another."""
    _, _, _, table, _ = engines
    (region,) = table.regions.values()
    cpu = tpu_exec.SCAN_CACHE.get(region, "cpu")
    assert tpu_exec.SCAN_CACHE.get(region, "cpu") is cpu
    meta = tpu_exec.SCAN_CACHE.get(region, "meta")
    assert meta is not cpu and str(meta.torch_device) == "meta"
    assert tpu_exec.SCAN_CACHE.last_outcome() == "full"


def test_plan_from_specs_matches_reference(engines):
    """The IR's explicit-spec entry (the non-SQL front ends' way in) and
    its executor, on both packages over the same table: the same frame,
    rows in run order, keys and counts exact, floats as above."""
    from greptimedb_tpu.query import ir as ref_ir
    from greptimedb_tpu_torch.query import ir

    _, ref_table, _, table, data = engines
    kw = dict(group_tags=["hostname"], time_lo=T0 + 60_000,
              time_hi=T0 + 1_800_000,
              moment_specs=[("last_ts", "max_ts", "usage_user")])
    aggs = [("avg(usage_user)", "avg", "usage_user"),
            ("count(usage_user)", "count", "usage_user"),
            ("max(req)", "max", "req"),
            ("first(usage_system)", "first", "usage_system"),
            ("stddev(usage_system)", "stddev", "usage_system")]
    want = ref_ir.execute_agg_plan(ref_table, ref_ir.plan_from_specs(
        ref_table.schema, aggs, bucket=ref_ir.BucketGroup(300_000, 0, "b"),
        **kw))
    got = ir.execute_agg_plan(table, ir.plan_from_specs(
        table.schema, aggs, bucket=ir.BucketGroup(300_000, 0, "b"), **kw),
        "cpu")
    assert ir.group_key_columns(ir.plan_from_specs(
        table.schema, aggs, **kw)) == ["__key__hostname"]
    _compare(want.rename(columns={"__key__b": "b"}),
             got.rename(columns={"__key__b": "b"}), data, "plan_from_specs")


#: the narrow and unsigned integer columns, with the range each draws
#: from: SMALLINT near its top and INT UNSIGNED above 2^31 reach the
#: wrap of the column's sum and the float32 rounding of a value
NARROW = {"i8": ("TINYINT", -128, 128), "i16": ("SMALLINT", 20000, 30000),
          "u32": ("INT UNSIGNED", 2**31, 2**32),
          "u16": ("SMALLINT UNSIGNED", 0, 2**16),
          "u8": ("TINYINT UNSIGNED", 0, 2**8)}
NARROW_OPS = ["count", "sum", "min", "max", "avg", "first_value",
              "last_value", "stddev"]
NARROW_GROUPS = {
    "tag": ("hostname", "hostname"),
    "date_bin": ("date_bin(INTERVAL '10 minutes', ts) AS b", "b")}


def _narrow_columns():
    """6 hosts x 240 rows at 10 s; ~5 % nulls, and host_5's INT UNSIGNED
    column all null (an empty first/last)."""
    rng = np.random.default_rng(7)
    hosts, samples = 6, 240
    n = hosts * samples
    cols = {"hostname": np.repeat([f"host_{i}" for i in range(hosts)],
                                  samples).astype(object),
            "ts": np.tile(T0 + np.arange(samples, dtype=np.int64) * STEP,
                          hosts)}
    for name, (_, lo, hi) in NARROW.items():
        v = [int(x) for x in rng.integers(lo, hi, n)]
        for i in np.nonzero(rng.random(n) < 0.05)[0]:
            v[i] = None
        cols[name] = v
    cols["u32"][5 * samples:] = [None] * samples
    return cols


@pytest.fixture(scope="module")
def narrow(stack):
    """Table `nt` with the NARROW columns in both packages, and each
    grouping's statement (every op over every column) run once through
    both, so the reference compiles one program per grouping."""
    cols = _narrow_columns()
    stack.fe.do_query(
        "CREATE TABLE nt (hostname STRING, ts TIMESTAMP TIME INDEX, " +
        ", ".join(f"{k} {t}" for k, (t, _, _) in NARROW.items()) +
        ", PRIMARY KEY(hostname))", RefCtx())
    ref_table = stack.fe.catalog.table("greptime", "public", "nt")
    ref_table.bulk_load(cols)
    table = _port_table(stack.storage, stack.catalog, "nt", ref_table, cols)
    out = {}
    for g, (sel, key) in NARROW_GROUPS.items():
        aggs = ", ".join(f"{op}({c})" for op in NARROW_OPS for c in NARROW)
        sql = f"SELECT {sel}, {aggs} FROM nt GROUP BY {key} ORDER BY {key}"
        out[g] = _run_tables(stack.ref, ref_table, stack.port, table, sql,
                             floor=0)
    return out


@pytest.mark.parametrize("op", NARROW_OPS)
@pytest.mark.parametrize("group", list(NARROW_GROUPS))
def test_narrow_int_fields_match_reference(narrow, group, op):
    """TINYINT / SMALLINT / INT UNSIGNED / SMALLINT UNSIGNED / TINYINT
    UNSIGNED on the device path: every result exactly the reference's
    (sums wrap to the column's type, INT UNSIGNED values above 2^31 are
    not rounded, an all-null first/last is the reference's 0); standard
    deviations, folded from those sums and float32 squares, within 1e-3
    relative as in `_compare`."""
    want, got, ref_prof, port_prof = narrow[group]
    assert ref_prof is not None and ref_prof.path == "resident"
    assert port_prof is not None and port_prof.path == "resident"
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) > 1
    for c in NARROW:
        col = f"{op}({c})"
        w, g = want[col].to_numpy(), got[col].to_numpy()
        np.testing.assert_array_equal(pd.isna(g), pd.isna(w), err_msg=col)
        ok = ~pd.isna(w)
        if op == "stddev":
            w64, g64 = w[ok].astype(np.float64), g[ok].astype(np.float64)
            assert (np.abs(g64 - w64) <= 1e-3 * np.abs(w64) + 1e-4).all(), \
                col
            continue
        np.testing.assert_array_equal(g[ok].astype(object),
                                      w[ok].astype(object), err_msg=col)


@pytest.fixture(scope="module")
def narrow_streamed(stack, narrow):
    """Each grouping's statement through the port's streamed cold path in
    its "device" mode (the streaming threshold at 0, the slices launched
    on the CPU through the kernel's plain version)."""
    from greptimedb_tpu_torch.query import stream_exec
    table = stack.catalog.table("greptime", "public", "nt")
    (region,) = table.regions.values()
    saved = stream_exec.stream_threshold_rows(), stream_exec._COLD_REDUCE[0]
    stream_exec.configure_streaming(threshold_rows=0, cold_reduce="device")
    out = {}
    try:
        for g, (sel, key) in NARROW_GROUPS.items():
            aggs = ", ".join(f"{op}({c})" for op in NARROW_OPS
                             for c in NARROW)
            sql = f"SELECT {sel}, {aggs} FROM nt GROUP BY {key} ORDER BY {key}"
            saved_floor = tpu_exec.TPU_DISPATCH_MIN_ROWS
            tpu_exec.TPU_DISPATCH_MIN_ROWS = 0
            tpu_exec._observed_min_dt[0] = None
            try:
                got = _frame(stack.port.execute(parse_sql(sql),
                                                QueryContext()))
            finally:
                tpu_exec.TPU_DISPATCH_MIN_ROWS = saved_floor
                tpu_exec._observed_min_dt[0] = None
            out[g] = (got, region.last_scan_profile)
    finally:
        stream_exec.configure_streaming(threshold_rows=saved[0],
                                        cold_reduce=saved[1])
    return out


@pytest.mark.parametrize("op", NARROW_OPS)
@pytest.mark.parametrize("group", list(NARROW_GROUPS))
def test_narrow_int_fields_streamed_match_reference(narrow, narrow_streamed,
                                                    group, op):
    """The narrow and unsigned integer table through the streamed path's
    device reduction: its slices mirror each column as the resident scan
    does, so every result is exactly the reference's, as on the resident
    path (standard deviations within 1e-3 relative)."""
    want = narrow[group][0]
    got, prof = narrow_streamed[group]
    assert prof is not None and prof.path == "streamed"
    assert prof.counters.get("device_slices", 0) > 0
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) > 1
    for c in NARROW:
        col = f"{op}({c})"
        w, g = want[col].to_numpy(), got[col].to_numpy()
        np.testing.assert_array_equal(pd.isna(g), pd.isna(w), err_msg=col)
        ok = ~pd.isna(w)
        if op == "stddev":
            w64, g64 = w[ok].astype(np.float64), g[ok].astype(np.float64)
            assert (np.abs(g64 - w64) <= 1e-3 * np.abs(w64) + 1e-4).all(), \
                col
            continue
        np.testing.assert_array_equal(g[ok].astype(object),
                                      w[ok].astype(object), err_msg=col)
