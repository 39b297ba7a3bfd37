"""Continuous rollup flows and downsampling: the JAX package against the
port, on the CPU.

Every case runs the same statements through both packages' standalone
frontends, each over its own data home (the reference's
FrontendInstance and the port's `build_standalone(DatanodeOptions(
device="cpu"))`), with the folds driven by `FlowManager.tick()`; the
port's folds launch segment_moments' plain version on the CPU. The
source rows are made from a numpy seed, as multiples of 1/8 that float32
holds exactly. Then:

- `storage/downsample.downsample_region` with every op in `_SUPPORTED`,
  a `time_range`, an `origin_ms` and a partitioned destination
  (reference tests/test_background.py TestDownsample and
  tests/test_flow.py TestPartitionedDestination);
- the cases of tests/test_flow.py but its distributed one: DDL and its
  errors (error class and message equal), information_schema, the
  incremental watermark, rewrite dispatch and equality across
  aggregates × strides, filters / HAVING / ORDER, shapes that stay raw,
  the dropped-sink fallback, retraction after a DELETE, integer columns
  keeping their type, the first/last tag rule, the cold region fold,
  the restart without a double fold and the partitioned sink.

Sink rows and answers are compared across the packages: columns, types,
keys, counts, min/max/first/last exactly; sums and averages within the
float32 bound of tests/test_torch_sql.py, |port - ref| <= 1e-5 |ref| +
8 eps32 P, P the sum of |x| over the source column. Fold counters,
watermarks, written bucket counts and dispatch decisions are equal. In
each package a rewritten answer equals the raw one, as the reference's
own tests hold it.
"""

import math

import numpy as np
import pytest

from greptimedb_tpu.datanode import DatanodeInstance as RefDatanode
from greptimedb_tpu.datanode import DatanodeOptions as RefOptions
from greptimedb_tpu.flow import rewrite as ref_rewrite
from greptimedb_tpu.frontend import FrontendInstance as RefFrontend
from greptimedb_tpu.query import stream_exec as ref_stream
from greptimedb_tpu.query import tpu_exec as ref_exec
from greptimedb_tpu.storage.downsample import \
    downsample_region as ref_downsample
from greptimedb_tpu_torch.common.time import TimestampRange
from greptimedb_tpu_torch.datanode import DatanodeOptions
from greptimedb_tpu_torch.flow import rewrite
from greptimedb_tpu_torch.frontend import build_standalone
from greptimedb_tpu_torch.query import stream_exec, tpu_exec
from greptimedb_tpu_torch.storage import downsample

EPS32 = 2.0 ** -24
FLOW_KEY = "greptime.public.cpu_1m"

FLOW_SQL = ("CREATE FLOW cpu_1m AS SELECT host, "
            "date_bin(INTERVAL '1 minute', ts) AS b, "
            "sum(v) AS v_sum, count(v) AS v_cnt, min(v) AS v_min, "
            "max(v) AS v_max, first(v) AS v_first, last(v) AS v_last, "
            "count(*) AS n FROM cpu GROUP BY host, b")


class Side:
    """One package's standalone frontend and its flow manager."""

    def __init__(self, port: bool, home):
        self.port = port
        if port:
            self.fe = build_standalone(DatanodeOptions(
                data_home=str(home), register_numbers_table=False,
                device="cpu"))
        else:
            self.fe = RefFrontend(RefDatanode(RefOptions(
                data_home=str(home), register_numbers_table=False)))
            self.fe.start()
        self.fm = self.fe.datanode.flow_manager
        self.exec = tpu_exec if port else ref_exec

    def out(self, sql):
        """(column names, type names, rows) of the statement's output."""
        out = self.fe.do_query(sql)[0]
        b = out.batches[0]
        return (b.schema.names(), [c.dtype.name
                                   for c in b.schema.column_schemas],
                [list(r) for r in b.rows()])

    def q(self, sql):
        return self.out(sql)[2]

    def dispatch(self):
        return self.fe.query_engine.last_exec_stats.dispatch or ""

    def spec(self):
        return self.fm.flows()[0]

    def table(self, name):
        return self.fe.catalog.table("greptime", "public", name)

    def raw(self, sql):
        """The statement's rows with the rollup rewrite off."""
        self.fe.do_query("SET rollup_rewrite = 0")
        try:
            return self.q(sql)
        finally:
            self.fe.do_query("SET rollup_rewrite = 1")

    def clear_cache(self):
        cache = self.exec.SCAN_CACHE
        with cache._lock:                # the reference has no clear()
            cache._entries.clear()


@pytest.fixture(autouse=True)
def _restore_knobs(monkeypatch):
    """SET statements and the adaptive dispatch floor change module
    state in both packages: restore it after each case."""
    for ex, st, rw in ((ref_exec, ref_stream, ref_rewrite),
                       (tpu_exec, stream_exec, rewrite)):
        monkeypatch.setattr(ex, "TPU_DISPATCH_MIN_ROWS",
                            ex.TPU_DISPATCH_MIN_ROWS)
        monkeypatch.setattr(ex, "_observed_min_dt", [None])
        monkeypatch.setattr(st, "_STREAM_THRESHOLD_ROWS",
                            list(st._STREAM_THRESHOLD_ROWS))
        monkeypatch.setattr(rw, "_ENABLED", [True])
    yield


@pytest.fixture()
def sides(tmp_path):
    ref = Side(False, tmp_path / "ref")
    port = Side(True, tmp_path / "port")
    yield ref, port
    ref.fe.shutdown()
    port.fe.shutdown()


def _values(n_per_host, hosts, with_nulls, seed):
    rng = np.random.default_rng(seed)
    rows = []
    for h in hosts:
        vals = rng.integers(0, 8000, n_per_host) / 8.0
        for i in range(n_per_host):
            v = None if with_nulls and i % 7 == 0 else float(vals[i])
            rows.append((h, i * 1000, v))
    return rows


def _insert_sql(rows):
    return "INSERT INTO cpu VALUES " + ",".join(
        f"('{h}', {t}, {'NULL' if v is None else repr(v)})"
        for h, t, v in rows)


def mk_cpu(sides, n_per_host=600, hosts=("a", "b"), with_nulls=False,
           seed=3):
    """The reference's cpu table in both packages; returns P, the sum of
    |v| over the rows."""
    rows = _values(n_per_host, hosts, with_nulls, seed)
    for s in sides:
        s.fe.do_query("CREATE TABLE cpu (host STRING, ts TIMESTAMP TIME "
                      "INDEX, v DOUBLE, PRIMARY KEY(host))")
        s.fe.do_query(_insert_sql(rows))
    return sum(abs(v) for _, _, v in rows if v is not None)


def both(sides, sql):
    return [s.fe.do_query(sql) for s in sides]


def _approx(name):
    n = name.lower()
    return "sum" in n or "avg" in n or n == "s"


def assert_rows(ref, port, p, names=None):
    """Rows equal: non-floats and exact columns by value, the float32
    bound for sums and averages."""
    assert len(port) == len(ref), (ref, port)
    for rr, pr in zip(ref, port):
        assert len(pr) == len(rr), (rr, pr)
        for k, (a, b) in enumerate(zip(rr, pr)):
            approx = names is None or _approx(names[k])
            if isinstance(a, float) and isinstance(b, float):
                if math.isnan(a) or math.isnan(b):
                    assert math.isnan(a) and math.isnan(b), (rr, pr)
                elif approx:
                    assert abs(b - a) <= 1e-5 * abs(a) + 8 * EPS32 * p, \
                        (rr, pr)
                else:
                    assert a == b, (rr, pr)
            else:
                assert type(a) is type(b) and a == b, (rr, pr)


def assert_same(sides, sql, p):
    """The statement's output equal across the packages (names, types,
    rows); returns the port's rows."""
    (rn, rt, rrows), (pn, pt, prows) = [s.out(sql) for s in sides]
    assert (pn, pt) == (rn, rt), sql
    assert_rows(rrows, prows, p, pn)
    return prows


def assert_sinks_same(sides, sink, p):
    sql = f"SELECT * FROM {sink} ORDER BY host, ts"
    return assert_same(sides, sql, p)


def assert_errors_same(sides, sql):
    """Both packages refuse the statement with the same error class name
    and message; returns the message."""
    errs = []
    for s in sides:
        with pytest.raises(Exception) as ei:
            s.fe.do_query(sql)
        errs.append((type(ei.value).__name__, str(ei.value)))
    assert errs[1] == errs[0], sql
    return errs[0]


def rewrite_diff(sides, sql, p):
    """Each package serves the statement through the rollup rewrite, its
    answer equals its raw answer, and the two packages agree."""
    got = []
    for s in sides:
        rolled = s.out(sql)
        assert "rollup-rewrite" in s.dispatch(), sql
        raw = s.raw(sql)
        assert "rollup-rewrite" not in s.dispatch(), sql
        assert_rows(raw, rolled[2], 0.0, rolled[0])
        got.append(rolled)
    (rn, rt, rrows), (pn, pt, prows) = got
    assert (pn, pt) == (rn, rt), sql
    assert_rows(rrows, prows, p, pn)


# ---------------------------------------------------------------------------
# downsample_region
# ---------------------------------------------------------------------------

DS_AGGS = [("v_avg", "avg", "v"), ("v_sum", "sum", "v"),
           ("v_min", "min", "v"), ("v_max", "max", "v"),
           ("v_cnt", "count", "v"), ("v_first", "first", "v"),
           ("v_last", "last", "v"), ("n", "count", None)]


def _ds_dest(sides, name, partitioned=False):
    cols = ", ".join(f"{d} DOUBLE" for d, _, _ in DS_AGGS)
    part = (" PARTITION BY RANGE COLUMNS (host) ("
            "PARTITION p0 VALUES LESS THAN ('b'), "
            "PARTITION p1 VALUES LESS THAN (MAXVALUE))") \
        if partitioned else ""
    both(sides, f"CREATE TABLE {name} (host STRING, ts TIMESTAMP TIME "
                f"INDEX, {cols}, PRIMARY KEY(host)){part}")


@pytest.mark.parametrize("case", [
    dict(),
    dict(time_range=(90_000, 420_000)),
    dict(time_range=(None, 250_000), origin_ms=15_000),
    dict(origin_ms=-7_000, stride_ms=45_000),
])
def test_downsample_region_every_op(sides, case):
    p = mk_cpu(sides, 600, with_nulls=True)
    _ds_dest(sides, "ds")
    stride = case.get("stride_ms", 60_000)
    origin = case.get("origin_ms", 0)
    wrote = []
    for s in sides:
        src = s.table("cpu")
        dst = s.table("ds")
        kw = {}
        if "time_range" in case:
            lo, hi = case["time_range"]
            if s.port:
                kw["time_range"] = TimestampRange(lo, hi)
            else:
                from greptimedb_tpu.common.time import \
                    TimestampRange as RefRange
                kw["time_range"] = RefRange(lo, hi)
        fn = downsample.downsample_region if s.port else ref_downsample
        if s.port:
            kw["device"] = "cpu"
        (region,) = src.regions.values()
        wrote.append(fn(region, dst, stride_ms=stride, aggs=DS_AGGS,
                        origin_ms=origin, **kw))
    assert wrote[1] == wrote[0] > 0
    rows = assert_sinks_same(sides, "ds", p)
    assert len(rows) == wrote[1]
    # the port's own fold is held to a numpy brute force, too
    lo, hi = case.get("time_range", (None, None))
    src_rows = _values(600, ("a", "b"), True, 3)
    for host, ts, *vals in rows:
        grp = [v for h, t, v in src_rows
               if h == host and (t - origin) // stride * stride + origin == ts
               and (lo is None or t >= lo) and (hi is None or t < hi)]
        live = [v for v in grp if v is not None]
        want = [np.mean(live) if live else None, sum(live) if live else None,
                min(live, default=None), max(live, default=None),
                float(len(live)), live[0] if live else None,
                live[-1] if live else None, float(len(grp))]
        for got, w, (name, _, _) in zip(vals, want, DS_AGGS):
            if w is None:
                assert got is None, name
            elif _approx(name):
                assert abs(got - w) <= 8 * EPS32 * p, name
            else:
                assert got == w, name
    prof = next(iter(sides[1].table("cpu").regions.values())
                ).last_scan_profile
    assert prof.path == "flow-fold" and prof.counters["buckets"] == wrote[1]
    assert {"scan_prep", "runs", "launch", "tags", "fetch",
            "sink_write"} <= set(prof.stages)


def test_downsample_into_partitioned_table(sides):
    p = mk_cpu(sides, 300)
    both(sides, "CREATE TABLE agg (host STRING, ts TIMESTAMP TIME INDEX, "
                "v DOUBLE, PRIMARY KEY(host)) PARTITION BY RANGE COLUMNS "
                "(host) (PARTITION p0 VALUES LESS THAN ('b'), "
                "PARTITION p1 VALUES LESS THAN (MAXVALUE))")
    for s in sides:
        src, dst = s.table("cpu"), s.table("agg")
        assert len(dst.regions) == 2
        fn = downsample.downsample_region if s.port else ref_downsample
        kw = {"device": "cpu"} if s.port else {}
        wrote = sum(fn(region, dst, stride_ms=60_000, aggs={"v": "avg"},
                       **kw) for region in src.regions.values())
        assert wrote == 2 * 5
        # each bucket row landed in its partition's region
        per_region = [r.snapshot().read_merged().num_rows
                      for r in dst.regions.values()]
        assert sorted(per_region) == [5, 5]
    assert_sinks_same(sides, "agg", p)


# ---------------------------------------------------------------------------
# DDL
# ---------------------------------------------------------------------------

def test_create_show_drop(sides):
    mk_cpu(sides, 120)
    both(sides, FLOW_SQL)
    shows = [s.q("SHOW FLOWS") for s in sides]
    assert shows[1] == shows[0]
    assert shows[1][0][:4] == ["cpu_1m", "cpu", "cpu_1m", 60_000]
    for s in sides:
        # the sink materialized as an ordinary table
        assert s.q("SHOW TABLES LIKE 'cpu_1m'") == [["cpu_1m"]]
        # idempotent create
        s.fe.do_query(FLOW_SQL.replace("CREATE FLOW",
                                       "CREATE FLOW IF NOT EXISTS"))
    assert_errors_same(sides, FLOW_SQL)
    both(sides, "DROP FLOW cpu_1m")
    assert [s.q("SHOW FLOWS") for s in sides] == [[], []]
    assert_errors_same(sides, "DROP FLOW cpu_1m")
    both(sides, "DROP FLOW IF EXISTS cpu_1m")       # silent


def test_flow_listed_in_information_schema(sides):
    p = mk_cpu(sides, 60)
    both(sides, FLOW_SQL)
    got = assert_same(sides, "SELECT * FROM information_schema.flows", p)
    assert got[0][:4] == ["cpu_1m", "cpu", "cpu_1m", 60_000]
    for s in sides:
        s.fm.tick()
    got = assert_same(sides, "SELECT flow_name, watermark, folds, "
                             "rows_folded, buckets_written FROM "
                             "information_schema.flows", p)
    assert got == [["cpu_1m", 59_000, 1, 120, 2]]
    got = assert_same(sides, "SELECT metric_name, labels, value FROM "
                             "information_schema.runtime_metrics WHERE "
                             "metric_name IN ('greptime_flow_watermark_ts', "
                             "'greptime_flow_rows_folded', "
                             "'greptime_flow_buckets_written') "
                             "ORDER BY metric_name", p)
    assert [(r[0], r[2]) for r in got] == [
        ("greptime_flow_buckets_written", 2.0),
        ("greptime_flow_rows_folded", 120.0),
        ("greptime_flow_watermark_ts", 59_000.0)]


FLOW_ERRORS = {
    "not-derivable": "CREATE FLOW f AS SELECT stddev(v) FROM cpu "
                     "GROUP BY date_bin(INTERVAL '1 minute', ts)",
    "no-bucket": "CREATE FLOW f AS SELECT host, sum(v) FROM cpu "
                 "GROUP BY host",
    "zero-stride": "CREATE FLOW f AS SELECT sum(v) FROM cpu "
                   "GROUP BY date_bin(INTERVAL '0 minutes', ts)",
    "where": "CREATE FLOW f AS SELECT sum(v) FROM cpu WHERE host = 'a' "
             "GROUP BY date_bin(INTERVAL '1 minute', ts)",
    "no-source": "CREATE FLOW f AS SELECT sum(v) FROM nope "
                 "GROUP BY date_bin(INTERVAL '1 minute', ts)",
    "sink-is-source": "CREATE FLOW cpu AS SELECT host, sum(v) FROM cpu "
                      "GROUP BY host, date_bin(INTERVAL '1 minute', ts)",
    "tag-subset": "CREATE FLOW f AS SELECT sum(v) FROM cpu "
                  "GROUP BY date_bin(INTERVAL '1 minute', ts)",
    "no-from": "CREATE FLOW f SINK TO s AS SELECT 1",
    "show-where": "SHOW FLOWS WHERE flow_name = 'x'",
    "sketch": "CREATE FLOW f AS SELECT host, median(v) FROM cpu "
              "GROUP BY host, date_bin(INTERVAL '1 minute', ts)",
    "expression-arg": "CREATE FLOW f AS SELECT host, sum(v * 2) FROM cpu "
                      "GROUP BY host, date_bin(INTERVAL '1 minute', ts)",
    "bad-rewrite-knob": "SET rollup_rewrite = 'x'",
}


@pytest.mark.parametrize("case", list(FLOW_ERRORS))
def test_create_flow_errors(sides, case):
    mk_cpu(sides, 10)
    name, msg = assert_errors_same(sides, FLOW_ERRORS[case])
    want = {"not-derivable": "not derivable", "no-bucket": "date_bin",
            "zero-stride": "date_bin", "where": "WHERE",
            "no-source": "not found", "sink-is-source": "differ",
            "tag-subset": "every tag column", "no-from": "FROM",
            "show-where": "LIKE"}.get(case)
    if want is not None:
        assert want in msg, msg
    assert [s.q("SHOW FLOWS") for s in sides] == [[], []]


def test_cross_schema_source_rejected(sides):
    both(sides, "CREATE DATABASE other")
    both(sides, "CREATE TABLE other.m (host STRING, ts TIMESTAMP TIME "
                "INDEX, v DOUBLE, PRIMARY KEY(host))")
    _, msg = assert_errors_same(
        sides, "CREATE FLOW f AS SELECT host, sum(v) FROM other.m "
               "GROUP BY host, date_bin(INTERVAL '1 minute', ts)")
    assert "current database" in msg


# ---------------------------------------------------------------------------
# incremental fold
# ---------------------------------------------------------------------------

def test_watermark_folds_only_new_rows(sides):
    p = mk_cpu(sides, 600)
    both(sides, FLOW_SQL)
    for s in sides:
        assert s.fm.tick()[FLOW_KEY] == 2 * 10
        spec = s.spec()
        assert spec.stats["rows_folded"] == 1200
        assert spec.stats["folds"] == 1
        # steady state: nothing new → no fold work at all
        assert s.fm.tick()[FLOW_KEY] == 0
        assert spec.stats["folds"] == 1
    assert_sinks_same(sides, "cpu_1m", p)
    # new rows: only the delta is folded, re-folding the touched bucket
    both(sides, "INSERT INTO cpu VALUES ('a', 600000, 600.0), "
                "('a', 601000, 601.0)")
    for s in sides:
        s.fm.tick()
        assert s.spec().stats["rows_folded"] == 1202
        assert s.spec().stats["folds"] == 2
        assert s.q("SELECT v_cnt, n FROM cpu_1m "
                   "WHERE host = 'a' AND ts = 600000") == [[2.0, 2.0]]
    # a late (out-of-order) write re-folds from its bucket onward
    both(sides, "INSERT INTO cpu VALUES ('a', 1000, 9999.0)")
    for s in sides:
        s.fm.tick()
        assert s.q("SELECT v_max FROM cpu_1m "
                   "WHERE host = 'a' AND ts = 0") == [[9999.0]]
    assert_sinks_same(sides, "cpu_1m", p + 1201.0 + 9999.0)
    wms = [s.spec().watermarks for s in sides]
    assert [{k: (w["ts"], w["rows"]) for k, w in wm.items()}
            for wm in wms][0] == \
        {k: (w["ts"], w["rows"]) for k, w in wms[1].items()}


def test_rewrite_dispatch_and_equality(sides):
    p = mk_cpu(sides, 600)
    both(sides, FLOW_SQL)
    for s in sides:
        s.fm.tick()
    sql = ("SELECT host, date_bin(INTERVAL '5 minutes', ts) AS b, "
           "sum(v), count(v), avg(v) FROM cpu "
           "GROUP BY host, b ORDER BY host, b")
    rewrite_diff(sides, sql, p)
    # EXPLAIN names the dispatch without folding, in the same words
    plans = [s.q("EXPLAIN " + sql)[0][1] for s in sides]
    assert plans[1] == plans[0]
    assert "Dispatch: rollup-rewrite (flow cpu_1m" in plans[1]
    assert "TableScan: cpu_1m" in plans[1]
    # EXPLAIN ANALYZE records the rewrite stage + dispatch line
    for s in sides:
        stages = s.q("EXPLAIN ANALYZE " + sql)
        by_stage = {r[0]: r[4] for r in stages}
        assert "rollup-rewrite" in by_stage["dispatch"]
        assert "flow=cpu_1m" in by_stage["rollup_rewrite"]


def test_rewrite_refreshes_lagging_sink(sides):
    """A query through the rewrite first folds pending rows, so the
    transparent path never serves stale buckets."""
    p = mk_cpu(sides, 300)
    both(sides, FLOW_SQL)
    # no manual tick: the SELECT itself must catch the sink up
    rewrite_diff(sides, "SELECT host, date_bin(INTERVAL '1 minute', ts) "
                        "AS b, sum(v) FROM cpu GROUP BY host, b "
                        "ORDER BY host, b", p)
    assert [s.spec().stats["rows_folded"] for s in sides] == [600, 600]


# ---------------------------------------------------------------------------
# rewrite differential
# ---------------------------------------------------------------------------

AGGS = ["sum(v)", "count(v)", "count(*)", "min(v)", "max(v)",
        "first(v)", "last(v)", "avg(v)"]


@pytest.mark.parametrize("stride", ["1 minute", "2 minutes", "5 minutes"])
def test_aggs_by_strides(sides, stride):
    p = mk_cpu(sides, 600, with_nulls=True)
    both(sides, FLOW_SQL)
    for s in sides:
        s.fm.tick()
    cols = ", ".join(AGGS)
    rewrite_diff(sides, f"SELECT host, date_bin(INTERVAL '{stride}', ts) "
                        f"AS b, {cols} FROM cpu GROUP BY host, b "
                        f"ORDER BY host, b", p)


@pytest.mark.parametrize("sql", [
    # tag filter + aligned time range + HAVING over an aggregate
    "SELECT host, date_bin(INTERVAL '2 minutes', ts) AS b, sum(v) AS s "
    "FROM cpu WHERE host = 'b' AND ts >= 60000 AND ts < 480000 "
    "GROUP BY host, b HAVING sum(v) > 0 ORDER BY s DESC, b",
    # global (tagless) rollup over the time bucket only
    "SELECT date_bin(INTERVAL '5 minutes', ts) AS b, count(*), avg(v) "
    "FROM cpu GROUP BY b ORDER BY b",
], ids=["filter-having-order", "tagless"])
def test_filters_having_order(sides, sql):
    p = mk_cpu(sides, 600)
    both(sides, FLOW_SQL)
    for s in sides:
        s.fm.tick()
    rewrite_diff(sides, sql, p)


@pytest.mark.parametrize("sql", [
    # stride not a multiple of the flow stride
    "SELECT date_bin(INTERVAL '90 seconds', ts) AS b, sum(v) "
    "FROM cpu GROUP BY b ORDER BY b",
    # unaligned time bound would clip a fine bucket
    "SELECT date_bin(INTERVAL '1 minute', ts) AS b, sum(v) "
    "FROM cpu WHERE ts >= 1500 GROUP BY b ORDER BY b",
    # field predicate cannot be applied post-aggregation
    "SELECT date_bin(INTERVAL '1 minute', ts) AS b, sum(v) "
    "FROM cpu WHERE v > 5 GROUP BY b ORDER BY b",
    # aggregate the flow does not store
    "SELECT date_bin(INTERVAL '1 minute', ts) AS b, stddev(v) "
    "FROM cpu GROUP BY b ORDER BY b",
    # finer stride than the flow
    "SELECT date_bin(INTERVAL '30 seconds', ts) AS b, sum(v) "
    "FROM cpu GROUP BY b ORDER BY b",
], ids=["stride-90s", "unaligned-time", "field-filter", "stddev",
        "finer-stride"])
def test_non_rewritable_shapes_stay_raw(sides, sql):
    p = mk_cpu(sides, 600)
    both(sides, FLOW_SQL)
    for s in sides:
        s.fm.tick()
    assert_same(sides, sql, p)
    dispatches = [s.dispatch() for s in sides]
    assert "rollup-rewrite" not in dispatches[1]
    assert dispatches[1] == dispatches[0]
    plans = [s.q("EXPLAIN " + sql)[0][1] for s in sides]
    assert plans[1] == plans[0] and "rollup-rewrite" not in plans[1]


# ---------------------------------------------------------------------------
# regressions of the reference, held in both packages
# ---------------------------------------------------------------------------

def test_dropped_sink_falls_back_to_raw(sides):
    """DROP TABLE on the sink (flow still registered) must not break
    queries on the source — the rewrite falls back to the raw scan."""
    p = mk_cpu(sides, 120)
    both(sides, FLOW_SQL)
    for s in sides:
        s.fm.tick()
    both(sides, "DROP TABLE cpu_1m")
    got = assert_same(sides, "SELECT host, date_bin(INTERVAL '1 minute', "
                             "ts) AS b, sum(v) FROM cpu GROUP BY host, b "
                             "ORDER BY host, b", p)
    assert len(got) == 2 * 2
    assert all("rollup-rewrite" not in s.dispatch() for s in sides)
    # a tick skips the flow whose sink is gone
    assert [s.fm.tick()[FLOW_KEY] for s in sides] == [0, 0]


@pytest.mark.parametrize("then_insert", [False, True],
                         ids=["delete", "delete-then-insert"])
def test_delete_triggers_retraction_refold(sides, then_insert):
    """DELETE of already-folded rows advances the sequence with no new
    scan rows (and, behind new INSERTs in the same interval, hides from
    the seq filter): the live-row count probe re-reduces, and the
    re-read rows do not count as folded again."""
    p = mk_cpu(sides, 120)
    both(sides, FLOW_SQL)
    for s in sides:
        s.fm.tick()
        assert s.spec().stats["rows_folded"] == 240
    both(sides, "DELETE FROM cpu WHERE host = 'a' AND ts = 0")
    if then_insert:
        both(sides, "INSERT INTO cpu VALUES ('a', 200000, 1.0)")
    for s in sides:
        s.fm.tick()
        assert s.spec().stats["rows_folded"] == 240 + int(then_insert)
    assert_sinks_same(sides, "cpu_1m", p)
    rewrite_diff(sides, "SELECT host, date_bin(INTERVAL '1 minute', ts) "
                        "AS b, sum(v), count(v) FROM cpu GROUP BY host, b "
                        "ORDER BY host, b", p)


def test_full_bucket_delete_removes_ghost_sink_rows(sides):
    """Deleting every row of a bucket must delete the bucket's sink
    row too — a refold alone cannot emit it."""
    p = mk_cpu(sides, 180)
    both(sides, FLOW_SQL)
    for s in sides:
        s.fm.tick()
        assert len(s.q("SELECT ts FROM cpu_1m WHERE host = 'a'")) == 3
    both(sides, "DELETE FROM cpu WHERE ts < 60000")
    for s in sides:
        s.fm.tick()
        # bucket 0 vanished from the sink for both hosts
        assert len(s.q("SELECT ts FROM cpu_1m WHERE host = 'a'")) == 2
    assert_sinks_same(sides, "cpu_1m", p)
    rewrite_diff(sides, "SELECT host, date_bin(INTERVAL '1 minute', ts) "
                        "AS b, sum(v), count(*) FROM cpu GROUP BY host, b "
                        "ORDER BY host, b", p)


def test_integer_columns_keep_their_type(sides):
    """sum/min/max/first/last over integer source columns come back
    integral through the rollup, as on the raw path."""
    rng = np.random.default_rng(5)
    vals = rng.integers(-50, 1000, 120)
    # INT UNSIGNED above 2^31: the port's mirror is biased by -2^31
    uvals = rng.integers(2**31, 2**32, 120)
    both(sides, "CREATE TABLE m (host STRING, ts TIMESTAMP TIME "
                "INDEX, c BIGINT, i INT, u INT UNSIGNED, PRIMARY KEY(host))")
    both(sides, "INSERT INTO m VALUES " + ",".join(
        f"('a', {k * 1000}, {int(v)}, {int(v) // 3}, {int(w)})"
        for k, (v, w) in enumerate(zip(vals, uvals))))
    both(sides, "CREATE FLOW m_1m AS SELECT host, sum(c) AS c_sum, "
                "max(c) AS c_max, first(c) AS c_first, min(i) AS i_min, "
                "count(i) AS i_cnt, max(u) AS u_max, min(u) AS u_min, "
                "last(u) AS u_last FROM m "
                "GROUP BY host, date_bin(INTERVAL '1 minute', ts)")
    for s in sides:
        s.fm.tick()
    sql = ("SELECT host, date_bin(INTERVAL '2 minutes', ts) AS b, "
           "sum(c), max(c), first(c), min(i), count(i), max(u), min(u), "
           "last(u) FROM m GROUP BY host, b")
    got = []
    for s in sides:
        rolled = s.out(sql)
        assert "rollup-rewrite" in s.dispatch()
        assert rolled[2] == s.raw(sql)
        got.append(rolled)
    assert got[1] == got[0]
    # exact int equality, not 1770.0 vs 1770
    assert all(isinstance(v, int) for v in got[1][2][0][2:])
    # one 2-minute bucket holds the 120 rows
    assert got[1][2] == [got[1][2][0]]
    assert got[1][2][0][7:] == [int(uvals.max()), int(uvals.min()),
                                int(uvals[-1])]


def test_first_last_require_full_tag_set(sides):
    """first/last cannot merge across collapsed tag dimensions: a GROUP
    BY without the flow's tags stays on the raw scan; sum over the same
    collapsed shape still rewrites."""
    p = mk_cpu(sides, 300)
    both(sides, FLOW_SQL)
    for s in sides:
        s.fm.tick()
    assert_same(sides, "SELECT date_bin(INTERVAL '5 minutes', ts) AS b, "
                       "first(v) FROM cpu GROUP BY b ORDER BY b", p)
    assert all("rollup-rewrite" not in s.dispatch() for s in sides)
    rewrite_diff(sides, "SELECT date_bin(INTERVAL '5 minutes', ts) AS b, "
                        "sum(v) FROM cpu GROUP BY b ORDER BY b", p)


def test_cold_region_fold_skips_scan_cache(sides):
    """A source region past the streaming threshold folds through the
    window-bounded host path — same answers, no scan-cache residency
    pinned by the background fold; incremental on the cold path too
    (ts-watermarked: refolds from the last bucket boundary only)."""
    p = mk_cpu(sides, 600)
    both(sides, FLOW_SQL)
    for st in (ref_stream, stream_exec):
        st.configure_streaming(threshold_rows=1)
    folded = []
    for s in sides:
        s.clear_cache()
        s.fm.tick()
        assert s.exec.SCAN_CACHE.resident_bytes() == 0
        assert s.spec().stats["rows_folded"] == 1200
    (region,) = sides[1].table("cpu").regions.values()
    assert region.last_scan_profile.path == "flow-fold-cold"
    assert_sinks_same(sides, "cpu_1m", p)
    both(sides, "INSERT INTO cpu VALUES ('a', 600000, 1.0)")
    for s in sides:
        before = s.spec().stats["rows_folded"]
        s.fm.tick()
        folded.append(s.spec().stats["rows_folded"] - before)
    assert folded[1] == folded[0] <= 2 * 60 + 1
    assert_sinks_same(sides, "cpu_1m", p + 1.0)
    rewrite_diff(sides, "SELECT host, date_bin(INTERVAL '5 minutes', ts) "
                        "AS b, sum(v), count(v) FROM cpu GROUP BY host, b "
                        "ORDER BY host, b", p + 1.0)


def test_explain_converts_time_literals_like_execution(sides):
    mk_cpu(sides, 300)
    both(sides, FLOW_SQL)
    plans = [s.q("EXPLAIN SELECT date_bin(INTERVAL '1 minute', ts) AS b, "
                 "sum(v) FROM cpu WHERE ts >= '1970-01-01 00:01:00' "
                 "GROUP BY b")[0][1] for s in sides]
    assert plans[1] == plans[0]
    assert "Dispatch: rollup-rewrite" in plans[1]


# ---------------------------------------------------------------------------
# restart and partitioned sinks
# ---------------------------------------------------------------------------

def test_flow_survives_restart_without_double_fold(tmp_path):
    rows = _values(300, ("a", "b"), False, 3)
    p = sum(abs(v) for _, _, v in rows)
    sides = [Side(False, tmp_path / "ref"), Side(True, tmp_path / "port")]
    before = []
    try:
        for s in sides:
            s.fe.do_query("CREATE TABLE cpu (host STRING, ts TIMESTAMP "
                          "TIME INDEX, v DOUBLE, PRIMARY KEY(host))")
            s.fe.do_query(_insert_sql(rows))
            s.fe.do_query(FLOW_SQL)
            s.fm.tick()
            assert s.spec().stats["rows_folded"] == 600
            before.append(s.q("SELECT * FROM cpu_1m ORDER BY host, ts"))
    finally:
        for s in sides:
            s.fe.shutdown()
    assert_rows(before[0], before[1], p,
                ["host", "ts", "v_sum", "v_cnt", "v_min", "v_max",
                 "v_first", "v_last", "n"])

    sides = [Side(False, tmp_path / "ref"), Side(True, tmp_path / "port")]
    try:
        for s, was in zip(sides, before):
            # flow + watermark + sink rows recovered
            assert s.q("SHOW FLOWS")[0][0] == "cpu_1m"
            spec = s.spec()
            assert spec.stats["rows_folded"] == 600
            assert spec.watermarks
            # ticking after restart folds NOTHING (watermark held)
            s.fm.tick()
            assert spec.stats["rows_folded"] == 600
            assert s.q("SELECT * FROM cpu_1m ORDER BY host, ts") == was
        # new rows fold exactly once and counts still match raw
        both(sides, "INSERT INTO cpu VALUES ('a', 300000, 1.0), "
                    "('b', 300000, 2.0)")
        for s in sides:
            s.fm.tick()
            assert s.spec().stats["rows_folded"] == 602
        rewrite_diff(sides, "SELECT host, date_bin(INTERVAL '1 minute', "
                            "ts) AS b, count(v) FROM cpu GROUP BY host, b "
                            "ORDER BY host, b", p)
    finally:
        for s in sides:
            s.fe.shutdown()


def test_flow_into_partitioned_sink(sides):
    p = mk_cpu(sides, 300)
    both(sides, "CREATE TABLE agg (host STRING, ts TIMESTAMP TIME INDEX, "
                "v_sum DOUBLE, PRIMARY KEY(host)) PARTITION BY RANGE "
                "COLUMNS (host) (PARTITION p0 VALUES LESS THAN ('b'), "
                "PARTITION p1 VALUES LESS THAN (MAXVALUE))")
    both(sides, "CREATE FLOW f1 SINK TO agg AS SELECT host, "
                "sum(v) AS v_sum FROM cpu "
                "GROUP BY host, date_bin(INTERVAL '1 minute', ts)")
    for s in sides:
        s.fm.tick()
        per_region = [r.snapshot().read_merged().num_rows
                      for r in s.table("agg").regions.values()]
        assert sorted(per_region) == [5, 5]
    assert_sinks_same(sides, "agg", p)


def test_port_flow_manager_folds_on_its_device(tmp_path):
    """The datanode hands its device to the FlowManager, which is "cuda"
    unless the caller asks for the CPU."""
    from greptimedb_tpu_torch.flow import FlowManager
    assert FlowManager(None, None).device == "cuda"
    fe = build_standalone(DatanodeOptions(data_home=str(tmp_path),
                                          device="cpu"))
    try:
        assert fe.datanode.flow_manager.device == "cpu"
        assert fe.query_engine.flow_manager is fe.datanode.flow_manager
        assert fe.catalog.flow_manager is fe.datanode.flow_manager
    finally:
        fe.shutdown()


class _NoRegions:
    """A source that offers only the table protocol (schema, name,
    scan_batches): the shape of a source without local regions, which
    fold_source hands to fold_generic."""

    def __init__(self, table):
        self._t = table
        self.schema = table.schema
        self.name = table.name

    def scan_batches(self, **kw):
        return self._t.scan_batches(**kw)


def test_fold_generic_raw_path(sides):
    """fold_generic's raw path (scan_batches over the refold window and a
    host reduce, ts-watermarked) in both packages: the same sink rows,
    then only the refold window after new rows."""
    from greptimedb_tpu.flow import lowering as ref_lowering
    from greptimedb_tpu_torch.flow import lowering
    p = mk_cpu(sides, 180, with_nulls=True)
    both(sides, FLOW_SQL)
    counts = []
    for step in (0, 1):
        if step:
            both(sides, "INSERT INTO cpu VALUES ('a', 180000, 5.0), "
                        "('b', 61000, 7.0)")
        got = []
        for s in sides:
            src = _NoRegions(s.table("cpu"))
            dst = s.table("cpu_1m")
            if s.port:
                got.append(lowering.fold_source(s.spec(), src, dst, "cpu"))
            else:
                got.append(ref_lowering.fold_source(s.spec(), src, dst))
        assert got[1] == got[0]
        counts.append(got[1])
        assert [s.spec().watermarks for s in sides][1] == \
            sides[0].spec().watermarks
        assert_sinks_same(sides, "cpu_1m", p + 12.0)
    # the refold starts at the watermark's bucket: one bucket per host
    # plus the new one
    assert counts[0] == (2 * 3, 360) and counts[1][0] == 3
