"""The self-monitor: the port's `monitor/` (SelfMonitor: the registry
snapshot and per-region heat written into greptime_private.node_metrics
and greptime_private.region_heat, the retention sweeps, the trace and
profile flushes it drives) against the JAX package's, on the CPU.

Both packages' standalone frontends get the same table `cpu` and the
same statements, and each test ticks both monitors cooperatively
(`tick()`: under pytest no background scrape runs). The two registries
are process-wide and hold different families (the reference's default
prometheus_client REGISTRY holds every reference metric of the process,
the port's own registry only the port's), so node_metrics is compared on
the families the statements touched, as deltas between two ticks.
Compared exactly: the columns, types and semantic types of both system
tables; the region_heat rows and the ingest rate's sign; the counter
deltas (statements by kind, written rows, the `tpu_execute` timer of one
device-path GROUP BY); idle ticks converging; what the retention sweeps
leave; `information_schema.self_monitor`; the knob's validation. A SQL
aggregate over greptime_private.trace_spans on the port's device path
(`SET tpu_dispatch_min_rows = 0`) is held to the same statement on the
pandas path.
"""

import time

import numpy as np
import pytest

from greptimedb_tpu.common import profiler as ref_profiler
from greptimedb_tpu.common import trace_store as ref_trace
from greptimedb_tpu.datanode import DatanodeInstance as RefDatanode
from greptimedb_tpu.datanode import DatanodeOptions as RefOptions
from greptimedb_tpu.frontend import FrontendInstance as RefFrontend
from greptimedb_tpu.monitor import scraper as ref_scraper
from greptimedb_tpu.query import tpu_exec as ref_exec
from greptimedb_tpu_torch.common import profiler, trace_store
from greptimedb_tpu_torch.datanode import DatanodeOptions
from greptimedb_tpu_torch.frontend import build_standalone
from greptimedb_tpu_torch.monitor import scraper
from greptimedb_tpu_torch.query import tpu_exec

T0 = 1_700_000_000_000
PRIVATE = "greptime_private"


def _rows(seed, hosts=30, samples=20, t0=T0):
    rng = np.random.default_rng(seed)
    return ", ".join(
        f"('h{h:02d}', {t0 + k * 1000}, "
        f"{float(np.round(rng.random() * 100, 3))})"
        for k in range(samples) for h in range(hosts))


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
        self.trace = trace_store if port else ref_trace
        self.prof = profiler if port else ref_profiler
        self.scraper = scraper if port else ref_scraper
        self.exec = tpu_exec if port else ref_exec
        self.fe.do_query("CREATE TABLE cpu (host STRING, ts TIMESTAMP TIME "
                         "INDEX, v DOUBLE, PRIMARY KEY(host))")
        self.fe.do_query("INSERT INTO cpu VALUES " + _rows(5))

    def do(self, sql):
        return self.fe.do_query(sql)[-1]

    def answer(self, sql):
        try:
            out = self.do(sql)
        except Exception as e:  # noqa: BLE001 — each package's own class
            return f"{type(e).__name__}: {e}"
        if not out.is_batches:
            return out.affected_rows
        return [tuple(r) for b in out.batches for r in b.rows()]

    def tick(self):
        """One scrape; the ticks of a test get distinct timestamps."""
        time.sleep(0.003)
        return self.fe.self_monitor.tick()

    def frame(self, sql):
        out = self.do(sql)
        d = {}
        for b in out.batches:
            for k, v in b.to_pydict().items():
                d.setdefault(k, []).extend(v)
        return d

    def series(self, names, by_ts=False):
        """metric (name, labels) -> values by tick, for `names`; with
        `by_ts`, only the series the last tick wrote, each value at a
        tick before it kept."""
        inl = ", ".join(f"'{n}'" for n in names)
        d = self.frame(f"SELECT metric_name, labels, ts, value FROM "
                       f"{PRIVATE}.node_metrics WHERE metric_name IN ({inl}) "
                       f"ORDER BY metric_name, labels, ts")
        last = max(d["ts"]) if d["ts"] else None
        out, seen_last = {}, set()
        for n, lab, ts, v in zip(d["metric_name"], d["labels"], d["ts"],
                                 d["value"]):
            out.setdefault((n, lab), []).append(v)
            if ts == last:
                seen_last.add((n, lab))
        if by_ts:
            out = {k: v for k, v in out.items() if k in seen_last}
        return out

    def schema(self, table):
        t = self.fe.catalog.table("greptime", PRIVATE, table)
        return [(c.name, c.dtype.name, str(c.semantic_type.value))
                for c in t.schema.column_schemas]


@pytest.fixture()
def sides(tmp_path):
    saved = [(m, m.sink()) for m in (trace_store, ref_trace)]
    saved_prof = [(m, m.sampler()) for m in (profiler, ref_profiler)]
    knobs = [(m, m.retention_ms()) for m in (scraper, ref_scraper)]
    traces = [(m, m.sample_ratio(), m.retention_ms())
              for m in (trace_store, ref_trace)]
    profs = [(m, m.retention_ms()) for m in (profiler, ref_profiler)]
    floors = [(m, m.TPU_DISPATCH_MIN_ROWS, m._observed_min_dt[0])
              for m in (tpu_exec, ref_exec)]
    both = {"port": Side(True, tmp_path / "port"),
            "ref": Side(False, tmp_path / "ref")}
    yield both
    for s in both.values():
        s.fe.shutdown()
    for m, sink in saved:
        m.install(sink)
    for m, sampler in saved_prof:
        m.install(sampler)
    for m, keep in knobs:
        m.configure_retention(keep)
    for m, ratio, keep in traces:
        m.configure(sample_ratio=ratio, retention_ms=keep)
    for m, keep in profs:
        m.configure(retention_ms=keep)
    for m, floor, dt in floors:
        m.TPU_DISPATCH_MIN_ROWS, m._observed_min_dt[0] = floor, dt


def test_tick_writes_the_references_tables(sides):
    """One tick: both system tables with the reference's columns, types
    and semantic types; the same region_heat rows; the same
    information_schema.self_monitor columns and counts."""
    got = {}
    for key, s in sides.items():
        assert s.tick() > 0
        heat = s.frame(f"SELECT node, region, rows, size_bytes, "
                       f"ingest_rate_rps FROM {PRIVATE}.region_heat")
        view = s.do("SELECT * FROM information_schema.self_monitor")
        row = dict(zip(view.batches[0].schema.names(),
                       next(iter(view.batches[0].rows()))))
        got[key] = (s.schema("node_metrics"), s.schema("region_heat"),
                    heat, [(c.name, c.dtype.name) for c in
                           view.batches[0].schema.column_schemas],
                    {k: row[k] for k in ("node", "ticks", "heat_rows",
                                         "retention_ms", "last_error")})
        assert row["metric_rows"] > 10 and row["rows_written"] > 10
    assert got["port"] == got["ref"]
    assert got["port"][2]["rows"] == [600]


#: the counters every statement below moves, in both registries
FAMILIES = ("greptime_stmt_insert_total", "greptime_stmt_query_total",
            "greptime_stmt_setvariable_total",
            "greptime_stmt_execute_seconds_count",
            "greptime_region_write_rows_total",
            "greptime_tpu_execute_seconds_count")


def test_counter_deltas_match_reference(sides):
    """Between two ticks, the same statements (three INSERTs, four
    SELECTs, one failing, a device-path GROUP BY) move the same
    counters by the same amounts."""
    got = {}
    for key, s in sides.items():
        s.tick()
        for i in range(3):
            s.do("INSERT INTO cpu VALUES " + _rows(10 + i, hosts=4,
                                                  samples=5,
                                                  t0=T0 + 10**6 * (i + 1)))
        for sql in ("SELECT count(*) FROM cpu", "SELECT host FROM cpu "
                    "WHERE v > 99", "SELECT max(v) FROM cpu",
                    "SELECT host, v FROM cpu ORDER BY ts LIMIT 3"):
            s.do(sql)
        assert isinstance(s.answer("SELECT x FROM nowhere"), str)
        s.do("SET tpu_dispatch_min_rows = 0")
        s.do("SELECT host, avg(v) FROM cpu GROUP BY host")
        s.tick()
        # a family first registered between the ticks counts from 0
        got[key] = {k: v[-1] - (v[-2] if len(v) >= 2 else 0)
                    for k, v in s.series(FAMILIES, by_ts=True).items()}
    assert got["port"] == got["ref"]
    assert got["port"][("greptime_region_write_rows_total", "")] == 60
    assert got["port"][("greptime_tpu_execute_seconds_count", "")] == 1


def test_idle_ticks_converge_as_in_reference(sides):
    """Ticks with no statement between them persist the same values: the
    monitor's own writes are not counted (suppress_metrics)."""
    got = {}
    for key, s in sides.items():
        for _ in range(3):
            s.tick()
        series = s.series(("greptime_region_write_rows_total",
                           "greptime_region_write_seconds_count"))
        got[key] = {k: (len(v), len(set(v))) for k, v in series.items()}
    assert got["port"] == got["ref"]
    assert set(got["port"].values()) == {(3, 1)}


def test_region_heat_rate_matches_reference(sides):
    got = {}
    for key, s in sides.items():
        s.tick()
        time.sleep(0.05)
        s.do("INSERT INTO cpu VALUES " + _rows(9, hosts=25, samples=20,
                                              t0=T0 + 10**7))
        s.tick()
        d = s.frame(f"SELECT ts, rows, ingest_rate_rps FROM "
                    f"{PRIVATE}.region_heat ORDER BY ts")
        got[key] = (d["rows"], [r > 0 for r in d["ingest_rate_rps"]])
    assert got["port"] == got["ref"] == ([600, 1100], [False, True])


def test_retention_sweeps_match_reference(sides):
    """A tightened retention deletes the older ticks' rows of node_metrics
    and region_heat, and every stored span and profile sample older than
    the trace and profile windows, through the DELETE path."""
    got = {}
    for key, s in sides.items():
        s.trace.configure(sample_ratio=1.0)
        s.do("SELECT count(*) FROM cpu")
        s.prof.sampler().sample_once()
        s.tick()
        s.tick()
        t2 = max(s.frame(f"SELECT ts FROM {PRIVATE}.node_metrics")["ts"])
        time.sleep(0.02)
        for sql in ("SET self_monitor_retention_ms = 10",
                    "SET trace_retention_ms = 10",
                    "SET profile_retention_ms = 10"):
            s.do(sql)
        s.trace.configure(sample_ratio=0.0)
        time.sleep(0.02)
        s.tick()
        view = s.do("SELECT retention_deleted FROM "
                    "information_schema.self_monitor")
        old = {t: s.frame(f"SELECT count(*) FROM {PRIVATE}.{t} WHERE ts "
                          f"<= {t2}")["count(*)"][0]
               for t in ("node_metrics", "region_heat", "trace_spans",
                         "profile_samples")}
        got[key] = (old, next(iter(view.batches[0].rows()))[0] > 0)
    assert got["port"] == got["ref"]
    assert got["port"] == ({"node_metrics": 0, "region_heat": 0,
                            "trace_spans": 0, "profile_samples": 0}, True)


@pytest.mark.parametrize("sql", [
    "SET self_monitor_retention_ms = 'week'",
    "SET self_monitor_retention_ms = -3",
    "SET self_monitor_retention_ms = 0",
    "SET self_monitor_retention_ms = 604800000",
])
def test_self_monitor_knob_matches_reference(sides, sql):
    assert sides["port"].answer(sql) == sides["ref"].answer(sql)
    assert scraper.retention_ms() == ref_scraper.retention_ms()


def test_trace_spans_aggregate_on_the_device_path_matches_pandas(sides):
    """An aggregate over greptime_private.trace_spans on the port's
    device path (the floor at 0: segment_moments' plain version on the
    CPU) equals the same statement on the pandas path (the floor above
    the table's rows): counts exact, max within float32."""
    s = sides["port"]
    trace_store.configure(sample_ratio=1.0)
    for i in range(12):
        s.do(f"SELECT host FROM cpu WHERE v > {i * 8}")
    trace_store.configure(sample_ratio=0.0)
    assert trace_store.sink().flush() > 0
    sql = (f"SELECT span_name, count(*) AS n, max(duration_ms) AS m, "
           f"sum(duration_ms) AS t FROM {PRIVATE}.trace_spans GROUP BY "
           f"span_name ORDER BY span_name")
    (region,) = s.fe.catalog.table("greptime", PRIVATE,
                                   "trace_spans").regions.values()
    s.do("SET tpu_dispatch_min_rows = 0")
    device = s.frame(sql)
    assert region.last_scan_profile.path == "resident"
    s.do("SET tpu_dispatch_min_rows = 100000000")
    region.last_scan_profile = None
    host = s.frame(sql)
    assert region.last_scan_profile is None
    assert device["span_name"] == host["span_name"]
    assert device["n"] == host["n"] and sum(host["n"]) >= 12
    eps = float(np.finfo(np.float32).eps)
    for m_dev, m_host, t_dev, t_host in zip(device["m"], host["m"],
                                            device["t"], host["t"]):
        assert abs(m_dev - m_host) <= eps * abs(m_host)
        assert abs(t_dev - t_host) <= 8 * eps * abs(t_host)
