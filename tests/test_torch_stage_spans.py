"""The port's stage spans, on the CPU: the resident region reduce's
stages (`ScanProfile.stage`: scan_cache with scan_read and scan_merge
under it, scan_runs, scan_masks, scan_h2d, scan_launch, scan_fetch,
scan_collect) as children of `region_scan`, a fused follower's
`scan_fusion_wait`, the query engine's `plan`, `finalize` and `project`,
and the Flight front door's `flight_do_get`, `parse_sql` and
`flight_encode`, each with its parent, its attributes and the profile's
own seconds. No span observes a histogram (`greptime_span_*`), and
`child_span` opens a span only inside a local span's trace.

A standalone frontend on the CPU holds the table `cpu` (HOSTS hosts x
SAMPLES samples) and the table `minutes` (MINUTE_HOSTS hosts, a sample
every 10 s for MINUTES minutes); a dispatch floor of 0 rows sends their
GROUP BYs down the device path. The reference's standalone frontend
holds `minutes` too, for the answers it is held to. A capturing span
sink stands in front of the frontend's trace sink while a test runs.
"""

import itertools
import threading

import numpy as np
import pytest

from greptimedb_tpu.datanode import DatanodeInstance as RefDatanode
from greptimedb_tpu.datanode import DatanodeOptions as RefOptions
from greptimedb_tpu.frontend import FrontendInstance as RefFrontend
from greptimedb_tpu.query import tpu_exec as ref_exec
from greptimedb_tpu_torch.client.flight import Database
from greptimedb_tpu_torch.common import telemetry
from greptimedb_tpu_torch.datanode import DatanodeOptions
from greptimedb_tpu_torch.frontend import build_standalone
from greptimedb_tpu_torch.query import tpu_exec
from greptimedb_tpu_torch.servers.flight import FlightFrontendServer
from greptimedb_tpu_torch.storage.series import SeriesDict

T0 = 1_700_000_000_000
HOSTS, SAMPLES = 12, 30
TIMEOUT_S = 60
GROUP_BY = "SELECT host, avg(v), max(v) FROM cpu GROUP BY host ORDER BY host"
#: the resident path's stages under region_scan, in order
STAGES = ["scan_cache", "scan_runs", "scan_masks", "scan_h2d",
          "scan_launch", "scan_fetch", "scan_collect"]
#: ScanProfile stage -> the span that times it
PROFILE_SPANS = {"scan_prep": "scan_cache", "region_scan": "scan_read",
                 "merge": "scan_merge", "runs": "scan_runs",
                 "masks": "scan_masks", "h2d": "scan_h2d",
                 "launch": "scan_launch", "fetch": "scan_fetch",
                 "collect": "scan_collect"}


#: `minutes`: a minute boundary, hosts m00.., a sample every 10 s; its
#: values are eighths, exact in float32
T0M = 1_699_999_980_000
MINUTE_HOSTS, MINUTES = 40, 10
CREATE_MINUTES = ("CREATE TABLE minutes (host STRING, ts TIMESTAMP TIME "
                  "INDEX, v DOUBLE, PRIMARY KEY(host))")
#: two hosts over three minutes: 6 of the 400 (host, minute) runs live
MINUTE_SQL = (
    "SELECT host, date_bin(INTERVAL '1 minute', ts) AS b, max(v), min(v), "
    "count(v) FROM minutes WHERE host IN ('m03', 'm31') AND "
    f"ts >= {T0M + 120_000} AND ts < {T0M + 300_000} "
    "GROUP BY host, b ORDER BY host, b")

#: rows written after the table's, one a second past them
_LATE = itertools.count()


def _rows(seed):
    rng = np.random.default_rng(seed)
    return ", ".join(
        f"('h{h:02d}', {T0 + k * 1000}, "
        f"{float(np.round(rng.random() * 100, 3))})"
        for k in range(SAMPLES) for h in range(HOSTS))


def _minute_rows():
    rng = np.random.default_rng(5)
    return ", ".join(
        f"('m{h:02d}', {T0M + k * 10_000}, {int(rng.integers(0, 800)) / 8})"
        for k in range(MINUTES * 6) for h in range(MINUTE_HOSTS))


class Capture:
    """A span sink that keeps every closed span (name, ids, attributes,
    its elapsed ms and status), then hands it on."""

    def __init__(self, inner):
        self.inner = inner
        self.spans = []
        self._lock = threading.Lock()

    def on_span_end(self, s, elapsed_ms, status):
        with self._lock:
            self.spans.append(dict(s, elapsed_ms=elapsed_ms,
                                   attrs=dict(s["attrs"]), status=status))
        if self.inner is not None:
            self.inner.on_span_end(s, elapsed_ms, status)

    def named(self, name):
        return [s for s in self.spans if s["name"] == name]

    def children(self, parent):
        kids = [s for s in self.spans if s["parent_id"] == parent["span_id"]]
        return sorted(kids, key=lambda s: s["start"])


@pytest.fixture(scope="module")
def fe(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(tpu_exec, "_dispatch_min_rows", lambda: 0)
    fusion = tpu_exec._FUSION_ENABLED[0]
    tpu_exec.configure_scan_fusion(enabled=True)
    f = build_standalone(DatanodeOptions(
        data_home=str(tmp_path_factory.mktemp("stage_spans")), device="cpu"))
    try:
        f.do_query("CREATE TABLE cpu (host STRING, ts TIMESTAMP TIME INDEX, "
                   "v DOUBLE, PRIMARY KEY(host))")
        f.do_query("INSERT INTO cpu VALUES " + _rows(3))
        f.do_query(CREATE_MINUTES)
        f.do_query("INSERT INTO minutes VALUES " + _minute_rows())
        yield f
    finally:
        f.shutdown()
        tpu_exec.configure_scan_fusion(enabled=fusion)
        mp.undo()


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's standalone frontend holding `minutes`, its
    dispatch floor at 0 rows as the port's."""
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_exec, "TPU_DISPATCH_MIN_ROWS", 0)
    mp.setattr(ref_exec, "_dispatch_min_rows", lambda: 0)
    f = RefFrontend(RefDatanode(RefOptions(
        data_home=str(tmp_path_factory.mktemp("stage_spans_ref")))))
    f.start()
    try:
        f.do_query(CREATE_MINUTES)
        f.do_query("INSERT INTO minutes VALUES " + _minute_rows())
        yield f
    finally:
        f.shutdown()
        mp.undo()


@pytest.fixture
def cap(fe):
    saved = telemetry._SPAN_SINK[0]
    c = Capture(saved)
    telemetry.set_span_sink(c)
    yield c
    telemetry.set_span_sink(saved)


def _region(fe):
    (region,) = fe.catalog.table("greptime", "public",
                                 "cpu").regions.values()
    return region


def _prepare(fe, outcome):
    """Leave the scan cache so that the next scan is a `full` build, an
    `incremental` merge or a `hit`."""
    tpu_exec.SCAN_CACHE.clear()
    if outcome == "full":
        return
    fe.do_query(GROUP_BY)
    if outcome == "incremental":
        fe.do_query(f"INSERT INTO cpu VALUES ('h00', "
                    f"{T0 + 10**6 + next(_LATE) * 1000}, 1.0)")


@pytest.mark.parametrize("outcome", ["full", "incremental", "hit"])
def test_region_scan_children_are_the_stage_spans(fe, cap, outcome):
    """Under region_scan, in order: the cache lookup (its outcome as an
    attribute; the reads and the merge under it where it built or
    merged), the runs, the masks, h2d, the launch, the fetch and the
    collect; every one in the statement's trace."""
    _prepare(fe, outcome)
    cap.spans.clear()
    fe.do_query(GROUP_BY)
    (scan,) = cap.named("region_scan")
    (tpu,) = cap.named("tpu_execute")
    assert scan["parent_id"] == tpu["span_id"]
    kids = cap.children(scan)
    assert [s["name"] for s in kids] == STAGES
    assert {s["trace_id"] for s in kids} == {scan["trace_id"]}
    cache = kids[0]
    assert cache["attrs"]["outcome"] == outcome
    under = [s["name"] for s in cap.children(cache)]
    assert under == ([] if outcome == "hit" else ["scan_read", "scan_merge"])
    assert _region(fe).last_scan_profile.counters == {f"cache_{outcome}": 1}


def test_host_moments_reduce_under_scan_host_reduce(fe, cap):
    """A sketch aggregate reduces the cached scan on the host: the cache
    lookup and scan_host_reduce under region_scan, marked as host_reduce
    on the profile."""
    _prepare(fe, "hit")
    cap.spans.clear()
    out = fe.do_query("SELECT host, approx_distinct(v) FROM cpu "
                      "GROUP BY host")
    assert out[-1].num_rows == HOSTS
    (scan,) = cap.named("region_scan")
    kids = cap.children(scan)
    assert [s["name"] for s in kids] == ["scan_cache", "scan_host_reduce"]
    prof = _region(fe).last_scan_profile
    assert prof.stages["host_reduce"] == kids[1]["elapsed_ms"] / 1e3


def test_profile_stages_are_the_span_seconds(fe, cap):
    """Each ScanProfile stage is its span's own measurement."""
    _prepare(fe, "full")
    cap.spans.clear()
    fe.do_query(GROUP_BY)
    prof = _region(fe).last_scan_profile
    assert set(prof.stages) == set(PROFILE_SPANS)
    for stage, name in PROFILE_SPANS.items():
        (s,) = cap.named(name)
        assert prof.stages[stage] == s["elapsed_ms"] / 1e3, stage


def _avg_case(where, live):
    """An avg by host over `cpu` (its id: the WHERE clause and the live
    runs)."""
    return pytest.param(f"SELECT host, avg(v) FROM cpu {where} GROUP BY host",
                        HOSTS, live, False, id=f"{where}-{live}")


def _rows_of(out):
    """A statement's answer as a list of row tuples."""
    return [row for b in out[-1].batches for row in b.rows()]


@pytest.mark.parametrize("sql, runs, live, against_ref", [
    _avg_case("", HOSTS), _avg_case("WHERE host IN ('h01', 'h07')", 2),
    _avg_case(f"WHERE ts >= {T0 + 5000} AND host = 'h03'", 1),
    pytest.param(MINUTE_SQL, MINUTE_HOSTS * MINUTES, 6, True,
                 id="per-minute-2-hosts-3-minutes")])
def test_collect_counts_launched_and_live_runs(fe, ref, cap, monkeypatch,
                                               sql, runs, live,
                                               against_ref):
    """scan_collect carries the runs launched and those that kept a row;
    scan_fetch the live runs and the bytes of the one copy, compacted to
    the live runs on the device (a 4-byte word per moment, count and run
    index of each). The collect decodes the tags of the live runs alone;
    the per-minute case answers as the reference does."""
    decoded, collecting = [], [False]
    decode, collect = SeriesDict.decode_tag_column, \
        tpu_exec._collect_moment_frame

    def spy_decode(sd, series_ids, tag_index):
        if collecting[0]:
            decoded.append(np.asarray(series_ids))
        return decode(sd, series_ids, tag_index)

    def spy_collect(*args):
        collecting[0] = True
        try:
            return collect(*args)
        finally:
            collecting[0] = False

    # a whole-table statement first: the cached region takes the
    # resident path (an uncached one answers a host IN list from the index)
    table = "minutes" if "FROM minutes" in sql else "cpu"
    fe.do_query(f"SELECT host, count(v) FROM {table} GROUP BY host")
    monkeypatch.setattr(SeriesDict, "decode_tag_column", spy_decode)
    monkeypatch.setattr(tpu_exec, "_collect_moment_frame", spy_collect)
    cap.spans.clear()
    out = fe.do_query(sql)
    monkeypatch.undo()
    got = _rows_of(out)
    assert len(got) == live
    if against_ref:
        assert got == _rows_of(ref.do_query(sql))
    (collect_span,) = cap.named("scan_collect")
    assert collect_span["attrs"] == {"runs": runs, "live_runs": live}
    (fetch,) = cap.named("scan_fetch")
    assert fetch["attrs"]["live_runs"] == live
    # avg reads two moments (count, sum), the per-minute case three (max,
    # min, count); then each live run's count and its index
    words = 4 if "avg(v)" in sql else 5
    assert fetch["attrs"]["bytes"] == 4 * words * live
    # one decode of the host tag, over the live runs' series alone
    (ids,) = decoded
    (region,) = fe.catalog.table("greptime", "public",
                                 table).regions.values()
    assert sorted(region.series_dict.decode_tag_column(ids, 0)) == \
        sorted(row[0] for row in got)


def test_forced_fusion_yields_one_wait(fe, cap, monkeypatch):
    """Two statements of one plan at once: the leader is held until the
    follower parks, so the follower adopts the leader's frame and one
    scan_fusion_wait, in the follower's trace, under its tpu_execute."""
    entered, parked = threading.Event(), threading.Event()
    orig = tpu_exec._execute_region

    class Watched(threading.Event):
        def wait(self, timeout=None):
            parked.set()
            return super().wait(timeout)

    class Entry(tpu_exec._FlightEntry):
        def __init__(self):
            super().__init__()
            self.done = Watched()

    def held(*args, **kwargs):
        entered.set()
        assert parked.wait(TIMEOUT_S)
        return orig(*args, **kwargs)

    monkeypatch.setattr(tpu_exec, "_FlightEntry", Entry)
    monkeypatch.setattr(tpu_exec, "_execute_region", held)
    cap.spans.clear()
    answers, errors = [None, None], []

    def run(i):
        try:
            answers[i] = list(fe.do_query(GROUP_BY)[-1].batches[0].rows())
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    a = threading.Thread(target=run, args=(0,))
    a.start()
    assert entered.wait(TIMEOUT_S)
    b = threading.Thread(target=run, args=(1,))
    b.start()
    for t in (a, b):
        t.join(TIMEOUT_S)
    assert not errors and answers[0] == answers[1]
    (wait,) = cap.named("scan_fusion_wait")
    (scan,) = cap.named("region_scan")
    parent = next(s for s in cap.named("tpu_execute")
                  if s["span_id"] == wait["parent_id"])
    assert parent["trace_id"] == wait["trace_id"] != scan["trace_id"]


def test_engine_spans_sit_under_the_statement(fe, cap):
    """plan, tpu_execute, finalize and project under execute_stmt, in
    that order; a bare do_query has no caller's span for parse_sql."""
    cap.spans.clear()
    fe.do_query(GROUP_BY)
    (stmt,) = cap.named("execute_stmt")
    names = [s["name"] for s in cap.children(stmt)]
    assert names == ["plan", "tpu_execute", "finalize", "project"]
    assert not cap.named("parse_sql")


def test_sql_over_flight_joins_the_clients_trace(fe, cap):
    """A statement over Flight: flight_do_get in the client's trace,
    holding the parse, the statement and the answer's encode."""
    srv = FlightFrontendServer(fe)
    srv.serve_in_background()
    db = Database(srv.address)
    try:
        cap.spans.clear()
        with telemetry.span("client") as client:
            got = db.sql(GROUP_BY)
        assert sum(b.num_rows for b in got) == HOSTS
    finally:
        db.close()
        srv.shutdown()
    (get,) = cap.named("flight_do_get")
    assert get["trace_id"] == client["trace_id"]
    assert get["parent_id"] == client["span_id"]
    under = {s["name"] for s in cap.children(get)}
    assert under == {"parse_sql", "execute_stmt", "flight_encode"}
    enc = cap.named("flight_encode")
    assert enc and {s["parent_id"] for s in enc} == {get["span_id"]}
    assert sum(s["attrs"]["rows"] for s in enc) == HOSTS


def test_no_span_histograms(fe):
    """Spans observe nothing in the registry; the timers stay."""
    fe.do_query(GROUP_BY)
    names = {f.name for f in telemetry.collect_families()}
    assert not [n for n in names if n.startswith("greptime_span_")]
    assert "greptime_tpu_execute_seconds" in names
    assert "greptime_stmt_execute_seconds" in names


@pytest.mark.parametrize("where", ["bare", "remote", "local"])
def test_child_span_joins_only_a_local_trace(cap, where):
    """child_span records nothing outside a trace, nothing under a
    remote caller's context alone, and a child inside a local span."""
    tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    cap.spans.clear()
    if where == "bare":
        with telemetry.child_span("c") as s:
            assert s is None
    elif where == "remote":
        with telemetry.remote_context(tp), telemetry.child_span("c") as s:
            assert s is None
    else:
        with telemetry.span("p") as p, telemetry.child_span("c") as s:
            assert s["parent_id"] == p["span_id"]
    assert [s["name"] for s in cap.spans] == \
        ([] if where != "local" else ["c", "p"])
