"""The durable trace store: the port's `common/trace_store.py` and its
wiring (the `tpu_execute` span, ADMIN SHOW TRACE, the SET knobs,
`information_schema.trace_spans`, `/v1/trace`, the slow-query WARN)
against the JAX package's, on the CPU.

Both packages' standalone frontends (the reference's
`FrontendInstance(DatanodeInstance(...))`, the port's
`build_standalone(DatanodeOptions(device="cpu"))`) get the same table
`cpu` (30 hosts x 20 samples, values from a seed) and the same
statements. Compared exactly: the span names, depths, parents, nodes,
statuses and attributes of a traced statement's waterfall (timings are
wall clock and left out); the head-sample verdicts of a fixed list of
trace ids at several ratios; the tail verdicts of fast, slow, failed and
head-sampled statements; `waterfall_rows` on the same stored rows; the
sink's buffer-role bookkeeping (verdict ring, export, TTL eviction) on
the same span sequence; the columns and types of
`greptime_private.trace_spans` and of the view; the knob validation
messages; the `/v1/trace` answers. Each package's trace store, sample
ratio, retention, slow-query threshold and dispatch floor are process
state: every test restores them.

The first test pins the port's `tpu_execute` span and timer around a
local device-path aggregate (`query/ir.py:execute_agg_plan`), which the
reference opens and the port once dropped: the waterfall of a GROUP BY
with `SET tpu_dispatch_min_rows = 0` must be the reference's
(`execute_stmt` → `tpu_execute` → `region_scan`), and the port's registry
must count `greptime_tpu_execute` observations. It is the one statement
here the reference compiles (one avg signature).
"""

import json
import logging
import re
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from greptimedb_tpu.common import telemetry as ref_telemetry
from greptimedb_tpu.common import trace_store as ref_trace
from greptimedb_tpu.datanode import DatanodeInstance as RefDatanode
from greptimedb_tpu.datanode import DatanodeOptions as RefOptions
from greptimedb_tpu.frontend import FrontendInstance as RefFrontend
from greptimedb_tpu.query import tpu_exec as ref_exec
from greptimedb_tpu.servers.http import HttpServer as RefHttpServer
from greptimedb_tpu_torch.common import telemetry, trace_store
from greptimedb_tpu_torch.datanode import DatanodeOptions
from greptimedb_tpu_torch.frontend import build_standalone
from greptimedb_tpu_torch.query import tpu_exec
from greptimedb_tpu_torch.servers.http import HttpServer

T0 = 1_700_000_000_000
HOSTS, SAMPLES = 30, 20
TIMEOUT_S = 60


def _rows():
    rng = np.random.default_rng(41)
    return ", ".join(
        f"('h{h:02d}', {T0 + k * 1000}, "
        f"{float(np.round(rng.random() * 100, 3))})"
        for k in range(SAMPLES) for h in range(HOSTS))


class Side:
    """One package's frontend, its trace store and telemetry modules."""

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
        self.telemetry = telemetry if port else ref_telemetry
        self.exec = tpu_exec if port else ref_exec
        self.fe.do_query("CREATE TABLE cpu (host STRING, ts TIMESTAMP TIME "
                         "INDEX, v DOUBLE, PRIMARY KEY(host))")
        self.fe.do_query("INSERT INTO cpu VALUES " + _rows())

    def do(self, sql):
        return self.fe.do_query(sql)[-1]

    def answer(self, sql):
        """The statement's affected rows or rendered rows, or its error's
        class name and message."""
        try:
            out = self.do(sql)
        except Exception as e:  # noqa: BLE001 — each package's own class
            return f"{type(e).__name__}: {e}"
        if not out.is_batches:
            return out.affected_rows
        return [tuple(r) for b in out.batches for r in b.rows()]

    def structure(self, trace_id):
        """(name, depth, parent's name, node, status, attrs) of every stored
        span of one trace, depth-first as the waterfall renders them."""
        rows = self.trace.fetch_trace(self.fe.catalog, trace_id)
        by_id = {r["span_id"]: r for r in rows}
        out = []
        for r in rows:
            depth, p = 0, r["parent_span_id"]
            while p in by_id:
                depth, p = depth + 1, by_id[p]["parent_span_id"]
            parent = by_id.get(r["parent_span_id"])
            out.append((r["span_name"], depth,
                        parent["span_name"] if parent else None, r["node"],
                        r["status"], r["attrs"]))
        return sorted(out)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    saved = [(m, m.sink()) for m in (trace_store, ref_trace)]
    both = {"port": Side(True, tmp_path_factory.mktemp("port")),
            "ref": Side(False, tmp_path_factory.mktemp("ref"))}
    yield both
    for s in both.values():
        s.fe.shutdown()
    for m, sink in saved:
        m.install(sink)


@pytest.fixture(autouse=True)
def _knobs():
    """Both packages' process-wide knobs that the tests SET, restored."""
    saved = [(m, m.sample_ratio(), m.retention_ms())
             for m in (trace_store, ref_trace)]
    floors = [(m, m.TPU_DISPATCH_MIN_ROWS, m._observed_min_dt[0])
              for m in (tpu_exec, ref_exec)]
    yield
    for m, ratio, keep in saved:
        m.configure(sample_ratio=ratio, retention_ms=keep, buffer_ttl_s=300)
    for m, floor, dt in floors:
        m.TPU_DISPATCH_MIN_ROWS, m._observed_min_dt[0] = floor, dt
    for t in (telemetry, ref_telemetry):
        t.set_slow_query_threshold_ms(None)


def _counter_total(name):
    total = 0.0
    for family in telemetry.collect_families():
        for s in family.samples:
            if s.name == name:
                total += s.value
    return total


def test_tpu_execute_span_and_timer_match_reference(sides):
    """A device-path GROUP BY through both frontends at ratio 1: ADMIN
    SHOW TRACE 'last' renders the same tree (execute_stmt → tpu_execute →
    region_scan, same nodes, statuses and attributes), and the port's
    registry counts one more tpu_execute observation."""
    before = _counter_total("greptime_tpu_execute_seconds_count")
    shown, stored = {}, {}
    for key, s in sides.items():
        s.do("SET trace_sample_ratio = 1")
        s.do("SET tpu_dispatch_min_rows = 0")
        s.do("SELECT host, avg(v) FROM cpu GROUP BY host ORDER BY host")
        (region,) = s.fe.catalog.table("greptime", "public",
                                       "cpu").regions.values()
        assert region.last_scan_profile.path == "resident"
        tid = s.trace.sink().last_retained
        out = s.do("ADMIN SHOW TRACE 'last'")
        d = out.batches[0].to_pydict()
        shown[key] = [(d["span"][i], d["node"][i], d["status"][i],
                       d["detail"][i]) for i in range(out.num_rows)]
        stored[key] = s.structure(tid)
    assert shown["port"] == shown["ref"]
    assert [r[0] for r in shown["port"]] == [
        "execute_stmt", "  └─ tpu_execute", "    └─ region_scan"]
    assert stored["port"] == stored["ref"]
    assert {(n, depth, parent) for n, depth, parent, *_ in stored["port"]} \
        == {("execute_stmt", 0, None), ("tpu_execute", 1, "execute_stmt"),
            ("region_scan", 2, "tpu_execute")}
    assert _counter_total("greptime_tpu_execute_seconds_count") == before + 1


TRACE_IDS = [f"{x:032x}" for x in
             np.random.default_rng(7).integers(0, 2**62, 256, dtype=np.int64)
             * 7919]


@pytest.mark.parametrize("ratio", [0.0, 0.01, 0.1, 0.5, 0.9, 1.0])
def test_head_sample_verdicts_match_reference(ratio):
    trace_store.configure(sample_ratio=ratio)
    ref_trace.configure(sample_ratio=ratio)
    got = [trace_store.head_sampled(t) for t in TRACE_IDS]
    assert got == [ref_trace.head_sampled(t) for t in TRACE_IDS]
    if 0.0 < ratio < 1.0:
        assert 0 < sum(got) < len(got)


#: name -> (sample ratio, slow-query threshold ms, statement)
TAIL_CASES = {
    "fast at ratio 0": (0.0, None, "SELECT host FROM cpu WHERE v > 50"),
    "slow at ratio 0": (0.0, 1, "SELECT host, v FROM cpu ORDER BY host"),
    "error at ratio 0": (0.0, None, "SELECT host FROM no_such_table"),
    "head-sampled at ratio 1": (1.0, None, "SELECT count(*) FROM cpu"),
}


@pytest.mark.parametrize("case", list(TAIL_CASES))
def test_tail_verdict_matches_reference(sides, case):
    """Each statement is retained or sampled out as in the reference, and
    a retained one stores the same spans (names, depths, parents,
    statuses, attributes)."""
    ratio, slow_ms, sql = TAIL_CASES[case]
    seen = {}
    for key, s in sides.items():
        s.trace.configure(sample_ratio=ratio)
        s.telemetry.set_slow_query_threshold_ms(slow_ms)
        sink = s.trace.sink()
        sink.flush()
        before = dict(sink.stats)
        last = sink.last_retained
        answer = s.answer(sql)
        s.telemetry.set_slow_query_threshold_ms(None)
        delta = {k: sink.stats[k] - before[k]
                 for k in ("traces_retained", "traces_sampled_out")}
        retained = sink.last_retained if sink.last_retained != last \
            else None
        written = sink.flush()
        seen[key] = (delta, answer if isinstance(answer, str) else None,
                     written, retained and s.structure(retained))
    assert seen["port"] == seen["ref"]
    delta, _, written, structure = seen["port"]
    kept = case != "fast at ratio 0"
    assert delta == {"traces_retained": int(kept),
                     "traces_sampled_out": int(not kept)}
    assert bool(written) == kept and bool(structure) == kept
    if case == "error at ratio 0":
        assert {r[4] for r in structure} == {"error"}


def _random_spans(seed, n=40):
    rng = np.random.default_rng(seed)
    names = ["execute_stmt", "tpu_execute", "region_scan", "dist_rpc",
             "dn_scan", "stream_scan", "flow_fold"]
    rows = []
    for i in range(n):
        parent = "" if i == 0 or rng.random() < 0.1 else \
            f"s{int(rng.integers(0, i)):03d}"
        if rng.random() < 0.05:
            parent = "missing"             # an orphan renders as a root
        rows.append({
            "span_id": f"s{i:03d}", "parent_span_id": parent,
            "span_name": names[int(rng.integers(0, len(names)))],
            "node": ["standalone", "dn1", 2][int(rng.integers(0, 3))],
            "ts": int(rng.integers(0, 50)),
            "duration_ms": float(np.round(rng.random() * 20, 3)),
            "status": ["ok", "error", "cancelled"][int(rng.integers(0, 3))],
            "attrs": "" if rng.random() < 0.3 else
            json.dumps({"k": int(rng.integers(0, 9))})})
    return rows


WATERFALL_CASES = {
    "dist_rpc network split": [
        {"span_id": "a", "parent_span_id": "", "span_name": "execute_stmt",
         "node": "frontend", "ts": 0, "duration_ms": 10.0, "status": "ok",
         "attrs": ""},
        {"span_id": "b", "parent_span_id": "a", "span_name": "dist_rpc",
         "node": "frontend", "ts": 1, "duration_ms": 8.0, "status": "ok",
         "attrs": '{"node":1}'},
        {"span_id": "c", "parent_span_id": "b", "span_name": "dn_scan",
         "node": "dn1", "ts": 2, "duration_ms": 5.0, "status": "ok",
         "attrs": ""}],
    "empty": [],
    "random tree 1": _random_spans(1),
    "random tree 2": _random_spans(2, 80),
}


@pytest.mark.parametrize("case", list(WATERFALL_CASES))
def test_waterfall_rows_match_reference(case):
    rows = WATERFALL_CASES[case]
    got = trace_store.waterfall_rows([dict(r) for r in rows])
    assert got == ref_trace.waterfall_rows([dict(r) for r in rows])
    assert len(got) == len(rows)


def _span(name, trace_id, span_id, parent=None, remote=False, **attrs):
    return {"name": name, "trace_id": trace_id, "span_id": span_id,
            "parent_id": parent, "remote_parent": remote, "attrs": attrs,
            "start_unix_ns": 1_700_000_000_000_000_000}


def _drive_buffer_sink(mod):
    """A datanode-role sink (writer None) through one sequence: remote
    rooted fragments buffer blind, verdicts release or drop them (a late
    span of a released trace buffers again: piggybacked verdicts do not
    enter the ring), a locally rooted error trace decides here, the
    export drains, the TTL evicts the rest."""
    sink = mod.TraceSink(node_label="dn1", service="datanode",
                         role="buffer", writer=None)
    a, b, c, d = ("a" * 32, "b" * 32, "c" * 32, "d" * 32)
    for tid in (a, b, c):
        sink.on_span_end(_span("dn_scan", tid, tid[:8] + "01", "remote01",
                               remote=True, node=1), 2.0, "ok")
        sink.on_span_end(_span("dn_write_region", tid, tid[:8] + "02",
                               tid[:8] + "01", node=1), 1.0, "ok")
    sink.on_span_end(_span("compaction", d, "d0000001"), 3.0, "error")
    buffered = sink.buffered_trace_count()
    sink.apply_verdicts({a: True, b: False})
    sink.on_span_end(_span("late", a, "a0000009", "remote01", remote=True),
                     1.0, "ok")
    exported = sink.take_export(limit=3)
    rest = sink.take_export()
    evicted = sink.evict_expired(now=10**9)
    stats = dict(sink.stats)
    rows = [{k: v for k, v in r.items() if k != "ts"}
            for r in exported + rest]
    return buffered, rows, evicted, stats, sink.buffered_trace_count()


def test_buffer_role_sink_matches_reference():
    ref_trace.configure(sample_ratio=0.0)
    trace_store.configure(sample_ratio=0.0)
    got = _drive_buffer_sink(trace_store)
    assert got == _drive_buffer_sink(ref_trace)
    buffered, rows, evicted, stats, left = got
    assert buffered == 3 and evicted == 2 and left == 0
    assert [r["span_name"] for r in rows].count("dn_scan") == 1


def _drive_root_sink(mod):
    """A root-role sink: head verdicts at ratio 0.5, the verdict ring's
    piggyback window, push_verdict's refusal to resurrect a sampled-out
    trace, absorbed remote rows and the slow-query log's verdict."""
    mod.configure(sample_ratio=0.5)
    sink = mod.TraceSink(node_label="fe", role="root", writer=None)
    for tid in TRACE_IDS[:40]:
        sink.on_span_end(_span("execute_stmt", tid, tid[:16]), 1.0, "ok")
    out = (sorted(sink.recent_verdicts().items()),
           [sink.stored_verdict(t) for t in TRACE_IDS[:48]],
           [sink.push_verdict(t) for t in TRACE_IDS[:8]],
           [sink.known_verdict(t) for t in TRACE_IDS[:48]])
    sink.absorb_spans([{"trace_id": "x", "span_name": "dn_scan"}, "junk"])
    return out + (dict(sink.stats), sink.last_retained)


def test_root_role_sink_matches_reference():
    assert _drive_root_sink(trace_store) == _drive_root_sink(ref_trace)


def test_trace_spans_table_and_view_match_reference(sides):
    """After a flush, greptime_private.trace_spans and the
    information_schema view have the reference's columns, types and
    semantic types."""
    want = None
    for s in (sides["ref"], sides["port"]):
        s.trace.configure(sample_ratio=1.0)
        s.do("SELECT host FROM cpu WHERE v < 1")
        assert s.trace.sink().flush() > 0
        table = s.fe.catalog.table("greptime", "greptime_private",
                                   "trace_spans")
        cols = [(c.name, c.dtype.name, str(c.semantic_type.value))
                for c in table.schema.column_schemas]
        view = s.do("SELECT * FROM information_schema.trace_spans")
        vcols = [(c.name, c.dtype.name)
                 for c in view.batches[0].schema.column_schemas]
        assert view.num_rows > 0
        assert want is None or (cols, vcols) == want
        want = (cols, vcols)


@pytest.mark.parametrize("sql", [
    "SET trace_sample_ratio = 2",
    "SET trace_sample_ratio = -0.1",
    "SET trace_sample_ratio = 'often'",
    "SET trace_sample_ratio = 0.25",
    "SET trace_retention_ms = 'abc'",
    "SET trace_retention_ms = -5",
    "SET trace_retention_ms = 60000",
    "ADMIN SHOW TRACE 'f00dfeedf00dfeedf00dfeedf00dfeed'",
])
def test_trace_knobs_and_errors_match_reference(sides, sql):
    got = sides["port"].answer(sql)
    assert got == sides["ref"].answer(sql)
    assert trace_store.sample_ratio() == ref_trace.sample_ratio()
    assert trace_store.retention_ms() == ref_trace.retention_ms()


_VOLATILE = [(re.compile(r"[0-9a-f]{32}"), "<trace>"),
             (re.compile(r"\d+\.\d+ms"), "<ms>ms"),
             (re.compile(r"=\d+\.\d+"), "=<ms>")]


def _scrub(msg):
    for pattern, repl in _VOLATILE:
        msg = pattern.sub(repl, msg)
    return msg


def test_slow_query_warning_matches_reference(sides, caplog):
    """The slow-query WARN names the trace, whether it is stored and the
    statement's stages, as the reference's does."""
    msgs = {}
    for key, s in sides.items():
        s.trace.configure(sample_ratio=0.0)
        s.telemetry.set_slow_query_threshold_ms(1)
        logger = "greptimedb_tpu_torch.slow_query" if s.port \
            else "greptimedb_tpu.slow_query"
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=logger):
            s.do("SELECT host, v FROM cpu WHERE host = 'h03' ORDER BY ts")
        s.telemetry.set_slow_query_threshold_ms(None)
        found = [r.getMessage() for r in caplog.records
                 if r.name == logger and "slow query" in r.getMessage()]
        assert len(found) == 1
        msgs[key] = found[0]
    assert "trace_stored=yes" in msgs["port"]
    assert _scrub(msgs["port"]) == _scrub(msgs["ref"])


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=TIMEOUT_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_trace_route_matches_reference(sides):
    """GET /v1/trace/last after a retained statement, and /v1/trace of an
    unknown id, through both packages' servers."""
    servers = {"port": HttpServer(sides["port"].fe, addr="127.0.0.1:0"),
               "ref": RefHttpServer(sides["ref"].fe, addr="127.0.0.1:0")}
    got = {}
    try:
        for key, srv in servers.items():
            srv.start()
            s = sides[key]
            s.trace.configure(sample_ratio=1.0)
            s.do("SELECT host FROM cpu WHERE v > 99")
            status, doc = _get(srv.port, "/v1/trace/last")
            assert doc["trace_id"] == s.trace.sink().last_retained
            wf = [{k: r[k] for k in ("span", "node", "status", "detail")}
                  for r in doc["waterfall"]]
            spans = sorted((r["span_name"], r["status"], r["attrs"])
                           for r in doc["spans"])
            missing = _get(srv.port, "/v1/trace/" + "0" * 32)
            got[key] = (status, sorted(doc), doc["span_count"], wf, spans,
                        missing)
    finally:
        for srv in servers.values():
            srv.shutdown()
    assert got["port"] == got["ref"]
    assert got["port"][0] == 200 and got["port"][5][0] == 404


def test_concurrent_traces_keep_their_spans(sides):
    """Statements traced on several threads at once: every retained trace
    stores its own execute_stmt root and nothing of another trace (the
    sink's per-trace buffers under its lock)."""
    s = sides["port"]
    trace_store.configure(sample_ratio=1.0)
    sink = trace_store.sink()
    sink.flush()
    retained0 = sink.stats["traces_retained"]
    errors = []

    def work(i):
        try:
            for _ in range(5):
                s.do(f"SELECT host FROM cpu WHERE host = 'h{i:02d}'")
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT_S)
    assert not errors and not any(t.is_alive() for t in threads)
    assert sink.stats["traces_retained"] - retained0 == 40
    assert sink.flush() >= 40
    rows = s.do("SELECT trace_id, span_name FROM "
                "information_schema.trace_spans")
    d = rows.batches[0].to_pydict()
    roots = {}
    for tid, name in zip(d["trace_id"], d["span_name"]):
        if name == "execute_stmt":
            roots[tid] = roots.get(tid, 0) + 1
    assert all(n == 1 for n in roots.values())
