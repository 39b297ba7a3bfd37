"""The distributed frontend's scatter-gather held to the reference, on the
CPU: over Arrow Flight both ways, the RPCs it sends, a stale route after
a failover, and the dist pool.

- Over Flight: the port's DistInstance over the reference's
  FlightDatanodeServers, the reference's over the port's, and the port
  over the port, each against the reference over the reference, on one
  script (DDL, INSERT, bulk load, the aggregates of
  tests/test_torch_distributed.py cold and warm, the raw-row statements,
  EXPLAIN and EXPLAIN ANALYZE, DROP). A frontend over Flight clients has
  no in-process region (`DistTable.regions` is empty), so its aggregates
  must come back through `execute_tpu_plan` — the datanodes reduce and
  ship moment frames — and not be empty. EXPLAIN text is compared only
  between frontends over the same client kind with the same heartbeat
  state (no region stats in meta: the dispatch line has no est_rows).
  A fresh loopback server now and then refuses a connection under a
  loaded parallel run (ROADMAP Queue 3): a pairing whose answers hold
  such a refusal runs again on fresh servers, as
  tests/test_torch_meta_flight.py does.
- The RPCs: both packages' frontends over datanodes whose clients log
  every data-plane call (node, pruned region list, limit, shipped
  filters) send the same calls for the same statements: pruning to one
  region on a point query, none on a contradiction, the limit only when
  the shipped filters are the whole predicate.
- A stale route: two datanodes on one shared object store behind their
  Flight servers; datanode 2 goes down, meta fails its regions over to
  datanode 1, which adopts them from the heartbeat's mailbox; the
  frontend, still holding the old route, answers its next aggregate and
  scan equal to before by retrying the dead node's RPC, refreshing the
  route and scattering again. Both packages answer alike and count the
  refresh.
- The dist pool (common/runtime.py): the bounded ordered gather keeps
  submit order, bounds the window, propagates an error and cancels what
  it had queued; `DistTable.regions` over a remote client degrades to
  empty with one warning.
"""

from __future__ import annotations

import logging
import threading
import time

import pytest

from test_torch_distributed import (
    AGGS, HASH_DDL, P_ABS, RANGE_DDL, RAW, ROWS, SIDES, T0, Cluster,
    _insert_sql, analyze_tree, answer_of, assert_same)

#: (frontend package, datanode package) over Flight; each is held to
#: the reference over the reference
PAIRINGS = [("port", "ref"), ("ref", "port"), ("port", "port")]
#: runs of a pairing: one more each time a fresh loopback server refused
RUNS = 3
FLIGHT_AGGS = ("by_host", "global", "by_bucket", "point", "none_left")
FLIGHT_RAW = ("distinct", "limit", "limit_pushed", "expr_filter")


def _refused(out):
    return any(isinstance(v, tuple) and len(v) == 3 and v[0] == "error" and
               v[1] in ("TransientRpcError", "FlightUnavailableError")
               for v in out.values())


def flight_script(cluster):
    fe = cluster.fe

    def answer(fe, sql):
        cluster.beat()
        return answer_of(fe, sql)

    out = {}
    out["create_range"] = answer(fe, RANGE_DDL)
    out["create_hash"] = answer(fe, HASH_DDL)
    out["insert"] = answer(fe, _insert_sql("cpu_r", range(len(ROWS["ts"]))))
    out["bulk"] = fe.handle_bulk_load("cpu_h", dict(ROWS),
                                      tag_columns=["host"],
                                      timestamp_column="ts")
    for t in ("cpu_r", "cpu_h"):
        table = fe.catalog.table("greptime", "public", t)
        out[f"regions_{t}"] = dict(table.regions)
        for name in FLIGHT_AGGS:
            for run in ("cold", "warm"):
                out[f"agg_{t}_{name}_{run}"] = answer(fe,
                                                      AGGS[name].format(t=t))
        for name in FLIGHT_RAW:
            out[f"raw_{t}_{name}"] = answer(fe, RAW[name].format(t=t))
        for name in ("by_host", "point"):
            out[f"explain_{t}_{name}"] = answer(
                fe, "EXPLAIN " + AGGS[name].format(t=t))
            out[f"analyze_{t}_{name}"] = analyze_tree(answer(
                fe, "EXPLAIN ANALYZE " + AGGS[name].format(t=t)))
    out["flush"] = answer(fe, "ADMIN FLUSH TABLE cpu_r")
    out["after_flush"] = answer(fe, AGGS["by_host"].format(t="cpu_r"))
    out["drop"] = answer(fe, "DROP TABLE cpu_h")
    out["dropped"] = answer(fe, "SELECT count(*) FROM cpu_h")
    return out


def _run_pairing(front, back, home):
    cluster = Cluster(front, back, home, nodes=2, transport="flight")
    try:
        return flight_script(cluster)
    finally:
        cluster.fe.self_monitor.stop()
        cluster.close()


@pytest.fixture(scope="module")
def flight_answers(tmp_path_factory):
    """{(frontend, datanodes): {step: answer}}, the reference over the
    reference included."""
    out = {}
    for front, back in [("ref", "ref")] + PAIRINGS:
        for run in range(RUNS):
            home = tmp_path_factory.mktemp(f"{front}_{back}_{run}")
            got = _run_pairing(front, back, str(home))
            if not _refused(got):
                break
        out[(front, back)] = got
    return out


FLIGHT_STEPS = (
    ["create_range", "create_hash", "insert", "bulk"] +
    [f"agg_{t}_{name}_{run}" for t in ("cpu_r", "cpu_h")
     for name in FLIGHT_AGGS for run in ("cold", "warm")] +
    [f"raw_{t}_{name}" for t in ("cpu_r", "cpu_h") for name in FLIGHT_RAW] +
    [f"{kind}_{t}_{name}" for t in ("cpu_r", "cpu_h")
     for name in ("by_host", "point") for kind in ("explain", "analyze")] +
    ["flush", "after_flush", "drop", "dropped"])


@pytest.mark.parametrize("pairing", PAIRINGS,
                         ids=[f"{f}-over-{b}" for f, b in PAIRINGS])
@pytest.mark.parametrize("step", FLIGHT_STEPS)
def test_flight_pairing_answers_as_reference(flight_answers, pairing, step):
    got = flight_answers[pairing][step]
    want = flight_answers[("ref", "ref")][step]
    if isinstance(want, tuple) and want and want[0] in ("ok", "error"):
        if want[0] == "error" and got[0] == "error":
            assert got[1] == want[1], (step, got, want)
            return
        assert_same(got, want, P_ABS, f"{pairing} {step}")
    else:
        assert got == want, (pairing, step, got, want)


def test_flight_aggregates_go_through_the_scatter(flight_answers):
    """Over Flight clients the frontend holds no region, so every
    aggregate came back through execute_tpu_plan: the dispatch names the
    pushdown, each datanode has its block with the region dispatch it
    took, and the answers are not empty."""
    for pairing in [("ref", "ref")] + PAIRINGS:
        got = flight_answers[pairing]
        for t in ("cpu_r", "cpu_h"):
            assert got[f"regions_{t}"] == {}, pairing
            tree = got[f"analyze_{t}_by_host"]
            stages = [s for s, *_ in tree]
            assert "dist_scatter" in stages, (pairing, stages)
            nodes = [(s, d) for s, _, _, d in tree
                     if s.strip().startswith("dn")]
            assert len(nodes) == 2, (pairing, tree)
            assert all("dispatch=device-resident" in d for _, d in nodes)
            dispatch = [d for s, _, _, d in tree if s == "dispatch"][0]
            assert dispatch == ("aggregate-pushdown (regions pruned 0/"
                                f"{3 if t == 'cpu_r' else 4}, fan-out=2; "
                                "datanodes reduce, frontend folds)")
            _, (cols, frame) = got[f"agg_{t}_by_host_cold"]
            assert len(frame) == len(set(ROWS["host"]))


# ---------------------------------------------------------------------------
# the data-plane calls
# ---------------------------------------------------------------------------

def _spy_class(side):
    local = SIDES[side].client.LocalDatanodeClient

    class Spy(local):
        def __init__(self, datanode, log):
            super().__init__(datanode)
            self.log = log

        def scan_batches(self, *a, **kw):
            self.log.append(("scan", self.node_id, kw.get("regions"),
                             kw.get("limit"),
                             [repr(f) for f in kw.get("filters") or ()]))
            return super().scan_batches(*a, **kw)

        def region_moments(self, *a, **kw):
            self.log.append(("moments", self.node_id, kw.get("regions")))
            return super().region_moments(*a, **kw)

        def flush_table(self, *a, **kw):
            self.log.append(("flush", self.node_id))
            return super().flush_table(*a, **kw)

        def write_region(self, catalog, schema, table, region_number,
                         columns, op="put"):
            self.log.append(("write", self.node_id, region_number, op,
                             len(next(iter(columns.values())))))
            return super().write_region(catalog, schema, table,
                                        region_number, columns, op)
    return Spy


SPY_STATEMENTS = [
    AGGS["point"].format(t="cpu_h"),
    AGGS["by_host"].format(t="cpu_h"),
    AGGS["in_list"].format(t="cpu_r"),
    AGGS["range_time"].format(t="cpu_r"),
    AGGS["none_left"].format(t="cpu_r"),
    "SELECT host, n FROM cpu_r WHERE host = 'h2' LIMIT 3",
    "SELECT host, n FROM cpu_r WHERE n - 100 >= 0 LIMIT 3",
    "SELECT host, v FROM cpu_r WHERE host < 'a' AND host > 'z'",
    "SELECT host, ts, v FROM cpu_h WHERE host IN ('h1', 'h6') AND "
    "v * 2 > 100 ORDER BY host, ts",
    "ADMIN FLUSH TABLE cpu_h",
    "INSERT INTO cpu_r VALUES ('h0', 1, 1.0, 1), ('h4', 1, 1.0, 1), "
    "('h7', 1, 1.0, 1)",
    "DELETE FROM cpu_r WHERE host = 'h4'",
]


@pytest.fixture(scope="module")
def spy_logs(tmp_path_factory):
    """{side: [(statement, answer, calls)]}, the frontend's data-plane
    calls per statement with the local frame cache turned off (so the
    CPU fallback scans over the wire, as it does for remote nodes)."""
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for side in ("ref", "port"):
            mp.setattr(SIDES[side].tpu_exec, "cached_table_frame",
                       lambda *a, **kw: None)
            home = tmp_path_factory.mktemp(f"spy_{side}")
            cluster = Cluster(side, side, str(home), nodes=2)
            log = []
            spy = _spy_class(side)
            for i, dn in cluster.datanodes.items():
                cluster.clients[i] = spy(dn, log)
            fe = cluster.fe = cluster.new_frontend()
            try:
                cluster.beat()
                fe.do_query(RANGE_DDL)
                fe.do_query(HASH_DDL)
                fe.do_query(_insert_sql("cpu_r", range(len(ROWS["ts"]))))
                fe.handle_bulk_load("cpu_h", dict(ROWS),
                                    tag_columns=["host"],
                                    timestamp_column="ts")
                rows = []
                for sql in SPY_STATEMENTS:
                    log.clear()
                    got = answer_of(fe, sql)
                    rows.append((sql, got, sorted(log, key=repr)))
                out[side] = rows
            finally:
                fe.self_monitor.stop()
                cluster.close()
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("i", range(len(SPY_STATEMENTS)),
                         ids=[s.split(" FROM ")[0][:30].replace(" ", "_")
                              + f"_{i}" for i, s in
                              enumerate(SPY_STATEMENTS)])
def test_scatter_sends_the_reference_calls(spy_logs, i):
    sql, got, calls = spy_logs["port"][i]
    _, want, want_calls = spy_logs["ref"][i]
    assert_same(got, want, P_ABS, sql)
    assert calls == want_calls, (sql, calls, want_calls)


def test_spy_calls_prune_and_ship_limits(spy_logs):
    """What the calls above show: a point query contacts one region on
    one node, so does a range predicate below the first bound, a
    contradiction contacts none, and a limit travels only with a
    pushable filter."""
    port = {sql: calls for sql, _, calls in spy_logs["port"]}
    point = port[SPY_STATEMENTS[0]]
    assert len(point) == 1 and point[0][0] == "moments" and \
        len(point[0][2]) == 1
    assert port[SPY_STATEMENTS[4]] == [("moments", 1, [0])]
    assert port[SPY_STATEMENTS[7]] == []
    pushed = port[SPY_STATEMENTS[5]]
    assert pushed and all(c[3] == 3 and c[4] for c in pushed)
    held = port[SPY_STATEMENTS[6]]
    assert held and all(c[3] is None for c in held)
    assert {c[1] for c in port[SPY_STATEMENTS[9]]} == {1, 2}


# ---------------------------------------------------------------------------
# a stale route after a failover
# ---------------------------------------------------------------------------

def _beat(srv, node_id, t0, until, step=1.0):
    t = t0
    while t < until:
        srv.handle_heartbeat(node_id, now=t)
        t += step


def _stale_route_run(side, home):
    cluster = Cluster(side, side, home, nodes=2, transport="flight",
                      shared=True, lease_s=5.0)
    fe = cluster.fe
    out = {}
    try:
        cluster.beat()
        fe.do_query(RANGE_DDL)
        fe.do_query(_insert_sql("cpu_r", range(len(ROWS["ts"]))))
        fe.do_query("ADMIN FLUSH TABLE cpu_r")    # durable on the store
        out["before"] = answer_of(fe, AGGS["by_host"].format(t="cpu_r"))
        out["scan_before"] = answer_of(fe, RAW["expr_filter"].format(t="cpu_r"))
        out["route_before"] = sorted(
            (rr.region_number, rr.leader.id) for rr in
            fe.catalog.table("greptime", "public", "cpu_r")
            .route.region_routes)
        # datanode 2 goes down; meta fails its regions over to node 1
        cluster.stop_node(2)
        t0 = time.time()
        _beat(cluster.srv, 1, t0, t0 + 30)
        _beat(cluster.srv, 2, t0, t0 + 3)
        moves = cluster.srv.failover_check(now=t0 + 29)
        out["moves"] = sorted((mv["region"], mv["from"], mv["to"])
                              for mv in moves)
        resp = cluster.srv.handle_heartbeat(1, now=t0 + 30)
        for msg in resp.mailbox:
            cluster.datanodes[1]._handle_mailbox(msg)
        refreshed = _stale_refreshes(side)
        out["after"] = answer_of(fe, AGGS["by_host"].format(t="cpu_r"))
        out["scan_after"] = answer_of(fe, RAW["expr_filter"].format(t="cpu_r"))
        out["refreshed"] = _stale_refreshes(side) > refreshed
        out["route_after"] = sorted(
            (rr.region_number, rr.leader.id) for rr in
            fe.catalog.table("greptime", "public", "cpu_r")
            .route.region_routes)
        out["insert_after"] = answer_of(
            fe, f"INSERT INTO cpu_r VALUES ('h7', {T0 + 5}, 1.5, 2)")
        out["count_after"] = answer_of(fe, "SELECT count(*) FROM cpu_r")
    finally:
        fe.self_monitor.stop()
        cluster.close()
    return out


def _stale_refreshes(side):
    from test_torch_distributed import _counter
    return _counter(side, "stale_route_refresh")


@pytest.fixture(scope="module")
def stale_answers(tmp_path_factory):
    saved = {s: (SIDES[s].dist._DIST_RPC_BASE_MS[0],
                 SIDES[s].dist._STALE_ROUTE_BASE_MS[0]) for s in SIDES}
    out = {}
    try:
        for side in ("ref", "port"):
            SIDES[side].dist._DIST_RPC_BASE_MS[0] = 1
            SIDES[side].dist._STALE_ROUTE_BASE_MS[0] = 1
            for run in range(RUNS):
                home = tmp_path_factory.mktemp(f"stale_{side}_{run}")
                got = _stale_route_run(side, str(home))
                if not _refused({k: v for k, v in got.items()
                                 if k.endswith("before")}):
                    break
            out[side] = got
    finally:
        for s, (rpc, stale) in saved.items():
            SIDES[s].dist._DIST_RPC_BASE_MS[0] = rpc
            SIDES[s].dist._STALE_ROUTE_BASE_MS[0] = stale
    return out


@pytest.mark.parametrize("step", ["before", "scan_before", "route_before",
                                  "moves", "after", "scan_after",
                                  "refreshed", "route_after",
                                  "insert_after", "count_after"])
def test_stale_route_retry_answers_as_reference(stale_answers, step):
    got, want = stale_answers["port"][step], stale_answers["ref"][step]
    if isinstance(want, tuple) and want and want[0] in ("ok", "error"):
        assert_same(got, want, P_ABS, step)
    else:
        assert got == want, (step, got, want)


def test_stale_route_retry_keeps_the_answer(stale_answers):
    port = stale_answers["port"]
    assert_same(port["after"], port["before"], P_ABS, "after")
    assert_same(port["scan_after"], port["scan_before"], P_ABS, "scan")
    assert port["refreshed"] is True
    assert {n for _, n in port["route_before"]} == {1, 2}
    assert {n for _, n in port["route_after"]} == {1}


# ---------------------------------------------------------------------------
# the dist pool and the remote view
# ---------------------------------------------------------------------------

def _runtime():
    return SIDES["port"].runtime


def test_gather_keeps_submit_order_on_the_dist_pool():
    rt = _runtime()

    def slow_first(i):
        time.sleep(0.05 if i == 0 else 0.0)
        return i * 10

    got = list(rt.parallel_imap(slow_first, range(8), max_workers=4,
                                pool=rt.dist_runtime()))
    assert got == [i * 10 for i in range(8)]


def test_gather_window_bounds_what_is_in_flight():
    rt = _runtime()
    live, peak = [], []
    lock = threading.Lock()

    def tracked(i):
        with lock:
            live.append(i)
            peak.append(len(live))
        time.sleep(0.02)
        with lock:
            live.remove(i)
        return i

    got = list(rt.parallel_imap(tracked, range(12), max_workers=3,
                                pool=rt.dist_runtime()))
    assert got == list(range(12)) and max(peak) <= 3


def test_gather_error_propagates_and_cancels_queued_work():
    rt = _runtime()
    calls = []
    gate = threading.Event()

    def boom(i):
        calls.append(i)
        if i == 0:
            raise ValueError("x")
        gate.wait(2)
        return i

    with pytest.raises(ValueError):
        list(rt.parallel_imap(boom, range(10), max_workers=2,
                              pool=rt.dist_runtime()))
    gate.set()
    time.sleep(0.2)
    assert len(calls) <= 3


def test_dist_fanout_knob_matches_reference():
    """SET dist_fanout's setter clamps as the reference's does, and the
    dist pool is sized as the reference's."""
    ref, port = SIDES["ref"].runtime, SIDES["port"].runtime
    saved = (ref.dist_fanout(), port.dist_fanout())
    try:
        for n in (0, 1, 4, 32):
            ref.configure_dist_fanout(n)
            port.configure_dist_fanout(n)
            assert port.dist_fanout() == ref.dist_fanout()
        assert port._SIZES == ref._SIZES
        assert port.dist_runtime()._max_workers == \
            ref.dist_runtime()._max_workers
    finally:
        ref.configure_dist_fanout(saved[0])
        port.configure_dist_fanout(saved[1])


def test_remote_regions_warn_once_and_degrade(tmp_path, caplog):
    port = SIDES["port"]
    cluster = Cluster("port", "port", str(tmp_path), nodes=2)
    try:
        cluster.fe.do_query(HASH_DDL)
        table = cluster.fe.catalog.table("greptime", "public", "cpu_h")
        assert table.regions            # the in-process union

        class RemoteStub(port.client.DatanodeClient):
            node_id = 99

        stub = RemoteStub()
        remote = port.dist.DistTable(table.info, table.partition_rule,
                                     table.route,
                                     {i: stub for i in cluster.clients})
        with caplog.at_level(logging.WARNING):
            assert remote.regions == {}
            assert remote.regions == {}
        warns = [r for r in caplog.records
                 if "region metadata is unavailable" in r.message]
        assert len(warns) == 1
        mixed = port.dist.DistTable(table.info, table.partition_rule,
                                    table.route,
                                    {1: cluster.clients[1], 2: stub})
        assert mixed.regions == {}
    finally:
        cluster.fe.shutdown()
        cluster.close()
