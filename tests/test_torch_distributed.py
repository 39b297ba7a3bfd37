"""The distributed frontend held to the reference, on the CPU.

greptimedb_tpu_torch/frontend/distributed.py (DistTable, DistInstance),
with the aggregate pushdown it drives (query/{tpu_exec,ir,engine}.py), the
dist pool (common/runtime.py) and the distributed SET knobs
(frontend/statement.py), against greptimedb_tpu/'s. Each package runs its
own cluster: an in-process `MetaSrv(MemKv())`, two or four datanodes
(node ids 1..n, `device="cpu"` for the port) behind LocalDatanodeClients,
and a DistInstance over them (`device="cpu"`). One statement script
(`SCRIPT`) runs on both packages' clusters, at two and at four
datanodes, and every step must answer alike:

- CREATE TABLE ... PARTITION BY RANGE COLUMNS and BY HASH: meta's
  placement, and the rows on each datanode's regions after a SQL INSERT
  and after a bulk load (`handle_bulk_load`);
- aggregates over both tables, cold then warm, grouped by tag and by tag
  and time bucket, with and without predicates that prune regions;
- statements that do not lower (a window function, a non-pushable
  filter, ORDER BY ... LIMIT) on the raw-row scatter, and count(DISTINCT),
  which lowers to the sketch partial in both packages;
- EXPLAIN's plan text and EXPLAIN ANALYZE's stage tree (every stage and
  node block by name, rows and dispatch; walls left out), byte-equal;
- `SET dist_partial_agg = 0` and `SET dist_fanout = 1`, whose answers
  must also equal the pushdown's;
- a transient `dist_rpc` failpoint that the per-RPC retry rides over;
- ALTER (ADD / DROP COLUMN, RENAME), DROP, a CREATE that one datanode
  fails (rolled back), ingest that creates and alters on demand, and a
  second frontend that hydrates every table from meta's routes.

Answers: rows, their order, keys, counts, integers, min / max and every
column's dtype exactly; float sums and averages within the bound of
tests/test_torch_sql.py (|port - ref| <= 1e-5 |ref| + 8 eps32 P, P the sum
of |v| over the table). Both packages' module knobs (the pushdown switch,
the fan-out, the RPC retry, the failpoints) are restored after the
script. The tables stay small and the script reuses one moment set per
shape, so the reference compiles few programs.
"""

from __future__ import annotations

import importlib
import re
import types

import numpy as np
import pandas as pd
import pytest

EPS32 = 2.0 ** -24
T0 = 1_700_000_000_000
HOSTS = [f"h{i}" for i in range(8)]
SAMPLES = 24
RANGE_DDL = ("CREATE TABLE cpu_r (host STRING, ts TIMESTAMP TIME INDEX, "
             "v DOUBLE, n BIGINT, PRIMARY KEY(host)) PARTITION BY RANGE "
             "COLUMNS (host) (PARTITION r0 VALUES LESS THAN ('h2'), "
             "PARTITION r1 VALUES LESS THAN ('h5'), PARTITION r2 VALUES "
             "LESS THAN (MAXVALUE))")
HASH_DDL = ("CREATE TABLE cpu_h (host STRING, ts TIMESTAMP TIME INDEX, "
            "v DOUBLE, n BIGINT, PRIMARY KEY(host)) PARTITION BY HASH "
            "(host) PARTITIONS 4")


def _mods(side):
    pkg = "greptimedb_tpu" if side == "ref" else "greptimedb_tpu_torch"

    def m(name):
        return importlib.import_module(f"{pkg}.{name}")
    return types.SimpleNamespace(
        side=side, datanode=m("datanode.instance"), client=m("client"),
        flight_client=m("client.flight"), flight_server=m("servers.flight"),
        dist=m("frontend.distributed"), meta=m("meta"),
        store=m("storage.object_store"), tpu_exec=m("query.tpu_exec"),
        runtime=m("common.runtime"), failpoint=m("common.failpoint"),
        errors=m("errors"), telemetry=m("common.telemetry"))


SIDES = {side: _mods(side) for side in ("ref", "port")}


def node_options(side, home, node_id):
    kw = {"data_home": home, "node_id": node_id,
          "register_numbers_table": False, "flow_tick_interval_s": 0,
          "self_monitor_interval_s": 0}
    if side == "port":
        kw["device"] = "cpu"
    return SIDES[side].datanode.DatanodeOptions(**kw)


class Cluster:
    """Meta, `nodes` datanodes of `node_side` and a DistInstance of
    `front_side`. `transport` "local" hands the frontend
    LocalDatanodeClients (both sides one package); "flight" puts each
    datanode behind its package's FlightDatanodeServer and hands the
    frontend its own package's FlightDatanodeClients. `shared` puts
    every datanode on one object store, as failover needs. A server's
    shutdown waits for its serve thread: one still winding down can
    close the listening socket of a server made after it in the process
    (tests/test_torch_meta_replication.py's FlightCluster)."""

    def __init__(self, front_side, node_side, home, nodes=2,
                 transport="local", shared=False, lease_s=3600.0):
        front, back = SIDES[front_side], SIDES[node_side]
        self.front_side = front_side
        self.srv = front.meta.MetaSrv(front.meta.MemKv(),
                                      datanode_lease_secs=lease_s)
        self.meta = front.meta.MetaClient(self.srv)
        store = back.store.FsObjectStore(f"{home}/shared") \
            if shared else None
        self.datanodes, self.servers, self.clients = {}, {}, {}
        self.serving = {}
        for i in range(1, nodes + 1):
            dn = back.datanode.DatanodeInstance(
                node_options(node_side, f"{home}/dn{i}", i), store=store)
            dn.start()
            self.datanodes[i] = dn
            if transport == "flight":
                server = back.flight_server.FlightDatanodeServer(dn)
                self.serving[i] = server.serve_in_background()
                self.servers[i] = server
                self.clients[i] = front.flight_client.FlightDatanodeClient(
                    server.address, i)
                addr = server.address
            else:
                self.clients[i] = front.client.LocalDatanodeClient(dn)
                addr = f"dn{i}"
            self.srv.register_datanode(front.meta.Peer(i, addr))
            self.srv.handle_heartbeat(i)
        kw = {"device": "cpu"} if front_side == "port" else {}
        self.kw = kw
        self.fe = front.dist.DistInstance(self.meta, self.clients, **kw)

    def beat(self):
        """One heartbeat from every datanode: meta places regions only on
        nodes its failure detector holds alive, and a slow run outlives a
        single beat's grace."""
        for i in self.datanodes:
            self.srv.handle_heartbeat(i)

    def new_frontend(self):
        return SIDES[self.front_side].dist.DistInstance(
            self.meta, self.clients, **self.kw)

    def stop_node(self, i):
        """Take datanode `i` down, its Flight server first."""
        server = self.servers.pop(i, None)
        if server is not None:
            server.shutdown()
            self.serving.pop(i).join(60)
        self.datanodes.pop(i).shutdown()

    def close(self):
        for c in self.clients.values():
            if hasattr(c, "close"):
                c.close()
        for i in list(self.datanodes):
            self.stop_node(i)


# ---------------------------------------------------------------------------
# answers
# ---------------------------------------------------------------------------

def frame_of(out):
    """An Output's rows as a DataFrame with its dtypes (a batch-less
    answer: its affected rows)."""
    if not out.is_batches:
        return int(out.affected_rows or 0)
    cols = out.schema.names() if out.schema is not None else \
        out.batches[0].schema.names()
    data = {c: [] for c in cols}
    for b in out.batches:
        for c, vals in b.to_pydict().items():
            data[c].extend(vals)
    dtypes = [cs.dtype.name for cs in (out.schema or out.batches[0].schema)
              .column_schemas]
    return (tuple(zip(cols, dtypes)), pd.DataFrame(data, columns=cols))


def answer_of(fe, sql):
    """(kind, value) of the last statement of `sql`: a frame, a count or
    the error's class and message."""
    try:
        out = fe.do_query(sql)[-1]
    except Exception as e:  # noqa: BLE001 — each package's own class
        return ("error", type(e).__name__, str(e))
    return ("ok", frame_of(out))


def assert_same(got, want, p_abs, what=""):
    """The port's answer `got` against the reference's `want`."""
    assert got[0] == want[0], (what, got, want)
    if got[0] == "error":
        assert got[1:] == want[1:], what
        return
    g, w = got[1], want[1]
    if isinstance(w, int):
        assert g == w, what
        return
    assert g[0] == w[0], (what, g[0], w[0])       # names and dtypes
    gf, wf = g[1], w[1]
    assert len(gf) == len(wf), (what, gf, wf)
    for c in wf.columns:
        gv, wv = gf[c].to_numpy(), wf[c].to_numpy()
        floats = [isinstance(x, float) for x in wv if x is not None]
        if floats and all(floats) and not c.startswith(("min", "max",
                                                        "count")):
            gv = np.asarray(gv, dtype=np.float64)
            wv = np.asarray(wv, dtype=np.float64)
            np.testing.assert_allclose(
                gv, wv, rtol=1e-5, atol=8 * EPS32 * p_abs,
                err_msg=f"{what}: {c}")
        else:
            assert list(gv) == list(wv), (what, c, list(gv), list(wv))


_WALL = re.compile(r"(elapsed_ms|node_ms|slowest_node_ms|network_ms)"
                   r"=[0-9A-Za-z:./#-]+")


def analyze_tree(result):
    """EXPLAIN ANALYZE's rows without their walls: (stage, rows, files,
    detail with every wall scrubbed)."""
    kind, value = result
    if kind != "ok":
        return result
    _, df = value
    return [(r["stage"], r["rows"], r["files"],
             _WALL.sub(r"\1=<ms>", str(r["detail"])))
            for _, r in df.iterrows()]


# ---------------------------------------------------------------------------
# the data: one numpy seed, values exact in float32
# ---------------------------------------------------------------------------

def _rows():
    rng = np.random.default_rng(18)
    host = np.repeat(np.array(HOSTS, dtype=object), SAMPLES)
    ts = np.tile(T0 + np.arange(SAMPLES, dtype=np.int64) * 5000,
                 len(HOSTS))
    v = rng.integers(0, 800, len(ts)) / 8.0
    n = rng.integers(-500, 500, len(ts)).astype(np.int64)
    return {"host": host, "ts": ts, "v": v, "n": n}


ROWS = _rows()
P_ABS = float(np.abs(ROWS["v"]).sum() + np.abs(ROWS["n"]).sum())


def _insert_sql(table, idx):
    vals = ", ".join(
        f"('{ROWS['host'][i]}', {int(ROWS['ts'][i])}, "
        f"{float(ROWS['v'][i])!r}, {int(ROWS['n'][i])})" for i in idx)
    return f"INSERT INTO {table} VALUES {vals}"


AGGS = {
    "by_host": "SELECT host, count(*), sum(v), avg(v), min(n), max(n) "
               "FROM {t} GROUP BY host ORDER BY host",
    "global": "SELECT count(*), sum(v), avg(v), min(n), max(n) FROM {t}",
    "by_bucket": "SELECT host, date_bin(INTERVAL '30 seconds', ts) AS b, "
                 "count(*), sum(v), avg(v), min(n), max(n) FROM {t} "
                 "GROUP BY host, b ORDER BY host, b",
    "point": "SELECT host, count(*), sum(v), avg(v), min(n), max(n) "
             "FROM {t} WHERE host = 'h3' GROUP BY host ORDER BY host",
    "in_list": "SELECT host, count(*), sum(v), avg(v), min(n), max(n) "
               "FROM {t} WHERE host IN ('h1', 'h6') GROUP BY host "
               "ORDER BY host",
    "range_time": "SELECT host, count(*), sum(v), avg(v), min(n), max(n) "
                  "FROM {t} WHERE host > 'h4' AND ts >= "
                  f"{T0 + 20_000} AND ts < {T0 + 90_000} GROUP BY host "
                  "ORDER BY host",
    "none_left": "SELECT host, count(*), sum(v), avg(v), min(n), max(n) "
                 "FROM {t} WHERE host < 'a' GROUP BY host ORDER BY host",
}
RAW = {
    "distinct": "SELECT count(DISTINCT host) FROM {t}",
    "window": "SELECT host, ts, v, row_number() OVER (PARTITION BY host "
              "ORDER BY ts) AS rn FROM {t} WHERE host = 'h2' ORDER BY ts",
    "expr_filter": "SELECT host, ts, v FROM {t} WHERE v * 2 > 190 "
                   "ORDER BY host, ts",
    "limit": "SELECT host, ts, n FROM {t} WHERE host = 'h6' ORDER BY ts "
             "LIMIT 3",
    "limit_pushed": "SELECT host, n FROM {t} WHERE host = 'h5' LIMIT 4",
}
EXPLAINED = ("by_host", "point", "in_list", "none_left", "by_bucket")
TABLES = ("cpu_r", "cpu_h")


def _region_rows(cluster, table):
    """{node id: {region number: rows}} over the datanodes' own
    regions."""
    out = {}
    for i, dn in cluster.datanodes.items():
        t = dn.catalog.table("greptime", "public", table)
        out[i] = {} if t is None else {
            rn: int(r.snapshot().read_merged().num_rows)
            for rn, r in sorted(t.regions.items())}
    return out


def _route(cluster, table):
    route = cluster.srv.table_route(f"greptime.public.{table}")
    return None if route is None else sorted(
        (rr.region_number, rr.leader.id) for rr in route.region_routes)


def _counter(side, name):
    tel = SIDES[side].telemetry
    if side == "ref":
        from prometheus_client import REGISTRY
        return REGISTRY.get_sample_value(f"greptime_{name}_total") or 0.0
    return sum(v for n, _, v, _ in tel.registry_snapshot()
               if n == f"greptime_{name}_total")


def run_script(side, cluster):
    """Every step's answer on one package's cluster: {step: answer}. The
    datanodes beat before each statement, as live ones do."""
    fe = cluster.fe

    def answer(fe, sql):
        cluster.beat()
        return answer_of(fe, sql)

    out = {}
    out["create_range"] = answer(fe, RANGE_DDL)
    out["create_hash"] = answer(fe, HASH_DDL)
    out["create_again"] = answer(fe, RANGE_DDL)
    out["create_if_not_exists"] = answer(
        fe, RANGE_DDL.replace("TABLE cpu_r", "TABLE IF NOT EXISTS cpu_r"))
    out["route_range"] = _route(cluster, "cpu_r")
    out["route_hash"] = _route(cluster, "cpu_h")
    n = len(ROWS["ts"])
    out["insert_range"] = answer(fe, _insert_sql("cpu_r", range(n)))
    out["rows_after_insert"] = _region_rows(cluster, "cpu_r")
    cluster.beat()
    out["bulk_hash"] = fe.handle_bulk_load(
        "cpu_h", dict(ROWS), tag_columns=["host"], timestamp_column="ts")
    out["rows_after_bulk"] = _region_rows(cluster, "cpu_h")
    for t in TABLES:
        for name, sql in AGGS.items():
            for run in ("cold", "warm"):
                out[f"agg_{t}_{name}_{run}"] = answer(fe, sql.format(t=t))
        for name, sql in RAW.items():
            out[f"raw_{t}_{name}"] = answer(fe, sql.format(t=t))
        for name in EXPLAINED:
            out[f"explain_{t}_{name}"] = answer(
                fe, "EXPLAIN " + AGGS[name].format(t=t))
            out[f"analyze_{t}_{name}"] = analyze_tree(answer(
                fe, "EXPLAIN ANALYZE " + AGGS[name].format(t=t)))
        out[f"explain_{t}_distinct"] = answer(
            fe, "EXPLAIN " + RAW["distinct"].format(t=t))
    # the pushdown switch: no plan at all, the raw-row scatter answers
    answer(fe, "SET dist_partial_agg = 0")
    for name in ("by_host", "point", "by_bucket"):
        out[f"nopush_{name}"] = answer(fe, AGGS[name].format(t="cpu_h"))
    out["nopush_explain"] = answer(
        fe, "EXPLAIN " + AGGS["point"].format(t="cpu_h"))
    answer(fe, "SET dist_partial_agg = 1")
    # a serial scatter
    answer(fe, "SET dist_fanout = 1")
    for name in ("by_host", "global"):
        out[f"fanout1_{name}"] = answer(fe, AGGS[name].format(t="cpu_r"))
    out["fanout1_limit"] = answer(fe, RAW["limit"].format(t="cpu_r"))
    answer(fe, "SET dist_fanout = 8")
    # the replica knobs: with no replica in region_peers, reads stay on
    # the leaders
    out["set_read_replica"] = answer(fe, "SET read_replica = 'follower'")
    out["replica_read"] = answer(fe, AGGS["by_host"].format(t="cpu_h"))
    out["set_read_replica_bad"] = answer(fe, "SET read_replica = 'x'")
    out["set_replica_lag"] = answer(fe, "SET replica_max_lag_ms = 250")
    answer(fe, "SET read_replica = 'leader'")
    # a transient fault on every other RPC: the retry answers
    before = _counter(side, "dist_rpc_retry")
    answer(fe, "SET dist_rpc_retry_base_ms = 1")
    out["failpoint_on"] = answer(
        fe, "SET failpoint_dist_rpc = '1x2*err(transient)'")
    out["failpoint_by_host"] = answer(fe, AGGS["by_host"].format(t="cpu_h"))
    out["failpoint_scan"] = answer(fe, RAW["limit"].format(t="cpu_h"))
    answer(fe, "SET failpoint_dist_rpc = 'off'")
    out["failpoint_retried"] = _counter(side, "dist_rpc_retry") > before
    out["failpoint_terminal"] = answer(
        fe, "SET failpoint_dist_rpc = 'err(boom)'")
    out["failpoint_terminal_query"] = answer(fe, "SELECT count(*) "
                                                 "FROM cpu_h")
    answer(fe, "SET failpoint_dist_rpc = 'off'")
    # SHOW / DESCRIBE
    out["show_tables"] = answer(fe, "SHOW TABLES")
    out["describe"] = answer(fe, "DESCRIBE TABLE cpu_r")
    # a second frontend hydrates the tables from meta's routes
    fe2 = cluster.new_frontend()
    try:
        out["hydrated_by_host"] = answer(fe2, AGGS["by_host"].format(
            t="cpu_r"))
        out["hydrated_explain"] = answer(
            fe2, "EXPLAIN " + AGGS["point"].format(t="cpu_h"))
        out["hydrated_insert"] = answer(
            fe2, "INSERT INTO cpu_h VALUES ('h9', 1, 1.5, 2)")
        out["hydrated_count"] = answer(fe2, "SELECT count(*) FROM cpu_h")
        out["hydrated_create_if_not_exists"] = answer(
            fe2, HASH_DDL.replace("TABLE cpu_h",
                                  "TABLE IF NOT EXISTS cpu_h"))
        out["hydrated_create"] = answer(fe2, HASH_DDL)
    finally:
        fe2.self_monitor.stop()
    # DELETE routes to the owner
    out["delete"] = answer(fe, "DELETE FROM cpu_h WHERE host = 'h9'")
    out["count_after_delete"] = answer(fe, "SELECT count(*) FROM cpu_h")
    # ALTER: add a column, write it, drop it, rename the table
    out["alter_add"] = answer(fe, "ALTER TABLE cpu_r ADD COLUMN w DOUBLE")
    out["insert_w"] = answer(
        fe, f"INSERT INTO cpu_r (host, ts, v, n, w) VALUES "
            f"('h1', {T0 + 999_000}, 1.5, 3, 2.25), "
            f"('h7', {T0 + 999_000}, 2.5, 4, 4.5)")
    out["select_w"] = answer(fe, "SELECT host, ts, w FROM cpu_r WHERE "
                                 f"ts >= {T0 + 999_000} ORDER BY host")
    out["describe_w"] = answer(fe, "DESCRIBE TABLE cpu_r")
    out["alter_drop"] = answer(fe, "ALTER TABLE cpu_r DROP COLUMN w")
    out["select_after_drop"] = answer(fe, "SELECT * FROM cpu_r WHERE ts >= "
                                          f"{T0 + 999_000} ORDER BY host")
    out["alter_rename"] = answer(fe, "ALTER TABLE cpu_r RENAME cpu_rr")
    out["renamed_route"] = (_route(cluster, "cpu_r"),
                            _route(cluster, "cpu_rr"))
    out["renamed_by_host"] = answer(fe, AGGS["by_host"].format(t="cpu_rr"))
    out["old_name"] = answer(fe, "SELECT count(*) FROM cpu_r")
    # ingest that creates the table, then alters it on demand
    cols = {"host": ["a", "b", "a"], "ts": [T0, T0, T0 + 1000],
            "v": [1.0, 2.0, 3.0]}
    cluster.beat()
    out["auto_create"] = fe.handle_row_insert(
        "auto_t", cols, tag_columns=["host"], timestamp_column="ts")
    out["auto_route"] = _route(cluster, "auto_t")
    out["auto_alter"] = fe.handle_row_insert(
        "auto_t", {**cols, "ts": [T0 + 5000] * 3, "u": [7, 8, 9]},
        tag_columns=["host"], timestamp_column="ts")
    out["auto_select"] = answer(fe, "SELECT * FROM auto_t ORDER BY host, ts")
    try:
        fe.handle_row_insert("auto_t", {**cols, "dc": ["x"] * 3},
                             tag_columns=["host", "dc"],
                             timestamp_column="ts")
        out["auto_new_tag"] = "accepted"
    except Exception as e:  # noqa: BLE001 — each package's own class
        out["auto_new_tag"] = (type(e).__name__, str(e))
    # a CREATE one datanode fails rolls back the route and the others
    bad = cluster.clients[2]
    orig = bad.ddl_create_table

    def boom(req):
        raise RuntimeError("boom")
    bad.ddl_create_table = boom
    try:
        out["create_fails"] = answer(fe, RANGE_DDL.replace("cpu_r", "cpu_x"))
    finally:
        bad.ddl_create_table = orig
    out["rolled_back_route"] = _route(cluster, "cpu_x")
    out["rolled_back_rows"] = _region_rows(cluster, "cpu_x")
    out["create_after_rollback"] = answer(fe, RANGE_DDL.replace("cpu_r",
                                                                "cpu_x"))
    # DROP removes the table everywhere
    out["drop"] = answer(fe, "DROP TABLE cpu_x")
    out["dropped_route"] = _route(cluster, "cpu_x")
    out["dropped_rows"] = _region_rows(cluster, "cpu_x")
    out["drop_missing"] = answer(fe, "DROP TABLE cpu_x")
    out["drop_if_exists"] = answer(fe, "DROP TABLE IF EXISTS cpu_x")
    out["show_tables_end"] = answer(fe, "SHOW TABLES")
    return out


def _knobs():
    saved = []
    for m in SIDES.values():
        saved.append((m, m.runtime.dist_fanout(),
                      m.tpu_exec._PARTIAL_PUSHDOWN[0],
                      m.dist._DIST_RPC_MAX_RETRIES[0],
                      m.dist._DIST_RPC_BASE_MS[0],
                      m.dist._READ_REPLICA[0],
                      m.dist._REPLICA_MAX_LAG_MS[0]))
    return saved


def _restore(saved):
    for m, fan, push, retries, base, replica, lag in saved:
        m.runtime.configure_dist_fanout(fan)
        m.tpu_exec._PARTIAL_PUSHDOWN[0] = push
        m.dist._DIST_RPC_MAX_RETRIES[0] = retries
        m.dist._DIST_RPC_BASE_MS[0] = base
        m.dist._READ_REPLICA[0] = replica
        m.dist._REPLICA_MAX_LAG_MS[0] = lag
        m.failpoint.reset()


@pytest.fixture(scope="module", params=[2, 4], ids=["2dn", "4dn"])
def answers(request, tmp_path_factory):
    """{side: {step: answer}} of the script on each package's cluster of
    `request.param` datanodes."""
    saved = _knobs()
    out = {}
    try:
        for side in ("ref", "port"):
            home = tmp_path_factory.mktemp(f"{side}{request.param}")
            cluster = Cluster(side, side, str(home), nodes=request.param)
            try:
                out[side] = run_script(side, cluster)
            finally:
                cluster.fe.self_monitor.stop()
                cluster.close()
    finally:
        _restore(saved)
    return out


STEPS = (
    ["create_range", "create_hash", "create_again", "create_if_not_exists",
     "route_range", "route_hash", "insert_range", "rows_after_insert",
     "bulk_hash", "rows_after_bulk"] +
    [f"agg_{t}_{name}_{run}" for t in TABLES for name in AGGS
     for run in ("cold", "warm")] +
    [f"raw_{t}_{name}" for t in TABLES for name in RAW] +
    [f"{kind}_{t}_{name}" for t in TABLES for name in EXPLAINED
     for kind in ("explain", "analyze")] +
    [f"explain_{t}_distinct" for t in TABLES] +
    ["nopush_by_host", "nopush_point", "nopush_by_bucket", "nopush_explain",
     "fanout1_by_host", "fanout1_global", "fanout1_limit",
     "set_read_replica", "replica_read", "set_read_replica_bad",
     "set_replica_lag", "failpoint_on", "failpoint_by_host",
     "failpoint_scan", "failpoint_retried", "failpoint_terminal",
     "failpoint_terminal_query", "show_tables", "describe",
     "hydrated_by_host", "hydrated_explain", "hydrated_insert",
     "hydrated_count", "hydrated_create_if_not_exists", "hydrated_create",
     "delete", "count_after_delete", "alter_add", "insert_w", "select_w",
     "describe_w", "alter_drop", "select_after_drop", "alter_rename",
     "renamed_route", "renamed_by_host", "old_name", "auto_create",
     "auto_route", "auto_alter", "auto_select", "auto_new_tag",
     "create_fails", "rolled_back_route", "rolled_back_rows",
     "create_after_rollback", "drop", "dropped_route", "dropped_rows",
     "drop_missing", "drop_if_exists", "show_tables_end"])


def _errors_alike(got, want):
    """Two error answers: the same class name, and the port's message
    is the reference's with the package name swapped."""
    return got[1] == want[1] and got[2].replace(
        "greptimedb_tpu_torch", "greptimedb_tpu") == want[2]


@pytest.mark.parametrize("step", STEPS)
def test_step_answers_as_reference(answers, step):
    got, want = answers["port"][step], answers["ref"][step]
    if isinstance(want, tuple) and want and want[0] in ("ok", "error"):
        if want[0] == "error" and got[0] == "error":
            assert _errors_alike(got, want), (step, got, want)
            return
        assert_same(got, want, P_ABS, step)
    else:
        assert got == want, (step, got, want)


def test_script_covers_the_cases(answers):
    """The script did what its steps claim: the aggregates took the
    pushdown, the raw statements did not, the failpoint retried, the
    rollback left nothing behind, and placement spread every table over
    more than one node."""
    port = answers["port"]
    assert port["insert_range"] == ("ok", len(ROWS["ts"]))
    assert sum(sum(v.values()) for v in port["rows_after_insert"].values()) \
        == len(ROWS["ts"])
    for t in TABLES:
        plan = port[f"explain_{t}_by_host"][1][1]["plan"][0]
        assert "Dispatch: aggregate-pushdown (regions pruned 0/" in plan
        point = port[f"explain_{t}_point"][1][1]["plan"][0]
        assert "fan-out=1" in point
        # count(DISTINCT) over a DistTable lowers to the sketch partial
        for side in ("port", "ref"):
            assert answers[side][f"explain_{t}_distinct"][1][1]["plan"][0] \
                .startswith("TpuAggregateExec"), side
        nodes = [s for s, *_ in port[f"analyze_{t}_by_host"]
                 if s.strip().startswith("dn")]
        assert len(nodes) >= 2, nodes
    assert port["nopush_explain"][1][1]["plan"][0].startswith(
        "CpuAggregateExec")
    assert port["failpoint_retried"] is True
    assert port["failpoint_terminal_query"][0] == "error"
    assert port["rolled_back_route"] is None
    assert all(not v for v in port["rolled_back_rows"].values())
    assert len({n for _, n in port["route_hash"]}) > 1
    assert sum(sum(v.values()) for v in port["rows_after_bulk"].values()) \
        == len(ROWS["ts"])
    assert port["auto_new_tag"][0] == "InvalidArgumentsError"


def test_elastic_admin_and_tql_name_what_is_missing(tmp_path):
    """Nothing is missing any more: ADMIN MIGRATE / SPLIT / REBALANCE /
    ADD or REMOVE REPLICA enqueue the same balancer operations in both
    packages (op ids aside), TQL over a DistTable and SET exact_distinct
    answer as the reference's do, and ADMIN FLUSH TABLE scatters."""
    answers = {}
    for side in ("ref", "port"):
        c = Cluster(side, side, str(tmp_path / side), nodes=2)
        out = answers[side] = {}
        try:
            fe = c.fe
            c.beat()
            fe.do_query(RANGE_DDL)
            fe.do_query(_insert_sql("cpu_r", range(8)))
            for sql in ("ADMIN MIGRATE REGION cpu_r 0 TO 2",
                        "ADMIN SPLIT REGION cpu_r 0 AT 'h1'",
                        "ADMIN REBALANCE", "ADMIN ADD REPLICA cpu_r 1 TO 2",
                        "ADMIN REMOVE REPLICA cpu_r 1 FROM 2"):
                got = answer_of(fe, sql)
                if got[0] == "ok":
                    got = ("ok", got[1][0],
                           got[1][1].drop(columns=["op_id"]))
                out[sql] = got
            out["tql"] = answer_of(
                fe, f"TQL EVAL ({T0 // 1000}, {T0 // 1000 + 60}, '15s') "
                    f"sum(cpu_r)")
            out["set"] = answer_of(fe, "SET exact_distinct = 1")
            out["distinct_exact"] = answer_of(
                fe, "EXPLAIN SELECT count(DISTINCT host) FROM cpu_r")
            answer_of(fe, "SET exact_distinct = 0")
            # ADMIN FLUSH TABLE scatters: every region's memtable drains
            fe.do_query("ADMIN FLUSH TABLE cpu_r")
            for dn in c.datanodes.values():
                t = dn.catalog.table("greptime", "public", "cpu_r")
                for region in t.regions.values():
                    v = region.version_control.current
                    assert all(m.num_rows == 0
                               for m in v.memtables.all_memtables())
        finally:
            if side == "port":
                c.fe.shutdown()
            c.close()
    port, ref = answers["port"], answers["ref"]
    for key, want in ref.items():
        got = port[key]
        if key in ("tql", "set"):
            assert_same(got, want, P_ABS, key)
        elif want[0] == "ok" and key.startswith("ADMIN"):
            assert got[0] == "ok" and got[1] == want[1], (key, got, want)
            pd.testing.assert_frame_equal(got[2], want[2])
        elif want[0] == "ok":
            assert got[0] == "ok" and got[1][0] == want[1][0], key
            pd.testing.assert_frame_equal(got[1][1], want[1][1])
        else:
            assert got == want, key
    assert port["tql"][0] == "ok" and len(port["tql"][1][1]) > 0
    assert port["distinct_exact"][1][1]["plan"][0].startswith(
        "CpuAggregateExec")


def test_frontend_default_device_raises_without_cuda():
    """A DistInstance left on its default device ("cuda") raises on a
    machine without CUDA, as a datanode does."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is usable")
    port = SIDES["port"]
    meta = port.meta.MetaClient(port.meta.MetaSrv(port.meta.MemKv()))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.dist.DistInstance(meta, {})
