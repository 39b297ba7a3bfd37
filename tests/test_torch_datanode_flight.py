"""The datanode as a cluster member: the Arrow Flight datanode plane, node
ids and the heartbeat, held to the reference.

greptimedb_tpu_torch/{servers/flight.py:FlightDatanodeServer,
client/flight.py:FlightDatanodeClient, client/__init__.py,
datanode/instance.py, query/tpu_exec.py:region_moment_frames} against
greptimedb_tpu/'s. Each package runs two datanodes (node ids 1 and 2) on
one data home of its own, each behind its FlightDatanodeServer, on the
CPU (`device="cpu"` for the port). One script (`SCRIPT`) runs for each
of the four pairings of a client package with a server package, on a
table of its own: ping, a RANGE COLUMNS table of four regions created
two on each node, write_region put / delete / bulk, describe, scans
with a projection, a time range, filters and a region subset,
region_moments with and without a subset, a foreign region, flush,
alter, background_jobs, profile, and a second table dropped. Every
pairing must answer as the reference client against the reference
server does: rows, keys, counts, integers and dtypes exactly, float
moments within the float32 bound of tests/test_torch_sql.py
(|port - ref| <= 1e-5 |ref| + 8 eps32 P, P the sum of |x| over the
rows); two clients against one server answer identically, and send
byte-identical region_moments tickets (the plan as query/plan_codec.py
encodes it).

Then the node-scoped state: both packages write the same object keys
under nodes/<id>/; the port's two nodes reopen only their own tables;
the port's node 2 opens the data home the reference's nodes wrote and
answers as the reference's node 2 did. The heartbeat: after the same
writes the port's full DatanodeStat equals the reference's, and a
flush_table mailed on a heartbeat response flushes. The port's
repl_apply and balancer steps answer as the reference's on the same
table (directly and over Flight), a balancer step's failure is acked to
meta, and an open_regions mail without table info is logged and
skipped. Tables stay small (two JAX signatures on the
reference's side).
"""

from __future__ import annotations

import importlib
import json
import logging
import types

import numpy as np
import pandas as pd
import pyarrow.flight as flight
import pytest

EPS32 = 2.0 ** -24
CAT, SCH = "greptime", "public"
T0 = 1_700_000_000_000
HOSTS = [f"h{i}" for i in range(8)]
SAMPLES = 30
#: meta's load_based placement of four regions on two empty nodes
PLACE = {1: [0, 2], 2: [1, 3]}
OWNER = {rn: n for n, rns in PLACE.items() for rn in rns}
DDL = ("CREATE TABLE {t} (host STRING, ts TIMESTAMP TIME INDEX, v DOUBLE, "
       "n BIGINT, PRIMARY KEY(host)) PARTITION BY RANGE COLUMNS (host) ("
       "PARTITION r0 VALUES LESS THAN ('h2'), PARTITION r1 VALUES LESS "
       "THAN ('h4'), PARTITION r2 VALUES LESS THAN ('h6'), PARTITION r3 "
       "VALUES LESS THAN (MAXVALUE))")
DROP_DDL = "CREATE TABLE {t} (host STRING, ts TIMESTAMP TIME INDEX, " \
           "v DOUBLE, PRIMARY KEY(host))"
PLANS = {
    "grouped": "SELECT host, count(*), sum(v), max(v), min(n), sum(n) "
               "FROM {t} GROUP BY host",
    "global": "SELECT count(*), sum(v), max(v), avg(n) FROM {t}",
}
PAIRINGS = [("ref", "ref"), ("ref", "port"), ("port", "ref"),
            ("port", "port")]
#: a table id per client package, so both servers' data homes hold the
#: same ids (and the same object keys under nodes/<id>/)
TABLE_ID = {"ref": 1024, "port": 1025}
DROP_ID = {"ref": 1026, "port": 1027}


def _mods(side):
    pkg = "greptimedb_tpu" if side == "ref" else "greptimedb_tpu_torch"

    def m(name):
        return importlib.import_module(f"{pkg}.{name}")
    return types.SimpleNamespace(
        side=side, datanode=m("datanode.instance"),
        server=m("servers.flight"), client=m("client.flight"),
        local=m("client"), sql=m("sql"), ast=m("sql.ast"),
        statement=m("frontend.statement"), rule=m("partition.rule"),
        splitter=m("partition.splitter"), table=m("table"),
        requests=m("table.requests"), schema=m("datatypes.schema"),
        dt=m("datatypes.data_type"), planner=m("query.planner"),
        tpu_exec=m("query.tpu_exec"), codec=m("query.plan_codec"),
        time=m("common.time"), errors=m("errors"), meta=m("meta"))


SIDES = {side: _mods(side) for side in ("ref", "port")}


def _opts(side, home, node_id):
    kw = {"data_home": home, "node_id": node_id,
          "register_numbers_table": False, "flow_tick_interval_s": 0,
          "self_monitor_interval_s": 0}
    if side == "port":
        kw["device"] = "cpu"
    return SIDES[side].datanode.DatanodeOptions(**kw)


def open_node(side, home, node_id):
    dn = SIDES[side].datanode.DatanodeInstance(_opts(side, home, node_id))
    dn.start()
    return dn


def _rows():
    """The put batch, the keys deleted after it and the bulk batch, from
    one numpy seed; every host at every ts."""
    rng = np.random.default_rng(16)
    host = np.repeat(np.array(HOSTS, dtype=object), SAMPLES)
    ts = np.tile(T0 + np.arange(SAMPLES, dtype=np.int64) * 1000,
                 len(HOSTS))
    put = {"host": host, "ts": ts,
           "v": np.round(rng.random(len(ts)) * 100, 3),
           "n": rng.integers(-50, 50, len(ts)).astype(np.int64)}
    gone = {"host": np.array(["h0", "h3", "h5", "h7"], dtype=object),
            "ts": T0 + np.array([0, 7, 11, 29], dtype=np.int64) * 1000}
    bulk = {"host": host.copy(), "ts": ts + SAMPLES * 1000,
            "v": np.round(rng.random(len(ts)) * 100, 3),
            "n": rng.integers(-50, 50, len(ts)).astype(np.int64)}
    return put, gone, bulk


PUT, GONE, BULK = _rows()
#: the float bound's P: sum of |x| over every row of either field
P_ABS = float(np.abs(PUT["v"]).sum() + np.abs(BULK["v"]).sum() +
              np.abs(PUT["n"]).sum() + np.abs(BULK["n"]).sum())


def _split(m, rule, cols):
    n = len(next(iter(cols.values())))
    return {rn: {k: np.asarray(v)[idx] for k, v in cols.items()}
            for rn, idx in m.splitter.split_rows(rule, cols, n).items()}


def _plan(m, dn, table, sql):
    t = dn.catalog.table(CAT, SCH, table)
    q = m.sql.parse_sql(sql)
    q.where = m.planner.convert_time_literals(q.where, t.schema)
    return m.tpu_exec.plan_for(t, m.planner.analyze(q), q)


def _err(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the type is compared
        return type(e).__name__, str(e).split(". Detail:")[0]
    return None


class _Tickets:
    """A FlightClient that keeps each do_get ticket's bytes."""

    def __init__(self, conn):
        self.conn, self.tickets = conn, []

    def do_get(self, ticket, *a, **k):
        self.tickets.append(bytes(ticket.ticket))
        return self.conn.do_get(ticket, *a, **k)

    def __getattr__(self, name):
        return getattr(self.conn, name)


def run_script(c, s, nodes, servers):
    """SCRIPT for client package `c` against server package `s`'s two
    nodes: {step: result}."""
    m, out = SIDES[c], {}
    t, d = f"t_{c}_{s}", f"d_{c}_{s}"
    clients = {}
    for i in (1, 2):
        cl = m.client.FlightDatanodeClient(servers[i].address, i)
        cl._conn = _Tickets(flight.FlightClient(servers[i].address))
        clients[i] = cl
    out["ping"] = [clients[i].ping() for i in (1, 2)]
    stmt = m.sql.parse_sql(DDL.format(t=t))
    schema, pk = m.statement.build_schema_from_create(stmt)
    rule = m.rule.rule_from_partitions(stmt.partitions)
    for i in (1, 2):
        clients[i].ddl_create_table(m.table.CreateTableRequest(
            t, schema, catalog_name=CAT, schema_name=SCH,
            primary_key_indices=pk, create_if_not_exists=True,
            partitions=stmt.partitions, table_id=TABLE_ID[c],
            assigned_region_numbers=PLACE[i]))
    out["create"] = {i: sorted(nodes[i].catalog.table(CAT, SCH, t).regions)
                     for i in (1, 2)}
    out["put"] = {rn: clients[OWNER[rn]].write_region(
        CAT, SCH, t, rn, part, op="put")
        for rn, part in sorted(_split(m, rule, PUT).items())}
    out["delete"] = {rn: clients[OWNER[rn]].write_region(
        CAT, SCH, t, rn, part, op="delete")
        for rn, part in sorted(_split(m, rule, GONE).items())}
    out["bulk"] = {rn: clients[OWNER[rn]].write_region(
        CAT, SCH, t, rn, part, op="bulk")
        for rn, part in sorted(_split(m, rule, BULK).items())}
    info, got_rule = clients[1].describe_table(CAT, SCH, t)
    doc = info.to_dict()
    doc["meta"].pop("created_on_ms", None)
    out["describe"] = (doc, repr(got_rule),
                       clients[2].describe_table(CAT, SCH, "nope"))
    lo = T0 + 10_000
    ts_range = m.time.TimestampRange(lo, lo + 40_000)
    eq = m.ast.BinaryOp("=", m.ast.Column("host"),
                        m.ast.Literal("h5", "string"))
    ne = m.ast.BinaryOp("!=", m.ast.Column("host"),
                        m.ast.Literal("h1", "string"))
    scans = {}
    for i in (1, 2):
        for label, kw in (
                ("all", {}), ("projection", {"projection": ["host", "v"]}),
                ("time_range", {"time_range": ts_range}),
                ("filter_eq", {"filters": [eq]}),
                ("filter_ne", {"filters": [ne], "projection": ["n"]}),
                ("region", {"regions": [PLACE[i][1]]}),
                ("limit", {"limit": 5, "regions": [PLACE[i][0]]})):
            batches = clients[i].scan_batches(CAT, SCH, t, **kw)
            rows = sorted(tuple(r) for b in batches for r in b.rows())
            names = [b.schema.names() for b in batches[:1]]
            scans[(i, label)] = (names, rows)
    out["scan"] = scans
    tickets, frames = {}, {}
    for name, sql in PLANS.items():
        for i in (1, 2):
            plan = _plan(m, nodes[i], t, sql.format(t=t))
            for label, regions in (("all", None),
                                   ("subset", [PLACE[i][1]])):
                n0 = len(clients[i]._conn.tickets)
                frames[(name, i, label)] = clients[i].region_moments(
                    CAT, SCH, t, plan, regions=regions)
                tickets[(name, i, label)] = clients[i]._conn.tickets[n0]
    out["moments"] = frames
    out["tickets"] = tickets
    plan = _plan(m, nodes[1], t, PLANS["grouped"].format(t=t))
    out["stale"] = [_err(lambda i=i: clients[i].region_moments(
        CAT, SCH, t, plan, regions=[PLACE[3 - i][0]])) for i in (1, 2)]
    for i in (1, 2):
        clients[i].flush_table(CAT, SCH, t)
    out["flush"] = {i: clients[i].region_moments(CAT, SCH, t, _plan(
        m, nodes[i], t, PLANS["grouped"].format(t=t))) for i in (1, 2)}
    col = m.schema.ColumnSchema("w", m.dt.FLOAT64)
    for i in (1, 2):
        clients[i].ddl_alter_table(m.requests.AlterTableRequest(
            t, m.requests.AlterKind.ADD_COLUMNS, catalog_name=CAT,
            schema_name=SCH,
            add_columns=[m.requests.AddColumnRequest(col)]))
    out["alter"] = [clients[i].describe_table(CAT, SCH, t)[0]
                    .meta.schema.names() for i in (1, 2)]
    jobs = clients[1].background_jobs()
    out["jobs"] = (type(jobs).__name__, sorted({k for r in jobs for k in r}),
                   clients[2].profile(drain=True),
                   clients[2].profile(seconds=0.01))
    ds = m.sql.parse_sql(DROP_DDL.format(t=d))
    schema, pk = m.statement.build_schema_from_create(ds)
    clients[1].ddl_create_table(m.table.CreateTableRequest(
        d, schema, catalog_name=CAT, schema_name=SCH,
        primary_key_indices=pk, table_id=DROP_ID[c]))
    n = clients[1].write_region(CAT, SCH, d, 0, {
        "host": ["a"], "ts": [T0], "v": [1.0]})
    out["drop"] = (n, clients[1].ddl_drop_table(CAT, SCH, d),
                   clients[1].describe_table(CAT, SCH, d),
                   _err(lambda: clients[1].write_region(
                       CAT, SCH, d, 0, {"host": ["a"], "ts": [T0],
                                        "v": [1.0]})))
    for cl in clients.values():
        cl.close()
    return out


class _Recorder:
    """A meta client that keeps each heartbeat's stat and answers with
    the mail queued for the node."""

    def __init__(self, side):
        self.side, self.beats, self.mail = side, [], []

    def heartbeat(self, node_id, stat):
        self.beats.append((node_id, stat))
        mail, self.mail = self.mail, []
        return SIDES[self.side].meta.HeartbeatResponse(mailbox=mail)


@pytest.fixture(scope="module")
def plane(tmp_path_factory):
    """Both packages' process-wide trace sink and profiler left out (an
    earlier test's would ride the tickets' verdicts and answer the
    profile action), then `_plane`."""
    saved = []
    for pkg in ("greptimedb_tpu", "greptimedb_tpu_torch"):
        ts = importlib.import_module(f"{pkg}.common.trace_store")
        prof = importlib.import_module(f"{pkg}.common.profiler")
        saved.append((ts, ts.install(None), prof, prof._SAMPLER[0]))
        prof._SAMPLER[0] = None
    try:
        yield _plane(tmp_path_factory)
    finally:
        for ts, sink, prof, sampler in saved:
            ts.install(sink)
            prof._SAMPLER[0] = sampler


def _plane(tmp_path_factory):
    """Both packages' two-node planes; SCRIPT for the four pairings; the
    heartbeats; then every node shut down and the node-scoped reopens."""
    homes = {s: str(tmp_path_factory.mktemp(f"dn_{s}")) for s in SIDES}
    nodes, servers = {}, {}
    for s in SIDES:
        nodes[s] = {i: open_node(s, homes[s], i) for i in (1, 2)}
        servers[s] = {}
        for i in (1, 2):
            srv = SIDES[s].server.FlightDatanodeServer(nodes[s][i])
            srv.serve_in_background()
            servers[s][i] = srv
    res = types.SimpleNamespace(homes=homes, script={}, beats={},
                                flushed={}, keys={}, reopened={})
    try:
        for c, s in PAIRINGS:
            res.script[(c, s)] = run_script(c, s, nodes[s], servers[s])
        for s in SIDES:
            rec = _Recorder(s)
            for i in (1, 2):
                nodes[s][i].start_heartbeat(rec, interval_s=3600,
                                            stats_every=1)
            res.beats[s] = [(i, st.__dict__) for i, st in rec.beats]
            # a row in the memtable of a table of node 2's own, then a
            # mailed flush_table
            dn = nodes[s][2]
            m = SIDES[s]
            stmt = m.sql.parse_sql(DROP_DDL.format(t="f"))
            schema, pk = m.statement.build_schema_from_create(stmt)
            m.local.LocalDatanodeClient(dn).ddl_create_table(
                m.table.CreateTableRequest(
                    "f", schema, catalog_name=CAT, schema_name=SCH,
                    primary_key_indices=pk, table_id=1030))
            table = dn.catalog.table(CAT, SCH, "f")
            table.write_region(0, {"host": ["h2"], "ts": [T0],
                                   "v": [0.5]}, "put")
            region = table.regions[0]
            before = len(region.version_control.current.ssts.all_files())
            rec.mail.append({"type": "flush_table", "catalog": CAT,
                             "schema": SCH, "table": "f"})
            dn._heartbeat_task.fn()
            res.flushed[s] = (before, len(
                region.version_control.current.ssts.all_files()))
    finally:
        for s in SIDES:
            for srv in servers[s].values():
                srv.shutdown()
            for dn in nodes[s].values():
                dn.shutdown()
    for s in SIDES:
        store = open_node(s, homes[s], 1)
        try:
            res.keys[s] = sorted(store.store.list("nodes/"))
        finally:
            store.shutdown()
    # the port's nodes reopen their own tables; node 0 sees none of them
    for i in (0, 1, 2):
        dn = open_node("port", homes["port"], i)
        try:
            res.reopened[("port", i)] = {
                name: sorted(dn.catalog.table(CAT, SCH, name).regions)
                for name in dn.catalog.table_names(CAT, SCH)}
        finally:
            dn.shutdown()
    # the port's node 2 on the reference's data home
    dn = open_node("port", homes["ref"], 2)
    try:
        m = SIDES["port"]
        local = m.local.LocalDatanodeClient(dn)
        res.cross = {name: {
            "regions": sorted(dn.catalog.table(CAT, SCH, name).regions),
            "frames": local.region_moments(
                CAT, SCH, name, _plan(m, dn, name,
                                      PLANS["grouped"].format(t=name)))}
            for name in ("t_ref_ref", "t_port_ref")}
    finally:
        dn.shutdown()
    return res


def same_frames(got, want, exact=False):
    """Moment frames: columns, dtypes, keys and integer moments exact;
    float moments equal (`exact`) or within the float32 bound."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g.columns) == list(w.columns)
        assert [str(x) for x in g.dtypes] == [str(x) for x in w.dtypes]
        assert len(g) == len(w)
        for col in w.columns:
            gv, wv = g[col].to_numpy(), w[col].to_numpy()
            if wv.dtype.kind == "f" and not exact:
                bound = 1e-5 * np.abs(wv) + 8 * EPS32 * P_ABS
                assert (np.abs(gv - wv) <= bound).all(), (col, gv, wv)
            else:
                assert (gv == wv).all(), (col, gv, wv)


# ---------------------------------------------------------------------------
# the four pairings, step by step
# ---------------------------------------------------------------------------

STEPS = ["ping", "create", "put", "delete", "bulk", "describe", "scan",
         "moments", "stale", "flush", "alter", "jobs", "drop"]


@pytest.mark.parametrize("pairing", PAIRINGS[1:],
                         ids=lambda p: f"{p[0]}-client-{p[1]}-server")
@pytest.mark.parametrize("step", STEPS)
def test_pairing_answers_as_the_reference(plane, step, pairing):
    got, want = plane.script[pairing][step], plane.script[("ref", "ref")][
        step]
    same_server = pairing[1] == "ref"
    if step == "moments":
        assert got.keys() == want.keys()
        for key in want:
            same_frames(got[key], want[key], exact=same_server)
    elif step == "flush":
        for i in (1, 2):
            same_frames(got[i], want[i], exact=same_server)
    elif step == "describe":
        (doc, rule, none), (wdoc, wrule, wnone) = got, want
        assert {**doc, "name": "t", "table_id": 0} == \
            {**wdoc, "name": "t", "table_id": 0}
        assert (rule, none) == (wrule, wnone)
    elif step == "scan":
        assert got.keys() == want.keys()
        for key in want:
            assert got[key] == want[key], key
    elif step in ("stale", "drop"):
        norm = json.loads(json.dumps(got).replace(
            f"t_{pairing[0]}_{pairing[1]}", "t").replace(
            f"d_{pairing[0]}_{pairing[1]}", "d"))
        assert norm == json.loads(json.dumps(want).replace(
            "t_ref_ref", "t").replace("d_ref_ref", "d"))
    else:
        assert got == want


def test_script_reaches_every_path(plane):
    """The reference pairing's own answers: placement, counts, subsets,
    stale routes and the drop."""
    out = plane.script[("ref", "ref")]
    assert out["ping"] == [1, 2]
    assert out["create"] == PLACE
    assert sum(out["put"].values()) == len(PUT["ts"])
    assert sum(out["delete"].values()) == len(GONE["ts"])
    assert sum(out["bulk"].values()) == len(BULK["ts"])
    for i in (1, 2):
        assert len(out["moments"][("grouped", i, "all")]) == 2
        assert len(out["moments"][("grouped", i, "subset")]) == 1
        assert out["moments"][("grouped", i, "subset")][0].equals(
            out["moments"][("grouped", i, "all")][1])
        assert out["scan"][(i, "limit")][1].__len__() == 5
    assert [e[0] for e in out["stale"]] == ["StaleRouteError"] * 2
    assert out["alter"][0][-1] == "w"
    assert out["drop"][:3] == (1, True, None)


@pytest.mark.parametrize("server", ["ref", "port"])
def test_region_moments_tickets_are_byte_identical(plane, server):
    """The reference client and the port's send the same ticket bytes
    for the same statement (table names aside), plan included."""
    ref = plane.script[("ref", server)]["tickets"]
    port = plane.script[("port", server)]["tickets"]
    assert ref.keys() == port.keys()
    for key in ref:
        assert ref[key].replace(f'"t_ref_{server}"'.encode(), b'"T"') == \
            port[key].replace(f'"t_port_{server}"'.encode(), b'"T"'), key
        plan = json.loads(port[key])["plan"]
        back = SIDES["port"].codec.plan_from_dict(plan)
        assert SIDES["port"].codec.plan_to_dict(back) == plan


@pytest.mark.parametrize("pairing", PAIRINGS,
                         ids=lambda p: f"{p[0]}-client-{p[1]}-server")
def test_foreign_region_raises_stale_route(plane, pairing):
    got = plane.script[pairing]["stale"]
    assert [g[0] for g in got] == ["StaleRouteError"] * 2
    assert all("stale route" in g[1] for g in got)


# ---------------------------------------------------------------------------
# node-scoped state
# ---------------------------------------------------------------------------

def test_node_scoped_object_keys_match_reference(plane):
    keys = plane.keys
    assert keys["port"] == keys["ref"]
    for i in (1, 2):
        assert f"nodes/{i}/catalog/system.json" in keys["port"]
        assert f"nodes/{i}/mito/engine.json" in keys["port"]
        assert f"nodes/{i}/mito/greptime/public/1025/manifest.json" in \
            keys["port"]


def test_port_nodes_reopen_only_their_own_tables(plane):
    names = {f"t_{c}_port" for c in SIDES}
    for i in (1, 2):
        # node 2 also keeps the table of the mailed flush
        extra = {"f": [0]} if i == 2 else {}
        assert plane.reopened[("port", i)] == \
            {**{n: PLACE[i] for n in names}, **extra}
    assert not names & set(plane.reopened[("port", 0)])


def test_port_node_opens_reference_node_home(plane):
    """The port's node 2 over the reference's data home hosts the
    reference's node 2's regions and answers its grouped moments as the
    reference's node 2 did (after the flush)."""
    for c in SIDES:
        got = plane.cross[f"t_{c}_ref"]
        assert got["regions"] == PLACE[2]
        same_frames(got["frames"], plane.script[(c, "ref")]["flush"][2])


# ---------------------------------------------------------------------------
# heartbeats and the mailbox
# ---------------------------------------------------------------------------

def test_heartbeat_stat_matches_reference(plane):
    ref, port = plane.beats["ref"], plane.beats["port"]
    assert [i for i, _ in port] == [i for i, _ in ref] == [1, 2]
    for (_, p), (_, r) in zip(port, ref):
        assert p == r
        assert p["full"] and p["region_count"] == 4
        assert len(p["region_stats"]) == 4


@pytest.mark.parametrize("side", ["ref", "port"])
def test_mailed_flush_table_flushes(plane, side):
    before, after = plane.flushed[side]
    assert after == before + 1


# ---------------------------------------------------------------------------
# the elastic regions' datanode steps, against the reference's
# ---------------------------------------------------------------------------

def _node_with_table(side, home):
    dn = open_node(side, home, 1)
    m = SIDES[side]
    stmt = m.sql.parse_sql(DDL.format(t="t"))
    schema, pk = m.statement.build_schema_from_create(stmt)
    m.local.LocalDatanodeClient(dn).ddl_create_table(
        m.table.CreateTableRequest(
            "t", schema, catalog_name=CAT, schema_name=SCH,
            primary_key_indices=pk, partitions=stmt.partitions,
            table_id=1024, assigned_region_numbers=[0, 1, 2, 3]))
    dn.catalog.table(CAT, SCH, "t").insert(
        {k: list(v) for k, v in PUT.items()})
    return dn


@pytest.fixture()
def port_node(tmp_path):
    dn = _node_with_table("port", str(tmp_path / "port"))
    yield dn
    dn.shutdown()


@pytest.fixture()
def ref_node(tmp_path):
    dn = _node_with_table("ref", str(tmp_path / "ref"))
    yield dn
    dn.shutdown()


def _outcome(fn):
    """A step's answer, or its error's class name."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — each package's own class
        return ("error", type(e).__name__)


def test_repl_apply_names_h4(port_node, ref_node):
    """repl_apply to a region that is no standby (a late ship from a
    deposed leader) is ignored alike in both packages, in process and
    over each package's Flight server."""
    answers = {}
    for side, dn in (("port", port_node), ("ref", ref_node)):
        m = SIDES[side]
        local = m.local.LocalDatanodeClient(dn).repl_apply(
            CAT, SCH, "t", 0, [])
        srv = m.server.FlightDatanodeServer(dn)
        serving = srv.serve_in_background()
        try:
            client = m.client.FlightDatanodeClient(srv.address, 1)
            wire = client.repl_apply(CAT, SCH, "t", 0, [], leader_flushed=3)
            client.close()
        finally:
            srv.shutdown()
            if serving is not None:
                serving.join(60)
        answers[side] = (local, wire)
    assert answers["port"] == answers["ref"]
    assert answers["port"][0]["standby"] is False


def test_balancer_step_failure_is_acked_through_meta(port_node):
    """A migrate's first step fails on the port's datanode (the
    `balancer_snapshot_upload` failpoint); the ack reaches meta, whose
    next tick rolls the operation back as for any failed step."""
    m = SIDES["port"]
    fp = importlib.import_module("greptimedb_tpu_torch.common.failpoint")
    srv = m.meta.MetaSrv(m.meta.MemKv())
    client = m.meta.MetaClient(srv)
    port_node.start_heartbeat(client, interval_s=3600)
    srv.handle_heartbeat(2, None)
    route = srv.create_table_route("greptime.public.t", [0, 1, 2, 3])
    region = route.regions_on(1)[0]
    op = srv.admin_migrate_region("greptime.public.t", region, 2)
    fp.configure("balancer_snapshot_upload", "err")
    try:
        srv.balancer.tick()
        port_node._heartbeat_task.fn()   # the step rides this response
    finally:
        fp.configure("balancer_snapshot_upload", None)
    srv.balancer.tick()
    done = srv.balancer.op(op["id"])
    assert done["state"] == "failed"
    assert "balancer_snapshot_upload" in done["error"]
    assert srv.balancer.ops() == []


@pytest.mark.parametrize("kind", ["balancer_fence", "balancer_open",
                                  "balancer_split_prepare", "repl_attach",
                                  "repl_promote"])
def test_balancer_steps_name_h4(port_node, ref_node, kind):
    """Each step answers as the reference's on the same table: the
    fence's WAL tail, the split probe's median, a promotion of a region
    that already leads, and the same error where the message lacks what
    the step needs (the table info of an open or attach)."""
    msg = {"type": kind, "catalog": CAT, "schema": SCH, "table": "t",
           "region": 0}
    got = _outcome(lambda: port_node._balancer_step(dict(msg)))
    want = _outcome(lambda: ref_node._balancer_step(dict(msg)))
    assert got == want, (kind, got, want)


def test_open_regions_is_logged(port_node, caplog):
    """An open_regions mail without table info is logged and skipped, as
    in the reference; with it, the node adopts the regions
    (tests/test_torch_failover.py holds adoption to the reference)."""
    msg = {"type": "open_regions", "catalog": CAT, "schema": SCH,
           "table": "t", "region_numbers": [5]}
    with caplog.at_level(logging.ERROR,
                         logger="greptimedb_tpu_torch.datanode.instance"):
        port_node._handle_mailbox(msg)
    assert any("without table info" in r.getMessage()
               for r in caplog.records)
    assert not any("h4" in r.getMessage() for r in caplog.records)
    table = port_node.catalog.table(CAT, SCH, "t")
    assert sorted(table.regions) == [0, 1, 2, 3]
    port_node._handle_mailbox({**msg, "table_info": table.info.to_dict()})
    assert sorted(port_node.catalog.table(CAT, SCH, "t").regions) == \
        [0, 1, 2, 3, 5]


def test_live_datanode_registry(port_node):
    m = SIDES["port"]
    assert m.datanode.live_datanode(1) is port_node
    assert m.datanode.live_datanode(None) is None
    assert m.datanode.live_datanode(7) is None


def test_node_scoped_wal_home(tmp_path):
    """A non-zero node id puts the WAL under nodes/<id>/wal and the
    control state under nodes/<id>/; node 0 keeps the standalone
    layout, as in the reference."""
    got = {}
    for s in SIDES:
        for i in (0, 3):
            dn = open_node(s, str(tmp_path / s), i)
            got[(s, i)] = (dn.storage.wal_home, dn.state_prefix,
                           dn.procedure_manager._prefix)
            dn.shutdown()
    for i in (0, 3):
        ref = tuple(str(x).replace(str(tmp_path / "ref"), "H")
                    for x in got[("ref", i)])
        port = tuple(str(x).replace(str(tmp_path / "port"), "H")
                     for x in got[("port", i)])
        assert port == ref
    assert got[("port", 3)][1] == "nodes/3/"


def test_kernel_launches_ride_the_stats():
    """A wrapper's launches count on the active ExecStats and cross the
    wire in its to_dict() under `launches` (only when a kernel launched,
    so a CPU node's stats keep the reference's keys); either package's
    absorb reads the rest alike."""
    port = importlib.import_module("greptimedb_tpu_torch.common.exec_stats")
    ref = importlib.import_module("greptimedb_tpu.common.exec_stats")
    with port.collect() as st:
        port.record("reduce", rows=5, elapsed_s=0.001)
        assert "launches" not in st.to_dict()
        port.count_launch("segment_moments")
        port.count_launch("segment_moments")
        port.count_launch("counts_leq_grid")
    port.count_launch("segment_moments")          # no collector: a no-op
    d = json.loads(json.dumps(st.to_dict()))
    assert d["launches"] == {"segment_moments": 2, "counts_leq_grid": 1}
    got, want = port.ExecStats(), ref.ExecStats()
    got.absorb(d)
    got.absorb(d)
    want.absorb(d)
    assert got.launches == {"segment_moments": 4, "counts_leq_grid": 2}
    once = port.ExecStats()
    once.absorb(d)
    out = once.to_dict()
    assert out.pop("launches") == d["launches"]
    assert out == want.to_dict()
