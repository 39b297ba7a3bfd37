"""Region failover on the port (meta's failover_check, the open_regions
mail, greptimedb_tpu_torch/mito/engine.py:adopt_regions and the
datanode's handler) held to the reference.

The reference's tests/test_failover.py scenarios, driven without a
distributed frontend: a table's route comes from meta, its regions are
created on the nodes meta placed them on, rows go in through
`LocalDatanodeClient.write_region` and answers come back as
`region_moments` frames, folded as a frontend folds them. Two datanodes
share one object store (node-scoped WAL and control state); node 2
falls silent, meta moves its regions to node 1 and mails it
open_regions on its next heartbeat, and node 1 adopts them at their
last-flushed state:

- regions move and their flushed data survives;
- the unflushed tail on the dead node is lost, by design;
- nothing moves while every node beats, or when no node is alive;
- a restarted metasrv gives persisted peers a grace period;
- a node that never saw the table adopts it from meta's table info,
  and keeps it across its own restart.

Each scenario runs on both packages (the port's datanodes on
`device="cpu"`), and the port's moment frames and folded answers after
adoption must be the reference's: counts exactly, float sums within the
float32 bound (the values here are multiples of 1/8, so the sums are
exact). A port datanode also adopts regions that the reference's
datanodes wrote, on the reference meta's mail, and answers as they did.
"""

from __future__ import annotations

import importlib
import json
import time
import types

import numpy as np
import pandas as pd
import pytest

CAT, SCH = "greptime", "public"
DDL = ("CREATE TABLE {t} (host STRING, ts TIMESTAMP TIME INDEX, v DOUBLE, "
       "PRIMARY KEY(host)) PARTITION BY RANGE COLUMNS (host) ("
       "PARTITION r0 VALUES LESS THAN ('h5'), "
       "PARTITION r1 VALUES LESS THAN (MAXVALUE))")
SOLO_DDL = ("CREATE TABLE {t} (host STRING, ts TIMESTAMP TIME INDEX, "
            "v DOUBLE, PRIMARY KEY(host))")
QUERY = "SELECT count(*) AS c, sum(v) AS s FROM {t}"
BY_HOST = "SELECT host, count(*) AS c, sum(v) AS s FROM {t} GROUP BY host"


def _mods(side):
    pkg = "greptimedb_tpu" if side == "ref" else "greptimedb_tpu_torch"

    def m(name):
        return importlib.import_module(f"{pkg}.{name}")
    return types.SimpleNamespace(
        side=side, datanode=m("datanode.instance"), local=m("client"),
        meta=m("meta"), kv=m("meta.kv"), sql=m("sql"),
        statement=m("frontend.statement"), rule=m("partition.rule"),
        splitter=m("partition.splitter"), table=m("table"),
        metadata=m("table.metadata"), mito=m("mito.engine"),
        store=m("storage.object_store"), planner=m("query.planner"),
        tpu_exec=m("query.tpu_exec"))


SIDES = {side: _mods(side) for side in ("ref", "port")}


def _opts(m, home, node_id):
    kw = {"data_home": home, "node_id": node_id,
          "register_numbers_table": False, "flow_tick_interval_s": 0,
          "self_monitor_interval_s": 0}
    if m.side == "port":
        kw["device"] = "cpu"
    return m.datanode.DatanodeOptions(**kw)


class Cluster:
    """Meta, and datanodes over one shared object store, driven through
    meta routes and LocalDatanodeClient (no distributed frontend)."""

    def __init__(self, m, root, nodes=(1, 2)):
        self.m, self.root = m, root
        self.shared = m.store.FsObjectStore(str(root / "shared_store"))
        self.srv = m.meta.MetaSrv(m.kv.MemKv(), datanode_lease_secs=5.0)
        self.meta = m.meta.MetaClient(self.srv)
        self.dns, self.clients, self.rules = {}, {}, {}
        for i in nodes:
            self.add_node(i)

    def add_node(self, i, beat=True):
        m = self.m
        dn = m.datanode.DatanodeInstance(
            _opts(m, str(self.root / f"wal{i}"), i), store=self.shared)
        dn.start()
        self.dns[i] = dn
        self.clients[i] = m.local.LocalDatanodeClient(dn)
        self.srv.register_datanode(m.meta.Peer(i, f"dn{i}"))
        if beat:
            self.srv.handle_heartbeat(i)
        return dn

    def create(self, t, ddl=DDL):
        """meta places the regions, each node creates its share, and the
        table info rides with the route (what failover ships)."""
        m = self.m
        stmt = m.sql.parse_sql(ddl.format(t=t))
        schema, pk = m.statement.build_schema_from_create(stmt)
        rule = m.rule.rule_from_partitions(stmt.partitions) \
            if stmt.partitions is not None else None
        numbers = rule.region_numbers() if rule is not None else [0]
        full = f"{CAT}.{SCH}.{t}"
        route = self.meta.create_route(full, numbers)
        for peer in route.peers():
            self.clients[peer.id].ddl_create_table(m.table.CreateTableRequest(
                t, schema, catalog_name=CAT, schema_name=SCH,
                primary_key_indices=pk, create_if_not_exists=True,
                partitions=stmt.partitions, table_id=route.table_id,
                assigned_region_numbers=route.regions_on(peer.id)))
        md = m.metadata
        info = md.TableInfo(
            ident=md.TableIdent(route.table_id), name=t,
            meta=md.TableMeta(schema=schema, primary_key_indices=pk,
                              engine="mito", region_numbers=list(numbers),
                              next_column_id=len(schema), options={},
                              partition_rule=m.mito._serialize_rule(rule)),
            catalog_name=CAT, schema_name=SCH)
        self.meta.put_table_info(full, info.to_dict())
        self.rules[t] = rule
        return route

    def owners(self, t):
        route = self.meta.route(f"{CAT}.{SCH}.{t}")
        return {rr.region_number: rr.leader.id for rr in route.region_routes}

    def insert(self, t, hosts, ts, v):
        cols = {"host": np.array(hosts, dtype=object),
                "ts": np.asarray(ts, dtype=np.int64),
                "v": np.asarray(v, dtype=np.float64)}
        rule, owner = self.rules[t], self.owners(t)
        parts = self.m.splitter.split_rows(rule, cols, len(hosts)) \
            if rule is not None else {0: np.arange(len(hosts))}
        return sum(self.clients[owner[rn]].write_region(
            CAT, SCH, t, rn, {k: c[idx] for k, c in cols.items()})
            for rn, idx in parts.items())

    def flush(self, t):
        for i in set(self.owners(t).values()):
            self.clients[i].flush_table(CAT, SCH, t)

    def frames(self, t, sql=QUERY, nodes=None):
        """Each owning node's region moment frames, by region number."""
        owner = self.owners(t)
        out = {}
        for i in sorted(set(owner.values()) if nodes is None else nodes):
            mine = sorted(rn for rn, n in owner.items() if n == i)
            plan = self._plan(i, t, sql)[0]
            got = self.clients[i].region_moments(CAT, SCH, t, plan,
                                                 regions=mine)
            out.update(zip(mine, got))
        return out

    def _plan(self, i, t, sql):
        m = self.m
        table = self.dns[i].catalog.table(CAT, SCH, t)
        q = m.sql.parse_sql(sql.format(t=t))
        a = m.planner.analyze(q)
        return m.tpu_exec.plan_for(table, a, q), a, q, table

    def answer(self, t, sql=QUERY):
        """The folded answer, as a frontend folds the nodes' frames."""
        frames = self.frames(t, sql)
        i = min(self.owners(t).values())
        plan, a, q, table = self._plan(i, t, sql)
        merged = self.m.tpu_exec._finalize(
            pd.concat(list(frames.values()), ignore_index=True), plan)
        out = self.dns[i].query_engine._finish_aggregate_frame(
            merged, a, q, table)
        rows = [tuple(r) for b in out.batches for r in b.rows()] \
            if hasattr(out, "batches") else \
            [tuple(r) for r in out.itertuples(index=False)]
        return sorted(rows)

    def beat_regularly(self, node_id, t0, until, step=1.0):
        t = t0
        while t < until:
            self.srv.handle_heartbeat(node_id, now=t)
            t += step

    def deliver(self, node_id, now):
        """The node's next heartbeat, and its mailbox run."""
        resp = self.srv.handle_heartbeat(node_id, now=now)
        for msg in resp.mailbox:
            self.dns[node_id]._handle_mailbox(msg)
        return [msg["type"] for msg in resp.mailbox]

    def close(self):
        for dn in self.dns.values():
            dn.shutdown()


@pytest.fixture()
def clusters(tmp_path):
    made = {s: Cluster(m, tmp_path / s) for s, m in SIDES.items()}
    yield made
    for c in made.values():
        c.close()


def _same(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        assert list(g.columns) == list(w.columns)
        assert [str(x) for x in g.dtypes] == [str(x) for x in w.dtypes]
        pd.testing.assert_frame_equal(g.reset_index(drop=True),
                                      w.reset_index(drop=True))


ROWS = ([f"h{i}" for i in range(10)], [1000 + i for i in range(10)],
        [i / 8 for i in range(10)])


def test_regions_move_and_data_survives(clusters):
    out = {}
    for side, c in clusters.items():
        c.create("ha")
        c.insert("ha", *ROWS)
        c.flush("ha")
        before = c.frames("ha")
        assert set(c.owners("ha").values()) == {1, 2}
        t0 = time.time()
        c.beat_regularly(1, t0, t0 + 30)
        c.beat_regularly(2, t0, t0 + 3)
        moves = c.srv.failover_check(now=t0 + 29)
        assert moves and all(mv["from"] == 2 and mv["to"] == 1
                             for mv in moves)
        mail = c.deliver(1, t0 + 30)
        assert mail == ["open_regions"]
        assert set(c.owners("ha").values()) == {1}
        after = c.frames("ha", nodes=[1])
        _same(after, before)
        out[side] = (moves, sorted(c.dns[1].catalog.table(
            CAT, SCH, "ha").regions), c.answer("ha"),
            c.answer("ha", BY_HOST), after)
    assert out["port"][2] == [(10, sum(ROWS[2]))]
    assert out["port"][:4] == out["ref"][:4]
    _same(out["port"][4], out["ref"][4])


def test_unflushed_tail_lost_by_design(clusters):
    out = {}
    for side, c in clusters.items():
        c.create("ha")
        c.insert("ha", ["h7", "h8"], [1, 2], [1.0, 2.0])
        c.flush("ha")
        c.insert("ha", ["h9"], [3], [3.0])
        t0 = time.time()
        c.beat_regularly(1, t0, t0 + 30)
        c.srv.failover_check(now=t0 + 29)
        c.deliver(1, t0 + 30)
        out[side] = (c.answer("ha"), c.frames("ha", nodes=[1]))
    assert out["port"][0] == [(2, 3.0)]
    assert out["port"][0] == out["ref"][0]
    _same(out["port"][1], out["ref"][1])


def test_noop_when_all_alive(clusters):
    for c in clusters.values():
        c.create("ha")
        t0 = time.time()
        c.beat_regularly(1, t0, t0 + 10)
        c.beat_regularly(2, t0, t0 + 10)
        assert c.srv.failover_check(now=t0 + 10) == []
        assert c.deliver(1, t0 + 10) == []


def test_no_alive_targets_is_noop(clusters):
    for c in clusters.values():
        c.create("ha")
        owners = c.owners("ha")
        assert c.srv.failover_check(now=time.time() + 3600) == []
        assert c.owners("ha") == owners


def test_metasrv_restart_grace_period(tmp_path):
    """After a metasrv restart, persisted peers get a grace window of
    twice the lease before failover: the same moves on both packages."""
    out = {}
    for side, m in SIDES.items():
        kv = m.kv.FileKv(str(tmp_path / f"{side}.kv"))
        srv1 = m.meta.MetaSrv(kv, datanode_lease_secs=5.0)
        srv1.register_datanode(m.meta.Peer(1, "dn1"))
        srv1.register_datanode(m.meta.Peer(2, "dn2"))
        t0 = time.time()
        srv1.handle_heartbeat(1, now=t0)
        srv1.handle_heartbeat(2, now=t0)
        route = srv1.create_table_route(f"{CAT}.{SCH}.t", [0, 1], now=t0)
        srv1.put_table_info(f"{CAT}.{SCH}.t", {"stub": True})
        srv2 = m.meta.MetaSrv(kv, datanode_lease_secs=5.0)
        t1 = srv2._start_time
        srv2.handle_heartbeat(1, now=t1)
        got = [sorted(p.id for p in srv2.peers()),
               srv2.failover_check(now=t1 + 1)]
        srv2.handle_heartbeat(2, now=t1 + 2)
        for n in (1, 2):
            t = t1
            while t < t1 + 15:
                srv2.handle_heartbeat(n, now=t)
                t += 1.0
        got.append(srv2.failover_check(now=t1 + 15))
        srv3 = m.meta.MetaSrv(kv, datanode_lease_secs=5.0)
        t2 = srv3._start_time
        t = t2
        while t < t2 + 12:
            srv3.handle_heartbeat(1, now=t)
            t += 1.0
        got.append(srv3.failover_check(now=t2 + 12))
        got.append(sorted(rr.leader.id for rr in route.region_routes))
        out[side] = got
    assert out["port"] == out["ref"]
    assert out["port"][1] == [] and out["port"][2] == []
    assert out["port"][3] and all(mv["from"] == 2 and mv["to"] == 1
                                  for mv in out["port"][3])


def test_adopting_node_that_never_saw_the_table(tmp_path):
    """Node 3 starts after the DDL, adopts the lone region of node 1 from
    meta's table info, and still hosts it after its own restart."""
    out = {}
    for side, m in SIDES.items():
        c = Cluster(m, tmp_path / side, nodes=(1,))
        try:
            c.create("solo", SOLO_DDL)
            c.insert("solo", ["a", "b"], [1, 2], [1.5, 0.125])
            c.flush("solo")
            before = c.frames("solo")
            c.add_node(3, beat=False)
            assert c.dns[3].catalog.table(CAT, SCH, "solo") is None
            t0 = time.time()
            c.beat_regularly(3, t0, t0 + 30)
            moves = c.srv.failover_check(now=t0 + 29)
            assert moves and moves[0]["to"] == 3
            assert c.deliver(3, t0 + 30) == ["open_regions"]
            after = c.frames("solo")
            _same(after, before)
            answer = c.answer("solo")
            c.dns.pop(3).shutdown()
            c.add_node(3)
            reopened = sorted(c.dns[3].catalog.table(
                CAT, SCH, "solo").regions)
            out[side] = (answer, reopened, c.answer("solo"), after)
        finally:
            c.close()
    assert out["port"][0] == [(2, 1.625)]
    assert out["port"][:3] == out["ref"][:3]
    _same(out["port"][3], out["ref"][3])


def _doc(raw):
    """A stored document without its creation time (the wall clock)."""
    doc = json.loads(raw) if isinstance(raw, bytes) else dict(raw)
    if "meta" in doc:
        doc["meta"] = {k: v for k, v in doc["meta"].items()
                       if k != "created_on_ms"}
    return doc


def test_adopted_table_manifest_matches_reference(tmp_path):
    """adopt_regions writes the same table manifest and registry on both
    packages for a node that never saw the table."""
    docs = {}
    for side, m in SIDES.items():
        c = Cluster(m, tmp_path / side, nodes=(1,))
        try:
            c.create("solo", SOLO_DDL)
            c.add_node(4, beat=False)
            info = c.meta.table_info(f"{CAT}.{SCH}.solo")
            table = c.dns[4].mito.adopt_regions(info, [0])
            again = c.dns[4].mito.adopt_regions(info, [0])
            assert again is table
            keys = sorted(k for k in c.shared.list("nodes/4/")
                          if "mito" in k)
            docs[side] = (keys, [_doc(c.shared.read(k)) for k in keys],
                          sorted(table.regions), _doc(table.info.to_dict()))
        finally:
            c.close()
    assert docs["port"] == docs["ref"]


def test_port_node_adopts_reference_regions(tmp_path):
    """The reference's two nodes write and flush, then fall silent; a
    port datanode on the same object store, mailed open_regions by the
    reference's meta, adopts every region and answers with the
    reference's frames."""
    ref, port = SIDES["ref"], SIDES["port"]
    c = Cluster(ref, tmp_path)
    try:
        c.create("ha")
        c.insert("ha", *ROWS)
        c.flush("ha")
        want = c.frames("ha")
        owner = c.owners("ha")
        dn = port.datanode.DatanodeInstance(
            _opts(port, str(tmp_path / "wal5"), 5), store=c.shared)
        dn.start()
        try:
            c.srv.register_datanode(ref.meta.Peer(5, "dn5"))
            t0 = time.time()
            c.beat_regularly(5, t0, t0 + 30)
            moves = c.srv.failover_check(now=t0 + 29)
            resp = c.srv.handle_heartbeat(5, now=t0 + 30)
            for msg in resp.mailbox:
                dn._handle_mailbox(msg)
            took = sorted(mv["region"] for mv in moves if mv["to"] == 5)
            assert took == sorted(owner)
            table = dn.catalog.table(CAT, SCH, "ha")
            assert sorted(table.regions) == took
            q = port.sql.parse_sql(QUERY.format(t="ha"))
            plan = port.tpu_exec.plan_for(table, port.planner.analyze(q), q)
            got = port.local.LocalDatanodeClient(dn).region_moments(
                CAT, SCH, "ha", plan)
            _same(dict(zip(took, got)), {rn: want[rn] for rn in took})
        finally:
            dn.shutdown()
    finally:
        c.close()
