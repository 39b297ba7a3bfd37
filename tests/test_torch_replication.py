"""Read replicas, the JAX package's scenarios run against both packages, on
the CPU.

tests/test_replication.py drives per-region read replicas through
in-process clusters whose datanodes share one data home: ADMIN ADD /
REMOVE REPLICA (the balancer's replica_add / replica_remove operations),
continuous WAL-tail shipping (datanode/replication.py's ReplicaShipper
into the follower's `repl_apply`), reads routed to lag-bounded followers
(`SET read_replica = 'follower'`), the promotion of the most caught-up
follower when a leader dies (salvaging the dead leader's WAL: no acked
row lost or duplicated), a resurrected old leader fenced, a meta restart
mid-bootstrap, and the torture cases that crash or fail the bootstrap,
a ship, an apply and a promotion. This file runs every one of those
scenarios twice, `[ref]` on the JAX package and `[port]` on
greptimedb_tpu_torch (tests/test_torch_balancer.py's `load_scenarios`:
the same source with the package name swapped, on "cpu"), and the
scenario's own assertions decide.

Then mixed clusters over Flight (`test_mixed_leader_ships_and_promotes`):
a port leader ships its WAL tail to a reference follower, and the
reverse; the follower answers a replica read with the leader's rows;
the leader is killed with an acked tail it never shipped, the follower
is promoted across packages (reading the dead leader's WAL), and every
acknowledged row is read back exactly once. About 15 s here.
"""

from __future__ import annotations

import importlib

import pytest

from test_torch_balancer import (
    MixedCluster, _Fixture, _pkg, load_scenarios, run_scenario,
    scenario_cases)

SIDES = ("ref", "port")
BALANCER = {side: load_scenarios("test_balancer.py", side)
            for side in SIDES}
MODULES = {side: load_scenarios(
    "test_replication.py", side,
    renames={"test_balancer": BALANCER[side].__name__})
    for side in SIDES}
CLASSES = ("TestReplicaLifecycle", "TestContinuousShip", "TestPromotion",
           "TestReplicationTorture", "TestStandaloneParity")
CASES = scenario_cases(MODULES["ref"], CLASSES)


def _repl_cluster(mod, tmp_path):
    """tests/test_replication.py's `cluster` fixture, on `mod`'s
    package."""
    def gen():
        mod.failpoint.reset()
        mod.configure_read_replica(mode="leader", max_lag_ms=5000)
        c = mod.ReplCluster(tmp_path)
        try:
            yield c
        finally:
            mod.failpoint.reset()
            mod.configure_read_replica(mode="leader", max_lag_ms=5000)
            c.shutdown()
    return _Fixture(gen())


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("case", CASES, ids=[c[3] for c in CASES])
def test_scenario(side, case, request):
    cls_name, meth_name, params, _ = case
    run_scenario(MODULES[side], cls_name, meth_name, params,
                 {"cluster": _repl_cluster}, request)


def test_port_cases_are_the_references():
    """Both sides run the same scenario list; the port's module and the
    balancer harness it builds on are the port's package's."""
    assert scenario_cases(MODULES["port"], CLASSES) == CASES
    assert len(CASES) >= 15
    port = MODULES["port"]
    assert port.Cluster is BALANCER["port"].Cluster
    assert port.DatanodeInstance.__module__.startswith(
        "greptimedb_tpu_torch")
    assert port.configure_read_replica.__module__.startswith(
        "greptimedb_tpu_torch")


# ---------------------------------------------------------------------------
# mixed clusters: the leader of one package, the follower of the other
# ---------------------------------------------------------------------------

def _region(c, node, region=0):
    return c.datanodes[node].catalog.table("greptime", "public",
                                           "ha").regions[region]


def _beat_full(c, node, node_side, front):
    """One stat-bearing heartbeat (the feed behind replicated_seq and
    lag_ms, which the read router checks)."""
    stream_exec = importlib.import_module(
        f"{'greptimedb_tpu' if node_side == 'ref' else 'greptimedb_tpu_torch'}"
        ".query.stream_exec")
    regions = c.datanodes[node].storage.list_regions()
    entries, rows, nbytes = stream_exec.region_stat_entries(regions.values())
    c.srv.handle_heartbeat(node, _pkg(front).meta.DatanodeStat(
        region_count=len(regions), approximate_rows=rows,
        approximate_bytes=nbytes, region_stats=entries))


@pytest.mark.parametrize("leader_side,follower_side,front", [
    ("port", "ref", "port"), ("ref", "port", "port"),
    ("port", "ref", "ref"), ("ref", "port", "ref")],
    ids=["port-to-ref-port-fe", "ref-to-port-port-fe",
         "port-to-ref-ref-fe", "ref-to-port-ref-fe"])
def test_mixed_leader_ships_and_promotes(tmp_path, leader_side,
                                         follower_side, front):
    ref_bal = BALANCER["ref"]
    c = MixedCluster(tmp_path, front, (leader_side, follower_side))
    f = _pkg(front)
    sides = {1: leader_side, 2: follower_side}
    f.dist.configure_read_replica(mode="leader", max_lag_ms=5000)
    try:
        c.fe.do_query(ref_bal.DDL)
        acked = set()

        def write(keys):
            c.fe.do_query("INSERT INTO ha VALUES " + ", ".join(
                f"('{h}', {t}, 1.0)" for h, t in keys))
            acked.update(keys)

        write([(f"h{i % 10}", 1000 + i) for i in range(20)])
        leader = c.owner(0)
        assert sides[leader] == leader_side
        target = next(i for i in c.datanodes if i != leader)
        c.fe.do_query(f"ADMIN ADD REPLICA ha 0 TO {target}")
        assert c.pump(), c.srv.balancer.ops()
        assert c.srv.balancer.done_ops()[-1]["state"] == "done"
        std = _region(c, target)
        assert std.standby and std.fenced

        # continuous shipping across packages, over Flight
        write([(f"h{i % 5}", 50_000 + i) for i in range(40)])
        lead = _region(c, leader)
        c.datanodes[leader].replication.drain(lead.name)
        std = _region(c, target)
        assert std.version_control.committed_sequence == \
            lead.version_control.committed_sequence
        for i in c.datanodes:
            _beat_full(c, i, sides[i], front)
        c.fe.do_query("SET read_replica = 'follower'")
        t = c.fe.catalog.table("greptime", "public", "ha")
        picked = set()
        for _ in range(4):
            for client, regions in t._read_owners_for([0]):
                picked.add(client.node_id)
        assert picked == {leader, target}
        count = c.fe.do_query("SELECT count(*) AS c FROM ha")[-1]
        assert next(count.batches[0].rows())[0] == len(acked)
        c.fe.do_query("SET read_replica = 'leader'")

        # the leader dies with an acked tail it never shipped
        c.datanodes[leader].replication.stop()
        write([("h3", 90_000 + i) for i in range(25)])
        assert lead.version_control.committed_sequence > \
            _region(c, target).version_control.committed_sequence
        for region in c.datanodes[leader].storage.list_regions().values():
            with region._writer_lock:
                region.closed = True
                region.wal.close()
        c.srv._last_seen[leader] = 0.0
        moves = c.srv.failover_check()
        assert moves == [{"table": "greptime.public.ha", "region": 0,
                          "from": leader, "to": target, "promoted": True}]
        for msg in c.srv.handle_heartbeat(target).mailbox:
            c.datanodes[target]._handle_mailbox(msg)
        promoted = _region(c, target)
        assert not promoted.standby and not promoted.fenced

        # a fresh frontend reads the promoted route: every acked row of
        # region 0 exactly once
        kw = {"device": "cpu"} if front == "port" else {}
        fe = f.dist.DistInstance(c.meta, {target: c.clients[target]}, **kw)
        try:
            out = fe.do_query("SELECT host, ts FROM ha WHERE host < 'h5'")[-1]
            keys = [tuple(r) for b in out.batches for r in b.rows()]
        finally:
            if hasattr(fe, "shutdown"):
                fe.shutdown()
        assert len(keys) == len(set(keys)), "duplicated rows"
        want = {k for k in acked if k[0] < "h5"}
        assert set(keys) == want
    finally:
        f.dist.configure_read_replica(mode="leader", max_lag_ms=5000)
        c.shutdown()
