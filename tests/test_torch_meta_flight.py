"""The port's meta service over Arrow Flight (greptimedb_tpu_torch/meta/
flight.py) held to the reference's (greptimedb_tpu/meta/flight.py), both
ways: each package's FlightMetaClient against each package's
FlightMetaServer.

A module fixture (`wire`) runs one script per pairing of client and
server package, each over a fresh `MetaSrv(MemKv())` of the server's
package, with both packages' meta clocks pinned to one settable value:
every action kind of `do_action` (register, heartbeat with full and
light stats and the mailbox, routes, table info, cluster_info,
region_heat, region_peers, the balancer's admin ops, configure and ack,
background_jobs, list_datanodes, the KV passthroughs with non-UTF-8
values, unknown actions and the raft actions of a server with no raft
node), the open_regions mail of a failover, the NotLeaderError redirect
of a follower and the failover client riding it, and
PeerClientRegistry resolving peers lazily. Each parametrised case
compares one answer across the four pairings.

Host-only code: nothing here compiles a JAX program.
"""

from __future__ import annotations

import dataclasses
import types

import pytest

import greptimedb_tpu.client.flight as ref_client_flight
import greptimedb_tpu.common.background_jobs as ref_jobs
import greptimedb_tpu.errors as ref_errors
import greptimedb_tpu.meta.balancer as ref_balancer
import greptimedb_tpu.meta.flight as ref_flight
import greptimedb_tpu.meta.kv as ref_kv
import greptimedb_tpu.meta.replication as ref_repl
import greptimedb_tpu.meta.service as ref_service
import greptimedb_tpu_torch.client.flight as port_client_flight
import greptimedb_tpu_torch.common.background_jobs as port_jobs
import greptimedb_tpu_torch.errors as port_errors
import greptimedb_tpu_torch.meta.balancer as port_balancer
import greptimedb_tpu_torch.meta.flight as port_flight
import greptimedb_tpu_torch.meta.kv as port_kv
import greptimedb_tpu_torch.meta.replication as port_repl
import greptimedb_tpu_torch.meta.service as port_service

PKGS = {
    "ref": types.SimpleNamespace(
        flight=ref_flight, service=ref_service, kv=ref_kv, repl=ref_repl,
        balancer=ref_balancer, jobs=ref_jobs, client=ref_client_flight),
    "port": types.SimpleNamespace(
        flight=port_flight, service=port_service, kv=port_kv,
        repl=port_repl, balancer=port_balancer, jobs=port_jobs,
        client=port_client_flight),
}
PAIRS = [(c, s) for c in PKGS for s in PKGS]
T0 = 1_700_000_000.0
TABLE = "greptime.public.t"
BTABLE = "greptime.public.b"


class _Clock:
    """A `time` module for meta/service.py and meta/balancer.py whose
    time() reads a settable value (the server threads read it too)."""

    def __init__(self):
        self.t = T0

    def time(self):
        return self.t


def _stat(p, regions, rows_each, full=True):
    if not full:
        return p.service.DatanodeStat(region_count=len(regions), full=False)
    stats = [{"region": r, "rows": rows_each, "size_bytes": 100 * rows_each,
              "series": 4, "time_span": 60_000, "committed_seq": rows_each}
             for r in regions]
    return p.service.DatanodeStat(
        region_count=len(regions), approximate_rows=rows_each * len(regions),
        approximate_bytes=100 * rows_each * len(regions),
        region_stats=stats)


def _outcome(fn):
    """The answer, or the raised error's type name and text (without
    the server's traceback, which names its package's files)."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the type and text compare
        return ("raised", type(e).__name__, str(e).split(". Detail:")[0])


def _peers(peers):
    return [q.to_dict() for q in peers]


def _script(cp, sp, clock):
    """One client package `cp` against one server package `sp`: the
    answers by step name."""
    srv = sp.service.MetaSrv(sp.kv.MemKv(), datanode_lease_secs=15.0)
    server = sp.flight.FlightMetaServer(srv)
    server.serve_in_background()
    client = cp.flight.FlightMetaClient(server.address)
    Peer = cp.service.Peer
    out = {}

    def at(t, name, fn):
        clock.t = T0 + t
        out[name] = _outcome(fn)

    try:
        at(0, "register", lambda: client.register(
            Peer(1, "grpc://127.0.0.1:4001")))
        at(0, "heartbeat_new_node", lambda: client.heartbeat(
            2, _stat(cp, [], 0)).mailbox)
        at(0, "heartbeat_full", lambda: client.heartbeat(
            1, _stat(cp, [], 0)).mailbox)
        for k in range(1, 6):
            clock.t = T0 + k
            client.heartbeat(1, _stat(cp, [], 0, full=False))
            client.heartbeat(2, None)
        at(5, "list_alive", lambda: _peers(client.list_datanodes()))
        at(5, "list_all", lambda: _peers(
            client.list_datanodes(alive_only=False)))
        at(5, "create_route", lambda: client.create_route(
            TABLE, [0, 1, 2, 3]).to_dict())
        route = client.route(TABLE)
        at(5, "route", lambda: client.route(TABLE).to_dict())
        at(5, "route_missing", lambda: client.route("greptime.public.no"))
        at(5, "create_route_dup", lambda: client.create_route(TABLE, [0]))
        at(5, "put_table_info", lambda: client.put_table_info(
            TABLE, {"name": "t", "id": route.table_id,
                    "blob": "é€"}))
        at(5, "table_info", lambda: client.table_info(TABLE))
        at(5, "create_route_u", lambda: client.create_route(
            "greptime.public.u", [0]).to_dict())
        at(5, "rename_route", lambda: client.rename_route(
            "greptime.public.u", "greptime.public.v").to_dict())
        at(5, "rename_route_clash", lambda: client.rename_route(
            "greptime.public.v", TABLE))
        at(5, "rename_route_missing", lambda: client.rename_route(
            "greptime.public.zz", "greptime.public.yy"))
        at(5, "delete_route", lambda: (client.delete_route(
            "greptime.public.v"), client.delete_route("greptime.public.v")))
        at(5, "put_table_info_v", lambda: client.put_table_info(
            "greptime.public.v", {"name": "v"}))
        at(5, "delete_table_info", lambda: (
            client.delete_table_info("greptime.public.v"),
            client.delete_table_info("greptime.public.v"),
            client.table_info("greptime.public.v")))
        at(5, "allocate_table_id", lambda: (client.allocate_table_id(),
                                            client.allocate_table_id()))
        names = [f"{route.table_id}_{rn:010d}" for rn in range(4)]
        on1 = [names[rn] for rn in route.regions_on(1)]
        on2 = [names[rn] for rn in route.regions_on(2)]
        at(10, "heartbeat_stats", lambda: (
            client.heartbeat(1, _stat(cp, on1, 1000)).mailbox,
            client.heartbeat(2, _stat(cp, on2, 500)).mailbox))
        clock.t = T0 + 12
        client.heartbeat(1, _stat(cp, on1, 3000))
        clock.t = T0 + 14
        client.heartbeat(2, _stat(cp, on2, 900))
        clock.t = T0 + 15
        client.heartbeat(1, _stat(cp, on1, 0, full=False))
        at(15, "cluster_info", lambda: [
            {**r, "peer_addr": "<meta>" if r["peer_type"] == "metasrv"
             else r["peer_addr"]} for r in client.cluster_info()])
        at(15, "region_heat", client.region_heat)
        at(15, "region_peers", client.region_peers)
        srv.send_mailbox(2, {"type": "flush_table", "catalog": "greptime",
                             "schema": "public", "table": "t"})
        at(16, "mailbox", lambda: (client.heartbeat(2, None).mailbox,
                                   client.heartbeat(2, None).mailbox))
        at(16, "balancer_configure", lambda: (
            client.balancer_configure("max_inflight", 3),
            client.balancer_configure("step_timeout_s", 0.2),
            {k: getattr(srv.balancer, k) for k in srv.balancer.KNOBS}))
        at(16, "balancer_configure_bad", lambda: client.balancer_configure(
            "nope", 1))
        # the balancer's ops run on a table of their own: a table with an
        # op in flight is off limits to the failover below
        at(16, "create_route_b", lambda: client.create_route(
            BTABLE, [0, 1, 2, 3]).to_dict())
        rb = client.route(BTABLE)
        src = rb.region_routes[0].leader.id
        at(16, "admin_migrate_region", lambda: client.admin_migrate_region(
            BTABLE, rb.region_routes[0].region_number, 3 - src))
        at(16, "admin_migrate_same_node", lambda: client.admin_migrate_region(
            BTABLE, rb.region_routes[0].region_number, src))
        at(16, "admin_split_region", lambda: client.admin_split_region(
            BTABLE, rb.region_routes[1].region_number, "host_5"))
        at(16, "admin_rebalance", lambda: client.admin_rebalance(BTABLE))
        at(16, "admin_add_replica", lambda: client.admin_add_replica(
            BTABLE, rb.region_routes[2].region_number,
            3 - rb.region_routes[2].leader.id))
        at(16, "admin_remove_replica", lambda: client.admin_remove_replica(
            BTABLE, rb.region_routes[3].region_number, 7))
        at(16, "balancer_ack", lambda: client.balancer_ack(
            src, "no-such-op", "balancer_snapshot", True, None, {"x": 1}))
        at(16, "region_peers_after_ops", client.region_peers)
        at(17, "balancer_mail", lambda: client.heartbeat(src, None).mailbox)
        # node 2 keeps beating, node 1 falls silent: the failover moves
        # node 1's regions and mails node 2 open_regions
        for k in range(18, 60):
            clock.t = T0 + k
            client.heartbeat(2, _stat(cp, on2, 900, full=False))
        clock.t = T0 + 60
        out["moves"] = ("ok", srv.failover_check())
        at(60, "route_after_failover", lambda: client.route(TABLE).to_dict())
        at(61, "failover_mail", lambda: client.heartbeat(2, None).mailbox)
        at(61, "list_after_failover", lambda: (
            _peers(client.list_datanodes()),
            _peers(client.list_datanodes(alive_only=False))))
        blob = bytes(range(256))
        at(62, "kv", lambda: (
            client.kv_put("__flow/a", blob), client.kv_put("__flow/b", b""),
            client.kv_get("__flow/a"), client.kv_get("__flow/none"),
            client.kv_range("__flow/"), client.kv_delete("__flow/a"),
            client.kv_delete("__flow/a"), client.kv_range("__flow/")))
        at(62, "background_jobs", lambda: [
            {k: v for k, v in r.items()
             if k not in ("start_ms", "duration_ms", "trace_id")}
            for r in client.background_jobs()])
        at(62, "unknown_action", lambda: client._action("nope", {}))
        at(62, "raft_without_raft_node", lambda: client._action(
            "raft_request_vote", {"term": 1, "candidate": 1,
                                  "last_idx": 0, "last_term": 0}))
        at(62, "bad_body", lambda: client._action("heartbeat", {}))
    finally:
        client.close()
        server.shutdown()
    return out


def _redirects(cp, sp):
    """A follower's server redirects the leader-only actions with
    NotLeaderError; the failover client over [follower, leader] lands on
    the leader."""
    follower = types.SimpleNamespace(is_leader=False, leader_id=2,
                                     role="follower")
    leader = types.SimpleNamespace(is_leader=True, leader_id=2,
                                   role="leader")
    kv = sp.kv.MemKv()
    srvs = [sp.service.MetaSrv(kv), sp.service.MetaSrv(kv)]
    servers = [sp.flight.FlightMetaServer(s, raft_node=r)
               for s, r in zip(srvs, (follower, leader))]
    for s in servers:
        s.serve_in_background()
    direct = cp.flight.FlightMetaClient(servers[0].address)
    ha = cp.flight.FailoverFlightMetaClient([s.address for s in servers],
                                            retry_delay=0.01, max_rounds=3)
    out = {}
    try:
        srvs[1].handle_heartbeat(7)
        for kind, call in [
                ("cluster_info", direct.cluster_info),
                ("region_heat", direct.region_heat),
                ("region_peers", direct.region_peers),
                ("admin_rebalance", lambda: direct.admin_rebalance(None)),
                ("balancer_ack", lambda: direct.balancer_ack(
                    1, "x", "s", True, None, {})),
                ("balancer_configure", lambda: direct.balancer_configure(
                    "max_inflight", 2))]:
            out[kind] = _outcome(call)
        # the follower serves what is not leader-only
        out["follower_route"] = _outcome(lambda: direct.route(TABLE))
        out["ha_cluster_info"] = _outcome(lambda: [
            (r["peer_id"], r["peer_type"], r["lease_state"])
            for r in ha.cluster_info()])
        out["ha_pinned"] = ha.address == servers[1].address
        out["advisory"] = _outcome(lambda: len(
            ha.advisory().region_peers()))
    finally:
        direct.close()
        ha.close()
        for s in servers:
            s.shutdown()
    return out


def _registry(cp, sp):
    """PeerClientRegistry over a meta server: empty until asked, then
    dials the asked peer's Flight address, once."""
    srv = sp.service.MetaSrv(sp.kv.MemKv())
    server = sp.flight.FlightMetaServer(srv)
    server.serve_in_background()
    meta = cp.flight.FlightMetaClient(server.address)
    try:
        srv.register_datanode(sp.service.Peer(1, "grpc://127.0.0.1:4001"))
        srv.register_datanode(sp.service.Peer(2, ""))
        reg = cp.flight.PeerClientRegistry(meta)
        out = [len(reg)]
        c1 = reg[1]
        out += [type(c1).__name__, type(c1).__module__.split(".")[0] ==
                cp.client.__name__.split(".")[0], c1.address, c1.node_id,
                len(reg), reg[1] is c1, reg.get(2), reg.get(9, "dflt"),
                _outcome(lambda: reg[9]), sorted(reg)]
        return out
    finally:
        meta.close()
        server.shutdown()


#: runs of a pairing: one more each time a fresh loopback server refused
#: a connection (seen now and then in a loaded full run, for either
#: package's server and in the reference's own Flight tests); every
#: answer still comes from one whole run
RUNS = 3


def _refused(out):
    return any(isinstance(v, tuple) and v[:2] == ("raised",
                                                   "TransientRpcError")
               for v in out.values())


def _pairing(cp, sp, clock):
    """The script, the redirects and the registry for one pairing, on
    fresh servers, with emptied background_jobs registries."""
    for p in PKGS.values():
        with p.jobs._lock:
            p.jobs._running.clear()
            p.jobs._completed.clear()
            p.jobs._next_id[0] = 1
        with p.jobs.job("wire_probe", table="t", region="0"):
            pass
    clock.t = T0
    try:
        return {**_script(cp, sp, clock),
                **{f"redirect_{k}": v
                   for k, v in _redirects(cp, sp).items()},
                "registry": ("ok", _registry(cp, sp))}
    except (ref_errors.TransientRpcError, port_errors.TransientRpcError) as e:
        return {"refused": ("raised", "TransientRpcError", str(e))}


@pytest.fixture(scope="module")
def wire():
    """Every pairing's answers: {(client, server): {step: answer}}."""
    mp = pytest.MonkeyPatch()
    clock = _Clock()
    saved = {}
    try:
        for p in PKGS.values():
            mp.setattr(p.service, "time", clock)
            mp.setattr(p.balancer, "time", clock)
            # the background_jobs registries are process state: emptied
            # for the script, restored after it
            saved[p.jobs] = (dict(p.jobs._running),
                             {k: list(v) for k, v in p.jobs._completed.items()},
                             p.jobs._next_id[0])
        out = {}
        for c, s in PAIRS:
            for _ in range(RUNS):
                got = _pairing(PKGS[c], PKGS[s], clock)
                if not _refused(got):
                    break
            out[(c, s)] = got
        yield out
    finally:
        for mod, (running, completed, next_id) in saved.items():
            with mod._lock:
                mod._running.clear()
                mod._running.update(running)
                mod._completed.clear()
                mod._completed.update(completed)
                mod._next_id[0] = next_id
        mp.undo()


STEPS = ["register", "heartbeat_new_node", "heartbeat_full", "list_alive",
         "list_all", "create_route", "route", "route_missing",
         "create_route_dup", "put_table_info", "table_info",
         "create_route_u", "rename_route", "rename_route_clash",
         "rename_route_missing", "delete_route", "put_table_info_v",
         "delete_table_info", "allocate_table_id", "heartbeat_stats",
         "cluster_info", "region_heat", "region_peers", "mailbox",
         "balancer_configure", "balancer_configure_bad", "create_route_b",
         "admin_migrate_region", "admin_migrate_same_node",
         "admin_split_region", "admin_rebalance", "admin_add_replica",
         "admin_remove_replica", "balancer_ack", "region_peers_after_ops",
         "balancer_mail", "moves", "route_after_failover", "failover_mail",
         "list_after_failover", "kv", "background_jobs", "unknown_action",
         "raft_without_raft_node", "bad_body", "redirect_cluster_info",
         "redirect_region_heat", "redirect_region_peers",
         "redirect_admin_rebalance", "redirect_balancer_ack",
         "redirect_balancer_configure", "redirect_follower_route",
         "redirect_ha_cluster_info", "redirect_ha_pinned",
         "redirect_advisory", "registry"]


@pytest.mark.parametrize("step", STEPS)
def test_step_answers_alike(wire, step):
    """Each pairing gives the reference's own answer (its client on its
    server)."""
    want = wire[("ref", "ref")][step]
    for pair in PAIRS:
        assert wire[pair][step] == want, (pair, step, wire[pair][step])


def test_script_covers_every_action_kind(wire):
    """The script reached each action `do_action` dispatches, and the
    answers say what the reference's tests say of them."""
    out = wire[("port", "port")]
    assert out["create_route_dup"][:2] == ("raised", "GreptimeError")
    assert out["rename_route_clash"][0] == "raised"
    assert out["delete_route"] == ("ok", (True, False))
    assert out["delete_table_info"] == ("ok", (True, False, None))
    info = {r["peer_id"]: r for r in out["cluster_info"][1]}
    assert info[-1]["peer_addr"] == "<meta>"
    assert info[1]["approximate_rows"] == 6000
    assert out["mailbox"][1][0][0]["type"] == "flush_table"
    assert out["mailbox"][1][1] == []
    assert out["admin_migrate_region"][1]["kind"] == "migrate"
    assert out["admin_migrate_same_node"][:2] == ("raised", "GreptimeError")
    assert [m["to"] for m in out["moves"][1]] == [2, 2]
    mail = out["failover_mail"][1]
    assert mail and mail[0]["type"] == "open_regions" and \
        mail[0]["table_info"]["blob"] == "é€"
    kv = out["kv"][1]
    assert kv[2] == bytes(range(256)) and kv[3] is None
    assert kv[4] == [("__flow/a", bytes(range(256))), ("__flow/b", b"")]
    assert kv[5:7] == (True, False)
    assert [r["kind"] for r in out["background_jobs"][1]] == ["wire_probe"]
    assert "unknown meta action 'nope'" in out["unknown_action"][2]
    assert "unknown meta action 'raft_request_vote'" in \
        out["raft_without_raft_node"][2]
    for kind in ("cluster_info", "region_heat", "region_peers",
                 "admin_rebalance", "balancer_ack", "balancer_configure"):
        assert out[f"redirect_{kind}"][:2] == ("raised", "NotLeaderError")
    assert out["redirect_ha_cluster_info"][1][1] == (7, "datanode", "alive")
    assert out["redirect_ha_pinned"] is True
    reg = out["registry"][1]
    assert reg[0] == 0 and reg[1] == "FlightDatanodeClient" and reg[2]
    assert reg[3:] == ["grpc://127.0.0.1:4001", 1, 1, True, None, "dflt",
                       ("raised", "KeyError", "9"), [1]]


@pytest.mark.parametrize("client", sorted(PKGS))
def test_heartbeat_stat_body_is_the_reference(client):
    """The heartbeat body a client sends: DatanodeStat as the
    reference's dataclass fields, so either server rebuilds it."""
    p = PKGS[client]
    stat = _stat(p, ["1_0000000000"], 10)
    assert dataclasses.asdict(stat) == dataclasses.asdict(
        _stat(PKGS["ref"], ["1_0000000000"], 10))
    assert set(dataclasses.asdict(stat)) == {
        f.name for f in dataclasses.fields(ref_service.DatanodeStat)}
