"""The port's in-process meta service (greptimedb_tpu_torch/meta/) held
to the reference's (greptimedb_tpu/meta/).

Every case runs one script on both packages, with explicit clocks
(`now=`) where the code reads one, and compares what the two return:
the KV stores (MemKv, FileKv), the lease lock and the election, the phi
accrual failure detector, MetaSrv through MetaClient over one scripted
sequence of registrations, light and full heartbeats and route and
table-info changes (routes, alive and failed peers, cluster_info,
region_heat, region_peers, failover_check's moves and mailbox), the
RegionBalancer's knobs and a migrate's first tick, and
`partition/rule.py:refine_range_rule` (tests/test_balancer.py's cases).
Host-only code: nothing here compiles a JAX program.
"""

from __future__ import annotations

import json
import time
import types

import pytest

import greptimedb_tpu.meta as ref_meta
import greptimedb_tpu.meta.balancer as ref_balancer
import greptimedb_tpu.meta.kv as ref_kv
import greptimedb_tpu.meta.lock as ref_lock
import greptimedb_tpu.mito.engine as ref_mito
import greptimedb_tpu.partition.rule as ref_rule
import greptimedb_tpu.sql.ast as ref_ast
import greptimedb_tpu_torch.meta as meta
import greptimedb_tpu_torch.meta.balancer as balancer
import greptimedb_tpu_torch.meta.kv as kv
import greptimedb_tpu_torch.meta.lock as lock
import greptimedb_tpu_torch.mito.engine as mito
import greptimedb_tpu_torch.partition.rule as rule
import greptimedb_tpu_torch.sql.ast as ast

PKGS = {
    "ref": types.SimpleNamespace(meta=ref_meta, kv=ref_kv, lock=ref_lock,
                                 balancer=ref_balancer, mito=ref_mito,
                                 rule=ref_rule, ast=ref_ast),
    "port": types.SimpleNamespace(meta=meta, kv=kv, lock=lock,
                                  balancer=balancer, mito=mito, rule=rule,
                                  ast=ast),
}

T0 = 1_700_000_000.0


def both(fn, *args):
    """fn(package namespace, *args) on both packages; the port's answer
    must be the reference's. Returns it."""
    got = {k: fn(p, *args) for k, p in PKGS.items()}
    assert got["port"] == got["ref"], got
    return got["port"]


# ---------------------------------------------------------------------------
# KV stores
# ---------------------------------------------------------------------------

def _kv_script(p, store):
    out = [store.get("a"), store.put("a", b"1"), store.get("a"),
           store.compare_and_put("a", b"2", b"3"),
           store.compare_and_put("a", b"1", b"3"),
           store.compare_and_put("b", None, b"x"),
           store.compare_and_put("b", None, b"y"),
           store.compare_and_delete("b", b"y"),
           store.compare_and_delete("b", b"x"),
           store.incr("seq", start=1023), store.incr("seq", start=1023),
           store.batch([("put", "p/1", b"u"), ("put", "p/2", b"v"),
                        ("delete", "a", None)], guard=("p/1", None)),
           store.batch([("put", "p/3", b"w")], guard=("p/1", None)),
           store.range("p/"), store.delete("p/2"), store.delete("p/2"),
           store.range("p/"), store.get("a")]
    return out


@pytest.mark.parametrize("kind", ["mem", "file"])
def test_kv_script_matches_reference(kind, tmp_path):
    def run(p):
        store = p.kv.MemKv() if kind == "mem" else \
            p.kv.FileKv(str(tmp_path / f"{p.kv.__name__}.json"))
        out = _kv_script(p, store)
        if kind == "file":
            # a fresh store over the same file sees the same state
            again = p.kv.FileKv(str(tmp_path / f"{p.kv.__name__}.json"))
            out.append((again.range(""), again.incr("seq")))
        return out
    out = both(run)
    assert out[9:11] == [1024, 1025]


def test_file_kv_snapshot_roundtrip(tmp_path):
    """tests/test_cluster.py::TestFileKv::test_snapshot_roundtrip."""
    def run(p):
        path = str(tmp_path / f"{p.kv.__name__}.json")
        store = p.kv.FileKv(path)
        store.put("a", b"1")
        store.incr("seq")
        return p.kv.FileKv(path).get("a"), p.kv.FileKv(path).incr("seq")
    assert both(run) == (b"1", 2)


def test_file_kv_cas_persists(tmp_path):
    """tests/test_cluster.py::TestFileKv::test_cas_persists."""
    def run(p):
        path = str(tmp_path / f"{p.kv.__name__}.json")
        first = p.kv.FileKv(path).compare_and_put("k", None, b"v")
        second = p.kv.FileKv(path).compare_and_put("k", None, b"w")
        return first, second
    assert both(run) == (True, False)


def test_file_kv_files_are_the_same(tmp_path):
    """Both packages write the same snapshot document."""
    def run(p):
        path = str(tmp_path / f"{p.kv.__name__}.json")
        store = p.kv.FileKv(path)
        _kv_script(p, store)
        with open(path) as f:
            return json.load(f)
    both(run)


# ---------------------------------------------------------------------------
# lease lock and election (tests/test_cluster.py::
# TestDistributedLockAndElection, on both packages)
# ---------------------------------------------------------------------------

def _lock_mutual_exclusion(p, t0):
    store = p.kv.MemKv()
    a = p.lock.DistributedLock(store, "ddl", holder="a")
    b = p.lock.DistributedLock(store, "ddl", holder="b")
    return [a.try_acquire(now=t0), b.try_acquire(now=t0),
            a.try_acquire(now=t0), a.release(), b.try_acquire(now=t0)]


def _lock_expired_lease(p, t0):
    store = p.kv.MemKv()
    a = p.lock.DistributedLock(store, "x", holder="a", lease_secs=5)
    b = p.lock.DistributedLock(store, "x", holder="b", lease_secs=5)
    return [a.try_acquire(now=t0), b.try_acquire(now=t0 + 2),
            b.try_acquire(now=t0 + 6), a.holder_of(now=t0 + 7)]


def _lock_stale_release(p, t0):
    store = p.kv.MemKv()
    a = p.lock.DistributedLock(store, "x", holder="a", lease_secs=5)
    b = p.lock.DistributedLock(store, "x", holder="b", lease_secs=5)
    return [a.try_acquire(now=t0), b.try_acquire(now=t0 + 6), a.release(),
            b.holder_of(now=t0 + 7)]


def _kv_compare_and_delete(p, t0):
    store = p.kv.MemKv()
    store.put("k", b"v1")
    return [store.compare_and_delete("k", b"other"), store.get("k"),
            store.compare_and_delete("k", b"v1"), store.get("k")]


def _lock_context_manager(p, t0):
    store = p.kv.MemKv()
    with p.lock.DistributedLock(store, "cm", holder="a") as held:
        inside = held.holder_of()
    return [inside, p.lock.DistributedLock(store, "cm",
                                           holder="b").try_acquire()]


def _election_single_leader(p, t0):
    store = p.kv.MemKv()
    e1 = p.lock.Election(store, "meta-1")
    e2 = p.lock.Election(store, "meta-2")
    return [e1.campaign_once(now=t0), e2.campaign_once(now=t0),
            e1.is_leader, e2.is_leader, e2.leader()]


def _election_failover(p, t0):
    store = p.kv.MemKv()
    e1 = p.lock.Election(store, "meta-1", lease_secs=5)
    e2 = p.lock.Election(store, "meta-2", lease_secs=5)
    return [e1.campaign_once(now=t0), e2.campaign_once(now=t0 + 2),
            e2.campaign_once(now=t0 + 6), e2.leader()]


LOCK_CASES = {
    "mutual_exclusion": (_lock_mutual_exclusion,
                         [True, False, True, True, True]),
    "expired_lease_taken_over": (_lock_expired_lease,
                                 [True, False, True, "b"]),
    "stale_release_does_not_break_new_holder": (
        _lock_stale_release, [True, True, False, "b"]),
    "compare_and_delete_atomicity": (_kv_compare_and_delete,
                                     [False, b"v1", True, None]),
    "context_manager": (_lock_context_manager, ["a", True]),
    "election_single_leader": (_election_single_leader,
                               [True, False, True, False, "meta-1"]),
    "election_failover_on_lease_expiry": (_election_failover,
                                          [True, False, True, "meta-2"]),
}


@pytest.mark.parametrize("case", sorted(LOCK_CASES))
def test_lock_and_election_match_reference(case):
    fn, want = LOCK_CASES[case]
    # the leases are read without a clock too (holder_of, leader): start
    # them at the wall clock, as the reference's tests do
    assert both(fn, time.time()) == want


def test_lock_documents_are_the_same():
    """The lease document both packages store for the same holder."""
    def run(p):
        store = p.kv.MemKv()
        p.lock.DistributedLock(store, "ddl", holder="a",
                               lease_secs=7).try_acquire(now=T0)
        p.lock.Election(store, "meta-1").campaign_once(now=T0)
        return store.range("")
    both(run)


# ---------------------------------------------------------------------------
# phi accrual failure detector
# ---------------------------------------------------------------------------

BEATS_MS = [0, 1000, 2100, 2900, 4000, 5200, 6000, 7100, 8050, 9000]


@pytest.mark.parametrize("kw", [{}, {"threshold": 3.0,
                                     "min_std_deviation_ms": 50.0,
                                     "acceptable_heartbeat_pause_ms": 0.0},
                                {"max_sample_size": 4}])
def test_phi_matches_reference(kw):
    def run(p):
        det = p.meta.PhiAccrualFailureDetector(**kw)
        out = [(det.phi(0.0), det.sample_count)]
        for t in BEATS_MS:
            det.heartbeat(float(t))
            out.append((det.phi(t + 500.0), det.sample_count))
        for late in (1000, 3000, 5000, 8000, 20000, 10 ** 6):
            t = BEATS_MS[-1] + late
            out.append((det.phi(float(t)), det.is_available(float(t))))
        return out
    out = both(run)
    assert out[-1][1] is False and out[1][0] < 1.0


# ---------------------------------------------------------------------------
# MetaSrv through MetaClient
# ---------------------------------------------------------------------------

def _stat(p, regions, rows_each, full=True):
    if not full:
        return p.meta.DatanodeStat(region_count=len(regions), full=False)
    stats = [{"region": r, "rows": rows_each, "size_bytes": 100 * rows_each,
              "series": 4, "time_span": 60_000, "committed_seq": rows_each}
             for r in regions]
    return p.meta.DatanodeStat(region_count=len(regions),
                               approximate_rows=rows_each * len(regions),
                               approximate_bytes=100 * rows_each *
                               len(regions), region_stats=stats)


def _meta_script(p):
    srv = p.meta.MetaSrv(p.kv.MemKv(), datanode_lease_secs=15.0)
    client = p.meta.MetaClient(srv)
    out = {}
    client.register(p.meta.Peer(1, "grpc://10.0.0.1:4001"))
    # node 2 registers by its first heartbeat, as a datanode does
    srv.handle_heartbeat(2, _stat(p, [], 0), now=T0)
    srv.handle_heartbeat(1, _stat(p, [], 0), now=T0)
    for k in range(1, 6):
        srv.handle_heartbeat(1, _stat(p, [], 0, full=False), now=T0 + k)
        srv.handle_heartbeat(2, _stat(p, [], 0, full=False), now=T0 + k)
    out["peers"] = [q.to_dict() for q in srv.peers()]
    out["alive"] = [q.id for q in srv.alive_datanodes(T0 + 5)]
    route = srv.create_table_route("greptime.public.t", [0, 1, 2, 3],
                                   now=T0 + 5)
    out["route"] = route.to_dict()
    out["on"] = {i: route.regions_on(i) for i in (1, 2, 3)}
    out["route_peers"] = [q.to_dict() for q in route.peers()]
    client.put_table_info("greptime.public.t", {"name": "t", "id": 1})
    out["dup_route"] = _raises(lambda: srv.create_table_route(
        "greptime.public.t", [0], now=T0 + 5))
    out["route2"] = srv.create_table_route("greptime.public.u", [0],
                                           now=T0 + 5).to_dict()
    out["renamed"] = client.rename_route("greptime.public.u",
                                         "greptime.public.v").to_dict()
    out["rename_clash"] = _raises(lambda: client.rename_route(
        "greptime.public.v", "greptime.public.t"))
    out["deleted"] = (client.delete_route("greptime.public.v"),
                      client.delete_route("greptime.public.v"))
    out["info"] = (client.table_info("greptime.public.t"),
                   client.table_info("greptime.public.v"))
    names = [f"{route.table_id}_{rn:010d}" for rn in range(4)]
    on1 = [names[rn] for rn in route.regions_on(1)]
    on2 = [names[rn] for rn in route.regions_on(2)]
    # two full beats each: rows and per-region rates
    srv.handle_heartbeat(1, _stat(p, on1, 1000), now=T0 + 10)
    srv.handle_heartbeat(2, _stat(p, on2, 500), now=T0 + 10)
    srv.handle_heartbeat(1, _stat(p, on1, 3000), now=T0 + 12)
    srv.handle_heartbeat(2, _stat(p, on2, 900), now=T0 + 14)
    # a light beat keeps the last full stat's rows
    srv.handle_heartbeat(1, _stat(p, on1, 0, full=False), now=T0 + 15)
    out["cluster_info"] = srv.cluster_info(now=T0 + 15,
                                           metasrv_addr="127.0.0.1:3002")
    out["region_heat"] = srv.region_heat(now=T0 + 15)
    out["region_peers"] = srv.region_peers(now=T0 + 15)
    srv.send_mailbox(2, {"type": "flush_table", "catalog": "greptime",
                         "schema": "public", "table": "t"})
    out["mail"] = srv.handle_heartbeat(2, None, now=T0 + 16).mailbox
    out["mail_again"] = srv.handle_heartbeat(2, None, now=T0 + 17).mailbox
    # node 2 keeps beating, node 1 falls silent: phi, then failover
    for k in range(18, 60):
        srv.handle_heartbeat(2, _stat(p, on2, 900, full=False),
                             now=T0 + k)
    out["failed_60"] = [q.id for q in srv.failed_datanodes(T0 + 60)]
    out["alive_60"] = [q.id for q in srv.alive_datanodes(T0 + 60)]
    out["moves"] = srv.failover_check(now=T0 + 60)
    out["route_after"] = client.route("greptime.public.t").to_dict()
    out["failover_mail"] = srv.handle_heartbeat(2, None,
                                                now=T0 + 61).mailbox
    out["cluster_info_after"] = srv.cluster_info(now=T0 + 61)
    out["all_routes"] = [r.to_dict() for r in srv.all_table_routes()]
    out["table_id"] = client.allocate_table_id()
    out["no_alive"] = _raises(lambda: p.meta.MetaSrv(
        p.kv.MemKv()).create_table_route("greptime.public.x", [0]))
    out["kv"] = (client.kv_put("__flow/a", b"1"),
                 client.kv_get("__flow/a"), client.kv_range("__flow/"),
                 client.kv_delete("__flow/a"))
    return out


def _raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the type and text compare
        return type(e).__name__, str(e)
    return None


def test_meta_service_script_matches_reference():
    out = both(_meta_script)
    assert out["alive"] == [1, 2]
    assert sorted(len(v) for v in out["on"].values()) == [0, 2, 2]
    assert out["dup_route"][0] == "GreptimeError"
    info = {r["peer_id"]: r for r in out["cluster_info"]}
    assert info[1]["approximate_rows"] == 6000
    assert info[1]["ingest_rate_rps"] == pytest.approx(2000.0)
    assert {h["region"] for h in out["region_heat"]} == \
        {f"{out['route']['table_id']}_{rn:010d}" for rn in range(4)}
    assert out["mail"] and out["mail_again"] == []
    assert out["failed_60"] == [1] and out["alive_60"] == [2]
    assert [m["to"] for m in out["moves"]] == [2, 2]
    assert out["failover_mail"][0]["type"] == "open_regions"
    assert out["no_alive"][0] == "NoAliveDatanodeError"


# ---------------------------------------------------------------------------
# RegionBalancer
# ---------------------------------------------------------------------------

def test_balancer_knobs_match_reference():
    def run(p):
        b = p.meta.MetaSrv(p.kv.MemKv()).balancer
        out = [{k: getattr(b, k) for k in b.KNOBS}]
        for knob, value in [("enabled", 0), ("split_size_bytes", "4096"),
                            ("split_rate_rps", 2.5),
                            ("rebalance_threshold", -3),
                            ("max_inflight", 7), ("step_timeout_s", 0.2)]:
            b.configure(knob, value)
        out.append({k: getattr(b, k) for k in b.KNOBS})
        out.append(_raises(lambda: b.configure("nope", 1)))
        out.append(_raises(lambda: b.configure("max_inflight", "x")))
        return out
    out = both(run)
    assert out[1]["enabled"] is False and out[1]["step_timeout_s"] == 1.0


class _Clock:
    """A `time` module whose time() reads a fixed value."""

    def __init__(self, t):
        self.t = t

    def time(self):
        return self.t


def test_migrate_then_tick_matches_reference(monkeypatch):
    """One migrate and a single tick: the same op document in the KV and
    the same step mailed to the source node."""
    for p in PKGS.values():
        monkeypatch.setattr(p.balancer, "time", _Clock(T0 + 20))

    def run(p):
        srv = p.meta.MetaSrv(p.kv.MemKv())
        for n in (1, 2):
            srv.handle_heartbeat(n, _stat(p, [], 0), now=T0)
        route = srv.create_table_route("greptime.public.t", [0, 1],
                                       now=T0)
        src = route.region_routes[0].leader.id
        op = srv.admin_migrate_region("greptime.public.t", 0, 3 - src)
        summary = srv.balancer.tick(now=T0 + 20)
        mail = srv.handle_heartbeat(src, None, now=T0 + 21).mailbox
        return (op, summary, srv.balancer.ops(), mail,
                _raises(lambda: srv.admin_migrate_region(
                    "greptime.public.t", 0, src)),
                _raises(lambda: srv.admin_migrate_region(
                    "greptime.public.t", 9, 1)))
    op, summary, ops, mail, same_node, bad_region = both(run)
    assert op["kind"] == "migrate" and op["state"] == "snapshot"
    assert mail == [{"type": "balancer_snapshot", "op_id": op["id"],
                     "catalog": "greptime", "schema": "public",
                     "table": "t", "region": 0}]
    assert ops[0]["id"] == op["id"]
    assert same_node[0] == "InvalidArgumentsError"
    assert bad_region[0] == "InvalidArgumentsError"


# ---------------------------------------------------------------------------
# refine_range_rule (tests/test_balancer.py::TestRuleRefinement)
# ---------------------------------------------------------------------------

def test_refine_and_codec_roundtrip():
    def run(p):
        r = p.rule.RangePartitionRule("host", ["h5", p.rule.MAXVALUE],
                                      [0, 1])
        refined = p.rule.refine_range_rule(r, 1, "h8", [4, 5])
        back = p.mito._deserialize_rule(p.mito._serialize_rule(refined))
        got = refined.find_regions_by_filters(
            [p.ast.BinaryOp(">=", p.ast.Column("host"),
                            p.ast.Literal("h8", "string"))])
        return (repr(r.bounds), r.regions, repr(refined.bounds),
                refined.regions, repr(back.bounds), back.regions,
                [refined.find_region(h) for h in ("h6", "h9", "h1")], got,
                p.mito._serialize_rule(refined))
    out = both(run)
    assert out[:4] == ("['h5', MAXVALUE]", [0, 1],
                       "['h5', 'h8', MAXVALUE]", [0, 4, 5])
    assert out[6:8] == ([4, 5, 0], [5])


def test_refine_range_columns_single():
    def run(p):
        r = p.rule.RangeColumnsPartitionRule(
            ["host"], [("h5",), (p.rule.MAXVALUE,)], [0, 1])
        refined = p.rule.refine_range_rule(r, 0, "h2", [2, 3])
        back = p.mito._deserialize_rule(p.mito._serialize_rule(refined))
        return (repr(refined.bounds), refined.regions, repr(back.bounds),
                type(refined).__name__)
    out = both(run)
    assert out[:2] == ("[('h2',), ('h5',), (MAXVALUE,)]", [2, 3, 1])


@pytest.mark.parametrize("case,match", [
    ("above the bound", "not below"), ("at the lower bound", "not above"),
    ("hash rule", "hash"), ("unknown region", "not in rule"),
    ("three children", "exactly 2 children"),
    ("no value", "concrete literal")])
def test_refine_rejections(case, match):
    def run(p):
        r = p.rule.RangePartitionRule("host", ["h5", p.rule.MAXVALUE],
                                      [0, 1])
        args = {"above the bound": (r, 0, "h7", [2, 3]),
                "at the lower bound": (r, 1, "h5", [2, 3]),
                "hash rule": (p.rule.HashPartitionRule(["host"], [0, 1]),
                              0, "x", [2, 3]),
                "unknown region": (r, 9, "h2", [2, 3]),
                "three children": (r, 0, "h2", [2, 3, 4]),
                "no value": (r, 0, None, [2, 3])}[case]
        return _raises(lambda: p.rule.refine_range_rule(*args))
    kind, text = both(run)
    assert kind == "ValueError" and match in text


def test_meta_service_reads_the_wall_clock_like_the_reference():
    """Without `now=`, both services stamp heartbeats with time.time():
    a just-registered peer is alive in both."""
    def run(p):
        srv = p.meta.MetaSrv(p.kv.MemKv())
        client = p.meta.MetaClient(srv)
        client.heartbeat(5, _stat(p, [], 0))
        return [q.id for q in srv.alive_datanodes()], \
            [r["lease_state"] for r in client.cluster_info()]
    assert both(run) == ([5], ["leader", "alive"])
    assert time.time() > T0
