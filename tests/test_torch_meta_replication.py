"""The port's raft-replicated meta KV (greptimedb_tpu_torch/meta/
replication.py) held to the reference's (greptimedb_tpu/meta/
replication.py).

- The reference's scenarios (tests/test_meta_replication.py) on port
  nodes: election, the leader hint, the batch guard, writes and ids
  surviving a leader kill, log compaction, a crash between the snapshot
  and the log write, snapshot install, concurrent proposals, a restarted
  node rejoining, MetaSrv routes surviving a leader kill, and the Flight
  transport with cluster_info's redirect.
- Mixed clusters: nodes of both packages in one cluster, in process and
  over FlightTransport (each node behind its own package's
  FlightMetaServer), electing, replicating and surviving a leader kill.
- Byte compatibility: one scripted sequence of proposals and RPCs gives
  both packages the same answers and the same persisted `<store>` and
  `<store>.snap` bytes, and each package reopens the other's state.

Host-only code: nothing here compiles a JAX program. Every wait polls
with a deadline far above the time it takes.
"""

from __future__ import annotations

import json
import threading
import time

import pytest

import greptimedb_tpu.meta.flight as ref_flight
import greptimedb_tpu.meta.replication as ref_repl
import greptimedb_tpu.meta.service as ref_service
import greptimedb_tpu_torch.meta.flight as port_flight
import greptimedb_tpu_torch.meta.replication as port_repl
import greptimedb_tpu_torch.meta.service as port_service
from greptimedb_tpu_torch.errors import GreptimeError
from greptimedb_tpu_torch.meta.kv import MemKv
from greptimedb_tpu_torch.meta.replication import (
    HaMetaClient, NotLeaderError, RaftNode, ReplicatedKv)
from greptimedb_tpu_torch.meta.service import MetaSrv, Peer

REPL = {"ref": ref_repl, "port": port_repl}
FLIGHT = {"ref": ref_flight, "port": port_flight}
SERVICE = {"ref": ref_service, "port": port_service}

FAST = dict(election_timeout=(0.25, 0.5), heartbeat_interval=0.08)
#: deadline of every wait: with FAST, elections take under a second
DEADLINE_S = 30.0
#: node kinds of a three-node cluster
COMPOSITIONS = {"port": ("port", "port", "port"),
                "mixed": ("ref", "port", "ref")}


def wait_for(pred, timeout=DEADLINE_S, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def make_nodes(kinds, tmp_path=None, **kw):
    ids = list(range(1, len(kinds) + 1))
    opts = {**FAST, **kw}
    return [REPL[k].RaftNode(i, ids,
                             store_path=str(tmp_path / f"raft-{i}.json")
                             if tmp_path else None, **opts)
            for i, k in zip(ids, kinds)]


def connect(nodes):
    """Each node reaches the others through its own package's
    LocalTransport."""
    for a in nodes:
        for b in nodes:
            if a is not b:
                mod = ref_repl if type(a) is ref_repl.RaftNode else port_repl
                a.transports[b.node_id] = mod.LocalTransport(b)


def make_cluster(kinds=COMPOSITIONS["port"], tmp_path=None, **kw):
    nodes = make_nodes(kinds, tmp_path, **kw)
    connect(nodes)
    for nd in nodes:
        nd.start()
    return nodes


def leader_of(nodes):
    live = [nd for nd in nodes if nd._threads]
    return wait_for(lambda: next((nd for nd in live if nd.is_leader), None),
                    what="leader election")


def kv_of(node):
    return (ref_repl if type(node) is ref_repl.RaftNode
            else port_repl).ReplicatedKv(node)


NOT_LEADER = (ref_repl.NotLeaderError, port_repl.NotLeaderError)
UNCERTAIN = (ref_repl.ProposeUncertainError,
             port_repl.ProposeUncertainError)


def on_leader(nodes, op, idempotent=False, what="leader write"):
    """op(kv) on whichever live node leads, and that node. A leader
    starved of its process's GIL past the election timeout loses its
    term to a follower; its proposal then raises NotLeaderError, which
    means the entry never committed (it was not appended, or the new
    leader overwrote it), so the op runs again on the new leader. A
    ProposeUncertainError (no quorum ack in time: the entry may still
    commit) is retried only for an `idempotent` op, a put of the same
    value; on a CAS or an incr it propagates."""
    retry = NOT_LEADER + (UNCERTAIN if idempotent else ())
    deadline = time.monotonic() + DEADLINE_S
    while True:
        leader = leader_of(nodes)
        try:
            return op(kv_of(leader)), leader
        except retry:
            if time.monotonic() > deadline:
                raise AssertionError(f"timed out waiting for {what}")


def crash(node):
    """Stop the node and cut its links (a process kill)."""
    node.stop()
    node.transports = {}


def partition_away(nodes, dead):
    for nd in nodes:
        nd.transports.pop(dead.node_id, None)


def stop_all(nodes):
    for nd in nodes:
        nd.stop()


# ---------------------------------------------------------------------------
# the reference's scenarios on port nodes
# ---------------------------------------------------------------------------

class TestElection:
    def test_single_leader_emerges(self):
        nodes = make_cluster()
        try:
            leader_of(nodes)

            def settled():
                # one leader, whose heartbeats every follower heeds
                leaders = [nd for nd in nodes if nd.is_leader]
                return len(leaders) == 1 and all(
                    nd.leader_id == leaders[0].node_id for nd in nodes)
            wait_for(settled, what="one leader named by every node")
        finally:
            stop_all(nodes)

    def test_new_leader_after_kill(self):
        nodes = make_cluster()
        try:
            leader = leader_of(nodes)
            crash(leader)
            partition_away(nodes, leader)
            survivors = [nd for nd in nodes if nd is not leader]
            new = wait_for(lambda: next((nd for nd in survivors
                                         if nd.is_leader), None),
                           what="re-election")
            assert new is not leader and new.term > 0
        finally:
            stop_all(nodes)

    def test_non_leader_raises_with_hint(self):
        nodes = make_cluster()
        try:
            leader = leader_of(nodes)
            ReplicatedKv(leader).put("k", b"v")
            follower = next(nd for nd in nodes if nd is not leader)
            wait_for(lambda: follower.leader_id == leader.node_id,
                     what="leader hint propagation")
            with pytest.raises(NotLeaderError) as ei:
                ReplicatedKv(follower).get("k")
            assert ei.value.leader_id == leader.node_id
            with pytest.raises(NotLeaderError):
                ReplicatedKv(follower).put("k", b"w")
        finally:
            stop_all(nodes)


class TestBatch:
    def test_batch_atomic_and_guarded(self):
        nodes = make_cluster()
        try:
            leader = leader_of(nodes)
            kv = ReplicatedKv(leader)
            kv.put("route/old", b"r1")
            kv.put("tinfo/old", b"i1")
            assert kv.batch(
                [("put", "route/new", b"r1"), ("delete", "route/old", None),
                 ("put", "tinfo/new", b"i1"), ("delete", "tinfo/old", None)],
                guard=("route/new", None))
            assert kv.get("route/new") == b"r1"
            assert kv.get("route/old") is None
            assert kv.get("tinfo/new") == b"i1"
            kv.put("route/back", b"x")
            assert not kv.batch([("put", "route/clobber", b"y"),
                                 ("delete", "route/new", None)],
                                guard=("route/back", None))
            assert kv.get("route/clobber") is None
            assert kv.get("route/new") == b"r1"
            with pytest.raises(ValueError):
                kv.batch([("frob", "x", b"1")])
            with pytest.raises(ValueError):
                kv.batch([("put", "x", "not bytes")])
            follower = next(nd for nd in nodes if nd is not leader)
            wait_for(lambda: follower.applied_idx == leader.applied_idx,
                     what="follower apply")
            assert follower.state.get("route/new") == b"r1"
            assert "route/old" not in follower.state
        finally:
            stop_all(nodes)

    def test_memkv_batch_guard(self):
        kv = MemKv()
        kv.put("a", b"1")
        assert kv.batch([("put", "b", b"2"), ("delete", "a", None)],
                        guard=("b", None))
        assert kv.get("a") is None and kv.get("b") == b"2"
        assert not kv.batch([("put", "c", b"3")], guard=("b", None))
        assert kv.get("c") is None


class TestReplication:
    @pytest.mark.parametrize("comp", sorted(COMPOSITIONS))
    def test_writes_survive_leader_kill(self, tmp_path, comp):
        nodes = make_cluster(COMPOSITIONS[comp], tmp_path)
        try:
            for i in range(5):
                on_leader(nodes, lambda kv: kv.put(f"key{i}",
                                                   f"val{i}".encode()),
                          idempotent=True)
            took, leader = on_leader(
                nodes, lambda kv: kv.compare_and_put("locked", None, b"a"))
            assert took
            crash(leader)
            partition_away(nodes, leader)
            survivors = [nd for nd in nodes if nd is not leader]
            for i in range(5):
                assert on_leader(survivors, lambda kv: kv.get(
                    f"key{i}"))[0] == f"val{i}".encode()
            assert not on_leader(survivors, lambda kv: kv.compare_and_put(
                "locked", None, b"b"))[0]
            assert on_leader(survivors, lambda kv: kv.compare_and_put(
                "locked", b"a", b"b"))[0]
        finally:
            stop_all(nodes)

    @pytest.mark.parametrize("comp", sorted(COMPOSITIONS))
    def test_incr_monotonic_across_failover(self, tmp_path, comp):
        nodes = make_cluster(COMPOSITIONS[comp], tmp_path)
        try:
            seen = []
            for _ in range(3):
                v, leader = on_leader(nodes, lambda kv: kv.incr("seq"))
                seen.append(v)
            crash(leader)
            partition_away(nodes, leader)
            survivors = [nd for nd in nodes if nd is not leader]
            seen += [on_leader(survivors, lambda kv: kv.incr("seq"))[0]
                     for _ in range(3)]
            assert seen == [1, 2, 3, 4, 5, 6]
        finally:
            stop_all(nodes)

    def test_follower_catches_up(self):
        nodes = make_cluster()
        try:
            leader = leader_of(nodes)
            ReplicatedKv(leader).put("a", b"1")
            follower = next(nd for nd in nodes if nd is not leader)
            wait_for(lambda: follower.state.get("a") == b"1",
                     what="follower apply")
        finally:
            stop_all(nodes)

    def test_non_utf8_values_roundtrip(self):
        nodes = make_cluster()
        try:
            leader = leader_of(nodes)
            kv = ReplicatedKv(leader)
            blob = bytes(range(256))
            kv.put("bin", blob)
            assert kv.get("bin") == blob
            assert kv.compare_and_put("bin", blob, b"\xff\xfe\x00")
            assert kv.get("bin") == b"\xff\xfe\x00"
            kv.batch([("put", "bin2", b"\x80\x81")])
            assert kv.get("bin2") == b"\x80\x81"
            assert kv.range("bin") == [("bin", b"\xff\xfe\x00"),
                                       ("bin2", b"\x80\x81")]
            follower = next(nd for nd in nodes if nd is not leader)
            wait_for(lambda: follower.state.get("bin2") == b"\x80\x81",
                     what="binary replication")
        finally:
            stop_all(nodes)


class TestLogCompaction:
    def test_log_stays_bounded(self, tmp_path):
        import os
        ids = [1, 2, 3]
        nodes = make_cluster(COMPOSITIONS["port"], tmp_path,
                             compact_threshold=32)
        try:
            for i in range(1000):
                _, leader = on_leader(nodes, lambda kv: kv.put(
                    f"k{i % 50}", f"v{i}".encode()), idempotent=True)
            assert len(leader.log) <= 32 + 4
            assert leader.base > 900
            log_bytes = sum(os.path.getsize(tmp_path / f"raft-{i}.json")
                            for i in ids[:2])
            assert log_bytes < 64_000
            committed = leader.commit_idx
            stop_all(nodes)
            revived = make_cluster(COMPOSITIONS["port"], tmp_path,
                                   compact_threshold=32)
            nodes.extend(revived)
            leader2 = leader_of(revived)
            wait_for(lambda: leader2.applied_idx >= committed,
                     what="revived apply")
            for i in range(950, 1000):
                assert on_leader(revived, lambda kv: kv.get(
                    f"k{i % 50}"))[0] == f"v{i}".encode()
        finally:
            stop_all(nodes)

    def test_crash_between_snapshot_and_log_write(self, tmp_path):
        import shutil
        ids = [1, 2, 3]
        nodes = make_cluster(COMPOSITIONS["port"], tmp_path,
                             compact_threshold=32)
        stale = tmp_path / "stale-log.json"
        try:
            def put(key, value):
                on_leader(nodes, lambda kv: kv.put(key, value.encode()),
                          idempotent=True)
            for i in range(100):
                put(f"k{i % 20}", f"v{i}")
            # the node whose log file goes stale: the leader of the first
            # writes (it compacts as a follower too if its term ends)
            leader = leader_of(nodes)
            wait_for(lambda: leader.base > 0, what="first compaction")
            lid = leader.node_id
            log_path = tmp_path / f"raft-{lid}.json"
            shutil.copy(log_path, stale)
            base_at_copy = leader.base
            for i in range(100, 200):
                put(f"k{i % 20}", f"v{i}")
            with leader._lock:
                last = leader._last_index()
            j = 0
            while leader.base < last and j < 300:
                put("filler", f"f{j}")
                j += 1
            assert leader.base >= last
            expected = {f"k{j}": f"v{180 + j}" for j in range(20)}
            stop_all(nodes)
            shutil.copy(stale, log_path)
            revived = RaftNode(lid, ids, compact_threshold=32,
                               store_path=str(log_path), **FAST)
            assert revived.base > base_at_copy
            assert revived.applied_idx == revived.base
            assert len(revived.log) <= 32 + 4
            for key, val in expected.items():
                assert revived.state.get(key) == val.encode(), key
        finally:
            stop_all(nodes)

    def test_truncated_history_refused(self, tmp_path):
        """A log whose base lies past every snapshot is refused, not
        served as an empty state."""
        path = tmp_path / "raft-1.json"
        path.write_text(json.dumps({"term": 3, "voted_for": 1, "base": 9,
                                    "snapshot_term": 2, "enc": "latin-1",
                                    "log": []}))
        for mod in REPL.values():
            with pytest.raises(Exception, match="truncated history"):
                mod.RaftNode(1, [1, 2, 3], store_path=str(path))

    def test_lagging_follower_gets_snapshot_install(self):
        nodes = make_cluster(COMPOSITIONS["port"], compact_threshold=16)
        try:
            leader = leader_of(nodes)
            kv = ReplicatedKv(leader)
            kv.put("seed", b"1")
            follower = next(nd for nd in nodes if nd is not leader)
            wait_for(lambda: follower.state.get("seed") == b"1",
                     what="initial sync")
            follower.stop()
            partition_away(nodes, follower)
            for i in range(200):
                kv.put(f"k{i}", f"v{i}".encode())
            assert leader.base > 100
            assert follower.base == 0
            connect(nodes)
            follower.start()
            wait_for(lambda: follower.state.get("k199") == b"v199",
                     what="snapshot install catch-up")
            assert follower.base > 0
            assert follower.state.get("seed") == b"1"
        finally:
            stop_all(nodes)


def _try_route(ha, name):
    try:
        return ha.route(name)
    except GreptimeError:
        return None


class TestMetaSrvFailover:
    def test_routes_survive_leader_kill(self, tmp_path):
        # in process, HaMetaClient catches its own package's
        # NotLeaderError: mixed clusters are held over Flight below
        nodes = make_cluster(COMPOSITIONS["port"], tmp_path)
        srvs = [MetaSrv(ReplicatedKv(nd)) for nd in nodes]
        ha = HaMetaClient(srvs)
        try:
            leader_of(nodes)
            ha.register(Peer(1, "dn1"))
            ha.register(Peer(2, "dn2"))
            ha.heartbeat(1)
            ha.heartbeat(2)
            route = ha.create_route("greptime.public.t1", [0, 1])
            tid = route.table_id
            leader = next(nd for nd in nodes if nd.is_leader)
            crash(leader)
            partition_away(nodes, leader)
            got = wait_for(lambda: _try_route(ha, "greptime.public.t1"),
                           what="route after failover")
            assert got.to_dict() == route.to_dict()
            ha.heartbeat(1)
            ha.heartbeat(2)
            r2 = ha.create_route("greptime.public.t2", [0])
            assert r2.table_id != tid
        finally:
            stop_all(nodes)


class TestConcurrentProposals:
    def test_parallel_writers_all_committed(self):
        nodes = make_cluster()
        try:
            leader = leader_of(nodes)
            kv = ReplicatedKv(leader)
            errs = []

            def writer(tid):
                try:
                    for i in range(10):
                        kv.put(f"t{tid}-{i}", f"v{tid}-{i}".encode())
                        kv.incr("shared_seq")
                except Exception as e:  # noqa: BLE001
                    errs.append(e)

            threads = [threading.Thread(target=writer, args=(t,))
                       for t in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=DEADLINE_S)
            assert not errs, errs
            for tid in range(6):
                for i in range(10):
                    assert kv.get(f"t{tid}-{i}") == f"v{tid}-{i}".encode()
            assert int(kv.get("shared_seq")) == 60
            follower = next(nd for nd in nodes if nd is not leader)
            wait_for(lambda: follower.applied_idx >= leader.applied_idx,
                     what="follower convergence")
            assert follower.state == leader.state
        finally:
            stop_all(nodes)


class TestRestartRejoin:
    def test_restarted_node_rejoins_with_word_kept(self, tmp_path):
        nodes = make_cluster(COMPOSITIONS["port"], tmp_path)
        try:
            leader = leader_of(nodes)
            kv = ReplicatedKv(leader)
            for i in range(4):
                kv.put(f"r{i}", f"x{i}".encode())
            follower = next(nd for nd in nodes if nd is not leader)
            fid = follower.node_id
            wait_for(lambda: follower.state.get("r3") == b"x3",
                     what="follower sync")
            follower.stop()
            partition_away(nodes, follower)
            kv.put("during_outage", b"yes")
            revived = RaftNode(fid, [nd.node_id for nd in nodes],
                               store_path=str(tmp_path / f"raft-{fid}.json"),
                               **FAST)
            assert len(revived.log) >= 4
            assert revived.term == follower.term
            live = [nd for nd in nodes if nd is not follower] + [revived]
            connect(live)
            nodes.append(revived)
            revived.start()
            wait_for(lambda: revived.state.get("during_outage") == b"yes",
                     what="revived catch-up")
            assert revived.state.get("r0") == b"x0"
        finally:
            stop_all(nodes)


# ---------------------------------------------------------------------------
# over Flight: port clusters and mixed clusters
# ---------------------------------------------------------------------------

FLIGHT_COMPOSITIONS = {"port": ("port", "port", "port"),
                       "ref-port-port": ("ref", "port", "port"),
                       "port-ref-ref": ("port", "ref", "ref")}


class FlightCluster:
    """Three raft nodes, each behind its own package's FlightMetaServer
    over a MetaSrv of its ReplicatedKv, linked by the sender's
    package's FlightTransport.

    A server's shutdown waits for its serve thread to return: a Flight
    server whose serve() is still winding down can close the listening
    socket of a server created after it in the same process (pyarrow
    25; about one new server in twenty refused every connection when
    the old serve thread was not joined), and a node behind such a
    server never hears from its leader."""

    def __init__(self, kinds):
        self.kinds = kinds
        self.nodes = make_nodes(kinds)
        self.srvs = [SERVICE[k].MetaSrv(REPL[k].ReplicatedKv(nd))
                     for k, nd in zip(kinds, self.nodes)]
        self.servers = [FLIGHT[k].FlightMetaServer(s, raft_node=nd)
                        for k, s, nd in zip(kinds, self.srvs, self.nodes)]
        self.serving = [s.serve_in_background() for s in self.servers]
        for k, a in zip(kinds, self.nodes):
            for b, sb in zip(self.nodes, self.servers):
                if a is not b:
                    a.transports[b.node_id] = REPL[k].FlightTransport(
                        sb.address)
        for nd in self.nodes:
            nd.start()
        self.dead = set()

    def live(self):
        return [i for i in range(len(self.nodes)) if i not in self.dead]

    def leader(self):
        """The index of the live leader."""
        return wait_for(lambda: [i for i in self.live()
                                 if self.nodes[i].is_leader],
                        what="wire leader election")[0]

    def _shutdown_server(self, i):
        self.servers[i].shutdown()
        self.serving[i].join(DEADLINE_S)
        assert not self.serving[i].is_alive(), f"server {i + 1} serves on"

    def kill(self, i):
        self.dead.add(i)
        self.nodes[i].stop()
        self._shutdown_server(i)

    def close(self):
        for i in self.live():
            self.nodes[i].stop()
            self._shutdown_server(i)


@pytest.fixture()
def flight_cluster(request):
    c = FlightCluster(FLIGHT_COMPOSITIONS[request.param])
    yield c
    c.close()


@pytest.mark.parametrize("flight_cluster", sorted(FLIGHT_COMPOSITIONS),
                         indirect=True)
def test_wire_cluster_elects_replicates_and_survives_leader_kill(
        flight_cluster):
    """Raft over FlightTransport with the nodes' packages as given: a
    leader is elected, a write through it reaches every follower, and
    after the leader's kill the survivors elect a new one that serves
    every earlier write and takes new ones."""
    c = flight_cluster
    li = c.leader()
    kv = REPL[c.kinds[li]].ReplicatedKv(c.nodes[li])
    kv.put("wire", b"ok")
    kv.put("bin", bytes(range(256)))
    assert kv.incr("seq") == 1
    for i in c.live():
        wait_for(lambda i=i: c.nodes[i].state.get("wire") == b"ok",
                 what=f"node {i + 1} applies the write")
    c.kill(li)
    nli = c.leader()
    assert nli != li
    kv2 = REPL[c.kinds[nli]].ReplicatedKv(c.nodes[nli])
    assert kv2.get("wire") == b"ok"
    assert kv2.get("bin") == bytes(range(256))
    assert kv2.incr("seq") == 2
    kv2.put("after", b"kill")
    other = next(i for i in c.live() if i != nli)
    wait_for(lambda: c.nodes[other].state.get("after") == b"kill",
             what="the surviving follower applies the new write")


@pytest.mark.parametrize("flight_cluster", ["ref-port-port"], indirect=True)
@pytest.mark.parametrize("client", ["ref", "port"])
def test_wire_routes_survive_leader_kill(flight_cluster, client):
    """Either package's FailoverFlightMetaClient over a mixed cluster: a
    route created before the leader's kill reads back equal after it,
    and cluster_info redirects to the leader, whose heartbeat view comes
    back from the datanode's beats."""
    c = flight_cluster
    c.leader()
    ha = FLIGHT[client].FailoverFlightMetaClient(
        [s.address for s in c.servers], retry_delay=0.05,
        max_rounds=int(DEADLINE_S / 0.05))
    try:
        peer = SERVICE[client].Peer
        ha.register(peer(1, "dn1"))
        ha.heartbeat(1)
        route = ha.create_route("greptime.public.t", [0, 1])
        info = {n["peer_id"]: n for n in ha.cluster_info()}
        assert info[1]["lease_state"] == "alive"
        assert info[-1]["lease_state"] == "leader"
        c.kill(c.leader())
        got = wait_for(lambda: _try_route(ha, "greptime.public.t"),
                       what="route after the leader's kill")
        assert got.to_dict() == route.to_dict()
        ha.heartbeat(1)
        info = {n["peer_id"]: n for n in ha.cluster_info()}
        assert info[1]["lease_state"] == "alive"
        assert ha.create_route("greptime.public.t2", [0]).table_id != \
            route.table_id
    finally:
        ha.close()


def test_cluster_info_redirects_to_leader():
    """A follower asked for cluster_info raises NotLeaderError over the
    wire (its heartbeat memory is empty); the failover client rides the
    redirect to the leader's view."""
    c = FlightCluster(FLIGHT_COMPOSITIONS["port"])
    try:
        li = c.leader()
        c.srvs[li].handle_heartbeat(7)
        deadline = time.monotonic() + DEADLINE_S
        while True:
            fi = next((i for i in c.live() if not c.nodes[i].is_leader),
                      None)
            if fi is not None:
                direct = port_flight.FlightMetaClient(c.servers[fi].address)
                try:
                    direct.cluster_info()
                except NotLeaderError:
                    break
                finally:
                    direct.close()
                assert c.nodes[fi].is_leader, \
                    "a follower served cluster_info"
            assert time.monotonic() < deadline, "no stable follower"
            time.sleep(0.05)
        ha = port_flight.FailoverFlightMetaClient(
            [s.address for s in c.servers])
        try:
            ha.cluster_info()
            ha.heartbeat(7)
            info = {n["peer_id"]: n for n in ha.cluster_info()}
            assert info[7]["lease_state"] == "alive"
            assert info[-1]["lease_state"] == "leader"
        finally:
            ha.close()
    finally:
        c.close()


# ---------------------------------------------------------------------------
# byte compatibility of the persisted state and the RPC answers
# ---------------------------------------------------------------------------

def _solo(mod, path, threshold):
    """A one-node cluster: its election needs no peer, so the script
    runs with no thread and no timer."""
    nd = mod.RaftNode(1, [1], store_path=str(path),
                      compact_threshold=threshold)
    nd._run_election()
    assert nd.is_leader
    return nd


def _propose_script(mod, nd):
    kv = mod.ReplicatedKv(nd)
    out = [kv.put("a", b"1"), kv.get("a"),
           kv.compare_and_put("a", b"2", b"3"),
           kv.compare_and_put("a", b"1", b"\xff\x00"),
           kv.compare_and_put("b", None, b"x"),
           kv.compare_and_delete("b", b"y"), kv.compare_and_delete("b", b"x"),
           kv.incr("seq", start=1023), kv.incr("seq", start=1023),
           kv.batch([("put", "p/1", b"u"), ("put", "p/2", bytes(range(200))),
                     ("delete", "a", None)], guard=("p/1", None)),
           kv.batch([("put", "p/3", b"w")], guard=("p/1", None)),
           kv.delete("p/1"), kv.delete("p/1"), kv.range("p/")]
    for i in range(12):
        out.append(kv.put(f"k{i % 5}", f"v{i}".encode("latin-1") + b"\xe9"))
    out.append(kv.range("k"))
    return out


@pytest.mark.parametrize("threshold", [256, 8])
def test_persisted_state_is_byte_identical(tmp_path, threshold):
    """The same proposals on a one-node cluster of each package give the
    same answers and the same `<store>` and `<store>.snap` bytes (with
    compaction at 8 entries, and without)."""
    files, answers = {}, {}
    for side, mod in REPL.items():
        d = tmp_path / side
        d.mkdir()
        nd = _solo(mod, d / "m.raft", threshold)
        answers[side] = _propose_script(mod, nd)
        files[side] = {p.name: p.read_bytes() for p in d.iterdir()}
    assert answers["port"] == answers["ref"]
    assert files["port"] == files["ref"]
    assert ("m.raft.snap" in files["port"]) == (threshold == 8)


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
@pytest.mark.parametrize("threshold", [256, 8])
def test_each_package_reopens_the_others_state(tmp_path, writer, reader,
                                               threshold):
    """A node of one package restarts from the other's persisted state
    (log, and snapshot when compacted): same term, vote, log and
    applied state once it leads again."""
    path = tmp_path / "m.raft"
    nd = _solo(REPL[writer], path, threshold)
    _propose_script(REPL[writer], nd)
    want = dict(nd.state)
    re_ = REPL[reader].RaftNode(1, [1], store_path=str(path),
                                compact_threshold=threshold)
    def bare(log):
        # as persisted: no apply results, tuples as JSON lists
        return json.loads(json.dumps(
            [{k: v for k, v in e.items() if k != "result"} for e in log]))
    assert (re_.term, re_.voted_for, re_.base, bare(re_.log)) == \
        (nd.term, nd.voted_for, nd.base, bare(nd.log))
    re_._run_election()
    re_.propose({"kind": "noop"})
    assert re_.state == want
    assert REPL[reader].ReplicatedKv(re_).get("p/2") == bytes(range(200))


def _rpc_script(mod):
    """One follower's answers to a fixed sequence of raft RPCs."""
    nd = mod.RaftNode(2, [1, 2, 3], compact_threshold=4)
    e = [{"term": 1, "op": {"kind": "noop"}},
         {"term": 1, "op": {"kind": "put", "key": "a", "value": "\xff1"}},
         {"term": 1, "op": {"kind": "incr", "key": "n", "start": 5}},
         {"term": 2, "op": {"kind": "cap", "key": "a", "expect": "\xff1",
                            "value": "2"}}]
    out = [
        nd.handle_request_vote(term=1, candidate=1, last_idx=0, last_term=0),
        nd.handle_request_vote(term=1, candidate=3, last_idx=0, last_term=0),
        nd.handle_append_entries(term=1, leader=1, prev_idx=0, prev_term=0,
                                 entries=e[:3], commit_idx=2),
        nd.handle_append_entries(term=1, leader=1, prev_idx=5, prev_term=1,
                                 entries=[], commit_idx=2),
        nd.handle_append_entries(term=0, leader=3, prev_idx=0, prev_term=0,
                                 entries=[], commit_idx=0),
        nd.handle_append_entries(term=2, leader=3, prev_idx=3, prev_term=1,
                                 entries=e[3:], commit_idx=4),
        nd.handle_request_vote(term=3, candidate=1, last_idx=2, last_term=1),
        nd.handle_install_snapshot(term=3, leader=1, base=9, snapshot_term=3,
                                   state={"z": "\x80", "a": "2"}),
        nd.handle_append_entries(term=3, leader=1, prev_idx=9, prev_term=3,
                                 entries=[{"term": 3, "op": {
                                     "kind": "batch",
                                     "guard": {"key": "z", "expect": "\x80"},
                                     "ops": [["delete", "z", None],
                                             ["put", "y", "\x01"]]}}],
                                 commit_idx=10),
    ]
    return out, (nd.term, nd.voted_for, nd.base, nd.snapshot_term,
                 nd.commit_idx, nd.applied_idx, nd.role, nd.leader_id,
                 sorted(nd.state.items()))


def test_rpc_handlers_answer_alike():
    """Vote grants and refusals, appends with a gap, a stale term and a
    conflicting suffix, a vote in a later term, a snapshot install and a
    guarded batch: the same answers and the same follower state."""
    assert _rpc_script(port_repl) == _rpc_script(ref_repl)


# ---------------------------------------------------------------------------
# the port's raft RPC deadline (the reference's transport has none)
# ---------------------------------------------------------------------------

class _StuckServer:
    """A Flight server whose every action blocks until released: a peer
    that accepted the connection and never answers."""

    def __init__(self):
        import pyarrow.flight as flight

        release = self.release = threading.Event()

        class Server(flight.FlightServerBase):
            def do_action(self, context, action):
                release.wait(DEADLINE_S)
                return iter([])

        self.server = Server("grpc://127.0.0.1:0")
        self.address = f"grpc://127.0.0.1:{self.server.port}"
        self.thread = threading.Thread(target=self.server.serve,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.release.set()
        self.server.shutdown()
        self.thread.join(DEADLINE_S)


@pytest.fixture()
def stuck_peer():
    s = _StuckServer()
    yield s
    s.close()


def test_flight_transport_raises_within_its_deadline(stuck_peer):
    """A raft call to a peer that never answers raises within the
    transport's deadline (half the owning node's lower election timeout)
    plus 0.5 s, and the transport drops its client so the next call
    dials again."""
    nd = RaftNode(1, [1, 2])
    tr = port_repl.FlightTransport(stuck_peer.address, node=nd)
    assert tr.rpc_deadline == nd._el_lo / 2 <= nd._el_lo
    for rpc in (tr.append_entries, tr.request_vote):
        t0 = time.monotonic()
        with pytest.raises(Exception):
            rpc(term=1, leader=1, candidate=1, prev_idx=0, prev_term=0,
                entries=[], commit_idx=0, last_idx=0, last_term=0)
        took = time.monotonic() - t0
        assert took < tr.rpc_deadline + 0.5, took
        assert tr._client is None
    # without an owning node the deadline follows RaftNode's default
    assert port_repl.FlightTransport(stuck_peer.address).rpc_deadline == \
        port_repl.ELECTION_TIMEOUT[0] / 2


def test_replication_round_survives_a_stuck_peer(stuck_peer):
    """With one stuck peer (asked first) and one live peer, the election
    and the no-op's replication round each end in about one deadline,
    reach a majority and advance commit_idx; the stuck calls count as
    raft_rpc_errors."""
    from greptimedb_tpu_torch.common.telemetry import registry_snapshot

    def counter_value(name):
        return sum(v for n, _labels, v, _kind in registry_snapshot()
                   if n == f"greptime_{name}_total")

    lead, live = RaftNode(1, [1, 2, 3]), RaftNode(3, [1, 2, 3])
    lead.transports = {
        2: port_repl.FlightTransport(stuck_peer.address, node=lead),
        3: port_repl.LocalTransport(live)}
    assert lead.peer_ids == [2, 3]
    errors0 = counter_value("raft_rpc_errors")
    t0 = time.monotonic()
    lead._run_election()                    # votes, then one round
    took = time.monotonic() - t0
    assert lead.is_leader
    assert lead.commit_idx == 1 and lead.applied_idx == 1
    assert took < 2 * lead.transports[2].rpc_deadline + 1.0, took
    assert counter_value("raft_rpc_errors") - errors0 == 2
    t0 = time.monotonic()
    assert lead._replicate()                # the next heartbeat round
    assert time.monotonic() - t0 < lead.transports[2].rpc_deadline + 0.5
    assert live.commit_idx == 1


def test_flight_leader_brings_a_lagging_follower_up_to_date():
    """A follower that missed a leader's entries refuses its first
    AppendEntries over Flight (`ok: false` with its `have` hint). The
    port's FlightTransport returns that refusal as LocalTransport does,
    so the leader walks next_idx back and the follower takes the whole
    log in one round. (The reference's transport raises on the refusal,
    so its leader counts an RPC error and never catches the follower
    up: after a leader's kill, a new leader whose only live follower
    lagged cannot commit.)"""
    follower = RaftNode(2, [1, 2])
    server = port_flight.FlightMetaServer(
        MetaSrv(ReplicatedKv(follower)), raft_node=follower)
    serving = server.serve_in_background()
    try:
        lead = RaftNode(1, [1, 2])
        with lead._lock:
            lead.term, lead.role, lead.leader_id = 2, "leader", 1
            lead.log = [{"term": 1, "op": {"kind": "noop"}},
                        {"term": 1, "op": {"kind": "put", "key": "a",
                                           "value": "1"}},
                        {"term": 2, "op": {"kind": "noop"}}]
            lead.next_idx = {2: 2}       # as if it had heard of entry 2
        lead.transports[2] = port_repl.FlightTransport(server.address,
                                                       node=lead)
        assert lead._replicate()
        assert lead.commit_idx == 3 and lead.state == {"a": b"1"}
        assert [e["term"] for e in follower.log] == [1, 1, 2]
        assert follower.term == 2 and follower.leader_id == 1
        # a stale term's refusal is an answer too: the leader steps down
        with follower._lock:
            follower.term = 5
        assert not lead._replicate()
        assert lead.term == 5 and not lead.is_leader
    finally:
        server.shutdown()
        serving.join(DEADLINE_S)
