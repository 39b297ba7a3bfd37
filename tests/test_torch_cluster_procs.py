"""The cluster's control plane as processes: `greptime metasrv start
--peers` of each package, three children each on the CPU, held to one
another.

A module fixture (`procs`) starts both packages' replica sets at once
(free ports, a raft store per child, `--failover-interval 1
--datanode-lease-secs 3`), then drives each through the same steps:

- a leader answers cluster_info through `FailoverFlightMetaClient`;
- a port datanode in this process (`device="cpu"`, node id 7, behind
  its FlightDatanodeServer) registers and heartbeats through the port's
  `FailoverFlightMetaClient`, and meta places a table's regions on it;
- the leader child is killed with SIGKILL: the client reaches a new
  leader, the route reads back equal, and the datanode's next beat
  keeps cluster_info alive on the new leader;
- SIGTERM ends each surviving child with exit code 0 within 10 s.

Each case compares what the port's children answered with what the
reference's did, after taking out addresses and clock readings. Every
wait polls with a deadline far above the time it takes.
"""

from __future__ import annotations

import os
import random
import signal
import socket
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"ref": "greptimedb_tpu", "port": "greptimedb_tpu_torch"}
NODE = 7
TABLE = "greptime.public.procs"
#: deadline of each wait: children start in seconds, elections in one
DEADLINE_S = 120.0


def _free_ports(n):
    """n ports free now, below the kernel's ephemeral range. A child binds
    its port seconds after this returns, with SO_REUSEPORT (gRPC's
    default): a port from the ephemeral range could meanwhile go to
    another test's port-0 server and then be shared with it."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            lo = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        lo = 32768
    rng = random.Random()
    ports = []
    while len(ports) < n:
        port = rng.randrange(10000, lo)
        if port in ports:
            continue
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        ports.append(port)
    return ports


def _wait(pred, what, procs=()):
    deadline = time.monotonic() + DEADLINE_S
    while True:
        for p in procs:
            assert p.poll() is None, f"{what}: a child exited {p.returncode}"
        try:
            v = pred()
        except Exception:  # noqa: BLE001 — not serving yet
            v = None
        if v is not None:
            return v
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.05)


class Replicas:
    """Three `metasrv start --peers` children of one package."""

    def __init__(self, pkg, home):
        self.addrs = [f"127.0.0.1:{p}" for p in _free_ports(3)]
        self.logs, self.procs = [], []
        for i, addr in enumerate(self.addrs):
            log = open(home / f"meta{i}.log", "w")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", f"{pkg}.cmd.main", "metasrv", "start",
                 "--bind-addr", addr, "--peers", ",".join(self.addrs),
                 "--store", str(home / f"meta{i}"), "--failover-interval",
                 "1", "--datanode-lease-secs", "3", "--log-level", "warn"],
                cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                env=dict(os.environ, OMP_NUM_THREADS="1")))

    def index_of(self, address):
        return self.addrs.index(address.split("://", 1)[-1])

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
        for log in self.logs:
            log.close()


def _info(rows, leader_addr):
    """cluster_info without clock readings; the metasrv row's address as
    'leader'."""
    out = []
    for r in rows:
        r = {k: v for k, v in r.items() if k != "last_seen_ms"}
        if r["peer_type"] == "metasrv":
            assert r["peer_addr"] == leader_addr, r
            r["peer_addr"] = "<leader>"
        else:
            r["peer_addr"] = "<datanode>"
        out.append(r)
    return out


def _route(route, dn_addr):
    """A route with the datanode's address taken out."""
    doc = route.to_dict()
    for rr in doc["region_routes"]:
        assert rr["leader"]["addr"] == dn_addr, rr
        rr["leader"]["addr"] = "<datanode>"
    return doc


def _drive(reps, home):
    """The steps of the module docstring on one replica set."""
    from greptimedb_tpu_torch.datanode import (
        DatanodeInstance, DatanodeOptions)
    from greptimedb_tpu_torch.meta import Peer
    from greptimedb_tpu_torch.meta.flight import FailoverFlightMetaClient
    from greptimedb_tpu_torch.servers.flight import FlightDatanodeServer
    out = {}
    meta = FailoverFlightMetaClient([f"grpc://{a}" for a in reps.addrs],
                                    retry_delay=0.1, max_rounds=600)
    dn = server = None
    try:
        t0 = time.monotonic()
        first = _wait(meta.cluster_info, "a metasrv leader", reps.procs)
        out["first_answer_s"] = time.monotonic() - t0
        out["info_empty"] = _info(first, meta.address)
        dn = DatanodeInstance(DatanodeOptions(
            data_home=str(home / "dn"), node_id=NODE, device="cpu",
            register_numbers_table=False, flow_tick_interval_s=0,
            self_monitor_interval_s=0))
        dn.start()
        server = FlightDatanodeServer(dn)
        server.serve_in_background()
        meta.register(Peer(NODE, server.address))
        dn.start_heartbeat(meta, interval_s=3600, stats_every=1)
        out["alive"] = [p.id for p in meta.list_datanodes()]
        route = meta.create_route(TABLE, [0, 1, 2])
        out["route"] = _route(route, server.address)
        dn._heartbeat_task.fn()
        out["info_beat"] = _info(meta.cluster_info(), meta.address)
        leader = reps.index_of(meta.address)
        reps.procs[leader].send_signal(signal.SIGKILL)
        reps.procs[leader].wait(30)
        t0 = time.monotonic()
        again = _wait(lambda: meta.route(TABLE), "a new leader's route",
                      [p for i, p in enumerate(reps.procs) if i != leader])
        out["new_leader_s"] = time.monotonic() - t0
        out["route_after_kill"] = _route(again, server.address)
        out["new_leader"] = reps.index_of(meta.address) != leader
        dn._heartbeat_task.fn()
        out["info_after_kill"] = _info(meta.cluster_info(), meta.address)
        rcs = []
        for i, p in enumerate(reps.procs):
            if i == leader:
                continue
            t1 = time.monotonic()
            p.send_signal(signal.SIGTERM)
            rcs.append((p.wait(10), time.monotonic() - t1 < 10))
        out["sigterm"] = rcs
    finally:
        meta.close()
        if server is not None:
            server.shutdown()
        if dn is not None:
            dn.shutdown()
    return out


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    homes = {s: tmp_path_factory.mktemp(f"procs_{s}") for s in PKGS}
    reps = {}
    try:
        for side, pkg in PKGS.items():
            reps[side] = Replicas(pkg, homes[side])
        yield {side: _drive(reps[side], homes[side]) for side in PKGS}
    finally:
        for r in reps.values():
            r.close()


STEPS = ["info_empty", "alive", "route", "info_beat", "route_after_kill",
         "new_leader", "info_after_kill", "sigterm"]


@pytest.mark.parametrize("step", STEPS)
def test_port_children_answer_as_the_reference(procs, step):
    assert procs["port"][step] == procs["ref"][step]


@pytest.mark.parametrize("side", sorted(PKGS))
def test_replica_set_survives_leader_kill(procs, side):
    """A leader answers, places the datanode's regions, and after its
    SIGKILL a new leader serves the same route and the datanode's
    liveness; the survivors exit 0 on SIGTERM."""
    out = procs[side]
    meta_row = out["info_empty"][0]
    assert (meta_row["peer_type"], meta_row["lease_state"]) == \
        ("metasrv", "leader")
    assert out["alive"] == [NODE]
    assert {r["leader"]["id"] for r in out["route"]["region_routes"]} == \
        {NODE}
    assert out["route_after_kill"] == out["route"]
    assert out["new_leader"] is True
    for key in ("info_beat", "info_after_kill"):
        rows = {r["peer_id"]: r for r in out[key]}
        assert rows[-1]["lease_state"] == "leader"
        assert rows[NODE]["lease_state"] == "alive"
        assert rows[NODE]["region_count"] == 3
    assert out["sigterm"] == [(0, True), (0, True)]
    assert out["first_answer_s"] < DEADLINE_S
    assert out["new_leader_s"] < DEADLINE_S
