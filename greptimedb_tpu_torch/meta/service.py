"""Meta service: the cluster brain.

Reference behavior: src/meta-srv — datanode registration + lease-tracked
heartbeats (handler.rs:115-176), table-route creation with region placement
via selectors (service/router.rs:86-238, selector/load_based.rs:27-80),
table-id sequences (sequence.rs:28), phi-accrual failure detection driven
off heartbeats (failure_detector.rs, handler/failure_handler/runner.rs),
and route/table metadata persisted to the KV store
(keys.rs:398, catalog/src/helper.rs:95-132).

This runs in-process over MemKv (the reference's MemStore test topology,
meta-srv/src/mocks.rs); a gRPC facade can wrap it 1:1 for multi-host.

Ported from greptimedb_tpu/meta/service.py (a copy).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..errors import GreptimeError
from .failure_detector import PhiAccrualFailureDetector
from .kv import MemKv


@dataclass(frozen=True)
class Peer:
    id: int
    addr: str = ""

    def to_dict(self) -> dict:
        return {"id": self.id, "addr": self.addr}

    @staticmethod
    def from_dict(d: dict) -> "Peer":
        return Peer(d["id"], d.get("addr", ""))


@dataclass
class RegionRoute:
    region_number: int
    leader: Peer
    #: read replicas: standby peers continuously fed the
    #: leader's WAL tail; reads may scatter here, writes never do, and
    #: failover promotes the most-caught-up one
    followers: List[Peer] = field(default_factory=list)

    def to_dict(self) -> dict:
        d = {"region_number": self.region_number,
             "leader": self.leader.to_dict()}
        if self.followers:
            d["followers"] = [p.to_dict() for p in self.followers]
        return d

    @staticmethod
    def from_dict(d: dict) -> "RegionRoute":
        return RegionRoute(d["region_number"], Peer.from_dict(d["leader"]),
                           [Peer.from_dict(p)
                            for p in d.get("followers", [])])


@dataclass
class TableRoute:
    table_id: int
    table_name: str                    # catalog.schema.table
    region_routes: List[RegionRoute] = field(default_factory=list)
    #: bumped on EVERY placement mutation (failover, migrate commit,
    #: split commit) — frontends compare it after a StaleRouteError
    #: refresh to tell "the route moved" from "still mid-handoff"
    version: int = 0

    def regions_on(self, peer_id: int) -> List[int]:
        return [r.region_number for r in self.region_routes
                if r.leader.id == peer_id]

    def peers(self) -> List[Peer]:
        seen: Dict[int, Peer] = {}
        for r in self.region_routes:
            seen[r.leader.id] = r.leader
        return [seen[i] for i in sorted(seen)]

    def to_dict(self) -> dict:
        return {"table_id": self.table_id, "table_name": self.table_name,
                "region_routes": [r.to_dict() for r in self.region_routes],
                "version": self.version}

    @staticmethod
    def from_dict(d: dict) -> "TableRoute":
        return TableRoute(d["table_id"], d["table_name"],
                          [RegionRoute.from_dict(r)
                           for r in d["region_routes"]],
                          version=int(d.get("version", 0)))


@dataclass
class DatanodeStat:
    """Per-heartbeat datanode report (reference: the Stat/RegionStat pair
    in meta-srv's heartbeat handler). `region_stats` carries one
    {"region", "rows", "size_bytes"} dict per hosted region — the
    region-heat input the elastic-region control loop (ROADMAP item 1)
    will read, surfaced via information_schema.cluster_info."""
    region_count: int = 0
    approximate_rows: int = 0
    approximate_bytes: int = 0
    region_stats: List[dict] = field(default_factory=list)
    #: False for a light liveness beat that refreshes region_count only
    #: (the load_based selector needs it fresh every beat) while the
    #: expensive per-region walk rides every stats_every-th beat; meta
    #: must not derive an ingest rate from a light beat's zero rows
    full: bool = True


@dataclass
class HeartbeatResponse:
    mailbox: List[dict] = field(default_factory=list)


TABLE_ID_SEQ = "__meta/seq/table_id"
ROUTE_PREFIX = "__meta/route/"
PEER_PREFIX = "__meta/peer/"
TINFO_PREFIX = "__meta/tinfo/"
#: pending failover promotions: the repl_promote mail is
#: fire-and-forget, so the doc persists here until a full heartbeat from
#: the promoted node shows the region out of standby — a new leader that
#: dies mid-promote gets the mail again after it restarts
PROMOTE_PREFIX = "__balancer/promote/"


class NoAliveDatanodeError(GreptimeError):
    status_code = "RuntimeResourcesExhausted"


class MetaSrv:
    """Single-leader metadata service over a KV store."""

    def __init__(self, kv: Optional[MemKv] = None, *,
                 datanode_lease_secs: float = 15.0,
                 selector: str = "load_based",
                 phi_threshold: float = 8.0) -> None:
        from ..common.locks import TrackedRLock
        from ..common.tracking import tracked_state
        self.kv = kv if kv is not None else MemKv()
        self.datanode_lease_secs = datanode_lease_secs
        self.selector = selector
        #: guards ALL the in-memory heartbeat state below. Heartbeats
        #: arrive on one server thread per datanode while cluster_info /
        #: region_heat / the balancer tick / failover_check read
        #: concurrently — greptsan flagged the unguarded dicts the round
        #: they were wrapped (a half-updated rate map could feed the
        #: selector). kv reads/writes stay OUTSIDE the lock.
        self._state_lock = TrackedRLock("meta.srv_state")
        self._stats: Dict[int, DatanodeStat] = tracked_state(
            {}, "meta.srv.stats")
        #: (approximate_rows, t) of the previous stat-bearing heartbeat,
        #: so consecutive reports yield a per-node ingest rate
        self._prev_ingest: Dict[int, tuple] = tracked_state(
            {}, "meta.srv.prev_ingest")
        self._ingest_rate: Dict[int, float] = tracked_state(
            {}, "meta.srv.ingest_rate")
        #: per-REGION twins of the above: {node: {region: rows}} at the
        #: previous full beat and the derived {node: {region: rps}} —
        #: the cluster-wide region-heat feed the self-monitoring
        #: scraper persists into greptime_private.region_heat
        self._prev_region_rows: Dict[int, tuple] = tracked_state(
            {}, "meta.srv.prev_region_rows")
        self._region_rates: Dict[int, Dict[str, float]] = tracked_state(
            {}, "meta.srv.region_rates")
        #: replica catch-up feed off full heartbeats: per
        #: FOLLOWER node {region_name: (replicated_seq, beat_time)}, and
        #: per region name the LEADER-reported (committed_seq,
        #: beat_time) — region_peers derives lag_ms from the pair, and
        #: failover_check promotes the max-replicated_seq follower
        self._replica_seq: Dict[int, Dict[str, tuple]] = tracked_state(
            {}, "meta.srv.replica_seq")
        self._leader_seq: Dict[str, tuple] = tracked_state(
            {}, "meta.srv.leader_seq")
        #: last FULL (stat-bearing) beat per node — pending-promotion
        #: confirmation compares against it (a beat after the promote
        #: mail whose stats no longer flag the region standby)
        self._stat_time: Dict[int, float] = tracked_state(
            {}, "meta.srv.stat_time")
        self._last_seen: Dict[int, float] = tracked_state(
            {}, "meta.srv.last_seen")
        self._detectors: Dict[int, PhiAccrualFailureDetector] = \
            tracked_state({}, "meta.srv.detectors")
        self._phi_threshold = phi_threshold
        self._mailboxes: Dict[int, List[dict]] = tracked_state(
            {}, "meta.srv.mailboxes")
        # Startup grace: peers persist in the KV but _last_seen does not.
        # After a metasrv restart every persisted peer would read seen=None
        # and a single failover tick would reassign ALL healthy nodes'
        # regions (split-brain: the old leaders keep serving writes). Treat
        # process start as the last-seen time for unseen persisted peers.
        self._start_time = time.time()
        # elastic region control loop (split / migrate / rebalance): the
        # op state machines persist under __balancer/ in the same KV, so
        # a metasrv restart resumes them (meta/balancer.py)
        from .balancer import RegionBalancer
        self.balancer = RegionBalancer(self)

    # ---- membership ----
    def register_datanode(self, peer: Peer) -> None:
        self.kv.put(f"{PEER_PREFIX}{peer.id}",
                    json.dumps(peer.to_dict()).encode())
        with self._state_lock:
            self._last_seen[peer.id] = time.time()
            self._detectors.setdefault(
                peer.id,
                PhiAccrualFailureDetector(threshold=self._phi_threshold))

    def peers(self) -> List[Peer]:
        return [Peer.from_dict(json.loads(v))
                for _, v in self.kv.range(PEER_PREFIX)]

    def peer(self, node_id: int) -> Optional[Peer]:
        raw = self.kv.get(f"{PEER_PREFIX}{node_id}")
        return Peer.from_dict(json.loads(raw)) if raw is not None else None

    def alive_datanodes(self, now: Optional[float] = None) -> List[Peer]:
        now = time.time() if now is None else now
        out = []
        peers = self.peers()               # kv read outside the lock
        with self._state_lock:
            for p in peers:
                seen = self._last_seen.get(p.id)
                if seen is not None and \
                        now - seen <= self.datanode_lease_secs:
                    det = self._detectors.get(p.id)
                    if det is None or det.sample_count == 0 or \
                            det.is_available(now * 1000.0):
                        out.append(p)
        return out

    def failed_datanodes(self, now: Optional[float] = None) -> List[Peer]:
        """Peers whose phi crossed the threshold (failover candidates —
        the action itself is still TODO in the reference too)."""
        now = time.time() if now is None else now
        out = []
        peers = self.peers()
        with self._state_lock:
            for p in peers:
                det = self._detectors.get(p.id)
                if det is not None and det.sample_count > 0 and \
                        not det.is_available(now * 1000.0):
                    out.append(p)
        return out

    # ---- heartbeat ----
    def handle_heartbeat(self, node_id: int,
                         stat: Optional[DatanodeStat] = None,
                         now: Optional[float] = None) -> HeartbeatResponse:
        now = time.time() if now is None else now
        if self.kv.get(f"{PEER_PREFIX}{node_id}") is None:
            # first contact registers the peer (reference: heartbeats are
            # the registration channel, keep_lease_handler.rs)
            self.register_datanode(Peer(node_id))
        with self._state_lock:
            self._last_seen[node_id] = now
            det = self._detectors.setdefault(
                node_id,
                PhiAccrualFailureDetector(threshold=self._phi_threshold))
            det.heartbeat(now * 1000.0)
            if stat is not None and stat.full:
                prev = self._prev_ingest.get(node_id)
                if prev is not None and now > prev[1]:
                    self._ingest_rate[node_id] = max(
                        0.0, (stat.approximate_rows - prev[0]) /
                        (now - prev[1]))
                self._prev_ingest[node_id] = (stat.approximate_rows, now)
                # per-region rate across consecutive FULL beats (light
                # beats carry no region rows, so the divisor is the true
                # elapsed time between stat walks, same as the node rate)
                by_region = {rs["region"]: int(rs["rows"])
                             for rs in stat.region_stats}
                prev_r = self._prev_region_rows.get(node_id)
                if prev_r is not None and now > prev_r[1]:
                    dt = now - prev_r[1]
                    self._region_rates[node_id] = {
                        region: max(0.0,
                                    (rows - prev_r[0].get(region, 0)) / dt)
                        for region, rows in by_region.items()}
                self._prev_region_rows[node_id] = (by_region, now)
                self._stats[node_id] = stat
                # replica lag feed: standby regions report how far they
                # have applied, leader regions what they have committed
                repl: Dict[str, tuple] = {}
                for rs in stat.region_stats:
                    if rs.get("standby"):
                        repl[rs["region"]] = (
                            int(rs.get("replicated_seq", 0) or 0), now)
                    elif rs.get("committed_seq") is not None:
                        self._leader_seq[rs["region"]] = (
                            int(rs.get("committed_seq", 0) or 0), now)
                self._replica_seq[node_id] = repl
                self._stat_time[node_id] = now
            elif stat is not None:
                # light beat: region_count only (selector freshness);
                # keep the last full stat's rows/region heat intact
                kept = self._stats.get(node_id)
                if kept is not None:
                    kept.region_count = stat.region_count
                else:
                    self._stats[node_id] = stat
            msgs = self._mailboxes.pop(node_id, [])
        return HeartbeatResponse(mailbox=msgs)

    def send_mailbox(self, node_id: int, message: dict) -> None:
        """Reverse control: meta→datanode messages ride the next heartbeat
        response (reference handler.rs:244-302)."""
        with self._state_lock:
            self._mailboxes.setdefault(node_id, []).append(message)

    # ---- sequences ----
    def allocate_table_id(self) -> int:
        return self.kv.incr(TABLE_ID_SEQ, start=1023)

    # ---- routes ----
    def create_table_route(self, full_table_name: str,
                           region_numbers: List[int],
                           now: Optional[float] = None) -> TableRoute:
        alive = self.alive_datanodes(now)
        if not alive:
            raise NoAliveDatanodeError("no alive datanode to place regions")
        if self.selector == "load_based":
            # fewest-regions-first (reference load_based.rs:27-80)
            with self._state_lock:
                load = {p.id: self._stats.get(p.id,
                                              DatanodeStat()).region_count
                        for p in alive}
            order = sorted(alive, key=lambda p: (load[p.id], p.id))
        else:
            order = sorted(alive, key=lambda p: p.id)
        table_id = self.allocate_table_id()
        routes = [RegionRoute(rn, order[i % len(order)])
                  for i, rn in enumerate(sorted(region_numbers))]
        route = TableRoute(table_id, full_table_name, routes)
        key = f"{ROUTE_PREFIX}{full_table_name}"
        if not self.kv.compare_and_put(
                key, None, json.dumps(route.to_dict()).encode()):
            raise GreptimeError(f"table route exists: {full_table_name}")
        return route

    def table_route(self, full_table_name: str) -> Optional[TableRoute]:
        raw = self.kv.get(f"{ROUTE_PREFIX}{full_table_name}")
        if raw is None:
            return None
        return TableRoute.from_dict(json.loads(raw))

    def delete_table_route(self, full_table_name: str) -> bool:
        return self.kv.delete(f"{ROUTE_PREFIX}{full_table_name}")

    def rename_table_route(self, old_full_name: str,
                           new_full_name: str) -> Optional[TableRoute]:
        """Move a route (and its table info) to a new name, keeping the
        table id and region placement (distributed ALTER ... RENAME)."""
        route = self.table_route(old_full_name)
        if route is None:
            return None
        route.table_name = new_full_name
        new_key = f"{ROUTE_PREFIX}{new_full_name}"
        # one guarded multi-op (etcd-txn shape): route + info move together
        # or not at all, so a crash can't leave the table under both names
        ops = [("put", new_key, json.dumps(route.to_dict()).encode()),
               ("delete", f"{ROUTE_PREFIX}{old_full_name}", None)]
        info = self.table_info(old_full_name)
        if info is not None:
            ops += [("put", f"{TINFO_PREFIX}{new_full_name}",
                     json.dumps(info).encode()),
                    ("delete", f"{TINFO_PREFIX}{old_full_name}", None)]
        if not self.kv.batch(ops, guard=(new_key, None)):
            raise GreptimeError(f"table route exists: {new_full_name}")
        return route

    def all_table_routes(self) -> List[TableRoute]:
        return [TableRoute.from_dict(json.loads(v))
                for _, v in self.kv.range(ROUTE_PREFIX)]

    # ---- table info (reference: TableGlobalKey/Value in etcd,
    # catalog/src/helper.rs:95-132 — schema travels with the route so
    # failover can materialize a region on a fresh datanode) ----
    def put_table_info(self, full_table_name: str, info: dict) -> None:
        self.kv.put(f"{TINFO_PREFIX}{full_table_name}",
                    json.dumps(info).encode())

    def table_info(self, full_table_name: str) -> Optional[dict]:
        raw = self.kv.get(f"{TINFO_PREFIX}{full_table_name}")
        return json.loads(raw) if raw is not None else None

    def delete_table_info(self, full_table_name: str) -> bool:
        return self.kv.delete(f"{TINFO_PREFIX}{full_table_name}")

    # ---- cluster health view (backs information_schema.cluster_info;
    # reference: the CLUSTER_INFO memory table fed from meta's
    # heartbeat-collected NodeInfo) ----
    def cluster_info(self, now: Optional[float] = None,
                     metasrv_addr: str = "",
                     metasrv_state: Optional[str] = None) -> List[dict]:
        """One row per cluster member: the metasrv itself plus every
        registered datanode with its lease state (alive / suspect /
        expired / unknown), last-seen time, route-derived region count
        and heartbeat-reported size/ingest-rate stats. Region counts
        come from the routes — the authoritative placement — so the view
        is live even before a node's next stat-bearing heartbeat.
        `metasrv_state` is the serving metasrv's raft role when it is
        replicated (a follower answering a stale read must not claim
        leadership); a lone metasrv is trivially the leader."""
        now = time.time() if now is None else now
        # peer_id -1: datanode ids are >= 0 (DatanodeOptions defaults to
        # 0), so the metasrv row must not collide with one — and sorts
        # first under ORDER BY peer_id
        rows = [{
            "peer_id": -1, "peer_type": "metasrv",
            "peer_addr": metasrv_addr,
            "lease_state": metasrv_state or "leader",
            "last_seen_ms": int(now * 1000), "region_count": 0,
            "approximate_rows": 0, "ingest_rate_rps": 0.0,
            "region_stats": "[]",
        }]
        placed: Dict[int, int] = {}
        for route in self.all_table_routes():
            for rr in route.region_routes:
                placed[rr.leader.id] = placed.get(rr.leader.id, 0) + 1
        peers = self.peers()               # kv read outside the lock
        with self._state_lock:
            for p in peers:
                seen = self._last_seen.get(p.id)
                if seen is None:
                    state = "unknown"
                elif now - seen <= self.datanode_lease_secs:
                    state = "alive"
                    det = self._detectors.get(p.id)
                    if det is not None and det.sample_count > 0 and \
                            not det.is_available(now * 1000.0):
                        state = "suspect"
                else:
                    state = "expired"
                stat = self._stats.get(p.id, DatanodeStat())
                rows.append({
                    "peer_id": p.id, "peer_type": "datanode",
                    "peer_addr": p.addr, "lease_state": state,
                    "last_seen_ms": int(seen * 1000)
                    if seen is not None else None,
                    "region_count": placed.get(p.id, 0),
                    "approximate_rows": int(stat.approximate_rows),
                    # rate is a derivative: a node that stopped
                    # heartbeating isn't ingesting, so don't let its
                    # last-known rate read as the hottest ingester
                    # forever (approximate_rows is cumulative and stays
                    # as the last-known fact)
                    "ingest_rate_rps": round(
                        self._ingest_rate.get(p.id, 0.0), 3)
                    if state == "alive" else 0.0,
                    "region_stats": json.dumps(stat.region_stats,
                                               separators=(",", ":")),
                })
        return rows

    def region_heat(self, now: Optional[float] = None) -> List[dict]:
        """One row per (datanode, region): heartbeat-reported rows and
        size plus the per-region ingest rate derived across full stat
        beats — the cluster-wide feed behind
        greptime_private.region_heat. Rates zero for non-alive nodes
        (same derivative rule as cluster_info's node rate)."""
        now = time.time() if now is None else now
        alive = {p.id for p in self.alive_datanodes(now)}
        rows: List[dict] = []
        with self._state_lock:
            for node_id in sorted(self._stats):
                stat = self._stats[node_id]
                rates = self._region_rates.get(node_id, {})
                for rs in stat.region_stats:
                    rows.append({
                        "node": f"dn{node_id}",
                        "region": rs["region"],
                        "rows": int(rs["rows"]),
                        "size_bytes": int(rs["size_bytes"]),
                        # cost-planner inputs riding the heartbeat
                        # (absent from pre-upgrade beats: .get)
                        "series": int(rs.get("series", 0) or 0),
                        "time_span": int(rs.get("time_span", 0) or 0),
                        "ingest_rate_rps": round(
                            rates.get(rs["region"], 0.0), 3)
                        if node_id in alive else 0.0,
                    })
        return rows

    # ---- elastic region admin (ADMIN MIGRATE/SPLIT/REBALANCE route
    # here through the frontends; meta/balancer.py runs the state
    # machines) ----
    def admin_migrate_region(self, full_table_name: str, region: int,
                             to_node: int) -> dict:
        return self.balancer.migrate(full_table_name, region, to_node)

    def admin_split_region(self, full_table_name: str, region: int,
                           at_value: object = None) -> dict:
        return self.balancer.split(full_table_name, region,
                                   at_value=at_value)

    def admin_rebalance(self, full_table_name: Optional[str] = None
                        ) -> List[dict]:
        return self.balancer.rebalance(full_table_name)

    def admin_add_replica(self, full_table_name: str, region: int,
                          to_node: int) -> dict:
        return self.balancer.add_replica(full_table_name, region, to_node)

    def admin_remove_replica(self, full_table_name: str, region: int,
                             node: int) -> dict:
        return self.balancer.remove_replica(full_table_name, region, node)

    def balancer_ack(self, node_id: int, op_id: str, step: str, ok: bool,
                     error: Optional[str], payload: dict) -> None:
        self.balancer.handle_ack(node_id, op_id, step, ok, error, payload)

    def region_peers(self, now: Optional[float] = None) -> List[dict]:
        """One row per (table, region, hosting peer): the leader row
        plus one row per read-replica follower, each with its lease
        state, replication position (`replicated_seq` — the leader row
        carries its committed sequence) and staleness bound (`lag_ms`),
        plus any in-flight balancer operation touching the region — the
        information_schema.region_peers feed and the replica-aware read
        router's input."""
        now = time.time() if now is None else now
        states = {r["peer_id"]: r["lease_state"]
                  for r in self.cluster_info(now)}
        addrs = {p.id: p.addr for p in self.peers()}
        ops_by_region: Dict[tuple, dict] = {}
        for op in self.balancer.ops():
            ops_by_region[(op["table"], op["region"])] = op
            for child in op.get("children") or []:
                ops_by_region.setdefault((op["table"], child), op)
        with self._state_lock:
            replica_seq = {nid: dict(m)
                           for nid, m in self._replica_seq.items()}
            leader_seq = dict(self._leader_seq)
        rows: List[dict] = []
        for route in self.all_table_routes():
            for rr in sorted(route.region_routes,
                             key=lambda r: r.region_number):
                op = ops_by_region.get(
                    (route.table_name, rr.region_number))
                rname = f"{route.table_id}_{rr.region_number:010d}"
                committed = leader_seq.get(rname, (None,))[0]
                base = {
                    "table_name": route.table_name,
                    "region_number": rr.region_number,
                    "route_version": route.version,
                    "operation": f"{op['kind']}:{op['state']}"
                    if op is not None else None,
                    "op_id": op["id"] if op is not None else None,
                }
                rows.append({
                    **base,
                    "peer_id": rr.leader.id,
                    "peer_addr": addrs.get(rr.leader.id, rr.leader.addr),
                    "is_leader": "Yes",
                    "status": states.get(rr.leader.id, "unknown").upper(),
                    "replicated_seq": committed,
                    "lag_ms": 0,
                })
                for f in rr.followers:
                    rep = replica_seq.get(f.id, {}).get(rname)
                    if rep is None:
                        lag_ms = None       # no stat beat yet: unknown
                    elif committed is not None and rep[0] >= committed:
                        lag_ms = 0          # fully caught up
                    else:
                        # staleness bound: the replica held everything
                        # as of its last stat-bearing heartbeat
                        lag_ms = max(0, int((now - rep[1]) * 1000))
                    rows.append({
                        **base,
                        "peer_id": f.id,
                        "peer_addr": addrs.get(f.id, f.addr),
                        "is_leader": "No",
                        "status": states.get(f.id, "unknown").upper(),
                        "replicated_seq": rep[0] if rep else None,
                        "lag_ms": lag_ms,
                    })
        rows.sort(key=lambda r: (r["table_name"], r["region_number"],
                                 r["is_leader"] != "Yes", r["peer_id"]))
        return rows

    # ---- region failover (the action the reference leaves TODO,
    # meta-srv/src/handler/failure_handler/runner.rs:132; design per
    # docs/rfcs/2023-03-08-region-fault-tolerance.md: region data lives
    # on shared object storage, so a dead node's regions reopen
    # elsewhere at their last-flushed state) ----
    def failover_check(self, now: Optional[float] = None) -> List[dict]:
        """Re-place regions led by dead datanodes onto alive ones and
        mail open_regions to the new leaders. Regions with a caught-up
        read replica are PROMOTED instead: the most-replicated alive
        follower becomes leader (mail repl_promote so it fences the dead
        leader's WAL, refreshes off the shared manifest and salvages the
        acked tail — zero acked rows lost). Dead followers are pruned.
        Returns the moves."""
        from ..common import failpoint as _fp
        now_t = time.time() if now is None else now
        self._retry_pending_promotions(now_t)
        dead = {p.id for p in self.failed_datanodes(now_t)}
        peers = self.peers()
        with self._state_lock:
            for p in peers:
                seen = self._last_seen.get(p.id, self._start_time)
                if now_t - seen > 2 * self.datanode_lease_secs:
                    dead.add(p.id)
        if not dead:
            return []
        alive = [p for p in self.alive_datanodes(now_t)
                 if p.id not in dead]
        if not alive:
            return []
        alive_ids = {p.id for p in alive}
        with self._state_lock:
            load = {p.id: self._stats.get(p.id,
                                          DatanodeStat()).region_count
                    for p in alive}
            replica_seq = {nid: dict(m)
                           for nid, m in self._replica_seq.items()}
        # tables mid-balancer-op are off limits: re-placing a region the
        # balancer is migrating would dual-own it (both paths rewrite the
        # route); the op finishes or times out into a rollback first, and
        # a truly dead source is caught by the NEXT failover pass
        busy_tables = {o["table"] for o in self.balancer.ops()}
        moves: List[dict] = []
        for route in self.all_table_routes():
            if route.table_name in busy_tables:
                continue
            changed = False
            rewire: List = []      # region routes whose follower set or
            promote: List = []     # leader changed: re-wire the shipper
            assigned: Dict[int, List[int]] = {}
            catalog, schema_name, tname = route.table_name.split(".", 2)
            for rr in route.region_routes:
                live_followers = [f for f in rr.followers
                                  if f.id not in dead]
                if len(live_followers) != len(rr.followers):
                    rr.followers = live_followers
                    changed = True
                    rewire.append(rr)
                if rr.leader.id not in dead:
                    continue
                old = rr.leader
                rname = f"{route.table_id}_{rr.region_number:010d}"
                candidates = [f for f in rr.followers
                              if f.id in alive_ids]
                if candidates:
                    # most-caught-up follower takes over: its standby
                    # region already holds everything up to its
                    # replicated_seq, so promotion replays the least
                    best = max(candidates, key=lambda f: (
                        replica_seq.get(f.id, {}).get(rname, (0, 0))[0],
                        -f.id))
                    rr.leader = best
                    rr.followers = [f for f in rr.followers
                                    if f.id != best.id]
                    load[best.id] = load.get(best.id, 0) + 1
                    pmsg = {
                        "type": "repl_promote", "catalog": catalog,
                        "schema": schema_name, "table": tname,
                        "region": rr.region_number,
                        "old_leader": old.id}
                    # durable until a post-promote heartbeat confirms:
                    # the mail itself is fire-and-forget, and a new
                    # leader that dies mid-promote must get it again
                    self.kv.put(
                        f"{PROMOTE_PREFIX}{best.id}/{rname}",
                        json.dumps({"node": best.id,
                                    "region_name": rname,
                                    "msg": pmsg, "t": now_t}).encode())
                    promote.append((best.id, pmsg))
                    rewire.append(rr)
                    moves.append({"table": route.table_name,
                                  "region": rr.region_number,
                                  "from": old.id, "to": best.id,
                                  "promoted": True})
                else:
                    target = min(alive, key=lambda p: (load[p.id], p.id))
                    load[target.id] += 1
                    rr.leader = target
                    assigned.setdefault(target.id, []).append(
                        rr.region_number)
                    moves.append({"table": route.table_name,
                                  "region": rr.region_number,
                                  "from": old.id, "to": target.id})
                changed = True
            if not changed:
                continue
            route.version += 1     # placement changed: stale frontends
            _fp.fail_point("balancer_route_commit")       # must refresh
            self.kv.put(f"{ROUTE_PREFIX}{route.table_name}",
                        json.dumps(route.to_dict()).encode())
            info = self.table_info(route.table_name)
            for node_id, region_numbers in assigned.items():
                self.send_mailbox(node_id, {
                    "type": "open_regions", "catalog": catalog,
                    "schema": schema_name, "table": tname,
                    "table_id": route.table_id,
                    "region_numbers": region_numbers,
                    "table_info": info})
            # fire-and-forget (no op_id → no ack): promotions first so
            # the new leader unfences before shipping resumes, then
            # shipper re-wires reflecting the pruned/promoted sets
            for node_id, msg in promote:
                self.send_mailbox(node_id, msg)
            for rr in rewire:
                self.send_mailbox(rr.leader.id, {
                    "type": "repl_set_followers", "catalog": catalog,
                    "schema": schema_name, "table": tname,
                    "region": rr.region_number,
                    "followers": [f.to_dict() for f in rr.followers]})
        return moves

    def _retry_pending_promotions(self, now_t: float) -> None:
        """Re-mail repl_promote for promotions the new leader has not
        confirmed (a full heartbeat after the mail whose stats show the
        region out of standby). The step is idempotent on the datanode,
        so duplicate deliveries are harmless; a doc whose region has
        since been re-routed away from the node is dropped."""
        docs = self.kv.range(PROMOTE_PREFIX)
        if not docs:
            return
        with self._state_lock:
            stat_time = dict(self._stat_time)
            replica_seq = {nid: dict(m)
                           for nid, m in self._replica_seq.items()}
        leaders = {}
        for route in self.all_table_routes():
            for rr in route.region_routes:
                leaders[f"{route.table_id}_{rr.region_number:010d}"] = \
                    rr.leader.id
        for key, raw in docs:
            try:
                doc = json.loads(raw)
                nid, rname = int(doc["node"]), doc["region_name"]
            except (ValueError, KeyError, TypeError):
                self.kv.delete(key)
                continue
            if leaders.get(rname) != nid:
                self.kv.delete(key)    # superseded by a later failover
                continue
            if stat_time.get(nid, 0.0) > float(doc["t"]) and \
                    rname not in replica_seq.get(nid, {}):
                self.kv.delete(key)    # promotion confirmed
                continue
            self.send_mailbox(nid, doc["msg"])


class MetaClient:
    """Client SDK facade (reference: src/meta-client). In-process it calls
    the service directly; the wire version keeps the same surface."""

    def __init__(self, srv: MetaSrv) -> None:
        self._srv = srv

    def register(self, peer: Peer) -> None:
        self._srv.register_datanode(peer)

    def heartbeat(self, node_id: int, stat: Optional[DatanodeStat] = None
                  ) -> HeartbeatResponse:
        return self._srv.handle_heartbeat(node_id, stat)

    def create_route(self, full_name: str, region_numbers: List[int]
                     ) -> TableRoute:
        return self._srv.create_table_route(full_name, region_numbers)

    def route(self, full_name: str) -> Optional[TableRoute]:
        return self._srv.table_route(full_name)

    def delete_route(self, full_name: str) -> bool:
        return self._srv.delete_table_route(full_name)

    def rename_route(self, full_name: str,
                     new_full_name: str) -> Optional[TableRoute]:
        return self._srv.rename_table_route(full_name, new_full_name)

    def allocate_table_id(self) -> int:
        return self._srv.allocate_table_id()

    def cluster_info(self) -> List[dict]:
        return self._srv.cluster_info()

    def background_jobs(self) -> List[dict]:
        """In-process twin of the wire action: the shared process
        registry (the view's (node, job_id) dedup absorbs the
        duplication with the frontend's own rows)."""
        from ..common import background_jobs
        return background_jobs.rows()

    def region_heat(self) -> List[dict]:
        return self._srv.region_heat()

    def region_peers(self) -> List[dict]:
        return self._srv.region_peers()

    def admin_migrate_region(self, full_name: str, region: int,
                             to_node: int) -> dict:
        return self._srv.admin_migrate_region(full_name, region, to_node)

    def admin_split_region(self, full_name: str, region: int,
                           at_value: object = None) -> dict:
        return self._srv.admin_split_region(full_name, region, at_value)

    def admin_rebalance(self, full_name: Optional[str] = None
                        ) -> List[dict]:
        return self._srv.admin_rebalance(full_name)

    def admin_add_replica(self, full_name: str, region: int,
                          to_node: int) -> dict:
        return self._srv.admin_add_replica(full_name, region, to_node)

    def admin_remove_replica(self, full_name: str, region: int,
                             node: int) -> dict:
        return self._srv.admin_remove_replica(full_name, region, node)

    def balancer_configure(self, knob: str, value: object) -> None:
        self._srv.balancer.configure(knob, value)

    def balancer_ack(self, node_id: int, op_id: str, step: str, ok: bool,
                     error: Optional[str], payload: dict) -> None:
        self._srv.balancer_ack(node_id, op_id, step, ok, error, payload)

    def put_table_info(self, full_name: str, info: dict) -> None:
        self._srv.put_table_info(full_name, info)

    def table_info(self, full_name: str) -> Optional[dict]:
        return self._srv.table_info(full_name)

    def delete_table_info(self, full_name: str) -> bool:
        return self._srv.delete_table_info(full_name)

    # generic kv passthroughs (flow specs persist under __flow/ so a
    # restarted frontend recovers its continuous rollups from meta)
    def kv_put(self, key: str, value: bytes) -> None:
        self._srv.kv.put(key, value)

    def kv_get(self, key: str) -> Optional[bytes]:
        return self._srv.kv.get(key)

    def kv_range(self, prefix: str) -> List[Tuple[str, bytes]]:
        return self._srv.kv.range(prefix)

    def kv_delete(self, key: str) -> bool:
        return self._srv.kv.delete(key)
