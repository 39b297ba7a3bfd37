"""Wire facade for the meta service: Flight/gRPC server + client.

Reference behavior: src/meta-srv/src/service/ exposes the metadata
server's heartbeat/router/store RPCs over tonic gRPC, and
src/meta-client wraps them in a client SDK (client.rs). Here the same
surface rides Arrow Flight actions (Flight is gRPC) with JSON bodies:
`FlightMetaServer` wraps an in-process `MetaSrv`; `FlightMetaClient`
implements the exact `MetaClient` interface, so datanodes heartbeat and
frontends resolve routes across real sockets with no call-site changes.

Ported from greptimedb_tpu/meta/flight.py (a copy): the action names and
JSON bodies are the reference's, so either package's client talks to
either package's server. Importing it loads no torch: a metasrv process
holds no regions and never opens the card. `shutdown()` waits for the
serve thread (servers/flight.py's servers do too), which the
reference's does not.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from typing import Iterator, List, Optional, Tuple

import pyarrow.flight as flight

from ..errors import GreptimeError
from .service import (
    DatanodeStat, HeartbeatResponse, MetaSrv, Peer, TableRoute)


class FlightMetaServer(flight.FlightServerBase):
    def __init__(self, srv: MetaSrv, location: str = "grpc://127.0.0.1:0",
                 raft_node: object = None) -> None:
        super().__init__(location)
        self.srv = srv
        self.raft_node = raft_node    # replication RPCs when clustered
        self._location = location

    @property
    def address(self) -> str:
        from ..servers.flight import _advertised_address
        return _advertised_address(self._location, self.port)

    def serve_in_background(self) -> threading.Thread:
        from ..common.runtime import new_thread
        t = new_thread(self.serve, daemon=True, name="flight-metasrv",
                       propagate_context=False)
        t.start()
        self._serving = t
        return t

    def shutdown(self) -> None:
        """Shut down, then wait for the serve thread to return: a Flight
        server whose serve() is still winding down can close the
        listening socket of a server made after it in the same process
        (pyarrow 25)."""
        super().shutdown()
        t = getattr(self, "_serving", None)
        if t is not None and t is not threading.current_thread():
            t.join()

    def do_action(self, context: object, action: "flight.Action"
                  ) -> Iterator["flight.Result"]:
        body = json.loads(action.body.to_pybytes() or b"{}")
        kind = action.type
        # popped (not just read): raft_* handlers splat **body, and the
        # trace keys must not reach them as unexpected arguments. The
        # verdict piggyback matters little here (metasrv-rooted balancer
        # traces verdict locally), but a frontend's _traced() attaches
        # it to every meta RPC all the same
        from ..common.telemetry import remote_context
        from ..servers.flight import _apply_wire_verdicts
        _apply_wire_verdicts(body)
        with remote_context(body.pop("traceparent", None)):
            yield from self._do_action_inner(kind, body)

    def _do_action_inner(self, kind: str, body: dict
                         ) -> Iterator["flight.Result"]:
        try:
            if kind == "register":
                self.srv.register_datanode(Peer.from_dict(body["peer"]))
                resp = {"ok": True}
            elif kind == "heartbeat":
                stat = DatanodeStat(**body["stat"]) \
                    if body.get("stat") else None
                hb = self.srv.handle_heartbeat(body["node_id"], stat)
                resp = {"ok": True, "mailbox": hb.mailbox}
            elif kind == "create_route":
                route = self.srv.create_table_route(
                    body["name"], body["region_numbers"])
                resp = {"ok": True, "route": route.to_dict()}
            elif kind == "route":
                route = self.srv.table_route(body["name"])
                resp = {"ok": True,
                        "route": route.to_dict() if route else None}
            elif kind == "delete_route":
                resp = {"ok": True,
                        "deleted": self.srv.delete_table_route(
                            body["name"])}
            elif kind == "rename_route":
                route = self.srv.rename_table_route(body["name"],
                                                    body["new_name"])
                resp = {"ok": True,
                        "route": route.to_dict() if route else None}
            elif kind == "allocate_table_id":
                resp = {"ok": True, "id": self.srv.allocate_table_id()}
            elif kind == "put_table_info":
                self.srv.put_table_info(body["name"], body["info"])
                resp = {"ok": True}
            elif kind == "table_info":
                resp = {"ok": True,
                        "info": self.srv.table_info(body["name"])}
            elif kind == "delete_table_info":
                resp = {"ok": True,
                        "deleted": self.srv.delete_table_info(
                            body["name"])}
            elif kind == "cluster_info":
                # heartbeat state (_last_seen/_stats/detectors) is
                # leader-local memory: a follower would report a healthy
                # cluster as all-unknown. Redirect the caller — the
                # failover client retries the next replica on this.
                if self.raft_node is not None \
                        and not self.raft_node.is_leader:
                    from .replication import NotLeaderError
                    raise NotLeaderError(self.raft_node.leader_id)
                resp = {"ok": True, "nodes": self.srv.cluster_info(
                    metasrv_addr=self.address,
                    metasrv_state=self.raft_node.role
                    if self.raft_node is not None else None)}
            elif kind == "region_heat":
                # same leader-only rule as cluster_info: heartbeat stats
                # are leader-local memory
                if self.raft_node is not None \
                        and not self.raft_node.is_leader:
                    from .replication import NotLeaderError
                    raise NotLeaderError(self.raft_node.leader_id)
                resp = {"ok": True, "rows": self.srv.region_heat()}
            elif kind == "region_peers":
                # leader-only like cluster_info: lease state + balancer
                # op state are leader-local memory
                if self.raft_node is not None \
                        and not self.raft_node.is_leader:
                    from .replication import NotLeaderError
                    raise NotLeaderError(self.raft_node.leader_id)
                resp = {"ok": True, "rows": self.srv.region_peers()}
            elif kind in ("admin_migrate_region", "admin_split_region",
                          "admin_rebalance", "admin_add_replica",
                          "admin_remove_replica", "balancer_ack",
                          "balancer_configure"):
                # balancer surface: ops mutate routes / consume leader-
                # local acks, so only the leader may run them
                if self.raft_node is not None \
                        and not self.raft_node.is_leader:
                    from .replication import NotLeaderError
                    raise NotLeaderError(self.raft_node.leader_id)
                if kind == "admin_migrate_region":
                    resp = {"ok": True,
                            "op": self.srv.admin_migrate_region(
                                body["name"], body["region"],
                                body["to_node"])}
                elif kind == "admin_split_region":
                    resp = {"ok": True,
                            "op": self.srv.admin_split_region(
                                body["name"], body["region"],
                                body.get("at_value"))}
                elif kind == "admin_rebalance":
                    resp = {"ok": True,
                            "ops": self.srv.admin_rebalance(
                                body.get("name"))}
                elif kind == "admin_add_replica":
                    resp = {"ok": True,
                            "op": self.srv.admin_add_replica(
                                body["name"], body["region"],
                                body["to_node"])}
                elif kind == "admin_remove_replica":
                    resp = {"ok": True,
                            "op": self.srv.admin_remove_replica(
                                body["name"], body["region"],
                                body["node"])}
                elif kind == "balancer_configure":
                    self.srv.balancer.configure(body["knob"],
                                                body["value"])
                    resp = {"ok": True}
                else:
                    self.srv.balancer_ack(
                        body["node_id"], body["op_id"], body["step"],
                        body["ok"], body.get("error"),
                        body.get("payload") or {})
                    resp = {"ok": True}
            elif kind == "background_jobs":
                # THIS replica's live + recent background work (the
                # balancer runs on the leader, so its rows live there;
                # any replica may answer about itself — the registry is
                # process-local memory, not raft state)
                from ..common import background_jobs
                resp = {"ok": True, "jobs": background_jobs.rows()}
            elif kind == "list_datanodes":
                peers = self.srv.alive_datanodes() \
                    if body.get("alive_only", True) else self.srv.peers()
                resp = {"ok": True,
                        "peers": [p.to_dict() for p in peers]}
            elif kind == "kv_put":
                # generic kv passthroughs (values base64 — they are
                # bytes, e.g. flow-spec JSON docs under __flow/); a
                # wire frontend recovers its flows from these
                import base64
                self.srv.kv.put(body["key"],
                                base64.b64decode(body["value"]))
                resp = {"ok": True}
            elif kind == "kv_get":
                import base64
                v = self.srv.kv.get(body["key"])
                resp = {"ok": True,
                        "value": base64.b64encode(v).decode()
                        if v is not None else None}
            elif kind == "kv_range":
                import base64
                resp = {"ok": True, "items": [
                    [k, base64.b64encode(v).decode()]
                    for k, v in self.srv.kv.range(body["prefix"])]}
            elif kind == "kv_delete":
                resp = {"ok": True,
                        "deleted": bool(self.srv.kv.delete(body["key"]))}
            elif kind == "raft_request_vote" and self.raft_node is not None:
                resp = {"ok": True,
                        **self.raft_node.handle_request_vote(**body)}
            elif kind == "raft_append_entries" \
                    and self.raft_node is not None:
                resp = {"ok": True,
                        **self.raft_node.handle_append_entries(**body)}
            elif kind == "raft_install_snapshot" \
                    and self.raft_node is not None:
                resp = {"ok": True,
                        **self.raft_node.handle_install_snapshot(**body)}
            else:
                raise GreptimeError(f"unknown meta action {kind!r}")
        except GreptimeError as e:
            resp = {"ok": False, "error": str(e),
                    "error_type": type(e).__name__}
        if not kind.startswith("raft_"):
            # metasrv-rooted retained traces (balancer op steps) ride
            # home on whatever meta RPC comes next — the same export
            # channel the datanode servers use (raft bodies stay
            # protocol-pure)
            from ..servers.flight import _export_spans
            exported = _export_spans()
            if exported:
                resp["trace_spans"] = exported
        yield flight.Result(json.dumps(resp).encode())


class FlightMetaClient:
    """MetaClient surface over a FlightMetaServer."""

    def __init__(self, address: str) -> None:
        self.address = address
        self._conn: Optional[flight.FlightClient] = None

    @property
    def conn(self) -> flight.FlightClient:
        if self._conn is None:
            self._conn = flight.FlightClient(self.address)
        return self._conn

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def _action(self, kind: str, body: dict) -> dict:
        from ..client.flight import (_absorb_wire_spans,
                                     _to_greptime_error, _traced)
        try:
            results = list(self.conn.do_action(
                flight.Action(kind, json.dumps(_traced(body)).encode())))
            resp = json.loads(results[0].body.to_pybytes())
        except flight.FlightError as e:
            raise _to_greptime_error(e) from None
        _absorb_wire_spans(resp.pop("trace_spans", None))
        if not resp.get("ok", False):
            if resp.get("error_type") == "NotLeaderError":
                from .replication import NotLeaderError
                raise NotLeaderError(None)
            raise GreptimeError(resp.get("error", "meta error"))
        return resp

    # ---- MetaClient surface ----
    def register(self, peer: Peer) -> None:
        self._action("register", {"peer": peer.to_dict()})

    def heartbeat(self, node_id: int,
                  stat: Optional[DatanodeStat] = None) -> HeartbeatResponse:
        resp = self._action("heartbeat", {
            "node_id": node_id,
            "stat": dataclasses.asdict(stat) if stat else None})
        return HeartbeatResponse(mailbox=resp.get("mailbox", []))

    def create_route(self, full_name: str,
                     region_numbers: List[int]) -> TableRoute:
        resp = self._action("create_route", {
            "name": full_name, "region_numbers": list(region_numbers)})
        return TableRoute.from_dict(resp["route"])

    def route(self, full_name: str) -> Optional[TableRoute]:
        resp = self._action("route", {"name": full_name})
        return TableRoute.from_dict(resp["route"]) \
            if resp.get("route") else None

    def delete_route(self, full_name: str) -> bool:
        return bool(self._action("delete_route",
                                 {"name": full_name})["deleted"])

    def rename_route(self, full_name: str,
                     new_full_name: str) -> Optional[TableRoute]:
        resp = self._action("rename_route", {"name": full_name,
                                             "new_name": new_full_name})
        return TableRoute.from_dict(resp["route"]) \
            if resp.get("route") else None

    def allocate_table_id(self) -> int:
        return int(self._action("allocate_table_id", {})["id"])

    def cluster_info(self) -> List[dict]:
        return self._action("cluster_info", {})["nodes"]

    def background_jobs(self) -> List[dict]:
        """The metasrv replica's live + recent background jobs (the
        balancer's op steps run on the leader) — merged into
        information_schema.background_jobs by the frontend."""
        return list(self._action("background_jobs", {}).get("jobs", []))

    def region_heat(self) -> List[dict]:
        return self._action("region_heat", {})["rows"]

    def put_table_info(self, full_name: str, info: dict) -> None:
        self._action("put_table_info", {"name": full_name, "info": info})

    def table_info(self, full_name: str) -> Optional[dict]:
        return self._action("table_info", {"name": full_name}).get("info")

    def delete_table_info(self, full_name: str) -> bool:
        return bool(self._action("delete_table_info",
                                 {"name": full_name})["deleted"])

    def list_datanodes(self, alive_only: bool = True) -> List[Peer]:
        resp = self._action("list_datanodes", {"alive_only": alive_only})
        return [Peer.from_dict(p) for p in resp["peers"]]

    # ---- elastic region balancer surface ----
    def region_peers(self) -> List[dict]:
        return self._action("region_peers", {})["rows"]

    def admin_migrate_region(self, full_name: str, region: int,
                             to_node: int) -> dict:
        return self._action("admin_migrate_region", {
            "name": full_name, "region": region, "to_node": to_node})["op"]

    def admin_split_region(self, full_name: str, region: int,
                           at_value: object = None) -> dict:
        return self._action("admin_split_region", {
            "name": full_name, "region": region,
            "at_value": at_value})["op"]

    def admin_rebalance(self, full_name: Optional[str] = None
                        ) -> List[dict]:
        return self._action("admin_rebalance", {"name": full_name})["ops"]

    def admin_add_replica(self, full_name: str, region: int,
                          to_node: int) -> dict:
        return self._action("admin_add_replica", {
            "name": full_name, "region": region, "to_node": to_node})["op"]

    def admin_remove_replica(self, full_name: str, region: int,
                             node: int) -> dict:
        return self._action("admin_remove_replica", {
            "name": full_name, "region": region, "node": node})["op"]

    def balancer_configure(self, knob: str, value: object) -> None:
        self._action("balancer_configure", {"knob": knob, "value": value})

    def balancer_ack(self, node_id: int, op_id: str, step: str, ok: bool,
                     error: Optional[str], payload: dict) -> None:
        self._action("balancer_ack", {
            "node_id": node_id, "op_id": op_id, "step": step, "ok": ok,
            "error": error, "payload": payload or {}})

    # generic kv passthroughs (KvFlowStore persists flow specs under
    # __flow/ — without these a WIRE frontend crashed at start trying
    # to recover flows through the proxy's synthesized attribute)
    def kv_put(self, key: str, value: bytes) -> None:
        import base64
        self._action("kv_put", {"key": key,
                                "value": base64.b64encode(value).decode()})

    def kv_get(self, key: str) -> Optional[bytes]:
        import base64
        v = self._action("kv_get", {"key": key}).get("value")
        return base64.b64decode(v) if v is not None else None

    def kv_range(self, prefix: str) -> List[Tuple[str, bytes]]:
        # eager, not a generator: the RPC must fire inside this call so
        # FailoverFlightMetaClient's replica-walking wrapper (and any
        # caller try block) sees a connection failure, not the iterator
        import base64
        return [(k, base64.b64decode(v)) for k, v in
                self._action("kv_range", {"prefix": prefix})["items"]]

    def kv_delete(self, key: str) -> bool:
        return bool(self._action("kv_delete", {"key": key})["deleted"])


class PeerClientRegistry(dict):
    """node_id → DatanodeClient map that resolves unknown peers through
    the meta service and dials their Flight address on demand (the
    frontend's view of an elastic cluster)."""

    def __init__(self, meta: FlightMetaClient) -> None:
        super().__init__()
        self.meta = meta
        self._lock = threading.Lock()

    def _resolve(self, node_id: int) -> Optional[object]:
        from ..client.flight import FlightDatanodeClient
        for peer in self.meta.list_datanodes(alive_only=False):
            if peer.id == node_id and peer.addr:
                client = FlightDatanodeClient(peer.addr, node_id=node_id)
                with self._lock:
                    return self.setdefault(node_id, client)
        return None

    def __missing__(self, node_id: int) -> object:
        client = self._resolve(node_id)
        if client is None:
            raise KeyError(node_id)
        return client

    def get(self, node_id: int, default: object = None) -> object:
        try:
            return self[node_id]
        except KeyError:
            return default


class FailoverFlightMetaClient:
    """MetaClient surface over a metasrv replica set: every call walks
    the address list until one answers as the leader (reference clients
    iterate etcd endpoints the same way). Accepts one address too, so
    callers can always construct it from --metasrv-addr."""

    def __init__(self, addresses: List[str], *, retry_delay: float = 0.2,
                 max_rounds: int = 25) -> None:
        self.clients = [FlightMetaClient(a) for a in addresses]
        # the leader pin lives in a shared cell so advisory() copies
        # write the leader they discover back to the parent client
        self._pin = [0]
        self._delay = retry_delay
        self._rounds = max_rounds

    @property
    def _cur(self) -> int:
        return self._pin[0]

    @_cur.setter
    def _cur(self, value: int) -> None:
        self._pin[0] = value

    @property
    def address(self) -> str:
        return self.clients[self._cur % len(self.clients)].address

    def advisory(self) -> "FailoverFlightMetaClient":
        """A view of this client that tries each replica once with no
        inter-round sleep — for advisory reads (the cluster_info health
        view) that must degrade immediately when meta is down instead of
        stalling behind the write-path's full retry budget. Connections
        AND the leader pin are shared (`_pin` is a mutable cell), so a
        leader the quick pass discovers sticks for every later call."""
        import copy
        quick = copy.copy(self)
        quick._rounds = 1
        quick._delay = 0.0
        return quick

    def close(self) -> None:
        for c in self.clients:
            c.close()

    def __getattr__(self, name: str) -> object:
        if name.startswith("_"):
            raise AttributeError(name)

        def call(*args: object, **kwargs: object) -> object:
            from .replication import NotLeaderError
            import time as _time
            last: Optional[Exception] = None
            for attempt in range(self._rounds * len(self.clients)):
                client = self.clients[self._cur % len(self.clients)]
                try:
                    return getattr(client, name)(*args, **kwargs)
                except (NotLeaderError, ConnectionError) as e:
                    last = e
                except GreptimeError as e:
                    # unreachable replica (connection refused rides in as
                    # a generic flight error) — try the next one; real
                    # application errors don't mention leadership
                    if "refused" not in str(e).lower() \
                            and "unavailable" not in str(e).lower():
                        raise
                    last = e
                self._cur += 1
                if (attempt + 1) % len(self.clients) == 0:
                    _time.sleep(self._delay)
            raise last if last is not None else GreptimeError(
                "no metasrv replica reachable")
        return call
