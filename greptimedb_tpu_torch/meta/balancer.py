"""RegionBalancer: meta-srv's elastic region control loop.

ROADMAP item 1 — partition layouts stop being frozen at CREATE TABLE.
A leader-only cooperative tick (`tick()`; cmd/main wraps it in a
RepeatedTask outside pytest, the FlowManager/SelfMonitor pattern) watches
the heartbeat-fed region heat (`MetaSrv.region_heat`) and lease state and
drives three multi-step, crash-safe region operations:

- **split** — a region crossing the size/ingest-rate threshold refines
  its RANGE partition rule into two child regions ON ITS OWNER (copy →
  fence → delta copy → atomic rule+route commit → swap), so a hot shard
  stops being hot forever; placement can then move a child elsewhere.
- **migrate** — snapshot the region's SSTs via the shared object store
  (flush), fence the source (it can never again ack a write the target
  misses — the adoption fencing discipline, with a durable
  node-local marker), ship the WAL tail through the op doc, replay it on
  the target, then commit the route and release the source. Only the
  fenced window stalls writes.
- **rebalance** — a placement pass moves regions off hot/suspect/
  overloaded datanodes toward the least-loaded alive ones (the
  load_based selector's heat, applied continuously instead of only at
  CREATE TABLE).
- **replica add/remove** — bootstrap a read replica of a region
  on another datanode (flush-snapshot → WAL-tail bootstrap through the
  op doc → standby attach → atomic route commit → continuous-shipping
  wire-up) or detach one (route commit first, then drop). Followers
  serve bounded-staleness reads and are the failover promotion pool.

Every operation is a resumable state machine persisted in the meta KV
under ``__balancer/`` (the ``__flow/`` durability pattern): each step is
one idempotent datanode mailbox message (datanode/instance.py handlers)
acked through ``balancer_ack``, and each transition is one KV write —
the route/rule **commit is a single atomic KV batch** — so a meta crash
mid-migration resumes exactly where it stopped, and a pre-commit failure
rolls back (unfence / abort-split). Frontends learn about moved regions
lazily: a stale-route RPC raises the typed StaleRouteError and the
DistTable refreshes + retries (frontend/distributed.py).

Ported from greptimedb_tpu/meta/balancer.py (a copy; `env_int` from the
port's utils). The port's datanode does not run the balancer's steps yet
(region adoption, standby replicas and split in mito): each step it is
mailed fails with an UnsupportedError that it acks back, and the balancer
rolls the operation back as for any failed step.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Tuple

from ..common import failpoint as _fp
from ..utils import env_int
from ..errors import GreptimeError, InvalidArgumentsError
from .service import Peer, RegionRoute, ROUTE_PREFIX, TINFO_PREFIX

if TYPE_CHECKING:  # circular at runtime: service constructs the balancer
    from .service import MetaSrv

logger = logging.getLogger(__name__)

_fp.register("balancer_route_commit")

OP_PREFIX = "__balancer/op/"
DONE_PREFIX = "__balancer/done/"
SEQ_KEY = "__balancer/seq"

#: op states that precede the route/rule commit: a failure there rolls
#: back; every later state must roll FORWARD (the route already moved)
_PRE_COMMIT = {"snapshot", "fence", "open", "prepare", "catchup",
               "bootstrap", "attach"}

#: op state -> the mailbox message type whose ack advances it
_STEP_MSG = {
    ("migrate", "snapshot"): "balancer_snapshot",
    ("migrate", "fence"): "balancer_fence",
    ("migrate", "open"): "balancer_open",
    ("migrate", "release"): "balancer_release",
    ("split", "prepare"): "balancer_split_prepare",
    ("split", "catchup"): "balancer_split_catchup",
    ("split", "apply"): "balancer_split_apply",
    ("replica_add", "snapshot"): "balancer_snapshot",
    ("replica_add", "bootstrap"): "repl_bootstrap",
    ("replica_add", "attach"): "repl_attach",
    ("replica_add", "wire"): "repl_set_followers",
    ("replica_remove", "drop"): "repl_drop",
    ("replica_remove", "wire"): "repl_set_followers",
}


class RegionBalancer:
    """Leader-only control loop over one MetaSrv's KV + heartbeat state."""

    def __init__(self, srv: "MetaSrv",
                 is_leader_fn: Optional[Callable[[], bool]] = None
                 ) -> None:
        self.srv = srv
        #: None = always leader (single metasrv / in-process tests)
        self.is_leader_fn = is_leader_fn
        # knobs (SET balancer_* forwards here; GREPTIME_BALANCER_* seeds)
        self.enabled = env_int("GREPTIME_BALANCER_ENABLED", 1) != 0
        self.split_size_bytes = env_int(
            "GREPTIME_BALANCER_SPLIT_SIZE_BYTES", 1 << 30)
        self.split_rate_rps = env_int(
            "GREPTIME_BALANCER_SPLIT_RATE_RPS", 0)
        self.rebalance_threshold = env_int(
            "GREPTIME_BALANCER_REBALANCE_THRESHOLD", 2)
        self.max_inflight = env_int("GREPTIME_BALANCER_MAX_INFLIGHT", 4)
        self.step_timeout_s = float(env_int(
            "GREPTIME_BALANCER_STEP_TIMEOUT_S", 300))
        self.resend_interval_s = 5.0
        from ..common.locks import TrackedLock
        from ..common.tracking import tracked_state
        #: (op_id, msg_type) -> ack dict; heartbeat threads write, the
        #: tick thread consumes
        self._acks: Dict[Tuple[str, str], dict] = tracked_state(
            {}, "meta.balancer.acks")
        self._acks_lock = TrackedLock("meta.balancer_acks")
        #: (op_id, msg_type) -> monotonic last-send time (in-memory only:
        #: after a meta restart every current step re-sends immediately,
        #: which is safe because steps are idempotent). Tick-thread only —
        #: unlike _acks it has exactly one writer, so no lock
        self._sent: Dict[Tuple[str, str], float] = tracked_state(
            {}, "meta.balancer.sent")

    # ------------------------------------------------------------------
    # knobs
    # ------------------------------------------------------------------
    KNOBS = ("enabled", "split_size_bytes", "split_rate_rps",
             "rebalance_threshold", "max_inflight", "step_timeout_s")

    def configure(self, knob: str, value: object) -> None:
        """SET balancer_<knob> = value (both frontends forward here)."""
        if knob not in self.KNOBS:
            raise InvalidArgumentsError(
                f"unknown balancer knob {knob!r} (have: "
                f"{', '.join(self.KNOBS)})")
        try:
            num = float(value)
        except (TypeError, ValueError):
            raise InvalidArgumentsError(
                f"balancer_{knob}: expected a number, got {value!r}")
        if knob == "enabled":
            self.enabled = num != 0
        elif knob == "step_timeout_s":
            self.step_timeout_s = max(1.0, num)
        else:
            setattr(self, knob, max(0, int(num)))
        logger.info("balancer knob %s = %r", knob, value)

    # ------------------------------------------------------------------
    # op store
    # ------------------------------------------------------------------
    def _alloc_id(self) -> str:
        return f"bop-{self.srv.kv.incr(SEQ_KEY):06d}"

    def _save(self, op: dict) -> None:
        op["updated_ms"] = int(time.time() * 1000)
        # first-entry timestamp per state: bench.py derives the fenced
        # handoff window (open → release) from these
        op.setdefault("times", {}).setdefault(op["state"],
                                              op["updated_ms"])
        self.srv.kv.put(f"{OP_PREFIX}{op['id']}",
                        json.dumps(op).encode())

    def ops(self) -> List[dict]:
        """In-flight operations, oldest first."""
        return [json.loads(v) for _, v in self.srv.kv.range(OP_PREFIX)]

    def done_ops(self) -> List[dict]:
        return [json.loads(v) for _, v in self.srv.kv.range(DONE_PREFIX)]

    def op(self, op_id: str) -> Optional[dict]:
        raw = self.srv.kv.get(f"{OP_PREFIX}{op_id}") or \
            self.srv.kv.get(f"{DONE_PREFIX}{op_id}")
        return json.loads(raw) if raw is not None else None

    def _finish(self, op: dict, state: str, error: Optional[str] = None
                ) -> None:
        from ..common.telemetry import increment_counter
        op["state"] = state
        if error:
            op["error"] = error
        op["updated_ms"] = int(time.time() * 1000)
        op.setdefault("times", {}).setdefault(state, op["updated_ms"])
        self.srv.kv.batch([
            ("put", f"{DONE_PREFIX}{op['id']}",
             json.dumps(op).encode()),
            ("delete", f"{OP_PREFIX}{op['id']}", None)])
        # purge the op's ack/send memos: unconsumed acks (rollback steps,
        # late arrivals after a timeout-abort) would otherwise accumulate
        # forever on a long-lived leader
        with self._acks_lock:
            for key in [k for k in self._acks if k[0] == op["id"]]:
                del self._acks[key]
        for key in [k for k in self._sent if k[0] == op["id"]]:
            del self._sent[key]
        increment_counter("balancer_ops_completed" if state == "done"
                          else "balancer_ops_failed")
        logger.info("balancer op %s (%s %s region %s) -> %s%s",
                    op["id"], op["kind"], op["table"], op["region"],
                    state, f": {error}" if error else "")

    def _inflight_tables(self) -> Dict[str, str]:
        return {o["table"]: o["id"] for o in self.ops()}

    # ------------------------------------------------------------------
    # admin entrypoints (ADMIN MIGRATE/SPLIT/REBALANCE; MetaSrv wraps)
    # ------------------------------------------------------------------
    def migrate(self, full_name: str, region: int, to_node: int,
                auto: bool = False) -> dict:
        from ..common.telemetry import increment_counter
        route = self.srv.table_route(full_name)
        if route is None:
            raise GreptimeError(f"table {full_name} has no route")
        rr = next((r for r in route.region_routes
                   if r.region_number == region), None)
        if rr is None:
            raise InvalidArgumentsError(
                f"region {region} is not in the route of {full_name} "
                f"(have {[r.region_number for r in route.region_routes]})")
        if self.srv.peer(to_node) is None:
            raise InvalidArgumentsError(
                f"datanode {to_node} is not registered")
        if rr.leader.id == to_node:
            raise InvalidArgumentsError(
                f"region {region} of {full_name} is already on datanode "
                f"{to_node}")
        self._check_can_enqueue(full_name)
        catalog, schema, table = full_name.split(".", 2)
        op = {
            "id": self._alloc_id(), "kind": "migrate",
            "catalog": catalog, "schema": schema, "table": full_name,
            "table_short": table, "region": int(region),
            "from_node": int(rr.leader.id), "to_node": int(to_node),
            "state": "snapshot", "wal_tail": None, "auto": bool(auto),
            "created_ms": int(time.time() * 1000),
        }
        self._save(op)
        increment_counter("balancer_ops_started")
        increment_counter("balancer_migrations_started")
        logger.info("balancer: enqueued %s — migrate region %s of %s "
                    "from dn%d to dn%d%s", op["id"], region, full_name,
                    op["from_node"], to_node, " (auto)" if auto else "")
        return op

    def split(self, full_name: str, region: int,
              at_value: object = None,
              auto: bool = False) -> dict:
        from ..common.telemetry import increment_counter
        from ..mito.engine import _deserialize_rule
        from ..partition.rule import refine_range_rule
        route = self.srv.table_route(full_name)
        if route is None:
            raise GreptimeError(f"table {full_name} has no route")
        rr = next((r for r in route.region_routes
                   if r.region_number == region), None)
        if rr is None:
            raise InvalidArgumentsError(
                f"region {region} is not in the route of {full_name}")
        info = self.srv.table_info(full_name)
        rule_doc = (info or {}).get("meta", {}).get("partition_rule")
        if rule_doc is None:
            raise InvalidArgumentsError(
                f"table {full_name} has no partition rule; single-region "
                f"tables cannot split (recreate with PARTITION BY RANGE)")
        rule = _deserialize_rule(rule_doc)
        from ..partition.rule import (
            HashPartitionRule, RangeColumnsPartitionRule)
        if isinstance(rule, HashPartitionRule):
            raise InvalidArgumentsError(
                f"table {full_name} is hash-partitioned; one hash bucket "
                f"cannot split locally (the modulus is global)")
        if isinstance(rule, RangeColumnsPartitionRule) and \
                len(rule.columns) > 1:
            raise InvalidArgumentsError(
                f"table {full_name} partitions on multiple columns; "
                f"only single-column range rules split")
        taken = {r.region_number for r in route.region_routes} | \
            set(rule.region_numbers())
        children = [max(taken) + 1, max(taken) + 2]
        if at_value is not None:
            # validate NOW so ADMIN SPLIT errors synchronously on a value
            # outside the region's range (the datanode probe handles the
            # at_value=None case)
            try:
                refine_range_rule(rule, region, at_value, children)
            except ValueError as e:
                raise InvalidArgumentsError(str(e))
        self._check_can_enqueue(full_name)
        catalog, schema, table = full_name.split(".", 2)
        op = {
            "id": self._alloc_id(), "kind": "split",
            "catalog": catalog, "schema": schema, "table": full_name,
            "table_short": table, "region": int(region),
            "node": int(rr.leader.id), "children": children,
            "at_value": at_value, "snapshot_seq": None,
            "state": "prepare", "auto": bool(auto),
            "created_ms": int(time.time() * 1000),
        }
        self._save(op)
        increment_counter("balancer_ops_started")
        increment_counter("balancer_splits_started")
        logger.info("balancer: enqueued %s — split region %s of %s into "
                    "%s at %r%s", op["id"], region, full_name, children,
                    at_value, " (auto)" if auto else "")
        return op

    def rebalance(self, full_name: Optional[str] = None,
                  auto: bool = False) -> List[dict]:
        """Move regions from the most- to the least-loaded alive nodes
        until the spread is <= 1 (admin) or <= rebalance_threshold
        (auto). Each move is an independent migrate op."""
        alive = self.srv.alive_datanodes()
        if len(alive) < 2:
            return []
        counts: Dict[int, int] = {p.id: 0 for p in alive}
        placed: Dict[int, List[Tuple[str, int]]] = {p.id: [] for p in alive}
        for route in self.srv.all_table_routes():
            if full_name is not None and route.table_name != full_name:
                continue
            for rr in route.region_routes:
                if rr.leader.id in counts:
                    counts[rr.leader.id] += 1
                    placed[rr.leader.id].append(
                        (route.table_name, rr.region_number))
        inflight = self._inflight_tables()
        floor = self.rebalance_threshold if auto else 1
        out: List[dict] = []
        while len(self.ops()) < self.max_inflight:
            hot = max(counts, key=lambda n: (counts[n], n))
            cold = min(counts, key=lambda n: (counts[n], -n))
            if counts[hot] - counts[cold] <= max(1, floor):
                break
            candidate = next(
                ((t, r) for t, r in placed[hot] if t not in inflight),
                None)
            if candidate is None:
                break
            table_name, region = candidate
            op = self.migrate(table_name, region, cold, auto=auto)
            out.append(op)
            inflight[table_name] = op["id"]
            placed[hot].remove(candidate)
            counts[hot] -= 1
            counts[cold] += 1
        if out:
            from ..common.telemetry import increment_counter
            increment_counter("balancer_rebalance_moves", len(out))
        return out

    def add_replica(self, full_name: str, region: int, to_node: int
                    ) -> dict:
        """ADMIN ADD REPLICA: bootstrap a read replica of the region on
        `to_node` (snapshot → WAL-tail bootstrap → standby attach →
        atomic route commit → shipper wire-up)."""
        from ..common.telemetry import increment_counter
        route = self.srv.table_route(full_name)
        if route is None:
            raise GreptimeError(f"table {full_name} has no route")
        rr = next((r for r in route.region_routes
                   if r.region_number == region), None)
        if rr is None:
            raise InvalidArgumentsError(
                f"region {region} is not in the route of {full_name} "
                f"(have {[r.region_number for r in route.region_routes]})")
        if self.srv.peer(to_node) is None:
            raise InvalidArgumentsError(
                f"datanode {to_node} is not registered")
        if rr.leader.id == to_node:
            raise InvalidArgumentsError(
                f"datanode {to_node} already leads region {region} of "
                f"{full_name}; a leader cannot follow itself")
        if any(f.id == to_node for f in rr.followers):
            raise InvalidArgumentsError(
                f"datanode {to_node} is already a replica of region "
                f"{region} of {full_name}")
        self._check_can_enqueue(full_name)
        catalog, schema, table = full_name.split(".", 2)
        op = {
            "id": self._alloc_id(), "kind": "replica_add",
            "catalog": catalog, "schema": schema, "table": full_name,
            "table_short": table, "region": int(region),
            "from_node": int(rr.leader.id), "to_node": int(to_node),
            "state": "snapshot", "wal_tail": None, "flushed_seq": 0,
            "created_ms": int(time.time() * 1000),
        }
        self._save(op)
        increment_counter("balancer_ops_started")
        increment_counter("balancer_replica_adds_started")
        logger.info("balancer: enqueued %s — add replica of region %s of "
                    "%s on dn%d (leader dn%d)", op["id"], region,
                    full_name, to_node, op["from_node"])
        return op

    def remove_replica(self, full_name: str, region: int, node: int
                       ) -> dict:
        """ADMIN REMOVE REPLICA: detach a follower — route commit first
        (reads stop scattering there), then drop its standby region."""
        from ..common.telemetry import increment_counter
        route = self.srv.table_route(full_name)
        if route is None:
            raise GreptimeError(f"table {full_name} has no route")
        rr = next((r for r in route.region_routes
                   if r.region_number == region), None)
        if rr is None:
            raise InvalidArgumentsError(
                f"region {region} is not in the route of {full_name}")
        if all(f.id != node for f in rr.followers):
            raise InvalidArgumentsError(
                f"datanode {node} is not a replica of region {region} of "
                f"{full_name} (followers: "
                f"{[f.id for f in rr.followers]})")
        self._check_can_enqueue(full_name)
        catalog, schema, table = full_name.split(".", 2)
        op = {
            "id": self._alloc_id(), "kind": "replica_remove",
            "catalog": catalog, "schema": schema, "table": full_name,
            "table_short": table, "region": int(region),
            "from_node": int(rr.leader.id), "to_node": int(node),
            "state": "commit",
            "created_ms": int(time.time() * 1000),
        }
        self._save(op)
        increment_counter("balancer_ops_started")
        increment_counter("balancer_replica_removes_started")
        logger.info("balancer: enqueued %s — remove replica of region %s "
                    "of %s from dn%d", op["id"], region, full_name, node)
        return op

    def _check_can_enqueue(self, full_name: str) -> None:
        inflight = self._inflight_tables()
        if full_name in inflight:
            raise InvalidArgumentsError(
                f"table {full_name} already has in-flight balancer "
                f"operation {inflight[full_name]}")

    # ------------------------------------------------------------------
    # acks (datanodes report step results here, via meta RPC)
    # ------------------------------------------------------------------
    def handle_ack(self, node_id: int, op_id: str, step: str, ok: bool,
                   error: Optional[str], payload: dict) -> None:
        with self._acks_lock:
            self._acks[(op_id, step)] = {
                "node": node_id, "ok": bool(ok), "error": error,
                "payload": payload or {}}

    def _take_ack(self, op_id: str, step: str) -> Optional[dict]:
        with self._acks_lock:
            return self._acks.pop((op_id, step), None)

    # ------------------------------------------------------------------
    # the control loop
    # ------------------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> dict:
        """Advance every in-flight op one step and run the auto policies.
        Cooperative: cmd/main wraps it in a RepeatedTask; tests call it
        directly. Errors are contained per op (background-loop safety)."""
        if self.is_leader_fn is not None and not self.is_leader_fn():
            return {"leader": False}
        from ..common.telemetry import span
        now = time.time() if now is None else now
        summary = {"leader": True, "advanced": 0, "auto_splits": 0,
                   "auto_moves": 0}
        from ..common import background_jobs
        with span("balancer_tick"):
            for op in self.ops():
                try:
                    # each op step is a background job rooting its own
                    # trace; the trace store ALWAYS retains traces that
                    # touched a balancer op (tail-sampling policy)
                    with background_jobs.job(
                            "balancer_op", table=op.get("table"),
                            region=str(op.get("region")),
                            op_id=op.get("id"), op_kind=op.get("kind"),
                            step=op.get("state")):
                        if self._advance(op, now):
                            summary["advanced"] += 1
                except Exception:  # noqa: BLE001 — one broken op must not
                    logger.exception(     # stall the whole control loop
                        "balancer op %s advance failed", op.get("id"))
            if self.enabled:
                try:
                    summary["auto_splits"] = len(self._auto_split(now))
                    summary["auto_moves"] = len(
                        self.rebalance(auto=True))
                except Exception:  # noqa: BLE001 — policy errors degrade
                    logger.exception("balancer auto policy failed")
        return summary

    def _advance(self, op: dict, now: float) -> bool:
        state = op["state"]
        if state == "commit":
            if op["kind"] == "migrate":
                self._commit_migrate(op)
            elif op["kind"] == "replica_add":
                self._commit_replica_add(op)
            elif op["kind"] == "replica_remove":
                self._commit_replica_remove(op)
            else:
                self._commit_split(op)
            return True
        msg_type = _STEP_MSG.get((op["kind"], state))
        if msg_type is None:
            logger.error("balancer op %s in unknown state %r; failing",
                         op["id"], state)
            self._finish(op, "failed", f"unknown state {state!r}")
            return True
        ack = self._take_ack(op["id"], msg_type)
        if ack is None:
            # pre-commit steps time out into a rollback; post-commit
            # steps retry forever (the route already moved — the only
            # way out is forward)
            age_s = (now * 1000 - op["updated_ms"]) / 1e3
            if state in _PRE_COMMIT and age_s > self.step_timeout_s:
                self._abort(op, f"step {state} timed out after "
                                f"{age_s:.0f}s")
                return True
            self._send_step(op, msg_type, now)
            return False
        if not ack["ok"]:
            if state in _PRE_COMMIT:
                self._abort(op, f"step {state} failed on dn"
                                f"{ack['node']}: {ack['error']}")
            else:
                # post-commit failure: log, clear the send memo so the
                # step re-mails, and keep rolling forward
                logger.error(
                    "balancer op %s post-commit step %s failed on dn%d "
                    "(%s); retrying", op["id"], state, ack["node"],
                    ack["error"])
                self._sent.pop((op["id"], msg_type), None)
            return True
        payload = ack["payload"]
        if op["kind"] == "migrate":
            self._migrate_on_ack(op, state, payload)
        elif op["kind"] in ("replica_add", "replica_remove"):
            self._replica_on_ack(op, state, payload)
        else:
            self._split_on_ack(op, state, payload)
        return True

    def _send_step(self, op: dict, msg_type: str, now: float) -> None:
        key = (op["id"], msg_type)
        last = self._sent.get(key)
        if last is not None and now - last < self.resend_interval_s:
            return
        if last is not None:
            from ..common.telemetry import increment_counter
            increment_counter("balancer_step_resends")
        self._sent[key] = now
        node, msg = self._build_step(op, msg_type)
        self.srv.send_mailbox(node, msg)

    def _build_step(self, op: dict, msg_type: str) -> Tuple[int, dict]:
        base = {"type": msg_type, "op_id": op["id"],
                "catalog": op["catalog"], "schema": op["schema"],
                "table": op["table_short"], "region": op["region"]}
        if op["kind"] == "migrate":
            if msg_type == "balancer_open":
                info = self.srv.table_info(op["table"])
                if info is None:
                    raise GreptimeError(
                        f"no table info for {op['table']} — cannot "
                        f"materialize the region on dn{op['to_node']}")
                return op["to_node"], {
                    **base, "table_info": info,
                    "wal_tail": op.get("wal_tail") or []}
            return op["from_node"], base
        if op["kind"] in ("replica_add", "replica_remove"):
            if msg_type == "repl_attach":
                info = self.srv.table_info(op["table"])
                if info is None:
                    raise GreptimeError(
                        f"no table info for {op['table']} — cannot "
                        f"materialize the standby on dn{op['to_node']}")
                return op["to_node"], {
                    **base, "table_info": info,
                    "wal_tail": op.get("wal_tail") or []}
            if msg_type == "repl_drop":
                return op["to_node"], base
            if msg_type == "repl_set_followers":
                # the re-wire targets the route's CURRENT leader with the
                # route's CURRENT follower set (a failover may have moved
                # either since the op was enqueued)
                route = self.srv.table_route(op["table"])
                rr = next((r for r in (route.region_routes
                                       if route else [])
                           if r.region_number == op["region"]), None)
                if rr is None:
                    raise GreptimeError(
                        f"route for region {op['region']} of "
                        f"{op['table']} vanished mid-op")
                return rr.leader.id, {
                    **base,
                    "followers": [f.to_dict() for f in rr.followers]}
            # balancer_snapshot / repl_bootstrap run on the leader
            return op["from_node"], base
        # split: every step runs on the owning node
        extra: dict = {"children": op["children"]}
        if msg_type == "balancer_split_prepare":
            extra["at_value"] = op.get("at_value")
        elif msg_type == "balancer_split_catchup":
            extra["at_value"] = op["at_value"]
            extra["snapshot_seq"] = op["snapshot_seq"]
        elif msg_type == "balancer_split_apply":
            extra["rule"] = op["rule_doc"]
        return op["node"], {**base, **extra}

    # ---- migrate transitions ----
    def _migrate_on_ack(self, op: dict, state: str, payload: dict
                        ) -> None:
        if state == "snapshot":
            op["state"] = "fence"
        elif state == "fence":
            # the tail persists IN THE OP DOC: a meta crash after this
            # point still holds everything the target needs to replay
            op["wal_tail"] = payload.get("wal_tail") or []
            op["state"] = "open"
        elif state == "open":
            op["state"] = "commit"
        elif state == "release":
            self._finish(op, "done")
            return
        self._save(op)

    def _commit_migrate(self, op: dict) -> None:
        """The migrate commit point: route leader flips to the target in
        ONE atomic KV batch with the op transition — a crash either left
        the route untouched (op re-commits) or moved it together with
        the op's advance to release (op resumes forward)."""
        from ..common.telemetry import increment_counter
        _fp.fail_point("balancer_route_commit")
        route = self.srv.table_route(op["table"])
        if route is None:
            self._finish(op, "failed", "route vanished before commit")
            return
        rr = next((r for r in route.region_routes
                   if r.region_number == op["region"]), None)
        if rr is None:
            self._finish(op, "failed", "region vanished before commit")
            return
        if rr.leader.id != op["from_node"]:
            # the region moved under the op (failover raced it before the
            # busy-table guard, or an operator intervened): committing
            # would orphan whatever the CURRENT leader acked — abort and
            # leave the live placement alone
            self._abort(op, f"region leader changed to dn{rr.leader.id} "
                            f"mid-migration; aborting commit")
            return
        peer = self.srv.peer(op["to_node"]) or Peer(op["to_node"])
        rr.leader = peer
        route.version += 1
        op["state"] = "release"
        op["updated_ms"] = int(time.time() * 1000)
        op.setdefault("times", {}).setdefault("release",
                                              op["updated_ms"])
        self.srv.kv.batch([
            ("put", f"{ROUTE_PREFIX}{op['table']}",
             json.dumps(route.to_dict()).encode()),
            ("put", f"{OP_PREFIX}{op['id']}", json.dumps(op).encode())])
        increment_counter("balancer_migrations_committed")
        logger.info("balancer op %s: route committed — region %s of %s "
                    "now on dn%d (route v%d)", op["id"], op["region"],
                    op["table"], op["to_node"], route.version)

    # ---- split transitions ----
    def _split_on_ack(self, op: dict, state: str, payload: dict) -> None:
        if state == "prepare":
            if payload.get("probed"):
                # probe round: PIN the value in the durable op doc, then
                # re-send prepare (now with the value) — copies only ever
                # happen across a boundary the op doc already recorded
                op["at_value"] = payload["split_value"]
                self._save(op)
                self._sent.pop((op["id"], "balancer_split_prepare"), None)
                return
            op["snapshot_seq"] = payload.get("snapshot_seq", 0)
            op["state"] = "catchup"
        elif state == "catchup":
            op["state"] = "commit"
        elif state == "apply":
            self._finish(op, "done")
            return
        self._save(op)

    def _commit_split(self, op: dict) -> None:
        """The split commit point: the refined rule + the child region
        routes land in ONE atomic KV batch with the op transition."""
        from ..common.telemetry import increment_counter
        from ..mito.engine import _deserialize_rule, _serialize_rule
        from ..partition.rule import refine_range_rule
        _fp.fail_point("balancer_route_commit")
        route = self.srv.table_route(op["table"])
        info = self.srv.table_info(op["table"])
        if route is None or info is None:
            self._finish(op, "failed", "route/table info vanished "
                                       "before commit")
            return
        rule_doc = info.get("meta", {}).get("partition_rule")
        rule = _deserialize_rule(rule_doc)
        try:
            refined = refine_range_rule(rule, op["region"],
                                        op["at_value"], op["children"])
        except ValueError as e:
            self._abort(op, f"rule refinement failed at commit: {e}")
            return
        new_doc = _serialize_rule(refined)
        peer = self.srv.peer(op["node"]) or Peer(op["node"])
        routes = [r for r in route.region_routes
                  if r.region_number != op["region"]]
        routes += [RegionRoute(rn, peer) for rn in op["children"]]
        route.region_routes = sorted(routes,
                                     key=lambda r: r.region_number)
        route.version += 1
        info["meta"]["partition_rule"] = new_doc
        info["meta"]["region_numbers"] = sorted(
            r.region_number for r in route.region_routes)
        op["rule_doc"] = new_doc
        op["state"] = "apply"
        op["updated_ms"] = int(time.time() * 1000)
        op.setdefault("times", {}).setdefault("apply", op["updated_ms"])
        self.srv.kv.batch([
            ("put", f"{ROUTE_PREFIX}{op['table']}",
             json.dumps(route.to_dict()).encode()),
            ("put", f"{TINFO_PREFIX}{op['table']}",
             json.dumps(info).encode()),
            ("put", f"{OP_PREFIX}{op['id']}", json.dumps(op).encode())])
        increment_counter("balancer_splits_committed")
        logger.info("balancer op %s: rule committed — region %s of %s "
                    "split into %s at %r (route v%d)", op["id"],
                    op["region"], op["table"], op["children"],
                    op["at_value"], route.version)

    # ---- replica add/remove transitions ----
    def _replica_on_ack(self, op: dict, state: str, payload: dict
                        ) -> None:
        if state == "snapshot":
            # leader flushed: the shared-store SSTs now cover everything
            # below its flushed sequence, so the bootstrap tail is small
            op["state"] = "bootstrap"
        elif state == "bootstrap":
            # the tail persists IN THE OP DOC (the migrate discipline):
            # a meta crash after this point still holds everything the
            # follower needs to come up at the leader's acked frontier
            op["wal_tail"] = payload.get("wal_tail") or []
            op["flushed_seq"] = payload.get("flushed_seq", 0)
            op["state"] = "attach"
        elif state == "attach":
            op["state"] = "commit"
        elif state == "drop":
            op["state"] = "wire"
        elif state == "wire":
            self._finish(op, "done")
            return
        self._save(op)

    def _commit_replica_add(self, op: dict) -> None:
        """The replica-add commit point: the follower joins the route in
        ONE atomic KV batch with the op transition; the wire step then
        turns on continuous shipping from the leader."""
        from ..common.telemetry import increment_counter
        _fp.fail_point("balancer_route_commit")
        route = self.srv.table_route(op["table"])
        if route is None:
            self._finish(op, "failed", "route vanished before commit")
            return
        rr = next((r for r in route.region_routes
                   if r.region_number == op["region"]), None)
        if rr is None:
            self._finish(op, "failed", "region vanished before commit")
            return
        if rr.leader.id != op["from_node"]:
            # the leader moved under the op (failover/migration raced the
            # busy-table guard): the bootstrapped standby tracked the OLD
            # leader's WAL — abort and drop it rather than publish a
            # follower of unknown lineage
            self._abort(op, f"region leader changed to dn{rr.leader.id} "
                            f"mid-replica-add; aborting commit")
            return
        if all(f.id != op["to_node"] for f in rr.followers):
            peer = self.srv.peer(op["to_node"]) or Peer(op["to_node"])
            rr.followers.append(peer)
        route.version += 1
        op["state"] = "wire"
        op["wal_tail"] = None      # bootstrapped; shrink the op doc
        op["updated_ms"] = int(time.time() * 1000)
        op.setdefault("times", {}).setdefault("wire", op["updated_ms"])
        self.srv.kv.batch([
            ("put", f"{ROUTE_PREFIX}{op['table']}",
             json.dumps(route.to_dict()).encode()),
            ("put", f"{OP_PREFIX}{op['id']}", json.dumps(op).encode())])
        increment_counter("balancer_replicas_added")
        logger.info("balancer op %s: route committed — region %s of %s "
                    "now replicated on dn%d (route v%d)", op["id"],
                    op["region"], op["table"], op["to_node"],
                    route.version)

    def _commit_replica_remove(self, op: dict) -> None:
        """The replica-remove commit point (the op STARTS here): the
        follower leaves the route first so no frontend routes reads to
        it, then the drop step releases its standby region."""
        from ..common.telemetry import increment_counter
        _fp.fail_point("balancer_route_commit")
        route = self.srv.table_route(op["table"])
        if route is None:
            self._finish(op, "failed", "route vanished before commit")
            return
        rr = next((r for r in route.region_routes
                   if r.region_number == op["region"]), None)
        if rr is None:
            self._finish(op, "failed", "region vanished before commit")
            return
        rr.followers = [f for f in rr.followers
                        if f.id != op["to_node"]]
        route.version += 1
        op["state"] = "drop"
        op["updated_ms"] = int(time.time() * 1000)
        op.setdefault("times", {}).setdefault("drop", op["updated_ms"])
        self.srv.kv.batch([
            ("put", f"{ROUTE_PREFIX}{op['table']}",
             json.dumps(route.to_dict()).encode()),
            ("put", f"{OP_PREFIX}{op['id']}", json.dumps(op).encode())])
        increment_counter("balancer_replicas_removed")
        logger.info("balancer op %s: route committed — region %s of %s "
                    "no longer replicated on dn%d (route v%d)", op["id"],
                    op["region"], op["table"], op["to_node"],
                    route.version)

    # ---- rollback ----
    def _abort(self, op: dict, reason: str) -> None:
        """Pre-commit rollback: the route never changed, so undoing means
        unfencing the source (migrate), dropping the pending children
        (split) or the half-built standby (replica_add). The undo message
        is fire-and-forget — it is idempotent and re-sendable, and the op
        itself lands in done/ as failed."""
        logger.warning("balancer op %s rolling back: %s", op["id"], reason)
        base = {"op_id": op["id"], "catalog": op["catalog"],
                "schema": op["schema"], "table": op["table_short"],
                "region": op["region"]}
        if op["kind"] == "migrate":
            self.srv.send_mailbox(op["from_node"],
                                  {**base, "type": "balancer_unfence"})
        elif op["kind"] == "replica_add":
            self.srv.send_mailbox(op["to_node"],
                                  {**base, "type": "repl_drop"})
        elif op["kind"] == "replica_remove":
            pass    # commit-first: nothing pre-commit to undo
        else:
            self.srv.send_mailbox(op["node"],
                                  {**base, "type": "balancer_split_abort",
                                   "children": op["children"]})
        self._finish(op, "failed", reason)

    # ------------------------------------------------------------------
    # auto policies
    # ------------------------------------------------------------------
    def _auto_split(self, now: float) -> List[dict]:
        """Enqueue splits for regions past the configured heat threshold
        (size and/or sustained ingest rate; 0 disables a dimension)."""
        if self.split_size_bytes <= 0 and self.split_rate_rps <= 0:
            return []
        by_tid = {r.table_id: r for r in self.srv.all_table_routes()}
        inflight = self._inflight_tables()
        out: List[dict] = []
        for row in self.srv.region_heat(now):
            if len(self.ops()) >= self.max_inflight:
                break
            hot_size = self.split_size_bytes > 0 and \
                int(row["size_bytes"]) > self.split_size_bytes
            hot_rate = self.split_rate_rps > 0 and \
                float(row["ingest_rate_rps"]) > self.split_rate_rps
            if not (hot_size or hot_rate):
                continue
            try:
                tid_s, rn_s = row["region"].rsplit("_", 1)
                tid, rn = int(tid_s), int(rn_s)
            except ValueError:
                continue
            route = by_tid.get(tid)
            if route is None or route.table_name in inflight:
                continue
            if rn not in {r.region_number for r in route.region_routes}:
                continue
            try:
                op = self.split(route.table_name, rn, auto=True)
            except (GreptimeError, ValueError) as e:
                logger.debug("auto-split of %s region %d skipped: %s",
                             route.table_name, rn, e)
                continue
            from ..common.telemetry import increment_counter
            increment_counter("balancer_auto_splits")
            inflight[route.table_name] = op["id"]
            out.append(op)
            logger.warning(
                "balancer: auto-split of region %d of %s (size=%s "
                "rate=%s) -> op %s", rn, route.table_name,
                row["size_bytes"], row["ingest_rate_rps"], op["id"])
        return out
